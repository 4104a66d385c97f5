"""Decode-made tokens delivered in the window per decode step (the live
slots a step serves)."""

from portbench import measure


def read(run):
    steps = run.out["counters"]["decode_steps"]
    return len(measure.decode_positions(run.out)) / steps if steps else None
