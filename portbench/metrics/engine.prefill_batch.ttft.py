"""Requests per batched prefill in the window: the change of the engine's
``prefill_requests`` over that of ``prefill_dispatches``."""


def read(run):
    c = run.out["counters"]
    return c["prefill_requests"] / c["prefill_dispatches"] if c["prefill_dispatches"] else None
