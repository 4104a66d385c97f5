"""Output tokens that reached the clients in the window, over the window."""

from portbench import measure


def read(run):
    n = len(measure.window_tokens(run.out))
    return n / run.out["window_s"] if n else None
