"""Host ms per batched decode step: the window over the engine's
``decode_steps`` counter's change in it."""


def read(run):
    steps = run.out["counters"]["decode_steps"]
    return 1e3 * run.out["window_s"] / steps if steps else None
