"""95th percentile, over every request due in the window, of the time from
its due time to its first token; a failed request is missing (reads as the
wait until the run stopped waiting for it)."""

from portbench import measure


def read(run):
    due = measure.due_in_window(run.out)
    if not due:
        return None
    give_up = run.out["t_drained"]
    return 1e3 * measure.quantile([measure.ttft_s(r, give_up) for r in due], 0.95)
