"""95th percentile, over the requests due in the window with at least 8
output tokens, of (last token - first token) / (tokens - 1)."""

from portbench import measure


def read(run):
    per = [(r.times[-1] - r.times[0]) / (len(r.times) - 1)
           for r in measure.due_in_window(run.out) if r.ok and len(r.times) >= 8]
    return 1e3 * measure.quantile(per, 0.95) if per else None
