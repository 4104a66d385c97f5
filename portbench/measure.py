"""What the metric readers share: the window's work, read from the client
records (host clock), and the percentile rule.

A token is in the window when its chunk reached the client between the
window's open and close. A request's first token comes from its prefill,
the others from decode steps; the j-th output token (j >= 1) of a request
whose fused prompt is ``n`` tokens came from a step whose query sat at
position ``n + j - 1``. A prefill is in the window when its request's first
token is.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple


def quantile(values: Sequence[float], q: float) -> float:
    """Linear interpolation between the order statistics (numpy's default):
    the q-quantile of ``values``, 0 <= q <= 1."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def in_window(out: dict, t: float) -> bool:
    return out["w0"] <= t <= out["w1"]


def window_tokens(out: dict) -> List[Tuple[object, int]]:
    """(record, output index) of every token delivered in the window."""
    return [(r, j) for r in out["records"] for j, t in enumerate(r.times) if in_window(out, t)]


def decode_positions(out: dict) -> List[int]:
    """Query positions of the decode steps behind the window's tokens."""
    return [r.fused_len + j - 1 for r, j in window_tokens(out) if j >= 1]


def window_prefills(out: dict) -> List[int]:
    """Fused prompt lengths of the requests whose first token came in the window."""
    return [r.fused_len for r in out["records"] if r.times and in_window(out, r.times[0])]


def due_in_window(out: dict) -> list:
    """Open loop: the requests due in the window."""
    w0, w1 = out["w0"], out["w1"]
    return [r for r in out["records"] if w0 <= r.due < w1]


def ttft_s(r, give_up: float) -> float:
    """From due to first token; a request that failed is missing, and reads
    as the time from its due to ``give_up`` (when the run stopped waiting)."""
    if r.ok and r.times:
        return r.times[0] - r.due
    return give_up - r.due
