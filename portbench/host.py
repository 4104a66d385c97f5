"""What the host gave the run: read so that a slow run can be told from a
slow program. Nothing here changes the run.

- ``speed_ms``: a fixed piece of pure-Python work, timed once at the
  process's start (before the program loads);
- over the measured window: the share of the machine's CPU time that the
  hypervisor gave to others (``steal`` in ``/proc/stat``), the share that was
  busy, and this process's CPU seconds a second of window (how many cores
  the run kept busy).
"""

from __future__ import annotations

import os
import time
from typing import Optional


def speed_ms(n: int = 200_000) -> float:
    t = time.perf_counter()
    acc = 0
    for i in range(n):
        acc = (acc + i * i) % 1_000_003
    return 1e3 * (time.perf_counter() - t)


def _cpu_ticks() -> Optional[list]:
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None


class Probe:
    """The host's state from construction to :meth:`close`."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.p0 = sum(os.times()[:2])
        self.k0 = _cpu_ticks()
        self.t1 = self.p1 = self.k1 = None

    def close(self):
        self.t1 = time.perf_counter()
        self.p1 = sum(os.times()[:2])
        self.k1 = _cpu_ticks()

    def summary(self) -> dict:
        out = {"process_cores": (self.p1 - self.p0) / (self.t1 - self.t0)}
        if self.k0 and self.k1:
            d = [b - a for a, b in zip(self.k0, self.k1)]
            total = sum(d[:8]) or 1   # user nice system idle iowait irq softirq steal
            out["steal_share"] = d[7] / total if len(d) > 7 else None
            out["busy_share"] = 1.0 - (d[3] + d[4]) / total
        return out
