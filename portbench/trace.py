"""Reduction of a ``torch.profiler`` trace of the measured window.

Device intervals are the trace's CUDA events (kernels, copies, sets). From
them: the busy time (the union of the intervals), device seconds by kernel
name and by the classes of ``portbench/kernels.json`` (first substring that
matches; ``other`` where none does), and the idle gaps between busy
stretches, each named by the innermost host operation running at its middle
(``host: no profiled op`` where none was: Python work of the program).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
TOP = 10          # entries of each breakdown list
GAPS_NAMED = 400  # longest gaps that get a host name


def kernel_classes(root: Path = HERE) -> List[Tuple[str, str]]:
    return [tuple(p) for p in json.loads((root / "kernels.json").read_text())]


def classify(name: str, table) -> str:
    for sub, cls in table:
        if sub in name:
            return cls
    return "other"


def _events(prof):
    """(device [(start_ns, end_ns, name)], host (start, end, name index, names))."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, hs, he, hn, names, index = [], [], [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == cuda:
            dev.append((start, end, name))
        elif end > start:
            i = index.get(name)
            if i is None:
                i = index[name] = len(names)
                names.append(name)
            hs.append(start)
            he.append(end)
            hn.append(i)
    host = (np.asarray(hs, np.int64), np.asarray(he, np.int64), np.asarray(hn, np.int64), names)
    return dev, host


def union(intervals) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce_events(dev, host, window_s: float, table) -> Dict[str, object]:
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    by_class: Dict[str, float] = {}
    for n, sec in by_name.items():
        c = classify(n, table)
        by_class[c] = by_class.get(c, 0.0) + sec
    busy = union((s, e) for s, e, _ in dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)
    hs, he, hn, names = host
    named: Dict[str, float] = {}
    for length, s, e in gaps[:GAPS_NAMED]:
        mid = (s + e) // 2
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        if inside.size:
            inner = inside[np.argmin(he[inside] - hs[inside])]
            label = "host: " + names[hn[inner]]
        else:
            label = "host: no profiled op"
        named[label] = named.get(label, 0.0) + length * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "kernel_s": sum(by_name.values()),
        "by_class": by_class,
        "by_name": by_name,
        "device_ops": [[n[:120], s] for n, s in top],
        "idle_gaps": [[n[:120], s] for n, s in sorted(named.items(), key=lambda kv: -kv[1])[:TOP]],
        "gaps_named": min(len(gaps), GAPS_NAMED),
        "gaps": len(gaps),
    }


def reduce(prof, window_s: float, root: Path = HERE) -> Dict[str, object]:
    dev, host = _events(prof)
    return reduce_events(dev, host, window_s, kernel_classes(root))


def kernel_seconds(trace: dict, substring: str) -> float:
    """Device seconds of the kernels whose name holds ``substring``."""
    return sum(s for n, s in trace["by_name"].items() if substring in n)
