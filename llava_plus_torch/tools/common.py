"""What the port's measurement tools share: the device line, seeded inputs,
the check of a kernel against its plain version, and CUDA-event timing.

A kernel passes when its error against an f64 truth, relative to the
largest output, is at most ``max(2.5 * plain error, 2e-3)``: the criterion
``chip_smoke.py`` holds every kernel to."""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


class Disagrees(RuntimeError):
    """A kernel's output is further from the f64 truth than its plain
    version allows."""


def describe_device(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or a
    note that the plain versions run on the host."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"{dev.type}: the kernels' plain versions, host clock"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def inputs(K: int, N: int, R: int, device: str, rng: np.random.Generator):
    """An f32 weight [K, N] of scale 0.02 and a bf16 x [R, K], from ``rng``."""
    w = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32) * 0.02).to(device)
    x = torch.from_numpy(rng.standard_normal((R, K), dtype=np.float32)).to(device)
    return w, x.bfloat16()


def parse_shape(text: str):
    K, N = (int(v) for v in text.lower().split("x"))
    return K, N


def check(name: str, kernel, plain, x: torch.Tensor, *args, **kwargs) -> float:
    """Run ``kernel`` and ``plain`` once on the same inputs, measure both
    against ``plain`` in f64, and raise :class:`Disagrees` on a miss.
    Returns the kernel's relative error."""
    out = kernel(x, *args, **kwargs)
    p_out = plain(x, *args, **kwargs)
    truth = plain(x.double(), *args, **kwargs)
    top = truth.abs().max().item()
    k_err = (out.double() - truth).abs().max().item() / top
    r_err = (p_out.double() - truth).abs().max().item() / top
    if out.shape != truth.shape or not k_err <= max(2.5 * r_err, 2e-3):
        raise Disagrees(f"{name}: shape {tuple(out.shape)}, rel err {k_err:.3e} "
                        f"(plain {r_err:.3e})")
    return k_err


def time_ms(fn, device: str, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms over ``iters`` back-to-back calls after
    ``warmup``: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
