"""Shares of the traced window that several metric readers take, each over
its own cells (``portbench/metrics``). A share with nothing to read is None."""

from __future__ import annotations

from types import SimpleNamespace

from portbench import counts, measure
from portbench import trace as trace_mod

NOT_ELEMENTWISE = ("gemm", "quant_gemm", "attention")


def elementwise_share(run):
    """% of the kernels' device time in kernels that are neither a GEMM
    (cuBLAS or the port's quantized products) nor attention."""
    t = run.out["trace"]
    if not t or not t["kernel_s"]:
        return None
    rest = sum(s for c, s in t["by_class"].items() if c not in NOT_ELEMENTWISE)
    return 100.0 * rest / t["kernel_s"]


def idle_share(run):
    """% of the measured window in which the device ran nothing: 1 - the
    device seconds a model FLOP took in the profiled window (the union of
    its device intervals over its work) x the measured window's FLOPs a
    second. The profiler slows the host, not the device, so the profiled
    window's own busy share would read a host-paced cell too idle."""
    t = run.out["trace"]
    flops = serve_flops(run)
    if not t or not t["busy_s"] or not flops:
        return None
    measured = run.out["measured"]
    rate = serve_flops(SimpleNamespace(out=measured, cfg=run.cfg)) / measured["window_s"]
    return 100.0 * (1.0 - t["busy_s"] / flops * rate)


def serve_flops(run) -> float:
    """Model FLOPs of the window's prefills and decode-made tokens."""
    cfg = run.cfg
    return (sum(counts.prefill_flops(cfg, n) for n in measure.window_prefills(run.out))
            + sum(counts.decode_token_flops(cfg, p) for p in measure.decode_positions(run.out)))


def mfu_over_window(run):
    flops = serve_flops(run)
    return 100.0 * flops / (run.out["window_s"] * run.peak["bf16_flops"]) if flops else None


def mfu_over_busy(run):
    t = run.out["trace"]
    if not t or not t["busy_s"]:
        return None
    flops = serve_flops(run)
    return 100.0 * flops / (t["busy_s"] * run.peak["bf16_flops"]) if flops else None


def kernel_s(run, *substrings) -> float:
    t = run.out["trace"]
    if not t:
        return 0.0
    return sum(trace_mod.kernel_seconds(t, s) for s in substrings)
