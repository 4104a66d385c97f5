"""Time the quantized matmuls at LLaVA-1.5-7B's decode shapes: the port's
counterpart of ``tools/bench_int4.py``.

Prints, one line per shape, ms and GB/s of resident quantized bytes for the
int4 and int8 kernels and for two library baselines (measured, never used
by the port): ``int4-library`` dequantizes the int4 weight to x's dtype and
calls ``torch.matmul``; ``int8-library`` is ``(x @ q.bf16) * scale``. Each
kernel is checked once against its plain version (both against an f64
truth) before it is timed; a miss exits non-zero. Times are CUDA events
over 100 back-to-back calls after 3 warm-up calls, on the same weights.

Usage: python -m llava_plus_torch.tools.bench_int4 [--rows 16] [--device cuda]
       [--shape KxN ...]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from llava_plus_torch.ops import quant
from llava_plus_torch.ops import quant_matmul as qm
from llava_plus_torch.tools import common
from llava_plus_torch.tools.bench_int4_variants import ITERS, WARMUP, int4_bytes, int8_bytes

# LLaVA-1.5-7B's q/o, gate/up and down projections (the JAX tool's shapes)
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))


def run_shape(K: int, N: int, R: int, device: str, rng) -> dict:
    """Check the two kernels, then time them and the two library baselines."""
    w, x = common.inputs(K, N, R, device, rng)
    q8 = quant.quantize_array(w)
    q4 = quant.quantize_array_int4(w)
    del w
    a4 = (q4[quant.Q4KEY], q4[quant.SKEY])
    a8 = (q8[quant.QKEY], q8[quant.SKEY])
    err4 = common.check(f"int4-kernel [{K}x{N}] R={R}", qm.matmul_int4,
                        qm.matmul_int4_reference, x, *a4)
    err8 = common.check(f"int8-kernel [{K}x{N}] R={R}", qm.matmul_int8,
                        qm.matmul_int8_reference, x, *a8)
    scale8 = q8[quant.SKEY].reshape(-1).to(x.dtype)
    calls = {
        "int4-kernel": lambda: qm.matmul_int4(x, *a4),
        "int4-library": lambda: x @ quant.dequantize_array(q4, x.dtype),
        "int8-kernel": lambda: qm.matmul_int8(x, *a8),
        "int8-library": lambda: (x @ q8[quant.QKEY].to(x.dtype)) * scale8,
    }
    out = {name: {"ms": common.time_ms(fn, device, ITERS, WARMUP)} for name, fn in calls.items()}
    out["int4-kernel"]["rel_err"], out["int8-kernel"]["rel_err"] = err4, err8
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=16)
    p.add_argument("--device", default="cuda")
    p.add_argument("--shape", action="append", type=common.parse_shape,
                   help="KxN (repeatable); default: the JAX tool's three 7B shapes")
    args = p.parse_args(argv)
    print(common.describe_device(args.device), flush=True)
    rng = np.random.default_rng(0)
    R = args.rows
    for K, N in args.shape or SHAPES:
        try:
            t = run_shape(K, N, R, args.device, rng)
        except common.Disagrees as e:
            print(f"[{K}x{N}] R={R}: FAIL {e}", flush=True)
            return 1
        b4, b8 = int4_bytes(K, N), int8_bytes(K, N)
        cols = [f"{name} {t[name]['ms']:.4f}ms ({nbytes / t[name]['ms'] / 1e6:.0f} GB/s)"
                for name, nbytes in (("int4-kernel", b4), ("int4-library", b4),
                                     ("int8-kernel", b8), ("int8-library", b8))]
        print(f"[{K}x{N}] R={R}: " + " | ".join(cols), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
