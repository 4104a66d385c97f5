"""Compare the int4 weight-only matmul variants on the card: the port's
counterpart of ``tools/bench_int4_variants.py``.

- V0: split-half packed int4 (``matmul_int4``, the serving path's kernel);
- V3: native int4 storage, ``[K, N/2]`` column pairs in a byte
  (``matmul_int4_native``, the counterpart of the JAX tool's
  ``_int4n_kernel``; it runs over all of K, where the Pallas variant drops
  the last ``K % 4096`` rows);
- int8: the int8 kernel, the time to beat (int4 halves the weight bytes).

Each variant is checked once against its plain version (both against an
f64 truth) before it is timed; a miss exits non-zero. Times are CUDA
events over 100 back-to-back calls after 3 warm-up calls, on the same
weights (warm in L2 where they fit its 50 MB); GB/s counts the resident
weight bytes, as the JAX tool does. One line per shape.

Usage: python -m llava_plus_torch.tools.bench_int4_variants [--rows 16]
       [--device cuda] [--shape KxN ...]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from llava_plus_torch.ops import quant
from llava_plus_torch.ops import quant_matmul as qm
from llava_plus_torch.ops.quant_matmul import matmul_int4_native  # noqa: F401  (the JAX tool's name)
from llava_plus_torch.tools import common

# the JAX tool's shapes: LLaVA-1.5-7B's q/o, gate/up and down projections,
# then LLaVA-1.5-13B's gate/up and down
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (5120, 13824), (13824, 5120))
WARMUP = 3
ITERS = 100


def int4_bytes(K: int, N: int) -> int:
    return K * N // 2 + (K // 32) * N * 4


def int8_bytes(K: int, N: int) -> int:
    return K * N + N * 4


def run_shape(K: int, N: int, R: int, device: str, rng) -> dict:
    """Check and time V0, V3 and int8 at one shape; ms and relative error each."""
    w, x = common.inputs(K, N, R, device, rng)
    q8 = quant.quantize_array(w)
    q4 = quant.quantize_array_int4(w)
    q4n, s4n = quant.quantize_array_int4_native(w)
    del w
    variants = {
        "V0-packed": (qm.matmul_int4, qm.matmul_int4_reference, (q4[quant.Q4KEY], q4[quant.SKEY])),
        "V3-native": (qm.matmul_int4_native, qm.matmul_int4_native_reference, (q4n, s4n)),
        "int8": (qm.matmul_int8, qm.matmul_int8_reference, (q8[quant.QKEY], q8[quant.SKEY])),
    }
    out = {}
    for name, (kernel, plain, args) in variants.items():
        err = common.check(f"{name} [{K}x{N}] R={R}", kernel, plain, x, *args)
        ms = common.time_ms(lambda: kernel(x, *args), device, ITERS, WARMUP)
        out[name] = {"ms": ms, "rel_err": err}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=16)
    p.add_argument("--device", default="cuda")
    p.add_argument("--shape", action="append", type=common.parse_shape,
                   help="KxN (repeatable); default: the JAX tool's five shapes")
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
        cols = [f"{name} {t[name]['ms'] * 1e3:.1f}us ({nbytes / t[name]['ms'] / 1e6:.0f} GB/s, "
                f"err {t[name]['rel_err']:.1e})"
                for name, nbytes in (("V0-packed", b4), ("V3-native", b4), ("int8", b8))]
        print(f"[{K}x{N}] R={R}: " + " | ".join(cols), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
