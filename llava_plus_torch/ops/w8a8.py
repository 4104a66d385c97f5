"""W8A8: int8 activations times int8 weights for prefill row counts.

Counterpart of the JAX package's ``_w8a8_matmul``
(``llava_plus_tpu/ops/quant.py:146``), which XLA compiles there: each row
of x is quantized to int8 by its own absmax, the int8 x int8 product sums
exactly in int32 (twice the bf16 tensor-core rate on the H100), and the
row and column scales turn the sums back into x's dtype. Three steps:

- :func:`w8a8_quantize_rows`: one pass over x, the int8 rows and each
  row's dequantizing scale (the CUDA kernel ``csrc/w8a8.cu``);
- :func:`w8a8_int_mm`: the int32 product, ``torch._int_mm`` (cuBLASLt
  IMMA) on the card, as the JAX package leaves the product to XLA's
  ``dot_general``;
- :func:`w8a8_epilogue`: ``(acc * row_scale) * col_scale`` in x's dtype
  (the CUDA kernel ``csrc/w8a8.cu``).

The arithmetic is the JAX function's as JAX runs it op by op: the row's
absmax in x's dtype floored at 1e-6 in that dtype, the quantizing inverse
``127 / f32(amax)`` in f32, and the dequantizing row scale ``amax / 127``
in x's dtype, so a bf16 row's scale is rounded to bf16. (Compiled by XLA,
the JAX engine's program computes that scale as ``f32(amax) * f32(1/127)``
without the bf16 rounding: a last-bit difference in a few outputs.)

Each step has its plain PyTorch version beside it; a wrapper takes it for
CPU tensors, launches its kernel for CUDA tensors (raising for what the
kernel does not take) and raises for any other device. The plain int32
product is an f64 product, exact because |acc| <= 127^2 * K < 2^53.
Launches count in ``<wrapper>.launches``.

:func:`matmul_w8a8` carries a gradient to x: the weight-only product's
``dx = dy @ dequant(w)^T`` (``ops/quant_matmul.py``). The JAX function
differentiates through the round and the int8 cast, whose derivative is 0,
so its gradient reaches x only through each row's absmax: a fault the port
does not copy. Backward calls count in ``matmul_w8a8.backward_calls``.
"""

from __future__ import annotations

from typing import Optional

import torch

from llava_plus_torch.kernels import build
from llava_plus_torch.ops.quant_matmul import dequantize
from llava_plus_torch.parallel import tp

AMAX_FLOOR = 1e-6
QMAX = 127.0
# the kernel holds a row in shared memory
MAX_ROW_BYTES = 227 * 1024


def _no_path(name, t):
    return ValueError(f"{name}: no path for device {t.device}")


def _full(t, value):
    """A tensor of ``value`` like ``t``: dividing by a tensor keeps a true
    division (a Python-scalar divisor may become a multiply by its
    reciprocal)."""
    return torch.full_like(t, value)


def quantize_rows_reference(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Plain version of :func:`w8a8_quantize_rows`: ``(int8 [R, K], f32
    [R])``."""
    if amax is None:
        amax = x.abs().amax(dim=-1, keepdim=True)
    else:
        amax = amax.reshape(-1, 1).to(x.dtype)
    amax = torch.maximum(amax, _full(amax, AMAX_FLOOR))           # in x's dtype
    af = amax.float()
    inv = _full(af, QMAX) / af
    xq = torch.clamp(torch.round(x.float() * inv), -QMAX, QMAX).to(torch.int8)
    scale = (amax / _full(amax, QMAX)).float()                    # rounded in x's dtype
    return xq, scale.reshape(-1)


def _check_rows(x):
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w8a8_quantize_rows takes a bf16 or f32 [R, K] x, got {x.dtype} "
                        f"{tuple(x.shape)}")
    R, K = x.shape
    elem = x.element_size()
    if R < 1 or x.stride(1) != 1 or (K * elem) % 16 or (x.stride(0) * elem) % 16:
        raise ValueError("w8a8_quantize_rows needs contiguous rows of a multiple of 16 bytes, "
                         f"16-byte aligned, got K={K} strides {x.stride()}")
    if x.data_ptr() % 16 or K * elem > MAX_ROW_BYTES or x.stride(0) >= 2 ** 31:
        raise ValueError(f"w8a8_quantize_rows: x must be 16-byte aligned, a row at most "
                         f"{MAX_ROW_BYTES} bytes and the row stride 32-bit")


def w8a8_quantize_rows(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """x [R, K] (bf16 or f32) -> (xq int8 [R, K], row scale f32 [R]): the
    CUDA kernel for a CUDA x, the plain version for a CPU one. ``amax`` [R]
    in x's dtype, when given, is each row's absmax (a row-parallel
    product's maximum over every rank's slice of K): the kernel then skips
    its reduction."""
    if x.device.type == "cpu":
        return quantize_rows_reference(x, amax)
    if not x.is_cuda:
        raise _no_path("w8a8_quantize_rows", x)
    _check_rows(x)
    R, K = x.shape
    if amax is not None and (amax.dtype != x.dtype or amax.numel() != R
                             or not amax.is_contiguous() or amax.device != x.device):
        raise ValueError(f"w8a8_quantize_rows: amax must be a contiguous [{R}] {x.dtype} "
                         f"tensor on {x.device}")
    xq = torch.empty((R, K), dtype=torch.int8, device=x.device)
    scale = torch.empty(R, dtype=torch.float32, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    build.check(build.lib().w8a8_quantize_rows(
        x.data_ptr(), int(x.dtype == torch.bfloat16), R, K, x.stride(0), xq.data_ptr(),
        scale.data_ptr(), None if amax is None else amax.data_ptr(), stream),
        "w8a8_quantize_rows")
    build.count_launch(w8a8_quantize_rows)
    return xq, scale


def int_mm_reference(xq: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 [R, K] and int8 [K, N], summed in f64."""
    return (xq.to(torch.float64) @ qw.to(torch.float64)).to(torch.int32)


def w8a8_int_mm(xq: torch.Tensor, qw: torch.Tensor,
                qw_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 [R, K] @ int8 [K, N] -> int32 [R, N]: ``torch._int_mm`` on the
    card (R > 16, K and N multiples of 8), the plain product on the CPU.
    ``qw_t`` is the weight's K-major copy (int8 [N, K] contiguous), which
    the card's IMMA kernels read about six times faster than the row-major
    [K, N] (0.118 against 0.676 ms at R = 768, K = 4096, N = 12288 on the
    H100, PERF.md)."""
    if xq.device.type == "cpu":
        return int_mm_reference(xq, qw)
    if not xq.is_cuda:
        raise _no_path("w8a8_int_mm", xq)
    R, K = xq.shape
    N = qw.shape[1]
    if R <= 16 or K % 8 or N % 8:
        raise ValueError(f"w8a8_int_mm needs R > 16 and K, N multiples of 8, got R={R} K={K} "
                         f"N={N}")
    if qw_t is not None and tuple(qw_t.shape) != (N, K):
        raise ValueError(f"w8a8_int_mm: the K-major copy must be [{N}, {K}], got "
                         f"{tuple(qw_t.shape)}")
    out = torch._int_mm(xq, qw if qw_t is None else qw_t.t())
    build.count_launch(w8a8_int_mm)
    return out


def epilogue_reference(acc, row_scale, col_scale, out_dtype) -> torch.Tensor:
    """Plain version of :func:`w8a8_epilogue`."""
    return ((acc.float() * row_scale.reshape(-1, 1)) * col_scale.reshape(1, -1)).to(out_dtype)


def w8a8_epilogue(acc: torch.Tensor, row_scale: torch.Tensor, col_scale: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """int32 acc [R, N], f32 row scale [R] and column scale [N] (or [1, N])
    -> ``(f32(acc) * row_scale) * col_scale`` as ``out_dtype`` (bf16 or
    f32)."""
    if acc.device.type == "cpu":
        return epilogue_reference(acc, row_scale, col_scale, out_dtype)
    if not acc.is_cuda:
        raise _no_path("w8a8_epilogue", acc)
    R, N = acc.shape
    cs = col_scale.reshape(-1)
    if (acc.dtype != torch.int32 or not acc.is_contiguous() or N % 8
            or row_scale.dtype != torch.float32 or row_scale.numel() != R
            or not row_scale.is_contiguous() or cs.dtype != torch.float32 or cs.numel() != N
            or not cs.is_contiguous()):
        raise ValueError("w8a8_epilogue takes a contiguous int32 [R, N] (N % 8 == 0) and "
                         "contiguous f32 scales [R] and [N]")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w8a8_epilogue writes bf16 or f32, not {out_dtype}")
    for name, t in (("acc", acc), ("row_scale", row_scale), ("col_scale", cs)):
        if t.device != acc.device or t.data_ptr() % 16:
            raise ValueError(f"w8a8_epilogue: {name} must be 16-byte aligned on {acc.device}")
    out = torch.empty((R, N), dtype=out_dtype, device=acc.device)
    stream = torch._C._cuda_getCurrentRawStream(acc.get_device())
    build.check(build.lib().w8a8_epilogue(
        acc.data_ptr(), row_scale.data_ptr(), cs.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.float32), R, N, build.sm_count(acc.device), stream),
        "w8a8_epilogue")
    build.count_launch(w8a8_epilogue)
    return out


def w8a8_product(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype, qw_t: Optional[torch.Tensor] = None,
                 row_parallel: bool = False) -> torch.Tensor:
    """x [R, K] @ int8 qw [K, N] through int8 activations: quantize, the
    int32 product, the epilogue. ``row_parallel``: x and qw hold this rank's
    slice of K of a product split over the active tensor-parallel group;
    each row is quantized by its absmax over the whole K (the ranks'
    maximum) and the int32 sums are added over the group before the
    epilogue, as GSPMD partitions the JAX function, so the result is the
    whole product's bit for bit."""
    if not row_parallel or tp.tp_size() == 1:
        xq, row_scale = w8a8_quantize_rows(x)
        return w8a8_epilogue(w8a8_int_mm(xq, qw, qw_t), row_scale, scale, out_dtype)
    amax = tp.reduce_max(x.abs().amax(dim=-1))
    xq, row_scale = w8a8_quantize_rows(x, amax)
    acc = tp.reduce_partial(w8a8_int_mm(xq, qw, qw_t))
    return w8a8_epilogue(acc, row_scale, scale, out_dtype)


class _W8A8Matmul(torch.autograd.Function):
    """:func:`w8a8_product` forward; the weight-only product's backward,
    ``dx = dy @ dequant(w)^T`` in x's dtype."""

    @staticmethod
    def forward(ctx, x, qw, scale, out_dtype, qw_t):
        ctx.save_for_backward(qw, scale)
        ctx.x_dtype = x.dtype
        return w8a8_product(x, qw, scale, out_dtype, qw_t)

    @staticmethod
    def backward(ctx, dy):
        qw, scale = ctx.saved_tensors
        build.count_launch(matmul_w8a8, "backward_calls")
        dx = dy.to(ctx.x_dtype) @ dequantize(8, qw, scale, ctx.x_dtype).T
        return dx, None, None, None, None


def matmul_w8a8(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None,
                qw_t: Optional[torch.Tensor] = None,
                row_parallel: bool = False) -> torch.Tensor:
    """x [R, K] @ int8 qw [K, N] times scale [1, N] with x quantized by row,
    -> [R, N] in ``out_dtype`` (x's dtype by default), with a gradient to x;
    ``qw_t`` the weight's K-major copy, if it has one; ``row_parallel`` as
    :func:`w8a8_product` (serving only: no gradient)."""
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and x.requires_grad:
        if row_parallel and tp.tp_size() > 1:
            raise NotImplementedError("a row-parallel W8A8 product has no backward")
        return _W8A8Matmul.apply(x, qw, scale, out_dtype, qw_t)
    return w8a8_product(x, qw, scale, out_dtype, qw_t, row_parallel)


for _wrapper in (w8a8_quantize_rows, w8a8_int_mm, w8a8_epilogue):
    _wrapper.launches = 0
matmul_w8a8.backward_calls = 0
