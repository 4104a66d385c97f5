"""Weight-only int8 / int4 matmuls: the CUDA kernels ``csrc/quant_matmul.cu``
and their plain PyTorch versions.

Counterpart of ``llava_plus_tpu/ops/quant_matmul.py`` (the Pallas kernels
they replace are ``_int8_kernel`` and ``_int4_kernel``). Layouts are the JAX
package's (K = contraction dim, N = output dim):

- int8: ``qw [K, N] int8`` with a per-output-channel scale ``[1, N]`` f32,
  which the kernel applies in its epilogue (the Pallas kernel left it to
  the caller);
- int4: ``qw [K/2, N] int8``, two nibbles per byte in split-half block
  order (within each 32-row block the low nibbles hold rows 0..15 and the
  high nibbles rows 16..31), with per-block scales ``[K/32, N]`` f32.

Both return ``x @ dequant(w)`` as [R, N] in ``out_dtype`` (x's dtype by
default; f32 for the lm_head's logits). The kernels run for CUDA tensors
(bf16 x, K % 128 == 0, N % 64 == 0) at every row count; the plain versions
for CPU tensors; anything else raises.

Both products carry a gradient to x (QLoRA trains adapters under a frozen
quantized base): a ``torch.autograd.Function`` whose backward is ``dx = dy
@ dequant(w)^T``, one matrix dequantized to x's dtype per call, then a
library product, as the JAX package leaves that product to XLA's autodiff
outside any Pallas kernel. The kernel fills a fresh buffer through a raw
pointer, so without the Function its output would have no ``grad_fn`` and
every adapter below the top layer would lose its gradient silently. The
weight takes no gradient. Backward calls count in ``<wrapper>.backward_calls``.
"""

from __future__ import annotations

from typing import Optional

import torch

from llava_plus_torch.kernels import build

INT4_BLOCK = 32
K_TILE = 128   # the kernel's K tile
N_TILE = 64    # N must be a multiple of this (both tile shapes divide it)


def _acc_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 [..., K/2, N] -> int8 [..., K/32, 32, N], nibbles sign-extended
    (split-half order: low nibbles are rows 0..15 of each block)."""
    *lead, half_in, n = packed.shape
    nb = half_in * 2 // INT4_BLOCK
    p = packed.reshape(*lead, nb, INT4_BLOCK // 2, n).to(torch.int32)
    lo = (p << 28) >> 28
    hi = p >> 4
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def dequantize(bits: int, qw, scale, dtype) -> torch.Tensor:
    """The [K, N] weight, values times scales in f32 (f64 for f64), cast to
    ``dtype``."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    if bits == 8:
        return (qw.to(acc) * scale.reshape(1, -1).to(acc)).to(dtype)
    q = unpack_int4(qw).to(acc)                              # [K/32, 32, N]
    return (q * scale.to(acc)[:, None, :]).reshape(-1, q.shape[-1]).to(dtype)


def matmul_int8_reference(x, qw, scale, *, out_dtype=None) -> torch.Tensor:
    """``x @ dequant(qw)`` in plain PyTorch, the weight dequantized to x's
    dtype (products in f32, or f64 for f64 inputs) and multiplied in it."""
    return (x @ dequantize(8, qw, scale, x.dtype)).to(out_dtype or x.dtype)


def matmul_int4_reference(x, qw, scale, *, out_dtype=None) -> torch.Tensor:
    """``x @ dequant(qw)`` for split-half packed int4 in plain PyTorch."""
    return (x @ dequantize(4, qw, scale, x.dtype)).to(out_dtype or x.dtype)


def _check_kernel_inputs(x, qw, scale, bits, out_dtype):
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise TypeError(f"quant matmul kernel takes a bf16 [R, K] x, got {x.dtype} {tuple(x.shape)}")
    R, K = x.shape
    if qw.dtype != torch.int8 or qw.dim() != 2 or not qw.is_contiguous():
        raise TypeError("quant matmul kernel takes a contiguous int8 [K(/2), N] weight")
    N = qw.shape[1]
    if qw.shape[0] != (K if bits == 8 else K // 2):
        raise ValueError(f"weight {tuple(qw.shape)} does not fit x {tuple(x.shape)} ({bits}-bit)")
    if K % K_TILE or N % N_TILE or R < 1:
        raise ValueError(f"quant matmul kernel needs K % {K_TILE} == 0 and N % {N_TILE} == 0, "
                         f"got R={R} K={K} N={N}")
    want = [1, N] if bits == 8 else [K // INT4_BLOCK, N]
    fits = scale.numel() == N if bits == 8 else list(scale.shape) == want
    if scale.dtype != torch.float32 or not scale.is_contiguous() or not fits:
        raise ValueError(f"scale must be a contiguous f32 {want}, got {tuple(scale.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quant matmul kernel writes bf16 or f32, not {out_dtype}")
    for name, t in (("x", x), ("qw", qw), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x.stride(1) != 1 or x.stride(0) % 8:
        raise ValueError("x: last dim must be contiguous, rows 16-byte aligned")
    if max(R * x.stride(0), K * N, R * N) >= 2 ** 31:
        raise ValueError("quant matmul kernel takes 32-bit row offsets")


def _launch(bits, x, qw, scale, out_dtype):
    _check_kernel_inputs(x, qw, scale, bits, out_dtype)
    R, K = x.shape
    N = qw.shape[1]
    out = torch.empty(R, N, dtype=out_dtype, device=x.device)
    fn = build.lib().quant_matmul_int8 if bits == 8 else build.lib().quant_matmul_int4
    err = fn(x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
             R, K, N, x.stride(0), int(out_dtype == torch.float32),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"quant_matmul_int{bits}")
    return out


def _product(bits, x, qw, scale, out_dtype):
    """The kernel on the card, its plain version on the CPU."""
    wrapper = matmul_int8 if bits == 8 else matmul_int4
    if x.is_cuda:
        out = _launch(bits, x, qw, scale, out_dtype)
        build.count_launch(wrapper)
        return out
    if x.device.type == "cpu":
        plain = matmul_int8_reference if bits == 8 else matmul_int4_reference
        return plain(x, qw, scale, out_dtype=out_dtype)
    raise ValueError(f"{wrapper.__name__}: no path for device {x.device}")


class _QuantMatmul(torch.autograd.Function):
    """:func:`_product` forward; ``dx = dy @ dequant(w)^T`` backward, the
    cotangent rounded to x's dtype first (as JAX's dot transpose casts it
    back at this boundary)."""

    @staticmethod
    def forward(ctx, x, qw, scale, bits, out_dtype):
        ctx.save_for_backward(qw, scale)
        ctx.bits, ctx.x_dtype = bits, x.dtype
        return _product(bits, x, qw, scale, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        qw, scale = ctx.saved_tensors
        build.count_launch(matmul_int8 if ctx.bits == 8 else matmul_int4, "backward_calls")
        dx = dy.to(ctx.x_dtype) @ dequantize(ctx.bits, qw, scale, ctx.x_dtype).T
        return dx, None, None, None, None


def _matmul(bits, x, qw, scale, out_dtype):
    # the Function only where a gradient is asked for: serving skips its
    # bookkeeping on every projection
    if torch.is_grad_enabled() and x.requires_grad:
        return _QuantMatmul.apply(x, qw, scale, bits, out_dtype)
    return _product(bits, x, qw, scale, out_dtype)


def matmul_int8(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [R, K] @ int8 qw [K, N] times scale [1, N] -> [R, N], with a
    gradient to x."""
    return _matmul(8, x, qw, scale, out_dtype or x.dtype)


def matmul_int4(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [R, K] @ packed int4 qw [K/2, N] with block scales [K/32, N] -> [R, N],
    with a gradient to x."""
    return _matmul(4, x, qw, scale, out_dtype or x.dtype)


for _wrapper in (matmul_int8, matmul_int4):
    _wrapper.launches = 0
    _wrapper.backward_calls = 0
