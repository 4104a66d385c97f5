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
(bf16 x, K % 128 == 0, N % 64 == 0) at every row count, each layout through
one of two kernels by row count (:func:`int8_plan`, :func:`int4_plan`: a
weight stream at decode rows, wgmma at prefill and training rows); the plain
versions for CPU tensors; anything else raises.

Both products carry a gradient to x (QLoRA trains adapters under a frozen
quantized base): a ``torch.autograd.Function`` whose backward is ``dx = dy
@ dequant(w)^T``, one matrix dequantized to x's dtype per call, then a
library product, as the JAX package leaves that product to XLA's autodiff
outside any Pallas kernel. The kernel fills a fresh buffer through a raw
pointer, so without the Function its output would have no ``grad_fn`` and
every adapter below the top layer would lose its gradient silently. The
weight takes no gradient. Backward calls count in ``<wrapper>.backward_calls``.

A third layout, native int4 (:func:`matmul_int4_native`), is the int4
measurement tools' variant (Pallas ``_int4n_kernel`` in
``tools/bench_int4_variants.py``): ``qw4n [K, N/2] uint8``, element (k, n)
in byte (k, n // 2), the low nibble for even n and the high one for odd n,
two's complement in [-8, 7], with the int4 block scales ``[K/32, N]``. It
is forward only and always writes f32, as the Pallas kernel does. On the
card it runs split-half int4's two kernels on its own bytes, as stored
(:func:`int4n_plan`; only where a warp's weight registers come from
differs).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from llava_plus_torch.kernels import build

INT4_BLOCK = 32
K_TILE = 128   # K must be a multiple of this (every kernel's k tile divides it)
N_TILE = 64    # N must be a multiple of this

# the row count at or below which a product streams the weight (decode
# rows: mma.sync with x's rows as n8) rather than running the wgmma kernel
# (prefill and training rows); measured on the H100 (chip_smoke.py phase 3's
# rows on both sides of each, PERF.md)
INT8_CUT = 32
INT4_CUT = 48
INT4N_CUT = 48
STREAM_COLS = 128                 # a decode block's strip
STREAM_K = 64                     # k rows of an int8 decode tile (64 x 128 bytes)
INT4_STREAM_K = 128               # k rows of an int4 decode tile (64 packed rows)
STREAM_MAX_SPLITS = 16            # K chunks of a decode strip, at most
STREAM_MIN_BLOCKS_PER_SM = 1.5    # decode blocks an SM should have, on average
SPLIT_COST = 0.02        # a decode plan's cost grows by this for each chunk past one
WGMMA_COLS, WGMMA_ROWS, WGMMA_K = 256, 128, 64   # a prefill block's tile and k step
MIN_CHUNK_STEPS = 8      # k steps of a prefill K chunk, at least


@functools.lru_cache(maxsize=None)
def _plan(R: int, K: int, N: int, n_sms: int, cut: int, stream_k: int):
    if R > cut:
        tiles = -(-N // WGMMA_COLS) * -(-R // WGMMA_ROWS)
        whole = tiles - tiles % n_sms
        steps = K // WGMMA_K
        want = max(1, min(n_sms // (tiles - whole or n_sms), steps // MIN_CHUNK_STEPS))
        splits = -(-steps // -(-steps // want))   # whole steps a chunk, none empty
        return "wgmma", splits, whole if splits > 1 else tiles
    strips = -(-N // STREAM_COLS)
    tiles = K // stream_k
    best = None
    for want in range(1, min(tiles, STREAM_MAX_SPLITS) + 1):
        splits = -(-tiles // -(-tiles // want))   # whole tiles a chunk, none empty
        blocks = strips * splits
        load = -(-blocks // n_sms) / splits * (1 + SPLIT_COST * (splits - 1))
        key = (blocks < STREAM_MIN_BLOCKS_PER_SM * n_sms, load, splits)
        if best is None or key < best[0]:
            best = (key, splits)
    return "stream", best[1], 0


def int8_plan(R: int, K: int, N: int, n_sms: int):
    """(regime, splits, whole tiles) of an int8 product from static shapes
    alone.

    Decode rows (``"stream"``, R <= INT8_CUT) are bound by the weight stream:
    a block streams a 128-column strip over one of ``splits`` K chunks, and
    the plan takes the chunk count that gives the SMs STREAM_MIN_BLOCKS_PER_SM
    blocks on average, then the least work on the busiest SM (in strips of
    the whole K: ceil(blocks / SMs) / splits, SPLIT_COST more for each chunk
    past one: its parts' round trip through L2, and another front of reads
    in the weight), then the fewest chunks. On the H100 a decode SM streams
    fastest with two or three such blocks (8-12 warps): wqkv at 16 rows
    takes 96 strips in 4 chunks, w_down 32 strips in 8.
    Prefill rows (``"wgmma"``) take 128-row x 256-column output tiles, one
    block an SM: whole waves of tiles run over all of K, and the tiles of a
    last, partial wave (or all of them, where they leave SMs idle) are cut
    into ``splits`` K chunks so that they spread over the SMs, chunks of at
    least MIN_CHUNK_STEPS 64-row steps (wqkv at 768 rows: 264 whole tiles,
    then 24 in 5 chunks). The plan, the grid and the workspace depend on
    shapes alone (a CUDA graph can capture the launch)."""
    return _plan(R, K, N, n_sms, INT8_CUT, STREAM_K)


def int4_plan(R: int, K: int, N: int, n_sms: int):
    """(regime, splits, whole tiles) of an int4 product, as :func:`int8_plan`
    plans an int8 one, with the cut at INT4_CUT rows and decode tiles of 128
    k rows (64 packed rows of 128 bytes, the same bytes as an int8 tile);
    prefill steps are 64 k rows (32 packed rows) as int8's."""
    return _plan(R, K, N, n_sms, INT4_CUT, INT4_STREAM_K)


def int4n_plan(R: int, K: int, N: int, n_sms: int):
    """(regime, splits, whole tiles) of a native-int4 product, as
    :func:`int4_plan` plans a split-half one, with its own cut INT4N_CUT:
    the same decode tiles of 128 k rows (128 rows of 64 bytes, the same 8 KB
    as a split-half tile's 64 packed rows of 128) and the same prefill steps
    of 64 k rows (two boxes of 64 rows x 64 bytes)."""
    return _plan(R, K, N, n_sms, INT4N_CUT, INT4_STREAM_K)


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


# the native int4 layout among the bit sizes that _prepare and _launch take
# (``int{bits}`` names every layout's kernels: int8, int4, int4n)
NATIVE = "4n"


def _columns(bits, qw):
    """N, the output columns of a weight of layout ``bits``."""
    return qw.shape[1] * (2 if bits == NATIVE else 1)


# what a launch needs besides x's and out's addresses, kept per _launch_key:
# the same weight at the same row count on the same stream (every projection
# of a decode step) costs one lookup and the kernel's call
_launches = {}


def _launch_key(bits, x, qw, scale, out_dtype, stream):
    """Everything :func:`_check_kernel_inputs` (or, native,
    :func:`_check_native_kernel_inputs`) and :func:`_prepare` read, but x's
    address (checked on every call)."""
    return (bits, stream, out_dtype, x.get_device(), x.dtype, x.shape, x.stride(),
            qw.get_device(), qw.data_ptr(), qw.dtype, qw.shape, qw.stride(),
            scale.get_device(), scale.data_ptr(), scale.dtype, scale.shape, scale.stride())


def _prepare(bits, x, qw, scale, out_dtype, stream):
    """One of the two kernels of ``bits`` (the plan's regime, K chunks and,
    for the prefill kernel, the output tiles run over all of K), as (entry
    point, its arguments after x and out, the regime's counter, the plan, the
    buffers the arguments point into). K chunks' f32 parts go to a workspace
    and the combine's counters to a zeroed buffer, both kept per device and
    stream (the kernels leave the counters zero); the kernels check their
    sizes."""
    if bits == NATIVE:
        _check_native_kernel_inputs(x, qw, scale)
    else:
        _check_kernel_inputs(x, qw, scale, bits, out_dtype)
    R, K = x.shape
    N = _columns(bits, qw)
    planner = {8: int8_plan, 4: int4_plan, NATIVE: int4n_plan}[bits]
    regime, splits, whole = plan = planner(R, K, N, build.sm_count(x.device))
    ws = counters = None
    if splits > 1:
        if regime == "stream":
            tiles, n_ws = -(-N // STREAM_COLS), splits * R * N
        else:   # only the tiles cut into chunks keep parts
            tiles = -(-N // WGMMA_COLS) * -(-R // WGMMA_ROWS)
            n_ws = (tiles - whole) * splits * WGMMA_ROWS * WGMMA_COLS
        ws = build.scratch("quant_matmul.ws", x.device, stream, n_ws, torch.float32)
        counters = build.scratch("quant_matmul.counters", x.device, stream, tiles, torch.int32,
                                 zeroed=True)
    weight, w_map = qw.data_ptr(), None
    if regime == "stream":
        # the decode kernels read the weight's bytes through a TMA map (a
        # CUtensorMap, 64-byte aligned) made here, once per key: no encode on
        # the decode path
        w_map = ctypes.create_string_buffer(128 + 64)
        weight = -(-ctypes.addressof(w_map) // 64) * 64
        build.check(build.lib().quant_matmul_weight_map(qw.data_ptr(), qw.shape[0], qw.shape[1],
                                                        int(bits == NATIVE), weight),
                    "quant_matmul_weight_map")
    sizes = ((None, 0, None, 0) if ws is None else
             (ws.data_ptr(), min(ws.numel(), 2 ** 31 - 1), counters.data_ptr(),
              counters.numel()))
    rest = (weight, scale.data_ptr(), *sizes, R, K, N, x.stride(0),
            int(out_dtype == torch.float32), splits) + (
            (stream,) if regime == "stream" else (whole, stream))
    name = f"quant_matmul_int{bits}_{regime}"
    counter = "decode_launches" if regime == "stream" else "prefill_launches"
    return getattr(build.lib(), name), name, rest, counter, plan, (ws, counters, w_map)


def _launch(bits, x, qw, scale, out_dtype):
    # the raw stream handle: a torch.cuda.Stream object costs microseconds
    # on a path that launches ~130 times a decode step
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    key = _launch_key(bits, x, qw, scale, out_dtype, stream)
    held = _launches.get(key)
    if held is None:
        held = _launches[key] = _prepare(bits, x, qw, scale, out_dtype, stream)
    elif x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    fn, name, rest, counter, plan, _ = held
    out = x.new_empty((x.shape[0], _columns(bits, qw)), dtype=out_dtype)
    build.check(fn(x.data_ptr(), out.data_ptr(), *rest), name)
    wrapper = {8: matmul_int8, 4: matmul_int4, NATIVE: matmul_int4_native}[bits]
    build.count_launch(wrapper, "launches", counter)
    wrapper.last_plan = plan
    return out


def _product(bits, x, qw, scale, out_dtype):
    """The kernel on the card, its plain version on the CPU."""
    if x.is_cuda:
        return _launch(bits, x, qw, scale, out_dtype)
    if x.device.type == "cpu":
        plain = matmul_int8_reference if bits == 8 else matmul_int4_reference
        return plain(x, qw, scale, out_dtype=out_dtype)
    wrapper = matmul_int8 if bits == 8 else matmul_int4
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


# -- native int4 (the measurement tools' layout) ----------------------------

def pack_int4_native(values: torch.Tensor) -> torch.Tensor:
    """int8 [..., K, N] in [-8, 7] -> uint8 [..., K, N/2]: element (k, n) in
    byte (k, n // 2), the low nibble for even n, the high one for odd n."""
    if values.shape[-1] % 2:
        raise ValueError(f"native int4 packs pairs of columns, got N={values.shape[-1]}")
    v = values.to(torch.int32) & 0x0F
    return (v[..., 0::2] | (v[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4_native(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., K, N/2] -> int8 [..., K, N], nibbles sign-extended."""
    p = packed.to(torch.int32)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).flatten(-2).to(torch.int8)


def dequantize_int4_native(qw4n, scale, dtype) -> torch.Tensor:
    """The [K, N] weight of the native layout, values times block scales in
    f32 (f64 for f64), cast to ``dtype``."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    K = qw4n.shape[0]
    q = unpack_int4_native(qw4n).to(acc).reshape(K // INT4_BLOCK, INT4_BLOCK, -1)
    return (q * scale.to(acc)[:, None, :]).reshape(K, -1).to(dtype)


def matmul_int4_native_reference(x, qw4n, scale) -> torch.Tensor:
    """Plain ``_int4n_kernel``: each value times its block scale in f32,
    rounded to x's dtype, then ``x @ w`` summed in f32 (f64 for f64 inputs),
    over the whole contraction."""
    acc = _acc_dtype(x)
    return x.to(acc) @ dequantize_int4_native(qw4n, scale, x.dtype).to(acc)


def _check_native_layout(x, qw4n, scale):
    """What the native layout needs on any device: x [R, K], uint8 [K, N/2]
    with K % 32 == 0, f32 scales [K/32, N]."""
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"matmul_int4_native takes x [R >= 1, K], got {tuple(x.shape)}")
    K = x.shape[1]
    if qw4n.dtype != torch.uint8 or qw4n.dim() != 2:
        raise TypeError(f"native int4 weight must be uint8 [K, N/2], got {qw4n.dtype} "
                        f"{tuple(qw4n.shape)}")
    if qw4n.shape[0] != K or K % INT4_BLOCK:
        raise ValueError(f"weight {tuple(qw4n.shape)} does not fit x {tuple(x.shape)} "
                         f"(K % {INT4_BLOCK} == 0)")
    want = [K // INT4_BLOCK, 2 * qw4n.shape[1]]
    if scale.dtype != torch.float32 or list(scale.shape) != want:
        raise ValueError(f"scale must be f32 {want}, got {scale.dtype} {tuple(scale.shape)}")


def _check_native_kernel_inputs(x, qw4n, scale):
    """What the native kernels take beyond the layout: a bf16 x with 16-byte
    aligned rows, K % 128 == 0, N % 64 == 0, a contiguous weight and scales
    on x's device, and sizes within the C entry points' 32-bit ints (the
    kernels reach x, the scales, the workspace and out with 64-bit offsets,
    and the weight through TMA maps)."""
    R, K = x.shape
    N = 2 * qw4n.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the native int4 kernel takes a bf16 x, got {x.dtype}")
    if K % K_TILE or N % N_TILE:
        raise ValueError(f"the native int4 kernel needs K % {K_TILE} == 0 and "
                         f"N % {N_TILE} == 0, got K={K} N={N}")
    for name, t in (("x", x), ("qw4n", qw4n), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not (qw4n.is_contiguous() and scale.is_contiguous()):
        raise ValueError("qw4n and scale must be contiguous")
    if x.stride(1) != 1 or x.stride(0) % 8:
        raise ValueError("x: last dim must be contiguous, rows 16-byte aligned")
    if max(R, K, N, x.stride(0)) >= 2 ** 31:
        raise ValueError("the native int4 kernels take 32-bit sizes")


def matmul_int4_native(x: torch.Tensor, qw4n: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [R, K] @ native int4 qw4n [K, N/2] with block scales [K/32, N] ->
    f32 [R, N], over all K (on the card one of the two int4 kernels by
    :func:`int4n_plan`, reading the bytes as stored; its plain version on the
    CPU; any shape the kernels cannot take raises)."""
    _check_native_layout(x, qw4n, scale)
    if x.is_cuda:
        return _launch(NATIVE, x, qw4n, scale, torch.float32)
    if x.device.type == "cpu":
        return matmul_int4_native_reference(x, qw4n, scale)
    raise ValueError(f"matmul_int4_native: no path for device {x.device}")


for _wrapper in (matmul_int8, matmul_int4, matmul_int4_native):
    _wrapper.launches = 0
    # the launches of each regime (also counted in ``launches``)
    _wrapper.decode_launches = _wrapper.prefill_launches = 0
    _wrapper.last_plan = None   # the plan of the latest launch
matmul_int8.backward_calls = matmul_int4.backward_calls = 0
