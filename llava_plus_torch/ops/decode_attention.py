"""Flash-decode attention over the dense KV cache: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

Counterpart of ``llava_plus_tpu/ops/decode_attention.py`` (the Pallas kernel
it replaces is ``_kernel``). A chunk of up to ``MAX_TQ`` query tokens per
sequence, token t at position ``q_pos + t`` (one for a decode step, the
current token and its proposals for a speculative verify step, where the
JAX package runs XLA's ``quant_cache_attention`` chain), attends over the
cache in the model's own layout [B, S, Hkv, D], read in place through
strides: bf16, or int8 with f32 per-(token, kv-head) scales
[B, S, Hkv, 1] folded into the scores (k) and the probabilities (v). Slots
with seg == 0 are masked (finite mask value, as in the JAX kernel); slots
past a token's position take no part at all, so the kernel never reads
them. With ``alibi_slopes`` [H] (MPT) each visible slot's scaled score loses
``slope_h * (q_pos + t - s)``: the bias that the JAX package's MPT decode builds
for XLA (``quant_cache_attention(bias=...)`` over an int8 cache, ``attention``
over a bf16 one); those launches count in ``decode_attention.alibi_launches``.

The kernel runs for CUDA tensors (bf16 q, D = 128, any number of query heads
per kv head: a (batch row, kv head) has G x Tq query rows, and a block holds
up to 64 of them, the whole group of every model in the repo at Tq = 1 and of
MHA and GQA at Tq <= 8); the plain version for CPU tensors; anything else
raises.
It splits each (batch row, kv head)'s cache into :func:`decode_splits`
chunks, one block each, and the last block of a row to finish combines the
chunks' f32 partials (a workspace the wrapper allocates, and a counter per
row in a zeroed int32 buffer kept per device and stream). Launches with
more than 8 query heads per kv head (an MQA MPT), with or without slopes,
count in ``decode_attention.wide_launches`` only; launches of more than one
query token also count in ``decode_attention.chunk_launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from llava_plus_torch.kernels import build
from llava_plus_torch.ops.attention import DEFAULT_MASK_VALUE, check_slopes

HEAD_DIM = 128
WIDE_GROUP = 8      # launches of wider groups count in ``wide_launches``
DECODE_TILE = 64    # cache slots of one stage of the kernel's ring
MAX_ROWS = 64       # query rows a kernel block holds; wider groups take more
BLOCKS_PER_SM = 2   # what decode_splits aims for
MAX_SPLITS = 64     # chunks the kernel's combine takes
MAX_TQ = 8          # query tokens a call takes


def row_groups(G: int) -> int:
    """Blocks a (batch row, kv head, chunk) of G query rows (query heads x
    query tokens) takes: one for every G <= 64."""
    return -(-G // MAX_ROWS)


def decode_splits(B: int, Hkv: int, G: int, S: int, n_sms: int) -> int:
    """How many chunks of whole 64-slot tiles the kernel cuts each (batch
    row, kv head)'s cache of S slots into, one block each, for G query rows
    a kv head (query heads x query tokens): 1 when the B *
    Hkv blocks already give BLOCKS_PER_SM blocks per SM, else enough chunks
    that they do, as far as S has tiles (and at most MAX_SPLITS; chunks of
    two tiles or more for a group wider than 16). S is the static cache length (the
    query positions live on the device), so the plan, the grid and the
    workspace depend on shapes alone."""
    blocks = B * Hkv * row_groups(G)
    want = -(-BLOCKS_PER_SM * n_sms // blocks)
    if want <= 1:
        return 1
    tiles = -(-S // DECODE_TILE)
    # a group wider than 16 rows takes chunks of at least 2 tiles: the last
    # block's combine reads G rows of every chunk
    per = max(1 if G <= 16 else 2, tiles // want, -(-tiles // MAX_SPLITS))
    return -(-tiles // per)


def decode_attention_reference(q, k_cache, v_cache, seg, q_pos,
                               k_scale=None, v_scale=None, *,
                               sm_scale: float, alibi_slopes=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in f32 (f64 for f64 inputs).

    q [B, Tq, H, D], token t at position ``q_pos + t``; caches [B, S, Hkv,
    D]; seg [B, S]; q_pos [B]; scales [B, S, Hkv, 1] or None;
    ``alibi_slopes`` [H] or None. Returns [B, Tq, H, D] in q's dtype.
    """
    B, Tq, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.to(acc).reshape(B, Tq, Hkv, G, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k_cache.to(acc))
    if k_scale is not None:
        scores = scores * k_scale[..., 0].to(acc).permute(0, 2, 1)[:, :, None, None, :]
    scores = scores * sm_scale
    pos = torch.arange(S, device=q.device)
    qt = q_pos.long()[:, None] + torch.arange(Tq, device=q.device)      # [B, Tq]
    if alibi_slopes is not None:
        dist = (qt[:, :, None] - pos).to(acc)                             # [B, Tq, S]
        scores = scores - (alibi_slopes.to(acc).reshape(Hkv, G)[None, :, :, None, None]
                           * dist[:, None, None])
    used = (pos <= qt[:, :, None])[:, None, None]                         # [B, 1, 1, Tq, S]
    scores = torch.where((seg != 0)[:, None, None, None, :], scores, DEFAULT_MASK_VALUE)
    scores = torch.where(used, scores, -torch.inf)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[..., 0].to(acc).permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkgts,bskd->btkgd", p, v_cache.to(acc)) / l.clamp_min(1e-9).permute(
        0, 3, 1, 2, 4)
    return out.reshape(B, Tq, H, D).to(q.dtype)


def _check_kernel_inputs(q, k_cache, v_cache, seg, q_pos, k_scale, v_scale):
    B, Tq, H, D = q.shape
    if not 1 <= Tq <= MAX_TQ:
        raise ValueError(f"decode kernel takes 1 to {MAX_TQ} query tokens, got {Tq}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"decode kernel takes a bf16 query, got {q.dtype}")
    quantized = k_scale is not None
    want = torch.int8 if quantized else torch.bfloat16
    if k_cache.dtype != want or v_cache.dtype != want:
        raise TypeError(f"decode kernel takes a {want} cache here, got {k_cache.dtype}")
    if D != HEAD_DIM:
        raise ValueError(f"decode kernel needs head dim {HEAD_DIM}, got {D}")
    Hkv = k_cache.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    S = k_cache.shape[1]
    if (k_cache.shape != (B, S, Hkv, D) or v_cache.shape != k_cache.shape
            or k_cache.stride() != v_cache.stride()):
        raise ValueError("k/v caches must be [B, S, Hkv, D] with equal strides")
    if seg.shape != (B, S) or seg.dtype != torch.int32 or seg.stride(1) != 1:
        raise ValueError("seg must be int32 [B, S] with contiguous rows")
    if q_pos.shape != (B,) or q_pos.dtype != torch.int32 or not q_pos.is_contiguous():
        raise ValueError("q_pos must be a contiguous int32 [B]")
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("seg", seg), ("q_pos", q_pos)]
    if quantized:
        if v_scale is None:
            raise ValueError("an int8 cache needs both scales")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or s.shape != (B, S, Hkv, 1):
                raise ValueError(f"{name} must be f32 [B, S, Hkv, 1]")
        if k_scale.stride() != v_scale.stride():
            raise ValueError("k and v scales must share strides")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, x in tensors:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not build.int32_offsets(x):
            raise ValueError(f"{name} is too large for 32-bit offsets")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        elem = x.element_size()
        if (x.stride(-1) != 1 or any(s * elem % 16 for s in x.stride()[:-1])
                or x.data_ptr() % 16):
            raise ValueError(f"{name}: last dim must be contiguous, rows 16-byte aligned")


def _launch(q, k_cache, v_cache, seg, q_pos, k_scale, v_scale, sm_scale, slopes):
    _check_kernel_inputs(q, k_cache, v_cache, seg, q_pos, k_scale, v_scale)
    B, Tq, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    R = H // Hkv * Tq   # query rows a kv head
    quantized = k_scale is not None
    out = torch.empty(B, Tq, H, D, dtype=q.dtype, device=q.device)
    ss = k_scale.stride() if quantized else (0, 0, 0)
    splits = decode_splits(B, Hkv, R, S, build.sm_count(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = counters = None
    if splits > 1:
        ws = torch.empty(B, Hkv, splits, R, D + 2, dtype=torch.float32, device=q.device)
        # the combine's counters, kept per device and stream (the kernel
        # leaves them zero)
        counters = build.scratch("decode_attention.counters", q.device, stream,
                                 B * Hkv * row_groups(R), torch.int32, zeroed=True)
    err = build.lib().decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        seg.data_ptr(), q_pos.data_ptr(),
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(),
        B, S, H, Hkv, Tq, int(quantized), splits,
        q.stride(0), q.stride(1), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        ss[0], ss[1], ss[2], seg.stride(0),
        float(sm_scale), stream,
    )
    build.check(err, "decode_attention_fwd")
    decode_attention.last_splits = splits
    return out


def decode_attention(
    q: torch.Tensor,                  # [B, Tq, H, D], Tq <= MAX_TQ
    k_cache: torch.Tensor,            # [B, S, Hkv, D] bf16 or int8
    v_cache: torch.Tensor,
    seg: torch.Tensor,                # [B, S] int32, 0 = empty slot
    q_pos: torch.Tensor,              # [B] int32 position of the first query token
    k_scale: Optional[torch.Tensor] = None,   # [B, S, Hkv, 1] f32 for int8
    v_scale: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,   # [H] f32 (MPT)
) -> torch.Tensor:
    """Attention of a short chunk over the cache. Returns [B, Tq, H, D]."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    check_slopes(alibi_slopes, q.shape[2], q.device)
    if q.is_cuda:
        out = _launch(q, k_cache, v_cache, seg, q_pos, k_scale, v_scale, sm_scale,
                      alibi_slopes)
        wide = q.shape[2] // k_cache.shape[2] > WIDE_GROUP
        build.count_launch(decode_attention, "wide_launches" if wide else
                           "launches" if alibi_slopes is None else "alibi_launches",
                           *(("chunk_launches",) if q.shape[1] > 1 else ()))
        return out
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, seg, q_pos, k_scale, v_scale,
                                          sm_scale=sm_scale, alibi_slopes=alibi_slopes)
    raise ValueError(f"decode_attention: no path for device {q.device}")


decode_attention.launches = 0
decode_attention.alibi_launches = 0
decode_attention.wide_launches = 0
decode_attention.chunk_launches = 0   # of those, launches of more than one query token
decode_attention.last_splits = 0   # the cache chunks of the latest launch
