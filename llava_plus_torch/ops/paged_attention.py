"""Paged attention over the KV page pool: the CUDA kernels of
``csrc/paged_attention.cu`` and their plain PyTorch version.

Counterpart of ``llava_plus_tpu/ops/paged_attention.py``; the two Pallas
kernels it replaces are ``_kernel_decode1`` (one query row per kv head, the
MHA decode step) and ``_kernel`` (the general kernel: several query rows per
kv head, for GQA/MQA and for chunks of up to 8 tokens). Both compute the same
function as :func:`paged_attention_reference`:

- ``kv_pages`` [NP, 2, P, Hkv, D] is one layer's pool (dim 1: 0 = K, 1 = V),
  token-major within a page; an int8 pool carries f32 per-(token, head)
  scales ``kv_scale`` [NP, 2, Hkv, P], head-major, folded into the scores
  (k) and the probabilities (v);
- ``page_ids`` [B, maxp] int32 maps a slot's logical page to a pool page;
  ``lengths`` [B] counts the slot's PAST tokens (those in the pool);
- the current chunk ``cur_k`` / ``cur_v`` [B, Tq, Hkv, D], not yet written
  to the pool, is folded in as a final self block: chunk token j sits at
  position ``lengths + j``, causal within the chunk, with a valid prefix of
  ``cur_valid`` [B] tokens. Without a current chunk the (single) query sits
  at ``lengths - 1``, already in the pool;
- with ``alibi_slopes`` [H] (MPT) each score loses ``slope_h * |q_pos -
  kv_pos|`` over those positions (pool token s at position s); the kernels'
  ALiBi launches count in ``<kernel>.alibi_launches``;
- masked entries take the finite mask value ``-0.7 * f32 max``.

The JAX package's Mosaic workarounds (the 128-lane head-dim gate and the
f32 block-diagonal query of ``_kernel_decode1``) are not carried over. On
CUDA tensors :func:`paged_decode_attention` launches a kernel or raises (for
a non-bf16 query, a head dim other than 128, or more than 8 chunk tokens);
on CPU tensors it runs the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from llava_plus_torch.kernels import build
from llava_plus_torch.ops.attention import DEFAULT_MASK_VALUE, check_slopes

HEAD_DIM = 128
MAX_CHUNK = 8   # chunk tokens the kernels fold into the self block
D1_TILE = 64    # pool tokens of one stage of the kernels' ring
D1_CHUNK_TILES = 8    # tiles of a chunk where the card is full
D1_MAX_SPLITS = 64    # chunks a slot is cut into, at most
BLOCKS_PER_SM = 2
# tiles of a general chunk, at least: each block pays about four tiles'
# worth of fixed cost (its first loads, counting in), measured on the H100
GENERAL_MIN_CHUNK_TILES = 4
GENERAL_ROWS = 8   # query rows of a general block: the n8 side of its products


def decode1_splits(B: int, Hkv: int, maxp: int, P: int, n_sms: int) -> int:
    """How many chunks of whole 64-token tiles the decode1 kernel cuts each
    (slot, kv head)'s ``maxp * P`` token positions into, one block each.
    Lengths are ragged and live on the device, so the plan takes the static
    shapes alone (a CUDA graph can capture the launch): chunks of
    ``D1_CHUNK_TILES`` tiles, so that the longest slot is spread over many
    SMs even where ``B * Hkv`` blocks already fill the card; shorter ones
    where fewer (slot, head) pairs would leave SMs without two blocks; at
    most ``D1_MAX_SPLITS`` chunks. Chunks past a slot's length exit at once."""
    tiles = -(-(maxp * P) // D1_TILE)
    fill = (tiles * B * Hkv) // (BLOCKS_PER_SM * n_sms)   # tiles a chunk may hold
    per = max(-(-tiles // D1_MAX_SPLITS), min(D1_CHUNK_TILES, max(1, fill)))
    return -(-tiles // per)


def general_groups(G: int, Tq: int) -> int:
    """Row groups of a kv head in the general kernel: its ``G * Tq`` query
    rows, ``GENERAL_ROWS`` to a block, as the columns of the n8 tile of the
    block's products (a wider group takes more blocks side by side: on the
    H100, two 8-row blocks at 16 heads over one kv head beat one block of
    two n8 tiles)."""
    return -(-(G * Tq) // GENERAL_ROWS)


def general_splits(B: int, Hkv: int, groups: int, maxp: int, P: int, n_sms: int) -> int:
    """How many chunks of whole 64-token tiles the general kernel cuts each
    (slot, kv head, row group)'s ``maxp * P`` token positions into: as
    :func:`decode1_splits` plans decode1's, with a block for each row group
    where decode1 has one for each kv head, and chunks of at least
    ``GENERAL_MIN_CHUNK_TILES`` tiles (MQA's 16 (slot, head) pairs would
    otherwise take one-tile chunks)."""
    tiles = -(-(maxp * P) // D1_TILE)
    fill = (tiles * B * Hkv * groups) // (BLOCKS_PER_SM * n_sms)   # tiles a chunk may hold
    per = max(-(-tiles // D1_MAX_SPLITS),
              min(D1_CHUNK_TILES, max(GENERAL_MIN_CHUNK_TILES, fill)))
    return -(-tiles // per)


def gather_pages(kv_pages, page_ids, kv_scale=None, dtype=torch.float32):
    """[NP, 2, P, Hkv, D] pool -> dense k, v [B, maxp * P, Hkv, D] in
    ``dtype`` (dequantized when ``kv_scale`` is given). Token-major pages
    concatenate straight into the dense order."""
    B, maxp = page_ids.shape
    _, _, P, Hkv, D = kv_pages.shape
    ids = page_ids.long()
    g = kv_pages[ids].to(dtype)                          # [B, maxp, 2, P, Hkv, D]
    if kv_scale is not None:
        s = kv_scale[ids].to(dtype).transpose(3, 4)      # [B, maxp, 2, P, Hkv]
        g = g * s[..., None]
    g = g.permute(2, 0, 1, 3, 4, 5).reshape(2, B, maxp * P, Hkv, D)
    return g[0], g[1]


def paged_attention_reference(q, kv_pages, page_ids, lengths, kv_scale=None,
                              cur_k=None, cur_v=None, cur_valid=None, *,
                              sm_scale: Optional[float] = None,
                              alibi_slopes=None) -> torch.Tensor:
    """The kernels' function in plain PyTorch: gather the pages, append the
    current chunk, masked softmax in f32 (f64 for an f64 query). Returns
    [B, Tq, H, D] in q's dtype. Same masks and ALiBi positions as the JAX
    package's ``paged_attention_reference``."""
    B, Tq, H, D = q.shape
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = D ** -0.5 if sm_scale is None else sm_scale
    k, v = gather_pages(kv_pages, page_ids, kv_scale, acc)
    S = k.shape[1]
    dev = q.device
    lengths = lengths.long()
    pool_ok = torch.arange(S, device=dev)[None, None, :] < lengths[:, None, None]  # [B, 1, S]
    kv_pos = torch.arange(S, device=dev).expand(B, S)
    if cur_k is None:
        if Tq != 1:
            raise ValueError("a query of several tokens needs the current chunk")
        allowed = pool_ok            # the query sits at lengths - 1, in the pool
        q_pos = (lengths - 1)[:, None]
    else:
        valid = (torch.full((B,), Tq, device=dev) if cur_valid is None
                 else cur_valid.long())
        t = torch.arange(Tq, device=dev)
        self_ok = ((t[None, None, :] <= t[None, :, None])
                   & (t[None, None, :] < valid[:, None, None]))              # [B, Tq, Tq]
        allowed = torch.cat([pool_ok.expand(B, Tq, S), self_ok], dim=-1)
        k = torch.cat([k, cur_k.to(acc)], dim=1)
        v = torch.cat([v, cur_v.to(acc)], dim=1)
        q_pos = lengths[:, None] + t[None]
        kv_pos = torch.cat([kv_pos, q_pos], dim=1)
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.to(acc).reshape(B, Tq, Hkv, G, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k) * scale
    if alibi_slopes is not None:
        dist = (q_pos[:, :, None] - kv_pos[:, None, :]).abs().to(acc)       # [B, Tq, S']
        scores = scores - (alibi_slopes.to(acc).reshape(Hkv, G)[None, :, :, None, None]
                           * dist[:, None, None])
    scores = torch.where(allowed[:, None, None], scores, DEFAULT_MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(B, Tq, H, D).to(q.dtype)


def _check_kernel_inputs(q, kv_pages, page_ids, lengths, kv_scale, cur_k, cur_v,
                         cur_valid):
    B, Tq, H, D = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged kernels take a bf16 query, got {q.dtype}")
    if D != HEAD_DIM:
        raise ValueError(f"paged kernels need head dim {HEAD_DIM}, got {D}")
    if Tq > MAX_CHUNK:
        raise ValueError(f"paged kernels take at most {MAX_CHUNK} query tokens, got {Tq}")
    if kv_pages.dim() != 5 or kv_pages.shape[1] != 2 or kv_pages.shape[4] != D:
        raise ValueError(f"the pool must be [NP, 2, P, Hkv, {D}], got {tuple(kv_pages.shape)}")
    NP, _, P, Hkv, _ = kv_pages.shape
    if H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} kv heads")
    quantized = kv_scale is not None
    want = torch.int8 if quantized else torch.bfloat16
    if kv_pages.dtype != want:
        raise TypeError(f"paged kernels take a {want} pool here, got {kv_pages.dtype}")
    if not kv_pages.is_contiguous():
        raise ValueError("the pool must be contiguous")
    tensors = [("q", q), ("kv_pages", kv_pages), ("page_ids", page_ids),
               ("lengths", lengths)]
    if quantized:
        if (kv_scale.dtype != torch.float32 or kv_scale.shape != (NP, 2, Hkv, P)
                or not kv_scale.is_contiguous()):
            raise ValueError(f"kv_scale must be contiguous f32 [{NP}, 2, {Hkv}, {P}]")
        tensors.append(("kv_scale", kv_scale))
    if (page_ids.dim() != 2 or page_ids.shape[0] != B or page_ids.dtype != torch.int32
            or page_ids.stride(1) != 1):
        raise ValueError("page_ids must be int32 [B, maxp] with contiguous rows")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 [B]")
    if cur_k is not None:
        if cur_v is None or cur_valid is None:
            raise ValueError("the current chunk needs cur_v and cur_valid")
        for name, c in (("cur_k", cur_k), ("cur_v", cur_v)):
            if c.shape != (B, Tq, Hkv, D) or c.dtype != torch.bfloat16:
                raise ValueError(f"{name} must be bf16 [B, Tq, Hkv, D]")
            tensors.append((name, c))
        if cur_k.stride() != cur_v.stride():
            raise ValueError("cur_k and cur_v must share strides")
        if (cur_valid.shape != (B,) or cur_valid.dtype != torch.int32
                or not cur_valid.is_contiguous()):
            raise ValueError("cur_valid must be a contiguous int32 [B]")
        tensors.append(("cur_valid", cur_valid))
    elif Tq != 1:
        raise ValueError("a query of several tokens needs the current chunk")
    for name, x in tensors:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not build.int32_offsets(x):
            raise ValueError(f"{name} is too large for 32-bit offsets")
    for name, x in [("q", q)] + ([] if cur_k is None else [("cur_k", cur_k), ("cur_v", cur_v)]):
        if x.stride(-1) != 1 or any(s % 4 for s in x.stride()[:-1]) or x.data_ptr() % 8:
            raise ValueError(f"{name}: last dim must be contiguous, rows 8-byte aligned")


# a launch's plan and buffers, kept per (kernel, device, stream, shapes): a
# call of the same shapes on the same stream (every layer of a step) costs a
# lookup besides its checks and the kernel's call
_plans = {}


def _plan(fn_name, device, stream, B, P, H, Hkv, Tq, maxp, D):
    """(chunks a slot, workspace, counters) of a launch. The chunks'
    partials and the combine's counters are kept per device and stream (the
    kernels leave the counters zero); a block per (slot, kv head[, row
    group])."""
    key = (fn_name, device.index, stream, B, P, H, Hkv, Tq, maxp)
    held = _plans.get(key)
    if held is None:
        sms = build.sm_count(device)
        if fn_name == "paged_decode1_fwd":
            rows, blocks = 1, B * Hkv
            splits = parts = decode1_splits(B, Hkv, maxp, P, sms)
        else:   # a partial for each chunk and one for the self block
            rows, groups = GENERAL_ROWS, general_groups(H // Hkv, Tq)
            blocks = B * Hkv * groups
            splits = general_splits(B, Hkv, groups, maxp, P, sms)
            parts = splits + 1
        ws = build.scratch("paged_attention.ws", device, stream,
                           blocks * parts * rows * (D + 2), torch.float32)
        counters = build.scratch("paged_attention.counters", device, stream, blocks,
                                 torch.int32, zeroed=True)
        held = _plans[key] = (splits, ws, counters)
    return held


def _launch(fn_name, q, kv_pages, page_ids, lengths, kv_scale, cur_k, cur_v, cur_valid,
            sm_scale, slopes):
    _check_kernel_inputs(q, kv_pages, page_ids, lengths, kv_scale, cur_k, cur_v, cur_valid)
    check_slopes(slopes, q.shape[2], q.device)
    B, Tq, H, D = q.shape
    _, _, P, Hkv, _ = kv_pages.shape
    maxp = page_ids.shape[1]
    quantized = kv_scale is not None
    has_cur = cur_k is not None
    out = torch.empty(B, Tq, H, D, dtype=q.dtype, device=q.device)
    cs = cur_k.stride() if has_cur else (0, 0, 0, 0)
    # the raw stream handle: a torch.cuda.Stream object costs microseconds
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    splits, ws, counters = _plan(fn_name, q.device, stream, B, P, H, Hkv, Tq, maxp, D)
    wrapper = paged_decode1 if fn_name == "paged_decode1_fwd" else paged_attention_general
    wrapper.last_splits = splits
    err = getattr(build.lib(), fn_name)(
        q.data_ptr(),
        cur_k.data_ptr() if has_cur else None, cur_v.data_ptr() if has_cur else None,
        kv_pages.data_ptr(), kv_scale.data_ptr() if quantized else None,
        page_ids.data_ptr(), lengths.data_ptr(),
        cur_valid.data_ptr() if has_cur else None,
        None if slopes is None else slopes.data_ptr(), out.data_ptr(),
        ws.data_ptr(), min(ws.numel(), 2 ** 31 - 1), counters.data_ptr(), counters.numel(),
        B, P, H, Hkv, Tq, maxp, int(quantized), int(has_cur), splits,
        q.stride(0), q.stride(1), q.stride(2), cs[0], cs[1], cs[2], page_ids.stride(0),
        float(sm_scale), stream,
    )
    build.check(err, fn_name)
    return out


def _counter(slopes) -> str:
    return "launches" if slopes is None else "alibi_launches"


def paged_decode1(q, kv_pages, page_ids, lengths, kv_scale=None, cur_k=None, cur_v=None,
                  cur_valid=None, *, sm_scale: float, alibi_slopes=None) -> torch.Tensor:
    """The decode1 kernel (``csrc/paged_attention.cu``, one query row per kv
    head: ``G * Tq == 1``) on CUDA tensors."""
    out = _launch("paged_decode1_fwd", q, kv_pages, page_ids, lengths, kv_scale,
                  cur_k, cur_v, cur_valid, sm_scale, alibi_slopes)
    build.count_launch(paged_decode1, _counter(alibi_slopes))
    return out


def paged_attention_general(q, kv_pages, page_ids, lengths, kv_scale=None, cur_k=None,
                            cur_v=None, cur_valid=None, *, sm_scale: float,
                            alibi_slopes=None) -> torch.Tensor:
    """The general kernel (``csrc/paged_attention.cu``: the ``G * Tq``
    query rows of a kv head, causal within the chunk, each slot's pages split
    into :func:`general_splits` chunks) on CUDA tensors."""
    out = _launch("paged_attention_fwd", q, kv_pages, page_ids, lengths, kv_scale,
                  cur_k, cur_v, cur_valid, sm_scale, alibi_slopes)
    build.count_launch(paged_attention_general, _counter(alibi_slopes))
    return out


for _wrapper in (paged_decode1, paged_attention_general):
    _wrapper.launches = _wrapper.alibi_launches = 0
    _wrapper.last_splits = 0   # the chunks of a slot in the latest launch


def paged_decode_attention(
    q: torch.Tensor,                     # [B, Tq, H, D]
    kv_pages: torch.Tensor,              # [NP, 2, P, Hkv, D] bf16 or int8
    page_ids: torch.Tensor,              # [B, maxp] int32
    lengths: torch.Tensor,               # [B] int32 past tokens per slot
    kv_scale: Optional[torch.Tensor] = None,   # [NP, 2, Hkv, P] f32 when int8
    cur_k: Optional[torch.Tensor] = None,      # [B, Tq, Hkv, D] current chunk
    cur_v: Optional[torch.Tensor] = None,
    cur_valid: Optional[torch.Tensor] = None,  # [B] int32 valid chunk tokens
    *,
    sm_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,   # [H] f32 (MPT)
) -> torch.Tensor:
    """Attention over the paged pool plus the current chunk's self block.
    Returns [B, Tq, H, D]."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    check_slopes(alibi_slopes, q.shape[2], q.device)
    if q.is_cuda:
        if cur_k is not None and cur_valid is None:
            cur_valid = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32,
                                   device=q.device)
        H, Hkv = q.shape[2], kv_pages.shape[3]
        kernel = paged_decode1 if (H // Hkv) * q.shape[1] == 1 else paged_attention_general
        return kernel(q, kv_pages, page_ids, lengths, kv_scale, cur_k, cur_v, cur_valid,
                      sm_scale=sm_scale, alibi_slopes=alibi_slopes)
    if q.device.type == "cpu":
        return paged_attention_reference(q, kv_pages, page_ids, lengths, kv_scale,
                                         cur_k, cur_v, cur_valid, sm_scale=sm_scale,
                                         alibi_slopes=alibi_slopes)
    raise ValueError(f"paged_decode_attention: no path for device {q.device}")
