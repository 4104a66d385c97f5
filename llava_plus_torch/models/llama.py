"""LLaMA/Vicuna decoder in PyTorch, dense or paged KV cache.

Counterpart of ``llava_plus_tpu/models/llama.py``: plain functions over the
same parameter tree (stacked per-layer weights ``[L, in, out]``, ``x @ w``),
explicit ``positions`` and ``segment_ids``, so prefill, padded batches and
cache decode share one code path. Layers run as a Python loop.

Attention: a fresh prefill attends over its own chunk through
:func:`ops.attention.attention` (the flash kernel on the card). Over the
dense :class:`KVCache`, a chunk of up to ``MAX_TQ`` (8) tokens at contiguous
positions (a decode step, a speculative verify step) goes through
:func:`ops.decode_attention.decode_attention`, which reads the cache in
place; any longer cached chunk uses the reference attention. Over the paged
:class:`PagedKVCache`, chunks of up to 8 tokens go through
:func:`ops.paged_attention.paged_decode_attention` (the paged kernels on the
card), longer ones through the gathered pages and the reference attention.
Kernels run on the card, their plain versions on the CPU.

Projections go through :func:`ops.quant.matmul`, so a weight may be a bf16
tensor or an int8 / int4 dict (``ops/quant.py``, the kernels of
``ops/quant_matmul.py`` on the card), unfused or fused (``wqkv``,
``w_gateup``) as ``quant.fuse_llama_matrices`` leaves it.

Training (no cache) differentiates through the same code: the flash
kernels' ``autograd.Function``, per-layer remat with
``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint`` over the
layer scan), and an ``lm_head`` whose backward rounds the f32 cotangent to
the weight dtype, as JAX's dot transpose does. The trainer holds the layers
as a list of per-layer dicts (``models/convert.py:per_layer``) so that each
layer's weights are their own autograd leaves: a view ``w[i]`` of a stacked
leaf would make autograd add a zero tensor the size of the whole stack into
its gradient for every layer.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from llava_plus_torch.models.configs import LlamaConfig, MptConfig
from llava_plus_torch.ops.attention import (
    alibi_bias, attention, quant_cache_attention, reference_attention,
)
from llava_plus_torch.ops.decode_attention import MAX_TQ, decode_attention
from llava_plus_torch.ops.paged_attention import (
    MAX_CHUNK, gather_pages, paged_decode_attention,
)
from llava_plus_torch.ops.quant import is_quantized, matmul


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def cache_dims(cfg: Union[LlamaConfig, MptConfig]) -> Tuple[int, int, int]:
    """(layers, kv heads, head dim) of a LLaMA or an MPT decoder: both
    backbones share the cache layouts (the JAX package reads the two
    configs' fields with ``getattr``)."""
    if isinstance(cfg, MptConfig):
        return cfg.n_layers, cfg.kv_heads, cfg.head_dim
    return cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim


@dataclasses.dataclass
class KVCache:
    """Per-layer stacked KV cache, updated IN PLACE by :func:`forward`
    (the JAX cache is a functional value returned anew by each call).

    k, v: [L, B, S, Hkv, Dh]; seg: [B, S] int32 segment ids of written
    tokens (0 = empty slot). Slot index == token position. With
    ``dtype=torch.int8`` the values are stored quantized with one f32 scale
    per (layer, batch row, slot, kv head) in ``k_scale``/``v_scale``
    [L, B, S, Hkv, 1].
    """

    k: torch.Tensor
    v: torch.Tensor
    seg: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: Union[LlamaConfig, MptConfig], batch: int, max_len: int,
               dtype=torch.bfloat16, *, device) -> "KVCache":
        L, Hkv, Dh = cache_dims(cfg)
        shape = (L, batch, max_len, Hkv, Dh)
        quantized = dtype == torch.int8
        scales = shape[:-1] + (1,)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            seg=torch.zeros(batch, max_len, dtype=torch.int32, device=device),
            k_scale=torch.zeros(scales, device=device) if quantized else None,
            v_scale=torch.zeros(scales, device=device) if quantized else None,
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def quantize_kv(new: torch.Tensor):
    """Per-(token, head) symmetric int8: scale = max(absmax, 1e-8) / 127,
    round half to even, clip to +-127. Returns (int8 values, f32 scale
    [..., 1]). The scale is ``max(amax, 1e-8) * f32(1/127)``, as the jitted
    JAX ``_cache_write`` computes it (XLA turns its division by 127 into
    that product, which can differ from a division in the last bit)."""
    nf = new.float()
    scale = nf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(nf / scale), -127, 127).to(torch.int8)
    return q, scale


class _Step(NamedTuple):
    """The slots of a chunk of up to ``MAX_TQ`` tokens: token (b, t) writes
    flat slot ``b * S + min(pos, S - 1)``. A token with ``keep`` False (pos
    >= S) writes back what that slot holds after the call: the new value of
    the row's token at S - 1 where the chunk has one (``src``, an index
    into the chunk's B * T tokens; several writes to one slot then agree),
    else the slot's own contents. ``src`` is None for one-token steps."""

    flat: torch.Tensor
    keep: torch.Tensor
    src: Optional[torch.Tensor] = None


def _put_rows(buf: torch.Tensor, step: _Step, vals: torch.Tensor):
    """buf [B, S, ...] <- vals [B * T, ...], one row each, at ``step``'s slots."""
    rows = buf.view(-1, *buf.shape[2:])
    keep = step.keep.view(-1, *[1] * (vals.dim() - 1))
    old = rows.index_select(0, step.flat)
    if step.src is not None:
        has = (step.src >= 0).view(-1, *[1] * (vals.dim() - 1))
        old = torch.where(has, vals.index_select(0, step.src.clamp_min(0)), old)
    rows.index_copy_(0, step.flat, torch.where(keep, vals, old))


def _write_slots(cache: KVCache, positions, segment_ids):
    """The cache slots a call writes, with their segment ids already
    written. Tokens at positions >= max_len (padding rows; engine slots that
    are idle, past their budget or verifying past the window) are left out,
    as the JAX package's dropping scatter leaves them out.

    A chunk of up to ``MAX_TQ`` tokens (decode, speculative verify) returns a
    :class:`_Step`: such a token is clamped onto its row's last slot and
    writes back what that slot holds, which needs no host sync and one flat
    index for every layer. A longer chunk returns ``(b, t, pos)``, its
    in-range tokens selected with ``nonzero`` (a host sync, which its callers,
    prefills, already make)."""
    B, T = positions.shape
    S = cache.max_len
    if T <= MAX_TQ:
        dev = positions.device
        pos = positions.long()
        keep = (pos < S).reshape(-1)
        flat = (torch.arange(B, device=dev)[:, None] * S + pos.clamp(max=S - 1)).reshape(-1)
        src = None
        if T > 1:
            at_end = pos == S - 1
            last = torch.arange(B, device=dev) * T + at_end.int().argmax(dim=1)
            src = torch.where(at_end.any(dim=1), last, -1).repeat_interleave(T)
        step = _Step(flat, keep, src)
        _put_rows(cache.seg, step, segment_ids.reshape(-1).to(torch.int32))
        return step
    b, t = torch.nonzero(positions < S, as_tuple=True)
    pos = positions[b, t]
    cache.seg[b, pos] = segment_ids[b, t].to(torch.int32)
    return b, t, pos


def _cache_write(all_vals, all_scales, new, idx, sel):
    """Write new [B, T, H, D] rows into layer ``idx`` of the stacked cache at
    the slots ``sel`` of :func:`_write_slots` (quantized per (token, head)
    when the cache carries scales)."""
    step = isinstance(sel, _Step)
    vals = new.reshape(-1, *new.shape[2:]) if step else new[sel[0], sel[1]]
    scales = None
    if all_scales is None:
        vals = vals.to(all_vals.dtype)
    else:
        vals, scales = quantize_kv(vals)
    for buf, x in ((all_vals, vals), (all_scales, scales)):
        if x is None:
            continue
        if step:
            _put_rows(buf[idx], sel, x)
        else:
            buf[idx, sel[0], sel[2]] = x


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV cache: one page pool shared by every slot, and a page table
    per slot (counterpart of the JAX ``PagedKVCache``), updated IN PLACE.

    The JAX layouts, read through the properties: ``kv`` [L, Np, 2, P, Hkv,
    Dh] (dim 2 selects K (0) / V (1); token-major within a page), ``kv_scale``
    [L, Np, 2, Hkv, P] f32 per-(token, head) scales of an int8 pool
    (head-major), ``seg`` [B, maxp * P] segment ids by logical position.
    ``page_table`` [B, maxp] int32 holds each slot's page ids (the same id in
    every layer); ``alloc`` [B] the tokens allocated to a slot.

    The buffers behind them carry one more page (``pool`` [L, Np + 1, ...],
    ``scale_pool``) and one more seg column (``seg_buf``): writes that the
    JAX package drops (positions >= max_len or >= alloc, padding and idle
    rows; its scatter sends them out of range) land there instead, with no
    host sync. No page table names the scratch page, so nothing reads it.
    """

    pool: torch.Tensor
    seg_buf: torch.Tensor
    page_table: torch.Tensor
    alloc: torch.Tensor
    scale_pool: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: Union[LlamaConfig, MptConfig], batch: int, *, num_pages: int,
               max_pages_per_slot: int, page_size: int = 128,
               dtype=torch.bfloat16, device) -> "PagedKVCache":
        L, Hkv, Dh = cache_dims(cfg)
        quantized = dtype == torch.int8
        max_len = max_pages_per_slot * page_size
        return cls(
            pool=torch.zeros(L, num_pages + 1, 2, page_size, Hkv, Dh,
                             dtype=dtype, device=device),
            seg_buf=torch.zeros(batch, max_len + 1, dtype=torch.int32, device=device),
            page_table=torch.zeros(batch, max_pages_per_slot, dtype=torch.int32,
                                   device=device),
            alloc=torch.full((batch,), max_len, dtype=torch.int32, device=device),
            scale_pool=(torch.zeros(L, num_pages + 1, 2, Hkv, page_size, device=device)
                        if quantized else None),
        )

    @property
    def kv(self) -> torch.Tensor:
        return self.pool[:, :-1]

    @property
    def kv_scale(self) -> Optional[torch.Tensor]:
        return None if self.scale_pool is None else self.scale_pool[:, :-1]

    @property
    def seg(self) -> torch.Tensor:
        return self.seg_buf[:, :-1]

    @property
    def page_size(self) -> int:
        return self.pool.shape[3]

    @property
    def num_pages(self) -> int:
        return self.pool.shape[1] - 1

    @property
    def max_len(self) -> int:
        return self.page_table.shape[1] * self.page_size

    @property
    def quantized(self) -> bool:
        return self.scale_pool is not None

    def row(self, slot: int) -> "PagedKVCache":
        """Slot ``slot`` alone, as a batch of one: views into this cache, so
        a forward over it writes here."""
        return PagedKVCache(pool=self.pool, seg_buf=self.seg_buf[slot:slot + 1],
                            page_table=self.page_table[slot:slot + 1],
                            alloc=self.alloc[slot:slot + 1], scale_pool=self.scale_pool)


def _paged_quant(new: torch.Tensor):
    """Per-(token, head) symmetric int8: [.., Hkv, D] -> (int8, scale [.., Hkv]),
    :func:`quantize_kv` with the scale's last dim dropped."""
    q, scale = quantize_kv(new)
    return q, scale[..., 0]


class _PagedStep(NamedTuple):
    """A call's page addressing, computed once on the device and shared by
    every layer: each token's K row in the flat pool view of layer 0
    ([L * (Np + 1) * 2 * P, Hkv * D]; the V row is P further) and its first
    scale element in the flat scale pool (the scratch page for the writes
    the JAX package drops), the slots' past tokens, the valid chunk tokens,
    and the pool segment ids the gather path masks with."""

    rows: torch.Tensor        # [B * T] int64
    srows: torch.Tensor       # [B * T, Hkv] int64, or None without scales
    past_len: torch.Tensor    # [B] int32
    cur_valid: torch.Tensor   # [B] int32
    pool_seg: torch.Tensor    # [B, maxp * P] int32: seg * (position < past_len)


def _paged_step(cache: PagedKVCache, positions, segment_ids) -> _PagedStep:
    """The page addressing of a call (JAX ``decoder_forward``'s paged
    ``pages``, ``offsets``, ``valid`` and ``past_len``), and the chunk's
    segment ids written into ``cache.seg``."""
    B, T = positions.shape
    P, maxp, S = cache.page_size, cache.page_table.shape[1], cache.max_len
    Np, Hkv = cache.num_pages, cache.pool.shape[4]
    dev = positions.device
    pos = positions.long()
    pages = torch.gather(cache.page_table, 1, (pos // P).clamp(0, maxp - 1)).long()
    valid = (pos < S) & (segment_ids > 0) & (pos < cache.alloc[:, None])
    pages = torch.where(valid, pages, Np)        # dropped writes: the scratch page
    offsets = pos % P
    rows = (pages * 2 * P + offsets).reshape(-1)
    srows = None
    if cache.quantized:
        h = torch.arange(Hkv, device=dev)
        srows = ((pages * 2 * Hkv)[..., None] + h) * P + offsets[..., None]
        srows = srows.reshape(-1, Hkv)
    past_len = torch.where(segment_ids[:, 0] > 0, positions[:, 0], 0).clamp(max=S)
    past_len = past_len.to(torch.int32)
    pool_seg = cache.seg * (torch.arange(S, device=dev)[None] < past_len[:, None])
    flat = torch.arange(B, device=dev)[:, None] * (S + 1) + pos.clamp(max=S)
    cache.seg_buf.view(-1).index_copy_(0, flat.reshape(-1),
                                       segment_ids.reshape(-1).to(torch.int32))
    return _PagedStep(rows, srows, past_len, segment_ids.sum(dim=1).to(torch.int32),
                      pool_seg)


def _paged_write_all(cache: PagedKVCache, staged, step: _PagedStep):
    """Write every layer's staged chunk (k, v [B, T, Hkv, D] in the pool's
    dtype, and for an int8 pool their scales [B, T, Hkv]) into the pool, one
    ``index_copy_`` per tensor for all layers: the deferred write of the JAX
    package. Nothing reads these rows before the next call: each layer
    attends its own chunk directly."""
    L, Np1 = cache.pool.shape[:2]
    P, Hkv, D = cache.page_size, cache.pool.shape[4], cache.pool.shape[5]
    dev = cache.pool.device
    layer = torch.arange(L, device=dev)[:, None] * (Np1 * 2 * P)
    rows = (layer + step.rows[None]).reshape(-1)
    flat = cache.pool.view(-1, Hkv * D)
    ks, vs, kss, vss = zip(*staged)
    flat.index_copy_(0, rows, torch.stack(ks).reshape(-1, Hkv * D))
    flat.index_copy_(0, rows + P, torch.stack(vs).reshape(-1, Hkv * D))
    if cache.quantized:
        layer = torch.arange(L, device=dev)[:, None, None] * (Np1 * 2 * Hkv * P)
        srows = (layer + step.srows[None]).reshape(-1)
        sflat = cache.scale_pool.view(-1)
        sflat.index_copy_(0, srows, torch.stack(kss).reshape(-1))
        sflat.index_copy_(0, srows + Hkv * P, torch.stack(vss).reshape(-1))


def _stage(cache: PagedKVCache, k, v):
    """A layer's chunk as the pool stores it (quantized here, per layer, as
    the JAX package does, so the staging is int8 with small scales)."""
    if cache.quantized:
        (qk, sk), (qv, sv) = _paged_quant(k), _paged_quant(v)
        return qk, qv, sk, sv
    return k.to(cache.pool.dtype), v.to(cache.pool.dtype), None, None


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: LlamaConfig, generator: torch.Generator, device,
                dtype=torch.bfloat16):
    """Random-normal init (scale 0.02) made directly on ``device``, shapes as
    in the JAX package. ``generator`` must live on ``device``."""
    D, Fd, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Hkv, Dh, L = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim, cfg.num_hidden_layers)

    def norm(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype).mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    params = {
        "embed_tokens": norm(V, D),
        "layers": {
            "attn": {
                "wq": norm(L, D, H * Dh), "wk": norm(L, D, Hkv * Dh),
                "wv": norm(L, D, Hkv * Dh), "wo": norm(L, H * Dh, D),
            },
            "mlp": {
                "w_gate": norm(L, D, Fd), "w_up": norm(L, D, Fd),
                "w_down": norm(L, Fd, D),
            },
            "input_norm": ones(L, D),
            "post_attn_norm": ones(L, D),
        },
        "final_norm": ones(D),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = norm(D, V)
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with f32 accumulation (HF LlamaRMSNorm)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling_type: Optional[str] = None,
                 scaling_factor: float = 1.0):
    """cos/sin tables [..., head_dim] for the given positions (rotate-half
    layout). "linear" divides positions by the factor; "dynamic" is the JAX
    package's static NTK rescaling of theta at the scaled target length."""
    pos = positions.float()
    if scaling_type == "linear":
        pos = pos / scaling_factor
    elif scaling_type == "dynamic":
        theta = theta * (
            scaling_factor * scaling_factor - scaling_factor + 1.0
        ) ** (head_dim / (head_dim - 2))
    elif scaling_type is not None:
        raise ValueError(f"unknown rope_scaling type: {scaling_type}")
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    freqs = pos[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, Dh]; cos/sin: [B, T, Dh]."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def embed_tokens(params, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings; negative ids (the image sentinel) read row 0, and
    the caller overwrites those positions with image features."""
    return params["embed_tokens"][input_ids.clamp_min(0)]


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _at(w, i: int):
    """Layer ``i`` of a stacked weight, plain or quantized (a dict of leaves)."""
    return {k: v[i] for k, v in w.items()} if isinstance(w, dict) else w[i]


def _layer(params, i: int):
    """Layer ``i``'s weights: the trainer's per-layer dict, or views into
    the stacked tensors."""
    lay = params["layers"]
    if isinstance(lay, list):
        return lay[i]
    return {
        "attn": {n: _at(w, i) for n, w in lay["attn"].items()},
        "mlp": {n: _at(w, i) for n, w in lay["mlp"].items()},
        "input_norm": lay["input_norm"][i],
        "post_attn_norm": lay["post_attn_norm"][i],
    }


def _cached_attention(q, cache: KVCache, idx, segment_ids, positions,
                      alibi_slopes=None, sm_scale=None, bias=None):
    """Attention of one layer's queries over the cache (whose slots already
    hold this chunk's k/v): a chunk of up to ``MAX_TQ`` tokens at contiguous
    positions through the decode kernel, a longer one through the reference
    paths. MPT passes its ALiBi slopes and softmax scale:
    the decode kernel takes the slopes, the other paths the explicit bias
    over the cache slots (JAX ``mpt.py:169-190``); and, with a prefix-LM or
    sequence-id mask, that additive ``bias`` over the slots, which only the
    reference paths take."""
    ks = None if cache.k_scale is None else cache.k_scale[idx]
    vs = None if cache.v_scale is None else cache.v_scale[idx]
    if q.shape[1] <= MAX_TQ and bias is None:
        # token t of the chunk sits at positions[:, 0] + t (decode and verify
        # chunks are contiguous)
        return decode_attention(q, cache.k[idx], cache.v[idx], cache.seg,
                                positions[:, 0].to(torch.int32).contiguous(), ks, vs,
                                sm_scale=sm_scale, alibi_slopes=alibi_slopes)
    if ks is not None:
        if alibi_slopes is not None:
            B, S = cache.seg.shape
            extra = alibi_bias(alibi_slopes, positions,
                               torch.arange(S, device=q.device).expand(B, S))
            bias = extra if bias is None else extra + bias
        return quant_cache_attention(q, cache.k[idx], ks, cache.v[idx], vs,
                                     kv_segment_ids=cache.seg, q_positions=positions,
                                     bias=bias, softmax_scale=sm_scale)
    return reference_attention(q, cache.k[idx], cache.v[idx],
                               causal=True, bias=bias, q_segment_ids=segment_ids,
                               kv_segment_ids=cache.seg, q_positions=positions,
                               softmax_scale=sm_scale, alibi_slopes=alibi_slopes)


def _paged_layer_attention(q, k_cur, v_cur, cache: PagedKVCache, idx: int,
                           step: _PagedStep, segment_ids, positions, gather: bool,
                           alibi_slopes=None, sm_scale=None):
    """One layer's attention over the paged pool (past tokens only) and the
    current chunk ``k_cur`` / ``v_cur``, which is written after the layer
    loop. A chunk of up to ``MAX_CHUNK`` tokens (contiguous positions from
    ``past_len``, a valid prefix) goes through ``paged_decode_attention``,
    reading the layer's pool in place through the page table; a longer one,
    or any chunk with ``gather``, through the gathered pages and the
    reference attention, as the JAX package's generic path does. MPT passes
    its ALiBi slopes and softmax scale; on the gather path the ALiBi bias
    is taken over the explicit q / kv positions (JAX ``llama.py:484-490``)."""
    kv = cache.pool[idx]
    ks = None if cache.scale_pool is None else cache.scale_pool[idx]
    if q.shape[1] <= MAX_CHUNK and not gather:
        return paged_decode_attention(q, kv, cache.page_table, step.past_len, ks,
                                      k_cur, v_cur, step.cur_valid, sm_scale=sm_scale,
                                      alibi_slopes=alibi_slopes)
    k, v = gather_pages(kv, cache.page_table, ks)
    B, S = k.shape[:2]
    k = torch.cat([k.to(q.dtype), k_cur.to(q.dtype)], dim=1)
    v = torch.cat([v.to(q.dtype), v_cur.to(q.dtype)], dim=1)
    # The pool holds past tokens only; entries at positions >= past_len (a
    # rejected chunk's writes) stay masked so nothing is counted twice.
    kv_seg = torch.cat([step.pool_seg, segment_ids.to(torch.int32)], dim=1)
    kv_positions = torch.cat([
        torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S),
        positions.to(torch.int32)], dim=1)
    return attention(q, k, v, causal=True, q_segment_ids=segment_ids,
                     kv_segment_ids=kv_seg, q_positions=positions,
                     kv_positions=kv_positions, softmax_scale=sm_scale,
                     alibi_slopes=alibi_slopes)


def _layer_forward(lp, h, cos, sin, segment_ids, positions, cfg: LlamaConfig,
                   cache, idx: int, sel, fresh_prefill: bool, paged_gather: bool):
    """One decoder layer. Returns (h, staged): ``staged`` is the layer's
    chunk as a paged pool stores it (None for the dense cache, which is
    written here)."""
    B, T, _ = h.shape
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    hn = rms_norm(h, lp["input_norm"], cfg.rms_norm_eps)
    wa = lp["attn"]
    if "wqkv" in wa:
        # inference-fused projection (quant.fuse_llama_matrices): one launch
        q, k, v = torch.split(matmul(hn, wa["wqkv"]), [H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    else:
        q, k, v = matmul(hn, wa["wq"]), matmul(hn, wa["wk"]), matmul(hn, wa["wv"])
    q = q.reshape(B, T, H, Dh)
    k = k.reshape(B, T, Hkv, Dh)
    v = v.reshape(B, T, Hkv, Dh).contiguous()  # the fused split leaves a strided view
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    paged = isinstance(cache, PagedKVCache)
    staged = None
    if cache is not None and not paged:
        _cache_write(cache.k, cache.k_scale, k, idx, sel)
        _cache_write(cache.v, cache.v_scale, v, idx, sel)
    if cache is None or (fresh_prefill and T > 1):
        # Without a cache, or at a stream's first prefill (the cache holds
        # only this chunk), attention over the local q/k/v is exact and
        # flash-eligible.
        attn_out = attention(q, k, v, causal=True,
                             q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
    elif paged:
        attn_out = _paged_layer_attention(q, k, v, cache, idx, sel, segment_ids,
                                          positions, paged_gather)
    else:
        attn_out = _cached_attention(q, cache, idx, segment_ids, positions)
    if paged:
        staged = _stage(cache, k, v)

    h = h + matmul(attn_out.reshape(B, T, H * Dh), wa["wo"])
    hn = rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps)
    wm = lp["mlp"]
    if "w_gateup" in wm:
        # inference-fused gate|up projection: one launch
        gate, up = torch.split(matmul(hn, wm["w_gateup"]), [cfg.intermediate_size] * 2, dim=-1)
    else:
        gate, up = matmul(hn, wm["w_gate"]), matmul(hn, wm["w_up"])
    gate = F.silu(gate.float()).to(hn.dtype)
    return h + matmul(gate * up, wm["w_down"]), staged


def _train_layer(lp, h, cos, sin, segment_ids, cfg: LlamaConfig):
    """One layer without a cache: the body that remat recomputes."""
    return _layer_forward(lp, h, cos, sin, segment_ids, None, cfg, None, 0, None,
                          False, False)[0]


Cache = Union[KVCache, PagedKVCache]


def cache_selection(cache: Optional[Cache], positions, segment_ids):
    """What a call's layers share about the cache: None without one, the
    paged addressing (:func:`_paged_step`) or the dense write slots
    (:func:`_write_slots`), with the chunk's segment ids already written."""
    if cache is None:
        return None
    if isinstance(cache, PagedKVCache):
        return _paged_step(cache, positions, segment_ids)
    return _write_slots(cache, positions, segment_ids)


def decoder_forward(
    params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    *,
    positions: torch.Tensor,
    segment_ids: torch.Tensor,
    cache: Optional[Cache] = None,
    fresh_prefill: bool = False,
    paged_gather: bool = False,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Run the decoder stack; returns (hidden_states, cache), the cache
    updated in place.

    positions [B, T]: absolute positions (RoPE and cache slots);
    segment_ids [B, T]: 0 = padding, >0 real tokens. ``fresh_prefill=True``
    asserts the cache is empty before the call. ``paged_gather`` sends every
    chunk over a paged cache through the gathered pages (the engine's suffix
    prefill, as the JAX package forces ``attn_impl="xla"`` there).
    ``remat`` (without a cache) keeps only each layer's input for the
    backward and recomputes the layer there.
    """
    h = inputs_embeds
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling_type, cfg.rope_scaling_factor)
    paged = isinstance(cache, PagedKVCache)
    sel = cache_selection(cache, positions, segment_ids)
    staged = []
    for i in range(cfg.num_hidden_layers):
        if remat and cache is None:
            h = checkpoint(_train_layer, _layer(params, i), h, cos, sin, segment_ids, cfg,
                           use_reentrant=False)
            continue
        h, st = _layer_forward(_layer(params, i), h, cos, sin, segment_ids, positions,
                               cfg, cache, i, sel, fresh_prefill, paged_gather)
        staged.append(st)
    if paged:
        _paged_write_all(cache, staged, sel)
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps), cache


class _Head(torch.autograd.Function):
    """f32 logits of ``h @ w``; the backward rounds the f32 cotangent to the
    operands' dtype and runs its products in it (bf16 on the card), as JAX's
    dot transpose casts the cotangent back at this boundary. No f32 copy of
    the weight or of the activations is made for the backward."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.is_cuda:
            return torch.mm(h, w, out_dtype=torch.float32)
        return h.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        dh = g @ w.T if ctx.needs_input_grad[0] else None
        dw = h.T @ g if ctx.needs_input_grad[1] else None
        return dh, dw


def lm_head(params, cfg: LlamaConfig, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits: the products of the (bf16) operands summed and kept in
    f32, as the JAX package's ``preferred_element_type=f32`` asks. On the
    card the GEMM takes the bf16 operands and writes f32, with no copy of the
    weight; the CPU has no mixed-dtype product, so there both are upcast. A
    quantized head writes f32 straight from the kernel's f32 accumulator
    (the JAX package rounds the product to the activation dtype first)."""
    w = params["embed_tokens"].T if cfg.tie_word_embeddings else params["lm_head"]
    if is_quantized(w):
        return matmul(hidden, w, out_dtype=torch.float32)
    logits = _Head.apply(hidden.reshape(-1, hidden.shape[-1]), w)
    return logits.reshape(*hidden.shape[:-1], w.shape[1])


def forward(
    params,
    cfg: LlamaConfig,
    input_ids: Optional[torch.Tensor] = None,
    *,
    inputs_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
    fresh_prefill: bool = False,
    logits_positions: Optional[torch.Tensor] = None,
    paged_gather: bool = False,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """ids/embeds -> f32 logits [B, T, V] (or [B, 1, V] at
    ``logits_positions`` [B]), and the cache updated in place."""
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids)
    B, T = inputs_embeds.shape[:2]
    device = inputs_embeds.device
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=device).expand(B, T)
    if segment_ids is None:
        segment_ids = torch.ones(B, T, dtype=torch.int32, device=device)
    h, cache = decoder_forward(params, cfg, inputs_embeds, positions=positions,
                               segment_ids=segment_ids, cache=cache,
                               fresh_prefill=fresh_prefill, paged_gather=paged_gather,
                               remat=remat)
    if logits_positions is not None:
        h = h[torch.arange(B, device=device), logits_positions][:, None]
    return lm_head(params, cfg, h), cache
