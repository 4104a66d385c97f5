"""LLaMA/Vicuna decoder in PyTorch, dense KV cache.

Counterpart of ``llava_plus_tpu/models/llama.py``: plain functions over the
same parameter tree (stacked per-layer weights ``[L, in, out]``, ``x @ w``),
explicit ``positions`` and ``segment_ids``, so prefill, padded batches and
cache decode share one code path. Layers run as a Python loop.

Attention: a fresh prefill attends over its own chunk through
:func:`ops.attention.attention` (the flash kernel on the card); a one-token
decode step goes through :func:`ops.decode_attention.decode_attention`,
which reads the cache in place (the kernel on the card, its plain version on
the CPU); any other cached chunk uses the reference attention.

Projections go through :func:`ops.quant.matmul`, so a weight may be a bf16
tensor or an int8 / int4 dict (``ops/quant.py``, the kernels of
``ops/quant_matmul.py`` on the card), unfused or fused (``wqkv``,
``w_gateup``) as ``quant.fuse_llama_matrices`` leaves it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from llava_plus_torch.models.configs import LlamaConfig
from llava_plus_torch.ops.attention import (
    attention, quant_cache_attention, reference_attention,
)
from llava_plus_torch.ops.decode_attention import decode_attention
from llava_plus_torch.ops.quant import is_quantized, matmul


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

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
    def create(cls, cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, max_len,
                 cfg.num_key_value_heads, cfg.head_dim)
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
    [..., 1])."""
    nf = new.float()
    scale = nf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(nf / scale), -127, 127).to(torch.int8)
    return q, scale


class _Step(NamedTuple):
    """The slots of a one-token step: row b writes flat slot ``b * S + pos``;
    rows with ``keep`` False write their slot's own contents back."""

    flat: torch.Tensor
    keep: torch.Tensor


def _put_rows(buf: torch.Tensor, step: _Step, vals: torch.Tensor):
    """buf [B, S, ...] <- vals [B, ...], one row each, at ``step``'s slots."""
    rows = buf.view(-1, *buf.shape[2:])
    keep = step.keep.view(-1, *[1] * (vals.dim() - 1))
    rows.index_copy_(0, step.flat, torch.where(keep, vals, rows.index_select(0, step.flat)))


def _write_slots(cache: KVCache, positions, segment_ids):
    """The cache slots a call writes, with their segment ids already
    written. Tokens at positions >= max_len (padding rows; engine slots that
    are idle or past their budget) are left out, as the JAX package's
    dropping scatter leaves them out.

    A one-token step (decode) returns a :class:`_Step`: such a row is clamped
    onto its last slot and writes that slot's own contents back, which needs
    no host sync and one flat index for every layer. A longer chunk returns
    ``(b, t, pos)``, its in-range tokens selected with ``nonzero``."""
    B, T = positions.shape
    S = cache.max_len
    if T == 1:
        step = _Step(torch.arange(B, device=positions.device) * S
                     + positions[:, 0].clamp(max=S - 1), positions[:, 0] < S)
        _put_rows(cache.seg, step, segment_ids[:, 0].to(torch.int32))
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
    vals = new[:, 0] if step else new[sel[0], sel[1]]
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
    """Layer ``i``'s weights: views into the stacked tensors."""
    lay = params["layers"]
    return {
        "attn": {n: _at(w, i) for n, w in lay["attn"].items()},
        "mlp": {n: _at(w, i) for n, w in lay["mlp"].items()},
        "input_norm": lay["input_norm"][i],
        "post_attn_norm": lay["post_attn_norm"][i],
    }


def _cached_attention(q, cache: KVCache, idx, segment_ids, positions):
    """Attention of one layer's queries over the cache (whose slots already
    hold this chunk's k/v)."""
    ks = None if cache.k_scale is None else cache.k_scale[idx]
    vs = None if cache.v_scale is None else cache.v_scale[idx]
    if q.shape[1] == 1:
        return decode_attention(q, cache.k[idx], cache.v[idx], cache.seg,
                                positions[:, 0].to(torch.int32), ks, vs)
    if ks is not None:
        return quant_cache_attention(q, cache.k[idx], ks, cache.v[idx], vs,
                                     kv_segment_ids=cache.seg,
                                     q_positions=positions)
    return reference_attention(q, cache.k[idx], cache.v[idx],
                               causal=True, q_segment_ids=segment_ids,
                               kv_segment_ids=cache.seg, q_positions=positions)


def _layer_forward(lp, h, cos, sin, segment_ids, positions, cfg: LlamaConfig,
                   cache: Optional[KVCache], idx: int, sel, fresh_prefill: bool):
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

    if cache is not None:
        _cache_write(cache.k, cache.k_scale, k, idx, sel)
        _cache_write(cache.v, cache.v_scale, v, idx, sel)
    if cache is None or (fresh_prefill and T > 1):
        # Without a cache, or at a stream's first prefill (the cache holds
        # only this chunk), attention over the local q/k/v is exact and
        # flash-eligible.
        attn_out = attention(q, k, v, causal=True,
                             q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
    else:
        attn_out = _cached_attention(q, cache, idx, segment_ids, positions)

    h = h + matmul(attn_out.reshape(B, T, H * Dh), wa["wo"])
    hn = rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps)
    wm = lp["mlp"]
    if "w_gateup" in wm:
        # inference-fused gate|up projection: one launch
        gate, up = torch.split(matmul(hn, wm["w_gateup"]), [cfg.intermediate_size] * 2, dim=-1)
    else:
        gate, up = matmul(hn, wm["w_gate"]), matmul(hn, wm["w_up"])
    gate = F.silu(gate.float()).to(hn.dtype)
    return h + matmul(gate * up, wm["w_down"])


def decoder_forward(
    params,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,
    *,
    positions: torch.Tensor,
    segment_ids: torch.Tensor,
    cache: Optional[KVCache] = None,
    fresh_prefill: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack; returns (hidden_states, cache), the cache
    updated in place.

    positions [B, T]: absolute positions (RoPE and cache slots);
    segment_ids [B, T]: 0 = padding, >0 real tokens. ``fresh_prefill=True``
    asserts the cache is empty before the call.
    """
    h = inputs_embeds
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling_type, cfg.rope_scaling_factor)
    sel = None if cache is None else _write_slots(cache, positions, segment_ids)
    for i in range(cfg.num_hidden_layers):
        h = _layer_forward(_layer(params, i), h, cos, sin, segment_ids,
                           positions, cfg, cache, i, sel, fresh_prefill)
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps), cache


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
    h = hidden.reshape(-1, hidden.shape[-1])
    if h.is_cuda:
        logits = torch.mm(h, w, out_dtype=torch.float32)
    else:
        logits = h.float() @ w.float()
    return logits.reshape(*hidden.shape[:-1], w.shape[1])


def forward(
    params,
    cfg: LlamaConfig,
    input_ids: Optional[torch.Tensor] = None,
    *,
    inputs_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    cache: Optional[KVCache] = None,
    fresh_prefill: bool = False,
    logits_positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
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
                               fresh_prefill=fresh_prefill)
    if logits_positions is not None:
        h = h[torch.arange(B, device=device), logits_positions][:, None]
    return lm_head(params, cfg, h), cache
