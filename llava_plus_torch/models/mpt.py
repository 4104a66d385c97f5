"""MPT decoder in PyTorch, dense or paged KV cache.

Counterpart of ``llava_plus_tpu/models/mpt.py`` (the vendored reference MPT
of ``llava/model/language_model/mpt/``): ALiBi or learned positions, MQA
(``multiquery``), prefix-LM and ``sequence_id`` attention restriction,
optional qk-LayerNorm and qkv clamp. Same parameter tree as the JAX package:
stacked per-layer weights ``[L, in, out]`` (``x @ w``), ``wqkv`` one matrix
(q | k | v along its output), the head tied to ``wte``. Layers run as a
Python loop and share the LLaMA decoder's caches (``models/llama.py``:
:class:`KVCache`, :class:`PagedKVCache`, their writes and the deferred paged
write).

ALiBi stays per-head slopes here, where the JAX package builds a dense
``[B, H, Tq, S]`` bias for XLA: the bias ``-slope_h * |q_pos - kv_pos|`` is
translation-invariant, so the kernels compute it from their own token
indices. Attention, by path:

- no cache, or a fresh prefill (``fresh_prefill``, T > 1): the chunk's own
  q/k/v through :func:`ops.attention.attention`, the flash kernel's ALiBi
  variant on the card. (The JAX ``llava.forward`` passes no
  ``fresh_prefill`` to MPT, so its prefill attends over the bucket-sized
  cache that holds only this chunk: the same function, except that over an
  int8 cache JAX attends the chunk's quantized copy and the port, as on its
  LLaMA path, the chunk itself.)
- a dense cache, up to 8 tokens (a decode or a speculative verify step):
  the decode kernel with slopes (any number of query heads per kv head);
  longer chunks: the reference attention (``quant_cache_attention`` over an
  int8 cache) with the explicit ALiBi bias, as the JAX package does.
- a paged cache: ``llama._paged_layer_attention`` with slopes (the paged
  kernels for chunks of up to 8 tokens, the gathered pages above).

The prefix-LM and sequence-id masks are an additive bias that no kernel
takes: they go through the reference attention, as the JAX package sends
them to XLA. Without a cache the bias spans the chunk's positions; over the
dense cache it spans the cache's slots (``arange(max_len)``, JAX
``mpt.py:266``), with JAX's broadcasting, so it is defined where JAX defines
it (a chunk as long as the cache, or one token). Over a paged cache they
raise: JAX builds no such bias over the pool (its paged attention drops it).

Training runs through the same code without a cache: on the card the ALiBi
variants of the flash forward and backward kernels, and ``remat`` recomputes
each layer in the backward (``torch.utils.checkpoint``, as ``llama.py``
does). The trainer holds the layers as a list of per-layer dicts
(``models/convert.py:per_layer``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from llava_plus_torch.models import llama
from llava_plus_torch.models.configs import MptConfig
from llava_plus_torch.models.llama import Cache, KVCache, PagedKVCache
from llava_plus_torch.ops.attention import alibi_bias, attention
from llava_plus_torch.ops.quant import matmul

MASK_BIAS = -1e9  # the JAX package's additive mask of the prefix-LM / sequence-id bias


def alibi_slopes(n_heads: int, alibi_bias_max: int = 8, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes [H] f32 (ref mpt/attention.py:284-291): for a
    head count that is not a power of two, the odd then the even slopes of
    the next power of two, cut to ``n_heads``."""
    n2 = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, n2 + 1, dtype=torch.float32) * (alibi_bias_max / n2)
    slopes = 1.0 / torch.pow(2.0, m)
    if n2 != n_heads:
        slopes = torch.cat([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes.to(device)


@functools.lru_cache(maxsize=None)
def _device_slopes(n_heads: int, alibi_bias_max: int, device: torch.device) -> torch.Tensor:
    """:func:`alibi_slopes` made once per device: a forward then issues no
    host-to-device copy (a pageable one would hold the host until the card
    reaches it, every decode step). Every caller gets the same tensor, which
    nothing writes to. It is made outside inference mode even when the
    first caller serves, so that training (remat saves it) can use it too."""
    with torch.inference_mode(False):
        return alibi_slopes(n_heads, alibi_bias_max, device)


def alibi_bias_from_positions(q_pos: torch.Tensor, kv_pos: torch.Tensor, n_heads: int,
                              alibi_bias_max: int = 8) -> torch.Tensor:
    """bias[b, h, tq, tkv] = -slope_h * |q_pos - kv_pos| (f32)."""
    return alibi_bias(alibi_slopes(n_heads, alibi_bias_max, q_pos.device), q_pos, kv_pos)


def init_params(cfg: MptConfig, generator: torch.Generator, device, dtype=torch.bfloat16):
    """Random-normal init (scale 0.02; norms at 1) made directly on
    ``device``, shapes as in the JAX package. ``generator`` must live on
    ``device``."""
    D, L = cfg.d_model, cfg.n_layers
    Fd = cfg.expansion_ratio * D
    kv_dim = cfg.kv_heads * cfg.head_dim

    def norm(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    layers = {
        "norm1": ones(L, D),
        "norm2": ones(L, D),
        "attn": {"wqkv": norm(L, D, D + 2 * kv_dim), "out_proj": norm(L, D, D)},
        "mlp": {"up_proj": norm(L, D, Fd), "down_proj": norm(L, Fd, D)},
    }
    if cfg.qk_ln:
        layers["q_ln"] = ones(L, D)
        layers["k_ln"] = ones(L, kv_dim)
    params = {"wte": norm(cfg.vocab_size, D), "layers": layers, "norm_f": ones(D)}
    if cfg.learned_pos_emb and not cfg.alibi:
        params["wpe"] = norm(cfg.max_seq_len, D)
    return params


def layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without a bias, in f32 (population variance)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def embed_tokens(params, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings; negative ids (the image sentinel) read row 0."""
    return params["wte"][input_ids.clamp_min(0)]


def _layer(params, i: int):
    """Layer ``i``'s weights: the trainer's per-layer dict, or views into
    the stacked tensors."""
    lay = params["layers"]
    if isinstance(lay, list):
        return lay[i]
    out = {
        "attn": {n: llama._at(w, i) for n, w in lay["attn"].items()},
        "mlp": {n: llama._at(w, i) for n, w in lay["mlp"].items()},
    }
    for name in ("norm1", "norm2", "q_ln", "k_ln"):
        if name in lay:
            out[name] = lay[name][i]
    return out


def _layer_forward(lp, h, bias, slopes, segment_ids, positions, cfg: MptConfig,
                   cache: Optional[Cache], idx: int, sel, fresh_prefill: bool,
                   paged_gather: bool):
    """One decoder block. Returns (h, staged): ``staged`` is the layer's
    chunk as a paged pool stores it (None otherwise)."""
    B, T, D = h.shape
    H, Hkv, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    kv_dim = Hkv * Dh
    eps = cfg.layer_norm_eps
    scale = cfg.softmax_scale or Dh ** -0.5

    hn = layer_norm(h, lp["norm1"], eps)
    qkv = matmul(hn, lp["attn"]["wqkv"])
    if cfg.clip_qkv:
        qkv = qkv.clamp(-cfg.clip_qkv, cfg.clip_qkv)
    q, k, v = torch.split(qkv, [D, kv_dim, kv_dim], dim=-1)
    if cfg.qk_ln:
        q = layer_norm(q, lp["q_ln"], eps)
        k = layer_norm(k, lp["k_ln"], eps)
    q = q.reshape(B, T, H, Dh)
    # the kernels take k and v with equal strides; the split leaves views
    k = k.reshape(B, T, Hkv, Dh).contiguous()
    v = v.reshape(B, T, Hkv, Dh).contiguous()

    paged = isinstance(cache, PagedKVCache)
    if cache is not None and not paged:
        llama._cache_write(cache.k, cache.k_scale, k, idx, sel)
        llama._cache_write(cache.v, cache.v_scale, v, idx, sel)
    if cache is None or (fresh_prefill and T > 1 and bias is None):
        # prefix-LM without a cache is bidirectional up to its bias
        attn_out = attention(q, k, v, causal=cache is not None or not cfg.prefix_lm,
                             bias=bias, q_segment_ids=segment_ids,
                             kv_segment_ids=segment_ids, softmax_scale=scale,
                             alibi_slopes=slopes)
    elif paged:
        attn_out = llama._paged_layer_attention(q, k, v, cache, idx, sel, segment_ids,
                                                positions, paged_gather,
                                                alibi_slopes=slopes, sm_scale=scale)
    else:
        attn_out = llama._cached_attention(q, cache, idx, segment_ids, positions,
                                           alibi_slopes=slopes, sm_scale=scale, bias=bias)
    staged = llama._stage(cache, k, v) if paged else None

    h = h + matmul(attn_out.reshape(B, T, D), lp["attn"]["out_proj"])
    hn = layer_norm(h, lp["norm2"], eps)
    inner = F.gelu(matmul(hn, lp["mlp"]["up_proj"]).float())   # exact (erf) GELU
    return h + matmul(inner.to(hn.dtype), lp["mlp"]["down_proj"]), staged


def _train_layer(lp, h, bias, slopes, segment_ids, cfg: MptConfig):
    """One layer without a cache: the body that remat recomputes."""
    return _layer_forward(lp, h, bias, slopes, segment_ids, None, cfg, None, 0, None, False,
                          False)[0]


def _mask_bias(cfg: MptConfig, positions, kv_pos, prefix_mask, sequence_id):
    """The prefix-LM and sequence-id restrictions as one additive bias
    [B, 1, T, S] (0 visible, -1e9 hidden) over the keys at ``kv_pos`` [B, S],
    or None (JAX ``mpt.py:277-289``, broadcasting as it does)."""
    bias = None
    if cfg.prefix_lm and prefix_mask is not None:
        # visible where causal OR key in the prefix (ref modeling_mpt.py:119-131)
        causal_ok = kv_pos[:, None, :] <= positions[:, :, None]
        visible = causal_ok | prefix_mask[:, None, :].bool()
        bias = torch.where(visible, 0.0, MASK_BIAS)[:, None]
    if cfg.attn_uses_sequence_id and sequence_id is not None:
        same = sequence_id[:, :, None] == sequence_id[:, None, :]
        extra = torch.where(same, 0.0, MASK_BIAS)[:, None]
        bias = extra if bias is None else bias + extra
    return bias


def decoder_forward(
    params,
    cfg: MptConfig,
    inputs_embeds: torch.Tensor,
    *,
    positions: torch.Tensor,
    segment_ids: torch.Tensor,
    cache: Optional[Cache] = None,
    prefix_mask: Optional[torch.Tensor] = None,
    sequence_id: Optional[torch.Tensor] = None,
    fresh_prefill: bool = False,
    paged_gather: bool = False,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Run the decoder stack; returns (hidden_states, cache), the cache
    updated in place. Arguments as ``llama.decoder_forward``; ``prefix_mask``
    [B, T] (1 = prefix) and ``sequence_id`` [B, T] apply when the config
    asks for them, without a cache or over the dense one."""
    h = inputs_embeds
    B = h.shape[0]
    if cfg.learned_pos_emb and not cfg.alibi:
        # idle engine rows sit at max_len: clamp as a gather that drops nothing
        h = h + params["wpe"][positions.long().clamp(0, cfg.max_seq_len - 1)]
    slopes = _device_slopes(cfg.n_heads, cfg.alibi_bias_max, h.device) if cfg.alibi else None
    paged = isinstance(cache, PagedKVCache)
    kv_pos = positions
    if cache is not None and not paged:
        kv_pos = torch.arange(cache.max_len, device=h.device).expand(B, cache.max_len)
    masked = (cfg.prefix_lm and prefix_mask is not None) or (
        cfg.attn_uses_sequence_id and sequence_id is not None)
    if masked and paged:
        raise NotImplementedError("the prefix-LM / sequence-id bias over a paged cache: the "
                                  "JAX package defines none there")
    T = h.shape[1]
    if masked and cache is not None and T not in (1, cache.max_len):
        raise ValueError(f"a prefix-LM / sequence-id mask over a dense cache needs one token "
                         f"or a chunk of the cache's {cache.max_len} slots, got {T} (the "
                         f"JAX package's bias does not broadcast otherwise)")
    bias = _mask_bias(cfg, positions, kv_pos, prefix_mask, sequence_id)
    sel = llama.cache_selection(cache, positions, segment_ids)
    staged = []
    for i in range(cfg.n_layers):
        if remat and cache is None:
            h = checkpoint(_train_layer, _layer(params, i), h, bias, slopes, segment_ids, cfg,
                           use_reentrant=False)
            continue
        h, st = _layer_forward(_layer(params, i), h, bias, slopes, segment_ids, positions, cfg,
                               cache, i, sel, fresh_prefill, paged_gather)
        staged.append(st)
    if paged:
        llama._paged_write_all(cache, staged, sel)
    return layer_norm(h, params["norm_f"], cfg.layer_norm_eps), cache


def lm_head(params, cfg: MptConfig, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits of the head tied to ``wte`` (ref llava_mpt.py:79:
    ``F.linear(h, wte.weight)``), times ``logit_scale`` when set."""
    w = params["wte"].T
    logits = llama._Head.apply(hidden.reshape(-1, hidden.shape[-1]), w)
    logits = logits.reshape(*hidden.shape[:-1], w.shape[1])
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    return logits


def forward(
    params,
    cfg: MptConfig,
    input_ids: Optional[torch.Tensor] = None,
    *,
    inputs_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
    prefix_mask: Optional[torch.Tensor] = None,
    sequence_id: Optional[torch.Tensor] = None,
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
                               segment_ids=segment_ids, cache=cache, prefix_mask=prefix_mask,
                               sequence_id=sequence_id, fresh_prefill=fresh_prefill,
                               paged_gather=paged_gather, remat=remat)
    if logits_positions is not None:
        h = h[torch.arange(B, device=device), logits_positions][:, None]
    return lm_head(params, cfg, h), cache


def create_cache(cfg: MptConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
                 device) -> KVCache:
    """A dense cache (the LLaMA layout: [L, B, S, Hkv, Dh], int8 with scales
    for ``dtype=torch.int8``)."""
    return KVCache.create(cfg, batch, max_len, dtype, device=device)
