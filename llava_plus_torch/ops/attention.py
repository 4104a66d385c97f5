"""Attention entry point: the plain reference and the dispatch to the kernel.

Counterpart of ``llava_plus_tpu/ops/attention.py``. Layout: q [B, Tq, H, D];
k, v [B, Tkv, Hkv, D] with H % Hkv == 0 (GQA/MQA). All masking is expressed
through segment ids (0 = padding), causal masking by absolute position, and
an optional additive bias, with the finite mask value ``-0.7 * f32 max`` so a
fully masked row averages instead of producing NaN.

ALiBi (the MPT backbone) comes in as per-head f32 slopes: the bias
``-slope_h * |q_pos - kv_pos|`` over the positions the causal mask uses (the
JAX package's ``alibi_bias_from_positions``). The JAX package builds that
bias as a dense array and sends every biased call to XLA; the port keeps the
slopes, so the kernels can compute the bias themselves.
"""

from __future__ import annotations

from typing import Optional

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def check_slopes(slopes: Optional[torch.Tensor], H: int, device) -> None:
    """Raise unless ``slopes`` is None or a contiguous f32 [H] on ``device``,
    as every ALiBi entry point (the kernels and their plain versions) takes
    them."""
    if slopes is None:
        return
    if (slopes.dtype != torch.float32 or slopes.shape != (H,) or slopes.device != device
            or not slopes.is_contiguous()):
        raise ValueError(f"ALiBi slopes must be a contiguous f32 [{H}] on {device}, got "
                         f"{slopes.dtype} {tuple(slopes.shape)} on {slopes.device}")


def alibi_bias(slopes: torch.Tensor, q_pos: torch.Tensor, kv_pos: torch.Tensor) -> torch.Tensor:
    """[B, H, Tq, Tkv] f32 bias ``-|q_pos - kv_pos| * slope_h`` for q_pos
    [B, Tq] and kv_pos [B, Tkv] (the JAX ``alibi_bias_from_positions``)."""
    dist = (q_pos[:, :, None] - kv_pos[:, None, :]).float()
    return -dist.abs()[:, None] * slopes.float()[None, :, None, None]


def _default_positions(B, Tq, Tkv, q_positions, kv_positions, device):
    """The positions the masks assume: queries suffix-aligned to the kv
    sequence, kv slot == position."""
    if q_positions is None:
        q_positions = (torch.arange(Tq, device=device) + (Tkv - Tq)).expand(B, Tq)
    if kv_positions is None:
        kv_positions = torch.arange(Tkv, device=device).expand(B, Tkv)
    return q_positions, kv_positions


def _causal_mask(B, Tq, Tkv, q_positions, kv_positions, device):
    """[B or 1, 1, Tq, Tkv] bool: kv position <= q position."""
    if kv_positions is not None:
        qp = q_positions
        if qp is None:
            qp = torch.arange(Tq, device=device).expand(B, Tq) + (Tkv - Tq)
        return (kv_positions[:, None, :] <= qp[:, :, None])[:, None]
    kv_pos = torch.arange(Tkv, device=device)
    if q_positions is not None:
        return (kv_pos[None, None, :] <= q_positions[:, :, None])[:, None]
    q_pos = torch.arange(Tq, device=device)[:, None] + (Tkv - Tq)
    return (kv_pos[None, :] <= q_pos)[None, None]


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    bias: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention with f32 softmax (the JAX package's ``xla_attention``).

    ``q_positions`` [B, Tq]: absolute position of each query within the kv
    sequence (kv slot == kv position); defaults to suffix alignment.
    ``kv_positions`` [B, Tkv]: absolute position of each kv entry; defaults
    to its slot index. ``alibi_slopes`` [H] adds :func:`alibi_bias` over
    those positions (before ``bias``, as the JAX package sums them).
    """
    B, Tq, H, D = q.shape
    Tkv, Hkv = k.shape[1], k.shape[2]
    assert H % Hkv == 0, (H, Hkv)
    groups = H // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5

    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    if groups > 1:
        qf = qf.reshape(B, Tq, Hkv, groups, D)
        logits = torch.einsum("btkgd,bskd->bkgts", qf, kf).reshape(B, H, Tq, Tkv)
    else:
        logits = torch.einsum("bthd,bshd->bhts", qf, kf)
    if alibi_slopes is not None:
        check_slopes(alibi_slopes, H, q.device)
        qp, kp = _default_positions(B, Tq, Tkv, q_positions, kv_positions, q.device)
        extra = alibi_bias(alibi_slopes, qp, kp)
        bias = extra if bias is None else extra + bias.float()
    if bias is not None:
        logits = logits + bias.float()

    mask = None
    if causal:
        mask = _causal_mask(B, Tq, Tkv, q_positions, kv_positions, q.device)
    if q_segment_ids is not None or kv_segment_ids is not None:
        assert q_segment_ids is not None and kv_segment_ids is not None
        seg = ((q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
               & (kv_segment_ids[:, None, :] != 0))[:, None]
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)

    probs = torch.softmax(logits, dim=-1)
    if groups > 1:
        probs = probs.reshape(B, Hkv, groups, Tq, Tkv)
        out = torch.einsum("bkgts,bskd->btkgd", probs, vf).reshape(B, Tq, H, D)
    else:
        out = torch.einsum("bhts,bshd->bthd", probs, vf)
    return out.to(q.dtype)


def quant_cache_attention(
    q: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    *,
    kv_segment_ids: torch.Tensor,
    q_positions: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over an int8 cache with the scales folded in: the k scale
    multiplies the scores, the v scale the probabilities (same math as
    dequantizing first, reassociated).

    q [B, Tq, H, D]; kq/vq int8 [B, S, Hkv, D]; ks/vs f32 [B, S, Hkv, 1];
    ``q_positions`` [B, Tq] absolute positions (cache slot == position);
    ``bias`` [B or 1, H, Tq, S] additive (MPT's ALiBi). As in the JAX
    version, the probabilities are rounded to q's dtype before the value
    product, and the products are summed in f32.
    """
    B, Tq, H, D = q.shape
    S, Hkv = kq.shape[1], kq.shape[2]
    assert H % Hkv == 0, (H, Hkv)
    groups = H // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5

    kb = kq.float()
    kscale = ks[..., 0].permute(0, 2, 1)                 # [B, Hkv, S]
    qg = q.float().reshape(B, Tq, Hkv, groups, D)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, kb)   # [B, Hkv, G, Tq, S]
    logits = (logits * (kscale * scale)[:, :, None, None, :]).reshape(B, H, Tq, S)
    if bias is not None:
        logits = logits + bias.float()

    kv_pos = torch.arange(S, device=q.device)
    mask = (kv_pos[None, None, :] <= q_positions[:, :, None])[:, None]
    mask = mask & (kv_segment_ids != 0)[:, None, None, :]
    logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)

    vscale = vs[..., 0].permute(0, 2, 1)                 # [B, Hkv, S]
    pg = probs.reshape(B, Hkv, groups, Tq, S) * vscale[:, :, None, None, :]
    pg = pg.to(q.dtype).float()
    out = torch.einsum("bkgts,bskd->btkgd", pg, vq.float())
    return out.reshape(B, Tq, H, D).to(q.dtype)


def _is_flash_call(q, k, bias, q_positions, kv_positions) -> bool:
    """Self-attention over one chunk (Tq == Tkv, slot == position) with no
    additive bias (ALiBi slopes are no bias here: the kernel takes them):
    the call the flash kernel computes, at any length."""
    return (bias is None and q_positions is None and kv_positions is None
            and q.shape[1] == k.shape[1])


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    bias: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatching attention. On CUDA tensors a self-attention call (the
    prefill's and the training forward's, with or without ALiBi slopes)
    always runs the flash kernel, which raises for inputs it does not take
    (head dim other than 128, dtype other than bf16); its output carries a
    gradient through the backward kernels (``flash_attention``'s
    ``autograd.Function``, ALiBi included). Calls with an additive bias
    (MPT's prefix-LM and sequence-id masks) or explicit positions, and every
    call on the CPU, take the reference, as the JAX package sends them to
    XLA."""
    if q.is_cuda and _is_flash_call(q, k, bias, q_positions, kv_positions):
        from llava_plus_torch.ops.flash_attention import flash_attention

        out, _ = flash_attention(
            q, k, v, causal=causal,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            softmax_scale=softmax_scale, alibi_slopes=alibi_slopes,
        )
        return out
    return reference_attention(
        q, k, v, causal=causal, bias=bias,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        q_positions=q_positions, kv_positions=kv_positions,
        softmax_scale=softmax_scale, alibi_slopes=alibi_slopes,
    )
