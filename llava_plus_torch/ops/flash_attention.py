"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward) and
``csrc/flash_bwd.cu`` (backward), their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Counterpart of ``llava_plus_tpu/ops/flash_attention.py``: the Pallas kernels
it replaces are ``_fwd_kernel``, ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``.
Inputs are [B, T, H, D], causal or not, with optional segment ids (0 =
padding). T is padded to the kernels' 64-row tile with segment 0, as
``_pad_inputs`` pads to the Pallas block. :func:`flash_attention` returns
the output [B, T, H, D], which carries a gradient, and the per-row
logsumexp [B, H, T] f32, which does not. The backward is recompute-free:
like the JAX ``custom_vjp`` it saves the padded q/k/v, segment ids, output
and lse, and replays the softmax from the lse (``_flash_bwd_rule``).

The kernels run for CUDA tensors (bf16, D = 128); the plain versions for
CPU tensors; anything else raises. Rows that see no valid key come out as
zeros from both (the reference attention gives them a uniform average
instead), and their gradients are zero.

ALiBi (MPT): ``alibi_slopes`` [H] f32 selects the ALiBi variants of the
forward and both backward kernels (the Pallas ``use_alibi`` branches), which
subtract ``slope_h * |i - j|`` from the scaled score of query row i and key
j. Their launches are counted apart, in ``<wrapper>.alibi_launches``.

Tiles: the forward takes 128 q rows a block (two warpgroups of 64) against
128-row K/V tiles; T % 128 may be 64, whose rows past T the
kernel neither reads nor writes. The dK/dV kernel takes 128 kv rows a block
(``DKV_TILE``) against 64-row Q/dO tiles; the dQ kernel 128 q rows a
block against 64-row K/V tiles, with dS entering dQ = dS K as two bf16
halves (hi = bf16(dS), lo = bf16(dS - hi)): ~16 bits of dS where the Pallas
kernel keeps 8 (a deliberate difference, toward the plain version). So the
wrapper pads T to ``BLOCK`` = 64. The dK/dV grid also splits
the G query heads of each kv head into ``dkv_head_splits(B, T, Hkv, G,
n_sms)`` contiguous ranges, one block each: 1 (no split, no workspace)
whenever the kv tiles alone give two blocks per SM, as every MHA call does;
otherwise the smallest divisor of G that does, capped at G (MQA at B = 2,
T = 2048, G = 32 on 132 SMs: 16). The split blocks write f32 partials to a
workspace [2, S, B, T, Hkv, D] and a second kernel adds them in order, so
the result stays deterministic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from llava_plus_torch.kernels import build
from llava_plus_torch.ops.attention import DEFAULT_MASK_VALUE, check_slopes

BLOCK = 64      # the padding of T: the backward's q tile
DKV_TILE = 128  # the dK/dV kernel's kv tile
HEAD_DIM = 128  # the kernels' only head dim


def dkv_head_splits(B: int, T: int, Hkv: int, G: int, n_sms: int) -> int:
    """How many contiguous ranges the dK/dV kernel splits the G query heads
    of a kv head into: 1 when the (T / DKV_TILE) * B * Hkv kv-tile blocks
    already give two blocks per SM, else the smallest divisor S of G whose
    S-fold grid does, G if none does."""
    blocks = -(-T // DKV_TILE) * B * Hkv
    for s in range(1, G + 1):
        if G % s == 0 and blocks * s >= 2 * n_sms:
            return s
    return G


def _pad_inputs(q, k, v, q_segment_ids, kv_segment_ids):
    """Pad T to a BLOCK multiple; padded rows get segment id 0. Always
    materializes segment ids (int32)."""
    B, T = q.shape[:2]
    pad = (-T) % BLOCK
    if q_segment_ids is None:
        q_segment_ids = torch.ones(B, T, dtype=torch.int32, device=q.device)
        kv_segment_ids = q_segment_ids
    q_segment_ids = q_segment_ids.to(torch.int32)
    kv_segment_ids = kv_segment_ids.to(torch.int32)
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        q_segment_ids = F.pad(q_segment_ids, (0, pad))
        kv_segment_ids = F.pad(kv_segment_ids, (0, pad))
    return q, k, v, q_segment_ids.contiguous(), kv_segment_ids.contiguous()


def flash_attention_reference(q, k, v, q_seg, kv_seg, *, causal: bool, sm_scale: float,
                              alibi_slopes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, in q's float precision
    (f32 for bf16 inputs). q [B, T, H, D]; k, v [B, T, Hkv, D]; segment ids
    [B, T]; ``alibi_slopes`` [H] or None. Masked probabilities are 0, a row
    with none valid outputs 0, and lse = m + log(l) with l taken as 1 where
    it is 0."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    acc_dtype = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(acc_dtype).permute(0, 2, 1, 3)                     # [B, H, T, D]
    kf = k.to(acc_dtype).permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1)
    vf = v.to(acc_dtype).permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale        # [B, H, T, T]
    pos = torch.arange(T, device=q.device)
    if alibi_slopes is not None:
        dist = (pos[:, None] - pos[None, :]).abs().to(acc_dtype)
        s = s - alibi_slopes.to(acc_dtype)[:, None, None] * dist
    mask = ((q_seg[:, :, None] == kv_seg[:, None, :])
            & (kv_seg[:, None, :] != 0))[:, None]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])[None, None]
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.matmul(p, vf) / l_safe                           # [B, H, T, D]
    lse = (m + torch.log(l_safe))[..., 0]                        # [B, H, T]
    return out.permute(0, 2, 1, 3).to(q.dtype), lse.to(acc_dtype)


def flash_attention_backward_reference(q, k, v, q_seg, kv_seg, out, lse, do, *,
                                       causal: bool, sm_scale: float, alibi_slopes=None):
    """The backward kernels' function in plain PyTorch, in q's float
    precision (f32 for bf16 inputs): the Pallas ``_bwd`` with the GQA fold
    of ``_flash_bwd_rule``. q, out, do [B, T, H, D]; k, v [B, T, Hkv, D];
    segment ids [B, T]; lse [B, H, T]; ``alibi_slopes`` [H] or None. P is
    replayed from lse (the scaled score less ``slope_h * |i - j|`` with
    slopes) and masked by select after the exp (causal, equal segments,
    neither segment 0), so a row that saw no key contributes nothing.
    Returns (dq, dk, dv) in q's dtype; dk and dv sum the G query heads of
    each kv head."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    acc_dtype = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(acc_dtype).permute(0, 2, 1, 3)                     # [B, H, T, D]
    kf = k.to(acc_dtype).permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vf = v.to(acc_dtype).permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    dof = do.to(acc_dtype).permute(0, 2, 1, 3)
    delta = (dof * out.to(acc_dtype).permute(0, 2, 1, 3)).sum(dim=-1)   # [B, H, T]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale        # [B, H, T, T]
    pos = torch.arange(T, device=q.device)
    if alibi_slopes is not None:
        dist = (pos[:, None] - pos[None, :]).abs().to(acc_dtype)
        s = s - alibi_slopes.to(acc_dtype)[:, None, None] * dist
    mask = ((q_seg[:, :, None] == kv_seg[:, None, :])
            & (kv_seg[:, None, :] != 0) & (q_seg[:, :, None] != 0))[:, None]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])[None, None]
    p = torch.where(mask, torch.exp(s - lse.to(acc_dtype)[..., None]), 0.0)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None]) * sm_scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dk = dk.reshape(B, Hkv, G, T, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, G, T, D).sum(dim=2)
    return tuple(x.permute(0, 2, 1, 3).to(q.dtype) for x in (dq, dk, dv))


def _check_kernel_inputs(q, k, v, seg):
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash kernel needs head dim {HEAD_DIM}, got {q.shape[-1]}")
    B, T, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != T or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over {k.shape[2]} kv heads")
    if k.stride() != v.stride():
        raise ValueError("k and v must share strides")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name}: last dim must be contiguous, rows 16-byte aligned")
        if not build.int32_offsets(x):
            raise ValueError(f"{name} is too large for 32-bit offsets")
    if seg.device != q.device:
        raise ValueError("segment ids must be on q's device")
    if seg.data_ptr() % 16:
        raise ValueError("segment ids must be 16-byte aligned (the kernels bulk-copy them)")


def _launch(q, k, v, q_seg, kv_seg, causal, sm_scale, slopes=None):
    _check_kernel_inputs(q, k, v, q_seg)
    B, T, H, D = q.shape
    check_slopes(slopes, H, q.device)
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    err = build.lib().flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(),
        None if slopes is None else slopes.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        B, T, H, k.shape[2], int(causal),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_fwd_bf16")
    return out, lse


def _bwd_args(q, k, v, do, q_seg, kv_seg, lse, delta, causal, sm_scale, slopes):
    """The pointer / shape / stride arguments both backward entry points
    share, after checking what the kernels take: q, k, v as the forward
    takes them, T a multiple of BLOCK, ``do`` of q's shape and contiguous
    (the Function makes the cotangent contiguous), lse and delta f32, the
    slopes f32 [H] or None."""
    _check_kernel_inputs(q, k, v, q_seg)
    check_slopes(slopes, q.shape[2], q.device)
    if do.dtype != q.dtype or do.shape != q.shape or not do.is_contiguous():
        raise ValueError(f"dO must be contiguous {q.dtype} {tuple(q.shape)}, got "
                         f"{do.dtype} {tuple(do.shape)}")
    B, T, H, _ = q.shape
    if T % BLOCK:
        raise ValueError(f"the backward kernels need T padded to {BLOCK}, got {T}")
    for x in (lse, delta):
        if x.dtype != torch.float32 or x.shape != (B, H, T) or not x.is_contiguous():
            raise ValueError("lse and delta must be contiguous f32 [B, H, T]")
    for x in (do, kv_seg, lse, delta):
        if x.device != q.device:
            raise ValueError(f"a backward input is on {x.device}, q on {q.device}")
    for x in (q_seg, kv_seg):
        if x.shape != (B, T) or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError("segment ids must be contiguous int32 [B, T]")
    for x in (kv_seg, lse, delta):
        if x.data_ptr() % 16:
            raise ValueError("segment ids, lse and delta must be 16-byte aligned")
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             q_seg.data_ptr(), kv_seg.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             None if slopes is None else slopes.data_ptr()),
            (B, T, H, k.shape[2], int(causal),
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             do.stride(0), do.stride(1), do.stride(2),
             float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream))


def _counter(slopes):
    return "launches" if slopes is None else "alibi_launches"


def flash_bwd_dkv(q, k, v, do, q_seg, kv_seg, lse, delta, *, causal, sm_scale,
                  alibi_slopes=None):
    """dK, dV [B, T, Hkv, D] bf16 from the dK/dV kernel (CUDA tensors only;
    T a multiple of BLOCK, as the forward's padding leaves it), with the
    query heads split as :func:`dkv_head_splits` plans for the card."""
    ptrs, rest = _bwd_args(q, k, v, do, q_seg, kv_seg, lse, delta, causal, sm_scale,
                           alibi_slopes)
    B, T, H, _ = q.shape
    Hkv = k.shape[2]
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = dkv_head_splits(B, T, Hkv, H // Hkv, n_sms)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    ws = (torch.empty((2, splits) + tuple(k.shape), dtype=torch.float32, device=k.device)
          if splits > 1 else None)
    n_int = 5   # B, T, H, Hkv, causal come first in ``rest``; splits follows them
    build.check(build.lib().flash_bwd_dkv_bf16(
        *ptrs, dk.data_ptr(), dv.data_ptr(), None if ws is None else ws.data_ptr(),
        *rest[:n_int], splits, *rest[n_int:]), "flash_bwd_dkv_bf16")
    flash_bwd_dkv.last_splits = splits
    build.count_launch(flash_bwd_dkv, _counter(alibi_slopes))
    return dk, dv


def flash_bwd_dq(q, k, v, do, q_seg, kv_seg, lse, delta, *, causal, sm_scale,
                 alibi_slopes=None):
    """dQ [B, T, H, D] bf16 from the dQ kernel (CUDA tensors only)."""
    ptrs, rest = _bwd_args(q, k, v, do, q_seg, kv_seg, lse, delta, causal, sm_scale,
                           alibi_slopes)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    build.check(build.lib().flash_bwd_dq_bf16(*ptrs, dq.data_ptr(), *rest), "flash_bwd_dq_bf16")
    build.count_launch(flash_bwd_dq, _counter(alibi_slopes))
    return dq


def flash_attention_backward(q, k, v, q_seg, kv_seg, out, lse, do, *, causal, sm_scale,
                             alibi_slopes=None):
    """(dq, dk, dv) of padded inputs: the two kernels on the card (delta =
    rowsum(dO * O) in f32 by torch, as the JAX rule leaves it to XLA), the
    plain version on the CPU."""
    kw = dict(causal=causal, sm_scale=sm_scale, alibi_slopes=alibi_slopes)
    if q.is_cuda:
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dk, dv = flash_bwd_dkv(q, k, v, do, q_seg, kv_seg, lse, delta, **kw)
        return flash_bwd_dq(q, k, v, do, q_seg, kv_seg, lse, delta, **kw), dk, dv
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, q_seg, kv_seg, out, lse, do, **kw)
    raise ValueError(f"flash_attention_backward: no path for device {q.device}")


class _Flash(torch.autograd.Function):
    """Forward kernel (or plain forward) with the recompute-free backward.
    Saves the padded q/k/v, segment ids, output and lse, as the JAX
    residuals (``_flash_fwd_rule``) do."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, slopes, causal, scale):
        T = q.shape[1]
        qp, kp, vp, qs, ks = _pad_inputs(q, k, v, q_segment_ids, kv_segment_ids)
        if q.is_cuda:
            out, lse = _launch(qp, kp, vp, qs, ks, causal, scale, slopes)
            build.count_launch(flash_attention, _counter(slopes))
        elif q.device.type == "cpu":
            out, lse = flash_attention_reference(qp, kp, vp, qs, ks, causal=causal,
                                                 sm_scale=scale, alibi_slopes=slopes)
        else:
            raise ValueError(f"flash_attention: no path for device {q.device}")
        ctx.save_for_backward(qp, kp, vp, qs, ks, out, lse, slopes)
        ctx.causal, ctx.scale, ctx.T = causal, scale, T
        lse_t = lse[:, :, :T]
        ctx.mark_non_differentiable(lse_t)
        return out[:, :T], lse_t

    @staticmethod
    def backward(ctx, g, _g_lse):
        qp, kp, vp, qs, ks, out, lse, slopes = ctx.saved_tensors
        pad = qp.shape[1] - ctx.T
        if pad:
            g = F.pad(g, (0, 0, 0, 0, 0, pad))   # padded rows: zero cotangent
        dq, dk, dv = flash_attention_backward(qp, kp, vp, qs, ks, out, lse, g.to(qp.dtype),
                                              causal=ctx.causal, sm_scale=ctx.scale,
                                              alibi_slopes=slopes)
        T = ctx.T
        return dq[:, :T], dk[:, :T], dv[:, :T], None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention over [B, T, H, D]: returns (out, lse [B, H, T]); the
    output carries a gradient through the backward kernels, with
    ``alibi_slopes`` [H] f32 (MPT's ALiBi) through their ALiBi variants."""
    check_slopes(alibi_slopes, q.shape[2], q.device)
    scale = softmax_scale if softmax_scale is not None else q.shape[3] ** -0.5
    return _Flash.apply(q, k, v, q_segment_ids, kv_segment_ids, alibi_slopes, causal, scale)


flash_attention.launches = 0
flash_attention.alibi_launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dkv.alibi_launches = 0
flash_bwd_dkv.last_splits = 0   # the head splits of the latest dK/dV launch
flash_bwd_dq.launches = 0
flash_bwd_dq.alibi_launches = 0
