"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version.

Counterpart of ``llava_plus_tpu/ops/flash_attention.py`` (forward only; the
Pallas kernel it replaces is ``_fwd_kernel``). Inputs are [B, T, H, D],
causal, with optional segment ids (0 = padding). T is padded to the kernel's
64-row tile with segment 0, as ``_pad_inputs`` pads to the Pallas block.
Returns the output [B, T, H, D] and the per-row logsumexp [B, H, T] f32,
which a backward pass replays.

The kernel runs for CUDA tensors (bf16, D = 128); the plain version for CPU
tensors; anything else raises. Rows that see no valid key come out as zeros
from both (the reference attention gives them a uniform average instead).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from llava_plus_torch.kernels import build
from llava_plus_torch.ops.attention import DEFAULT_MASK_VALUE

BLOCK = 64      # q and kv tile of the kernel
HEAD_DIM = 128  # the kernel's only head dim


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


def flash_attention_reference(q, k, v, q_seg, kv_seg, *, causal: bool,
                              sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, in q's float precision
    (f32 for bf16 inputs). q [B, T, H, D]; k, v [B, T, Hkv, D]; segment ids
    [B, T]. Masked probabilities are 0, a row with none valid outputs 0, and
    lse = m + log(l) with l taken as 1 where it is 0."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    acc_dtype = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(acc_dtype).permute(0, 2, 1, 3)                     # [B, H, T, D]
    kf = k.to(acc_dtype).permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1)
    vf = v.to(acc_dtype).permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale        # [B, H, T, T]
    mask = ((q_seg[:, :, None] == kv_seg[:, None, :])
            & (kv_seg[:, None, :] != 0))[:, None]
    if causal:
        pos = torch.arange(T, device=q.device)
        mask = mask & (pos[None, :] <= pos[:, None])[None, None]
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.matmul(p, vf) / l_safe                           # [B, H, T, D]
    lse = (m + torch.log(l_safe))[..., 0]                        # [B, H, T]
    return out.permute(0, 2, 1, 3).to(q.dtype), lse.to(acc_dtype)


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


def _launch(q, k, v, q_seg, kv_seg, causal, sm_scale):
    _check_kernel_inputs(q, k, v, q_seg)
    B, T, H, D = q.shape
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    err = build.lib().flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_seg.data_ptr(), kv_seg.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, T, H, k.shape[2], int(causal),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_fwd_bf16")
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    alibi_nheads: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention over [B, T, H, D]: returns (out, lse [B, H, T])."""
    if alibi_nheads:
        raise NotImplementedError(
            "the ALiBi variant of the flash kernel (MPT) is not ported yet")
    T, D = q.shape[1], q.shape[3]
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qp, kp, vp, qs, ks = _pad_inputs(q, k, v, q_segment_ids, kv_segment_ids)
    if q.is_cuda:
        out, lse = _launch(qp, kp, vp, qs, ks, causal, scale)
        build.count_launch(flash_attention)
    elif q.device.type == "cpu":
        out, lse = flash_attention_reference(qp, kp, vp, qs, ks,
                                             causal=causal, sm_scale=scale)
    else:
        raise ValueError(f"flash_attention: no path for device {q.device}")
    return out[:, :T], lse[:, :, :T]


flash_attention.launches = 0
