"""Host-side multimodal batch planning: the image-splice position map (the
port's own copy of ``llava_plus_tpu/data/multimodal.py``).

Replaces the reference's per-sample Python splice loop
(``llava/model/llava_arch.py:99-240``) with a numpy planner that runs in the
data pipeline. Semantics preserved:

- each IMAGE_TOKEN_INDEX sentinel expands into ``num_patches`` feature slots;
- labels over image spans are IGNORE_INDEX;
- sequences truncate at ``max_len`` (possibly mid-span — dropped patch
  positions scatter out-of-bounds and vanish);
- padding side honors the tokenizer (left for generation, right for training).

The output is pure position arithmetic; the device program consumes it as one
vectorized scatter (``models/llava.py:fuse``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from llava_plus_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX


@dataclasses.dataclass
class SplicePlan:
    """Numpy arrays ready to become a ``models.llava.MultimodalBatch``."""

    tokens: np.ndarray        # [B, T] int32
    positions: np.ndarray     # [B, T] int32
    segment_ids: np.ndarray   # [B, T] int32
    image_pos: np.ndarray     # [B, max_images * num_patches] int32
    labels: Optional[np.ndarray]  # [B, T] int32 or None
    lengths: np.ndarray       # [B] true fused lengths (pre-padding)
    num_images: np.ndarray    # [B]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_multimodal_batch(
    input_ids_list: Sequence[np.ndarray],
    labels_list: Optional[Sequence[np.ndarray]] = None,
    *,
    num_patches: int,
    max_len: int,
    max_images: Optional[int] = None,
    pad_to_multiple: int = 1,
    pad_to: Optional[int] = None,
    padding_side: str = "right",
    pad_token_id: int = 0,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    ignore_index: int = IGNORE_INDEX,
) -> SplicePlan:
    """Expand image sentinels and compute the scatter position map."""
    B = len(input_ids_list)
    if labels_list is not None:
        assert len(labels_list) == B

    per_sample = []
    n_images_all = []
    for i in range(B):
        ids = np.asarray(input_ids_list[i], dtype=np.int64)
        labs = (
            np.asarray(labels_list[i], dtype=np.int64)
            if labels_list is not None else None
        )
        is_img = ids == image_token_index
        n_img = int(is_img.sum())
        n_images_all.append(n_img)
        # fused position of each original token: text tokens occupy 1 slot,
        # sentinels occupy num_patches slots.
        sizes = np.where(is_img, num_patches, 1)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        fused_len = int(starts[-1] + sizes[-1]) if len(ids) else 0
        fused_len_t = min(fused_len, max_len)

        tokens = np.full(fused_len_t, pad_token_id, dtype=np.int64)
        labels = (
            np.full(fused_len_t, ignore_index, dtype=np.int64)
            if labs is not None else None
        )
        text_idx = np.where(~is_img)[0]
        text_starts = starts[text_idx]
        keep = text_starts < fused_len_t
        tokens[text_starts[keep]] = ids[text_idx[keep]]
        if labels is not None:
            labels[text_starts[keep]] = labs[text_idx[keep]]

        img_starts = starts[is_img]
        # all patch positions of all images in order; >= fused_len_t will be
        # padded out to scatter-drop later.
        img_positions = (
            img_starts[:, None] + np.arange(num_patches)[None, :]
        ).reshape(-1)
        per_sample.append((tokens, labels, img_positions, fused_len_t))

    max_imgs = max_images if max_images is not None else max(n_images_all, default=0)
    max_imgs = max(max_imgs, 1)  # keep a non-degenerate image slot dimension
    T = pad_to if pad_to is not None else _round_up(
        max((s[3] for s in per_sample), default=1), pad_to_multiple
    )
    T = max(T, 1)

    out_tokens = np.full((B, T), pad_token_id, dtype=np.int32)
    out_labels = (
        np.full((B, T), ignore_index, dtype=np.int32)
        if labels_list is not None else None
    )
    # Pad positions point one past the usable range so KV-cache scatter
    # writes (mode="drop") discard them instead of clobbering slot 0.
    out_positions = np.full((B, T), max_len, dtype=np.int32)
    out_seg = np.zeros((B, T), dtype=np.int32)
    out_img_pos = np.full((B, max_imgs * num_patches), T, dtype=np.int32)
    lengths = np.zeros((B,), dtype=np.int32)

    for i, (tokens, labels, img_positions, L) in enumerate(per_sample):
        lengths[i] = L
        off = 0 if padding_side == "right" else T - L
        out_tokens[i, off:off + L] = tokens
        if out_labels is not None:
            out_labels[i, off:off + L] = labels
        out_positions[i, off:off + L] = np.arange(L)
        out_seg[i, off:off + L] = 1
        ip = img_positions.copy()
        ip = np.where(ip < L, ip + off, T)  # truncated patches -> drop slot
        out_img_pos[i, : ip.shape[0]] = ip[: max_imgs * num_patches]

    return SplicePlan(
        tokens=out_tokens,
        positions=out_positions,
        segment_ids=out_seg,
        image_pos=out_img_pos,
        labels=out_labels,
        lengths=lengths,
        num_images=np.asarray(n_images_all, dtype=np.int32),
    )


def pad_images(
    images_list: Sequence[np.ndarray],
    max_images: int,
    image_shape,
    dtype=np.float32,
) -> np.ndarray:
    """Stack per-sample image arrays [n_i, H, W, 3] into [B, max_images, ...],
    zero-padding missing slots (text-only samples get all-zero dummy images,
    mirroring ref train.py:735-738)."""
    B = len(images_list)
    out = np.zeros((B, max_images) + tuple(image_shape), dtype=dtype)
    for i, imgs in enumerate(images_list):
        if imgs is None or len(imgs) == 0:
            continue
        imgs = np.asarray(imgs, dtype=dtype)
        n = min(len(imgs), max_images)
        out[i, :n] = imgs[:n]
    return out
