"""Sequence packing: multiple samples per training row via segment ids (the
port's own copy of ``llava_plus_tpu/data/packing.py``).

The reference pads every sample to the batch max
(``llava/train/train.py:742-773``); at 2048-token rows with typical
100-600-token instruct samples, most of each step's FLOPs are padding.
(Its ``group_by_modality_length`` sampler reduces — but can't eliminate —
the waste; SURVEY §6 credits it ~25%.)

Packing concatenates samples into FIXED ``[rows, max_len]`` batches:

- per-sample **segment ids** (1, 2, 3, ... within a row) — both the flash
  kernels and the reference attention attend only within equal ids, so
  packed samples are computationally isolated;
- per-sample **restarting positions** (RoPE sees each sample at 0..L);
- the shifted loss (``train/objective.py``: logits[t] predicts
  labels[t+1]) is boundary-safe because each packed sample's FIRST label
  is forced to IGNORE_INDEX — the last token of sample j never scores
  against the first token of sample j+1;
- a fixed shape for every step of the run (the padded collator's rows
  vary by 64-token length bucket).

Packed loss equals unpacked loss on the same samples (the mean is over
valid tokens, which are identical) — asserted by tests/test_packing.py.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from llava_plus_torch.constants import IGNORE_INDEX
from llava_plus_torch.data.multimodal import plan_multimodal_batch


def pack_instances(
    instances: Sequence[Dict],
    *,
    rows: int,
    max_len: int,
    num_patches: int,
    image_size: int,
    max_images_per_row: int = 2,
    pad_token_id: int = 0,
) -> Tuple[Dict[str, np.ndarray], int]:
    """First-fit pack a CONTIGUOUS PREFIX of ``instances`` into a fixed
    ``[rows, max_len]`` batch. Returns (arrays, n_consumed) — the caller
    advances its sample cursor by ``n_consumed`` (packing stops at the
    first sample that fits no row, preserving sampler order).

    ``arrays`` has the same keys as ``dataset.collate_batch``; rows with
    fewer samples are padding (segment id 0) and unused image slots are
    zero images whose features scatter-drop.
    """
    row_tok = [0] * rows
    row_img = [0] * rows
    row_items: List[List] = [[] for _ in range(rows)]

    consumed = 0
    for inst in instances:
        plan = plan_multimodal_batch(
            [inst["input_ids"]], [inst["labels"]],
            num_patches=num_patches, max_len=max_len,
            pad_token_id=pad_token_id,
        )
        L = int(plan.lengths[0])
        n_img = min(int(plan.num_images[0]), max_images_per_row)
        placed = False
        for r in range(rows):
            if (row_tok[r] + L <= max_len
                    and row_img[r] + n_img <= max_images_per_row):
                row_items[r].append((plan, inst, L, n_img))
                row_tok[r] += L
                row_img[r] += n_img
                placed = True
                break
        if not placed:
            if consumed == 0:
                # a lone over-size sample still trains (planner already
                # truncated it to max_len); never stall the epoch
                row_items[0].append((plan, inst, L, n_img))
                consumed = 1
            break
        consumed += 1

    T = max_len
    n_slots = max_images_per_row * num_patches
    tokens = np.full((rows, T), pad_token_id, dtype=np.int32)
    labels = np.full((rows, T), IGNORE_INDEX, dtype=np.int32)
    positions = np.full((rows, T), max_len, dtype=np.int32)  # scatter-drop
    seg = np.zeros((rows, T), dtype=np.int32)
    img_pos = np.full((rows, n_slots), T, dtype=np.int32)    # scatter-drop
    images = np.zeros((rows, max_images_per_row, image_size, image_size, 3),
                      dtype=np.float32)

    for r in range(rows):
        off = 0
        img_slot = 0
        for j, (plan, inst, L, n_img) in enumerate(row_items[r]):
            tokens[r, off:off + L] = plan.tokens[0, :L]
            lab = plan.labels[0, :L].copy()
            lab[0] = IGNORE_INDEX  # shifted-loss boundary guard
            labels[r, off:off + L] = lab
            positions[r, off:off + L] = np.arange(L)
            seg[r, off:off + L] = j + 1
            ip = plan.image_pos[0][: n_img * num_patches]
            ip = np.where(ip < L, ip + off, T).astype(np.int32)
            img_pos[r, img_slot * num_patches:
                    img_slot * num_patches + ip.shape[0]] = ip
            imgs = inst.get("images")
            if imgs is not None and n_img:
                arr = np.asarray(imgs, np.float32)
                if arr.ndim == 3:
                    arr = arr[None]
                for k in range(min(n_img, arr.shape[0])):
                    images[r, img_slot + k] = arr[k]
            img_slot += n_img
            off += L

    arrays = {
        "tokens": tokens,
        "positions": positions,
        "segment_ids": seg,
        "image_pos": img_pos,
        "labels": labels,
        "images": images,
    }
    return arrays, consumed
