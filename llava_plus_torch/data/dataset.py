"""Supervised dataset, collator, and length/modality-grouped sampling (the
port's own copy of ``llava_plus_tpu/data/dataset.py``).

Rebuild of the reference data stack (``llava/train/train.py:641-802``,
``llava/train/llava_trainer.py:38-148``) without torch:

- ``LazySupervisedDataset``: JSON list of {image?, conversations}; lazy PIL
  load with multi-folder search; pad-aspect handling; dummy zero image for
  text-only samples in multimodal runs
- ``ConcatDataset`` over comma-separated data paths (and the missing
  ``return`` bug in the reference's ``make_supervised_data_module`` fixed by
  construction)
- collator emits a fused ``MultimodalBatch`` directly — sentinel expansion
  happens here, not on device
- ``LengthGroupedSampler`` with modality grouping (the reference's ~25%
  speedup knob); numpy RNG instead of torch generators. The reference's
  ``modality_lengths`` checks ``'images'`` where the data uses ``'image'``
  (a fork bug that degraded it to all-text grouping); fixed here.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from llava_plus_torch.constants import IGNORE_INDEX
from llava_plus_torch.data.image_processing import ClipImageProcessor
from llava_plus_torch.data.multimodal import pad_images, plan_multimodal_batch
from llava_plus_torch.data.preprocess import preprocess, preprocess_multimodal
from llava_plus_torch.mm_utils import expand2square


@dataclasses.dataclass
class DataConfig:
    data_path: str = ""
    image_folder: str = ""
    image_aspect_ratio: Optional[str] = None
    is_multimodal: bool = True
    mm_use_im_start_end: bool = False
    conv_version: str = "v1"


class LazySupervisedDataset:
    def __init__(self, data_path: str, tokenizer, data_cfg: DataConfig,
                 image_processor: Optional[ClipImageProcessor] = None,
                 conv=None):
        with open(data_path) as f:
            self.records = json.load(f)
        self.tokenizer = tokenizer
        self.cfg = data_cfg
        self.image_processor = image_processor or ClipImageProcessor()
        self.conv = conv

    def __len__(self):
        return len(self.records)

    @property
    def lengths(self) -> List[int]:
        out = []
        for sample in self.records:
            img_tokens = 128 if "image" in sample else 0
            out.append(
                sum(len(c["value"].split()) for c in sample["conversations"])
                + img_tokens
            )
        return out

    @property
    def modality_lengths(self) -> List[int]:
        out = []
        for sample in self.records:
            n = sum(len(c["value"].split()) for c in sample["conversations"])
            out.append(n if "image" in sample else -n)
        return out

    def load_image(self, image_file: str) -> Image.Image:
        """Multi-folder search in order (ref train.py:675-689)."""
        folders = [d.strip() for d in self.cfg.image_folder.split(",")]
        if len(folders) == 1:
            return Image.open(os.path.join(folders[0], image_file)).convert("RGB")
        for d in folders:
            p = os.path.join(d, image_file)
            if os.path.exists(p):
                return Image.open(p).convert("RGB")
        raise ValueError(f"Unknown_file: {image_file}")

    def __getitem__(self, i: int) -> Dict:
        record = self.records[i]
        sources = [copy.deepcopy(record["conversations"])]
        has_image = "image" in record
        image = None
        if has_image:
            pil = self.load_image(record["image"])
            if self.cfg.image_aspect_ratio == "pad":
                bg = tuple(
                    int(x * 255) for x in self.image_processor.image_mean
                )
                pil = expand2square(pil, bg)
            image = self.image_processor(pil)
            sources = preprocess_multimodal(
                sources,
                is_multimodal=self.cfg.is_multimodal,
                mm_use_im_start_end=self.cfg.mm_use_im_start_end,
                version=self.cfg.conv_version,
            )
        out = preprocess(sources, self.tokenizer, has_image=has_image,
                         conv=self.conv)
        item = {
            "input_ids": out["input_ids"][0],
            "labels": out["labels"][0],
        }
        if has_image:
            item["images"] = image[None]  # [1, H, W, 3]
        elif self.cfg.is_multimodal:
            s = self.image_processor.crop_size
            item["images"] = np.zeros((1, s, s, 3), np.float32)
        return item


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1]) if len(self.datasets) else 0

    def __getitem__(self, i: int):
        ds = int(np.searchsorted(self._offsets, i, side="right"))
        prev = 0 if ds == 0 else int(self._offsets[ds - 1])
        return self.datasets[ds][i - prev]

    @property
    def lengths(self):
        return [l for d in self.datasets for l in d.lengths]

    @property
    def modality_lengths(self):
        return [l for d in self.datasets for l in d.modality_lengths]


def make_supervised_dataset(
    tokenizer, data_cfg: DataConfig,
    image_processor: Optional[ClipImageProcessor] = None, conv=None,
):
    """Comma-separated data paths -> ConcatDataset (ref train.py:783-802,
    with the missing-return bug fixed by returning the dataset)."""
    paths = [p.strip() for p in data_cfg.data_path.split(",") if p.strip()]
    parts = []
    for p in paths:
        assert os.path.exists(p), f"{p} does not exist"
        parts.append(
            LazySupervisedDataset(p, tokenizer, data_cfg, image_processor, conv)
        )
    return ConcatDataset(parts)


# ---------------------------------------------------------------------------
# Collation -> fused MultimodalBatch arrays
# ---------------------------------------------------------------------------

def collate_batch(
    instances: Sequence[Dict],
    *,
    num_patches: int,
    max_len: int,
    image_size: int,
    pad_token_id: int = 0,
    pad_to_multiple: int = 64,
    max_images: int = 1,
):
    """Pad + expand image sentinels into a device-ready batch dict of numpy
    arrays (MultimodalBatch fields)."""
    plan = plan_multimodal_batch(
        [inst["input_ids"] for inst in instances],
        [inst["labels"] for inst in instances],
        num_patches=num_patches,
        max_len=max_len,
        max_images=max_images,
        pad_to_multiple=pad_to_multiple,
        pad_token_id=pad_token_id,
    )
    images = pad_images(
        [inst.get("images") for inst in instances],
        max_images, (image_size, image_size, 3),
    )
    return {
        "tokens": plan.tokens,
        "positions": plan.positions,
        "segment_ids": plan.segment_ids,
        "image_pos": plan.image_pos,
        "labels": plan.labels,
        "images": images,
    }


# ---------------------------------------------------------------------------
# Length-grouped sampling (ref llava_trainer.py:38-148)
# ---------------------------------------------------------------------------

def split_to_even_chunks(indices, lengths, num_chunks):
    if len(indices) % num_chunks != 0:
        return [indices[i::num_chunks] for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks = [[] for _ in range(num_chunks)]
    chunk_lens = [0.0] * num_chunks
    for index in indices:
        shortest = chunk_lens.index(min(chunk_lens))
        chunks[shortest].append(index)
        chunk_lens[shortest] += lengths[index]
        if len(chunks[shortest]) == per_chunk:
            chunk_lens[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths, batch_size, world_size, rng=None):
    rng = rng or np.random.default_rng()
    indices = rng.permutation(len(lengths)).tolist()
    mb_size = world_size * batch_size
    megabatches = [
        indices[i : i + mb_size] for i in range(0, len(lengths), mb_size)
    ]
    megabatches = [
        sorted(mb, key=lambda i: lengths[i], reverse=True) for mb in megabatches
    ]
    megabatches = [
        split_to_even_chunks(mb, lengths, world_size) for mb in megabatches
    ]
    return [i for mb in megabatches for chunk in mb for i in chunk]


def get_modality_length_grouped_indices(lengths, batch_size, world_size, rng=None):
    rng = rng or np.random.default_rng()
    assert all(l != 0 for l in lengths), "Should not have zero length."
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return get_length_grouped_indices(lengths, batch_size, world_size, rng)
    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, -l) for i, l in enumerate(lengths) if l < 0]
    mm_indices = [i for i, _ in mm]
    lang_indices = [i for i, _ in lang]
    mm_shuffle = [
        mm_indices[i] for i in get_length_grouped_indices(
            [l for _, l in mm], batch_size, world_size, rng
        )
    ]
    lang_shuffle = [
        lang_indices[i] for i in get_length_grouped_indices(
            [l for _, l in lang], batch_size, world_size, rng
        )
    ]
    mb_size = world_size * batch_size
    mm_mb = [mm_shuffle[i : i + mb_size] for i in range(0, len(mm_shuffle), mb_size)]
    lang_mb = [
        lang_shuffle[i : i + mb_size] for i in range(0, len(lang_shuffle), mb_size)
    ]
    additional = mm_mb[-1] + lang_mb[-1] if (mm_mb and lang_mb) else []
    megabatches = mm_mb[:-1] + lang_mb[:-1]
    order = rng.permutation(len(megabatches))
    megabatches = [megabatches[i] for i in order]
    if additional:
        megabatches.append(sorted(additional))
    return [i for mb in megabatches for i in mb]


class LengthGroupedSampler:
    def __init__(self, batch_size, world_size, lengths,
                 group_by_modality=False, seed: Optional[int] = None):
        if lengths is None:
            raise ValueError("Lengths must be provided.")
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = lengths
        self.group_by_modality = group_by_modality
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return len(self.lengths)

    def __iter__(self):
        rng = np.random.default_rng(
            None if self.seed is None else self.seed + self._epoch
        )
        if self.group_by_modality:
            return iter(get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, rng
            ))
        return iter(get_length_grouped_indices(
            self.lengths, self.batch_size, self.world_size, rng
        ))
