"""CLIP image preprocessing with exact HF ``CLIPImageProcessor`` semantics
(the port's own copy of ``llava_plus_tpu/data/image_processing.py``).

The reference relies on the HF processor shipped with the vision tower
checkpoint (``llava/model/multimodal_encoder/clip_encoder.py:23``). Logit
parity requires bit-identical preprocessing, so we reproduce the pipeline —
PIL bicubic shortest-edge resize, integer center crop, rescale, normalize —
and verify it against ``transformers.CLIPImageProcessor`` in
``tests/test_image_processing.py``.

Output layout is **NHWC float32** (TPU/XLA-canonical), not the reference's
NCHW torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
from PIL import Image

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ClipImageProcessor:
    """Callable image preprocessor: PIL.Image -> float32 [H, W, 3]."""

    shortest_edge: int = 336
    crop_size: int = 336
    image_mean: Tuple[float, float, float] = OPENAI_CLIP_MEAN
    image_std: Tuple[float, float, float] = OPENAI_CLIP_STD
    rescale_factor: float = 1.0 / 255.0

    def resize(self, image: Image.Image) -> Image.Image:
        w, h = image.size
        short, long = (h, w) if h <= w else (w, h)
        if short == self.shortest_edge:
            new_short, new_long = short, long
        else:
            new_short = self.shortest_edge
            new_long = int(self.shortest_edge * long / short)
        new_h, new_w = (new_short, new_long) if h <= w else (new_long, new_short)
        return image.resize((new_w, new_h), resample=Image.BICUBIC)

    def center_crop(self, image: Image.Image) -> Image.Image:
        w, h = image.size
        cw = ch = self.crop_size
        left = (w - cw) // 2
        top = (h - ch) // 2
        return image.crop((left, top, left + cw, top + ch))

    def __call__(self, image: Image.Image) -> np.ndarray:
        if image.mode != "RGB":
            image = image.convert("RGB")
        image = self.resize(image)
        image = self.center_crop(image)
        arr = np.asarray(image, dtype=np.float32) * self.rescale_factor
        mean = np.asarray(self.image_mean, dtype=np.float32)
        std = np.asarray(self.image_std, dtype=np.float32)
        return (arr - mean) / std

    def preprocess_batch(self, images: Sequence[Image.Image]) -> np.ndarray:
        return np.stack([self(im) for im in images], axis=0)


def processor_for_vision_tower(name_or_path: str) -> ClipImageProcessor:
    """Build the processor matching a CLIP vision tower name.

    openai/clip-vit-large-patch14-336 -> 336px; openai/clip-vit-large-patch14
    (224px) and laion towers use their own sizes.
    """
    if "336" in name_or_path:
        return ClipImageProcessor(shortest_edge=336, crop_size=336)
    return ClipImageProcessor(shortest_edge=224, crop_size=224)
