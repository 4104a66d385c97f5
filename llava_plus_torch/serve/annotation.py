"""Annotation utilities: box/mask/point overlays + COCO RLE codecs.

Replaces the reference's supervision-based annotator and pycocotools RLE
(``llava/serve/utils.py:11-57``, ``gradio_web_server_llava_plus.py:100-131``)
with pure PIL/numpy — no GPU-stack dependencies.

The port's own copy of ``llava_plus_tpu/serve/annotation.py``.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

_PALETTE = [
    (255, 89, 94), (255, 202, 58), (138, 201, 38),
    (25, 130, 196), (106, 76, 147), (255, 149, 0),
]


# ---------------------------------------------------------------------------
# COCO RLE (column-major, uncompressed counts — pycocotools-compatible dicts)
# ---------------------------------------------------------------------------

def mask_to_rle(mask: np.ndarray) -> Dict:
    """Binary [H, W] -> {"size": [H, W], "counts": [run lengths]} in COCO
    column-major order starting with the count of zeros."""
    h, w = mask.shape
    flat = np.asarray(mask, dtype=np.uint8).T.reshape(-1)  # column-major
    counts: List[int] = []
    prev = 0
    run = 0
    for v in flat:
        if v == prev:
            run += 1
        else:
            counts.append(run)
            prev = v
            run = 1
    counts.append(run)
    return {"size": [int(h), int(w)], "counts": counts}


def rle_to_mask(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _decode_coco_compressed(counts, h, w)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T  # column-major inverse


def _decode_coco_compressed(counts, h, w) -> List[int]:
    """Decode pycocotools' LEB128-style compressed counts string."""
    if isinstance(counts, str):
        counts = counts.encode()
    out: List[int] = []
    i = 0
    while i < len(counts):
        x = 0
        k = 0
        more = True
        while more:
            c = counts[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(out) > 2:
            x += out[-2]
        out.append(x)
    return out


# ---------------------------------------------------------------------------
# Overlays
# ---------------------------------------------------------------------------

def _font():
    try:
        return ImageFont.load_default()
    except Exception:
        return None


def draw_boxes(
    image: Image.Image,
    boxes: Sequence[Sequence[float]],
    labels: Optional[Sequence[str]] = None,
    *,
    normalized: bool = False,
    width: int = 3,
) -> Image.Image:
    """Draw xyxy boxes (optionally normalized cx-style handled upstream)."""
    img = image.convert("RGB").copy()
    draw = ImageDraw.Draw(img)
    W, H = img.size
    font = _font()
    for i, box in enumerate(boxes):
        x0, y0, x1, y1 = box
        if normalized:
            x0, y0, x1, y1 = x0 * W, y0 * H, x1 * W, y1 * H
        color = _PALETTE[i % len(_PALETTE)]
        draw.rectangle([x0, y0, x1, y1], outline=color, width=width)
        if labels is not None and i < len(labels):
            text = str(labels[i])
            draw.text((x0 + 2, max(y0 - 12, 0)), text, fill=color, font=font)
    return img


def draw_masks(
    image: Image.Image,
    masks: Sequence[np.ndarray],
    *,
    alpha: float = 0.5,
) -> Image.Image:
    """Alpha-composite binary masks in palette colors
    (ref llava/serve/utils.py:41-57)."""
    img = np.asarray(image.convert("RGB"), dtype=np.float32)
    for i, mask in enumerate(masks):
        color = np.asarray(_PALETTE[i % len(_PALETTE)], dtype=np.float32)
        m = np.asarray(mask, dtype=bool)
        img[m] = img[m] * (1 - alpha) + color * alpha
    return Image.fromarray(img.astype(np.uint8))


def draw_points(
    image: Image.Image,
    points: Sequence[Sequence[float]],
    *,
    normalized: bool = True,
    radius: int = 6,
) -> Image.Image:
    """Mark click points (ref gradio_web_server_llava_plus.py:119-131)."""
    img = image.convert("RGB").copy()
    draw = ImageDraw.Draw(img)
    W, H = img.size
    for i, pt in enumerate(points):
        x, y = pt[:2]
        if normalized:
            x, y = x * W, y * H
        color = _PALETTE[i % len(_PALETTE)]
        draw.ellipse(
            [x - radius, y - radius, x + radius, y + radius],
            fill=color, outline=(255, 255, 255), width=2,
        )
    return img


def mask_to_bbox(mask: np.ndarray) -> Optional[List[int]]:
    """Bounding box [x0, y0, x1, y1] of a binary mask (the sketch-pad ->
    'Input box' feature, ref gradio_web_server_llava_plus.py:39-97)."""
    ys, xs = np.where(np.asarray(mask) != 0)
    if len(xs) == 0:
        return None
    return [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]
