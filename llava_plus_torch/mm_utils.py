"""Multimodal utilities: image-aware tokenization, image batching and the
tool-use turn format of the training data.

The port's own copy of what it uses from ``llava_plus_tpu/mm_utils.py``
(parity target: reference ``llava/mm_utils.py``). Host-side numpy / PIL only.
"""

from __future__ import annotations

import base64
import json
from io import BytesIO
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from llava_plus_torch.constants import IMAGE_TOKEN_INDEX


def load_image_from_base64(image: str) -> Image.Image:
    return Image.open(BytesIO(base64.b64decode(image)))


def expand2square(pil_img: Image.Image, background_color) -> Image.Image:
    """Pad to square, centering the image (ref mm_utils.py:16-27)."""
    width, height = pil_img.size
    if width == height:
        return pil_img
    side = max(width, height)
    result = Image.new(pil_img.mode, (side, side), background_color)
    result.paste(pil_img, ((side - width) // 2, (side - height) // 2))
    return result


def process_images(images: Sequence[Image.Image], image_processor, model_cfg) -> np.ndarray:
    """Preprocess a list of PIL images into a stacked [N, H, W, 3] float array.

    Honors ``image_aspect_ratio == 'pad'`` by padding each image to square
    with the processor's mean pixel color first (ref mm_utils.py:30-44).
    """
    image_aspect_ratio = getattr(model_cfg, "image_aspect_ratio", None)
    if image_aspect_ratio == "pad":
        out = []
        for image in images:
            bg = tuple(int(x * 255) for x in image_processor.image_mean)
            image = expand2square(image, bg)
            out.append(image_processor(image))
        return np.stack(out, axis=0)
    return np.stack([image_processor(im) for im in images], axis=0)


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    return_tensors: Optional[str] = None,
):
    """Tokenize a prompt containing ``<image>`` markers.

    Splits on ``<image>``, tokenizes each chunk, and joins the chunks with the
    image sentinel id, keeping a single BOS at the front. Matches the
    reference algorithm (mm_utils.py:47-67) including its offset trick, so the
    resulting id sequences are identical. ``return_tensors``: None (a list)
    or "np".
    """
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    bos = getattr(tokenizer, "bos_token_id", None)
    has_bos = bool(chunks) and bool(chunks[0]) and bos is not None and chunks[0][0] == bos

    input_ids: List[int] = []
    offset = 0
    if has_bos:
        offset = 1
        input_ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    pieces: List[List[int]] = []
    for i, c in enumerate(chunks):
        if i > 0:
            pieces.append(sep)
        pieces.append(c)
    for piece in pieces:
        input_ids.extend(piece[offset:])

    if return_tensors is None:
        return input_ids
    if return_tensors == "np":
        return np.asarray(input_ids, dtype=np.int32)
    raise ValueError(f"Unsupported tensor type: {return_tensors}")


def reorganize_source_for_tool_use(source: List[Dict]) -> List[Dict]:
    """Merge {thoughts, actions, value} assistant fields into the emoji
    grammar string the model is trained to emit (ref mm_utils.py:117-149).
    Byte-format must match ``conversation.parse_tool_output``."""
    new_source = []
    for conv in source:
        if conv["from"].lower() == "human":
            new_source.append(conv)
            continue
        merged = ""
        if "thoughts" in conv:
            merged += '"{}" {}'.format("thoughts🤔", conv.pop("thoughts")) + "\n"
        if "actions" in conv:
            merged += '"{}" {}'.format("actions🚀", json.dumps(conv.pop("actions"))) + "\n"
        if "value" in conv:
            merged += '"{}" {}'.format("value👉", conv.pop("value")) + "\n"
        conv["value"] = merged
        new_source.append(conv)
    return new_source


def reorganize_source_for_tool_use_batch(sources: List[List[Dict]]) -> List[List[Dict]]:
    return [reorganize_source_for_tool_use(s) for s in sources]
