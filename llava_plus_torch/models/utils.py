"""Model-layer utilities: image special tokens, config upgrade and
checkpoint consolidation (the port's counterpart of
``llava_plus_tpu/models/utils.py``).

- :func:`initialize_vision_tokenizer`: the reference's ``llava_arch.py:
  242-284`` with ``smart_tokenizer_and_embedding_resize`` (``train.py:
  229-252``): add <im_patch> / <im_start> / <im_end>, grow both embedding
  matrices, new rows the mean of the old ones;
- :func:`auto_upgrade`: the v0 -> v1 config migration (the reference's
  ``llava/model/utils.py``);
- :func:`consolidate_ckpt` and its CLI: any supported checkpoint layout to
  one HF-format directory.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Tuple

import torch

from llava_plus_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_PATCH_TOKEN,
)


def resize_token_embeddings(lm_params, new_vocab: int, pad_to_multiple: int = 64):
    """``embed_tokens`` / ``lm_head`` grown to ``new_vocab`` rows rounded up
    to a multiple of ``pad_to_multiple``; the new rows are the mean of the
    old ones (computed in f32). A new dict; the other leaves are shared."""
    target = -(-new_vocab // pad_to_multiple) * pad_to_multiple

    def grow(mat: torch.Tensor, dim: int) -> torch.Tensor:
        old = mat.shape[dim]
        if old >= target:
            return mat
        mean = mat.float().mean(dim=dim, keepdim=True).to(mat.dtype)
        reps = [1] * mat.dim()
        reps[dim] = target - old
        return torch.cat([mat, mean.repeat(*reps)], dim=dim)

    out = dict(lm_params)
    out["embed_tokens"] = grow(lm_params["embed_tokens"], 0)
    if "lm_head" in lm_params:
        out["lm_head"] = grow(lm_params["lm_head"], 1)
    return out


def initialize_vision_tokenizer(lm_params, tokenizer, *, mm_use_im_patch_token: bool = False,
                                mm_use_im_start_end: bool = False) -> Tuple[dict, int]:
    """Add the image special tokens to ``tokenizer`` and grow the
    embeddings: ``(new_lm_params, num_new_tokens)``."""
    num_new = 0
    if mm_use_im_patch_token:
        num_new += tokenizer.add_tokens([DEFAULT_IMAGE_PATCH_TOKEN], special_tokens=True)
    if mm_use_im_start_end:
        num_new += tokenizer.add_tokens([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN],
                                        special_tokens=True)
    if num_new > 0:
        lm_params = resize_token_embeddings(lm_params, len(tokenizer))
    return lm_params, num_new


def auto_upgrade(config_path) -> None:
    """Upgrade a v0-era 'llava' ``config.json`` in place: its ``model_type``
    lacks the ``llava`` name that inference keys the pipeline on."""
    path = Path(config_path) / "config.json"
    cfg = json.loads(path.read_text())
    if "llava" in cfg.get("_name_or_path", "") and cfg.get("model_type") != "llava":
        cfg["model_type"] = "llava"
        path.write_text(json.dumps(cfg, indent=2))


def consolidate_ckpt(src_path: str, dst_path: str) -> None:
    """Load any supported checkpoint layout and write one HF-format
    directory (the reference's ``llava/model/consolidate.py``)."""
    from llava_plus_torch.models.builder import load_pretrained_model
    from llava_plus_torch.train.checkpoint import export_hf_llava

    tokenizer, params, cfg, _proc, _ctx = load_pretrained_model(src_path)
    export_hf_llava(params, cfg, dst_path, tokenizer)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", type=str, required=True)
    parser.add_argument("--dst", type=str, required=True)
    args = parser.parse_args(argv)
    consolidate_ckpt(args.src, args.dst)


if __name__ == "__main__":
    main()
