"""LLaVA multimodal model in PyTorch: vision tower -> projector -> language
decoder (LLaMA, ``models/llama.py``, or MPT, ``models/mpt.py``).

Counterpart of ``llava_plus_tpu/models/llava.py``. The image splice follows
the position map that ``data/multimodal.py`` plans: image features are
written into the token embeddings at ``image_pos``, and positions >= T (pad
images, truncated spans) are left out. The vision tower is frozen: it runs under
``torch.no_grad()`` (the JAX package's ``stop_gradient``), so training builds
no graph for it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from llava_plus_torch.models.configs import LlavaConfig, LlamaConfig, MptConfig
from llava_plus_torch.models import clip_vit, llama, mpt, projector


@dataclasses.dataclass
class MultimodalBatch:
    """One fused multimodal batch, as tensors on one device.

    tokens [B, T]; positions [B, T]; segment_ids [B, T] (0 = padding);
    images [B, N, H, W, 3]; image_pos [B, N * num_patches] (>= T: dropped);
    labels [B, T] or None: IGNORE_INDEX-masked next-token targets.
    """

    tokens: torch.Tensor
    positions: torch.Tensor
    segment_ids: torch.Tensor
    images: torch.Tensor
    image_pos: torch.Tensor
    labels: Optional[torch.Tensor] = None


def backbone(cfg: LlavaConfig) -> Tuple[object, Union[LlamaConfig, MptConfig]]:
    """The language model's decoder module (``llama`` or ``mpt``, which share
    ``init_params`` / ``embed_tokens`` / ``forward``) and its config."""
    if cfg.language_model_type == "llama":
        return llama, cfg.text
    if cfg.language_model_type == "mpt":
        return mpt, cfg.mpt
    raise ValueError(f"unknown language_model_type {cfg.language_model_type!r}")


def init_params(cfg: LlavaConfig, generator: torch.Generator, device,
                dtype=torch.bfloat16):
    """Full random parameter tree made on ``device`` from ``generator``."""
    lm, lm_cfg = backbone(cfg)
    return {
        "language_model": lm.init_params(lm_cfg, generator, device, dtype),
        "vision_tower": clip_vit.init_params(cfg.vision, generator, device, dtype),
        "mm_projector": projector.init_params(
            cfg.mm_projector_type, cfg.mm_hidden_size, cfg.hidden_size,
            generator, device, dtype),
    }


def encode_images(params, cfg: LlavaConfig, images: torch.Tensor) -> torch.Tensor:
    """[B*, H, W, 3] -> [B*, num_patches, lm_hidden]; gradients reach the
    projector, never the vision tower."""
    with torch.no_grad():
        feats = clip_vit.encode(params["vision_tower"], cfg.vision, images)
    return projector.apply(params["mm_projector"], cfg.mm_projector_type, feats)


def fuse(params, cfg: LlavaConfig, batch: MultimodalBatch) -> torch.Tensor:
    """The fused embedding sequence [B, T, D]."""
    embeds = backbone(cfg)[0].embed_tokens(params["language_model"], batch.tokens)
    B, T = batch.tokens.shape
    N = batch.images.shape[1]
    if N == 0:
        return embeds
    b, j = torch.nonzero(batch.image_pos < T, as_tuple=True)
    if b.numel() == 0:
        return embeds  # no image slot lands inside T: skip the tower
    images = batch.images.reshape((B * N,) + batch.images.shape[2:])
    feats = encode_images(params, cfg, images)               # [B*N, P, D]
    feats = feats.reshape(B, N * feats.shape[1], feats.shape[2]).to(embeds.dtype)
    embeds[b, batch.image_pos[b, j]] = feats[b, j]
    return embeds


def forward(
    params,
    cfg: LlavaConfig,
    batch: MultimodalBatch,
    *,
    cache: Optional[llama.Cache] = None,
    fresh_prefill: bool = False,
    logits_positions: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[llama.Cache]]:
    """Multimodal forward -> (f32 logits, cache updated in place); the cache
    is a dense :class:`~llava_plus_torch.models.llama.KVCache` or a paged
    :class:`~llava_plus_torch.models.llama.PagedKVCache`. ``remat``
    recomputes each decoder layer in the backward (training, either
    backbone). Unlike the JAX package, the MPT branch takes
    ``fresh_prefill`` and ``logits_positions`` too: the same numbers (over a
    bf16 cache), through the flash kernel and one head row."""
    embeds = fuse(params, cfg, batch)
    if cfg.language_model_type == "mpt":
        return mpt.forward(
            params["language_model"], cfg.mpt, inputs_embeds=embeds,
            positions=batch.positions, segment_ids=batch.segment_ids, cache=cache,
            fresh_prefill=fresh_prefill, logits_positions=logits_positions, remat=remat,
        )
    return llama.forward(
        params["language_model"], cfg.text,
        inputs_embeds=embeds, positions=batch.positions,
        segment_ids=batch.segment_ids, cache=cache,
        fresh_prefill=fresh_prefill, logits_positions=logits_positions, remat=remat,
    )


def decode_step(
    params,
    cfg: LlavaConfig,
    token: torch.Tensor,        # [B, 1]
    position: torch.Tensor,     # [B, 1]
    segment_ids: torch.Tensor,  # [B, 1]
    cache: llama.Cache,
) -> Tuple[torch.Tensor, llama.Cache]:
    """One text-only decode step over the cache (dense or paged):
    (logits [B, 1, V], cache)."""
    lm, lm_cfg = backbone(cfg)
    return lm.forward(
        params["language_model"], lm_cfg, token,
        positions=position, segment_ids=segment_ids, cache=cache,
    )
