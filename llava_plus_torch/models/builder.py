"""Pretrained model loading: the reference's four checkpoint shapes.

Counterpart of ``llava_plus_tpu/models/builder.py`` (the reference's
``llava/model/builder.py:26-151``):

1. LoRA + base:      an adapter directory (``adapter_config.json``,
                     ``adapter_model``, ``non_lora_trainables.bin``) over a
                     base model, merged on load;
2. base + projector: an LM directory plus ``mm_projector.bin`` (the stage-1
                     output of ``tune_mm_mlp_adapter``);
3. full LLaVA:       one directory with everything (LLaMA or MPT backbone);
4. plain LM:         a text-only checkpoint.

:func:`load_pretrained_model` returns ``(tokenizer, params, cfg,
image_processor, context_len)``, the JAX package's contract. The tree holds
CPU tensors in ``dtype`` (bf16 by default); the caller moves it to its
device. ``transformers`` is imported only for a directory that carries
tokenizer files; without them the port's :class:`DebugTokenizer` stands in.
"""

from __future__ import annotations

import json
import logging
import warnings
from pathlib import Path
from typing import Optional, Tuple

import torch

from llava_plus_torch.data.image_processing import ClipImageProcessor
from llava_plus_torch.models import hf_import
from llava_plus_torch.models.configs import LlavaConfig

logger = logging.getLogger("model_builder")


def load_tokenizer(model_path: str):
    path = Path(model_path)
    has_tok_files = any(
        (path / f).exists()
        for f in ("tokenizer.json", "tokenizer.model", "tokenizer_config.json"))
    if not has_tok_files and (path / "config.json").exists():
        # checkpoints of --tiny-debug-model runs carry no tokenizer: the
        # offline DebugTokenizer lets serving and eval run without downloads
        logger.warning(f"{model_path}: no tokenizer files; using DebugTokenizer")
        from llava_plus_torch.data.debug_tokenizer import DebugTokenizer

        return DebugTokenizer(vocab_size=_read_config(path).get("vocab_size", 32000))
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_path, use_fast=True)


def _read_config(path: Path) -> dict:
    return json.loads((path / "config.json").read_text())


def load_pretrained_model(
    model_path: str,
    model_base: Optional[str] = None,
    model_name: Optional[str] = None,
    *,
    dtype="bfloat16",
    device="cpu",
) -> Tuple[object, dict, LlavaConfig, Optional[ClipImageProcessor], int]:
    """(tokenizer, params, cfg, image_processor, context_len) of the
    checkpoint at ``model_path`` (over ``model_base`` for the LoRA and the
    base + projector shapes); ``dtype`` is a torch dtype or its name. A
    plain language model (the base a training recipe starts from) is read
    onto ``device`` and laid out there (a card stacks and transposes its
    matrices far faster than the host); every other kind is read on the
    host."""
    path = Path(model_path)
    model_name = model_name or path.name
    is_llava = "llava" in model_name.lower()

    # (the reference also requires 'llava' in the name; an
    # adapter_config.json over a base is unambiguous, so any name is taken)
    if model_base is not None and (path / "adapter_config.json").exists():
        from llava_plus_torch.train.lora import merge_lora_checkpoint

        tokenizer, params, cfg = merge_lora_checkpoint(path, Path(model_base), dtype)
    elif model_base is not None and (path / "mm_projector.bin").exists():
        tokenizer, params, cfg = _load_base_plus_projector(path, Path(model_base), dtype)
    elif is_llava or _has_mm_config(path):
        params, cfg = hf_import.llava_params_from_hf_dir(path, dtype=dtype)
        tokenizer = load_tokenizer(model_path)
    else:
        text_cfg = hf_import.llama_config_from_hf(_read_config(path))
        sd = hf_import.load_state_dict_dir(path, device)
        lm = hf_import.llama_params_from_state_dict(sd, text_cfg, dtype=dtype)
        cfg = LlavaConfig(text=text_cfg, mm_projector_type="identity")
        params = {"language_model": lm, "vision_tower": {}, "mm_projector": {}}
        tokenizer = load_tokenizer(model_path)

    image_processor = None
    if is_llava or _has_mm_config(path):
        # sized from the checkpoint's own vision dims (mm_vision_config when
        # present), not from the tower's name
        size = cfg.vision.image_size
        image_processor = ClipImageProcessor(shortest_edge=size, crop_size=size)
    return tokenizer, params, cfg, image_processor, _context_len(path)


def _leaf_paths(tree, prefix=()):
    """(path, leaf) of every leaf of a nested dict / list tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _structure(tree, leaf):
    """The nested dict / list structure of ``tree`` with ``leaf(x)`` at each
    leaf x."""
    if isinstance(tree, dict):
        return {k: _structure(v, leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v, leaf) for v in tree]
    return leaf(tree)


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def load_sharded_model(model_path: str, model_base: Optional[str] = None,
                       model_name: Optional[str] = None, *, tp, device,
                       quantize: Optional[str] = None, dtype="bfloat16"):
    """:func:`load_pretrained_model` for tensor-parallel serving: rank 0 of
    the serving group ``tp`` (``parallel/tp.TPGroup``) loads the checkpoint
    once; its tokenizer, config and image processor reach the other ranks
    pickled over the group's control channel, and the tree leaf by leaf
    over its collectives, each leaf on ``device``. Every rank keeps only its
    slice of each leaf: a matrix that ``quantize`` ("int8" / "int4")
    quantizes is quantized whole on the card first, then cut
    (``tp.shard_plan``); LLaMA's matrices are fused after, as
    ``TorchBackend(quantize=...)`` fuses them. Rank 0 drops each host leaf
    as it is sent, so no host holds more than the one checkpoint. Returns
    the same 5-tuple, with this rank's tree."""
    import torch.distributed as dist

    from llava_plus_torch.ops import quant
    from llava_plus_torch.parallel import tp as tp_lib

    meta = [None]
    if tp.leader:
        tokenizer, params, cfg, processor, ctx = load_pretrained_model(
            model_path, model_base, model_name, dtype=dtype)
        meta = [(tokenizer, cfg, processor, ctx,
                 _structure(params, lambda x: (tuple(x.shape), x.dtype)))]
    root = dist.get_global_rank(tp.group, 0)
    dist.broadcast_object_list(meta, src=dist.get_global_rank(tp.control, 0), group=tp.control)
    tokenizer, cfg, processor, ctx, skeleton = meta[0]
    plan = tp_lib.shard_plan(cfg, tp.rank, tp.size)
    bits = {"int8": 8, "int4": 4, None: None}[quantize]
    qpaths = set(quant.MPT_QUANT_PATHS if cfg.language_model_type == "mpt"
                 else quant.LLAMA_QUANT_PATHS)
    out = _structure(skeleton, lambda x: None)
    for path, (shape, leaf_dtype) in _leaf_paths(skeleton):
        if tp.leader:
            host = params
            for k in path[:-1]:
                host = host[k]
            full = host[path[-1]].to(device)
            host[path[-1]] = None   # the host copy goes as it is sent
        else:
            full = torch.empty(shape, dtype=leaf_dtype, device=device)
        dist.broadcast(full, root, group=tp.group)
        leaf = full
        if path[0] == "language_model":
            if bits is not None and path[1:] in qpaths:
                leaf = quant._quantize_matrix(full, bits)
            leaf = tp_lib.shard_leaf(path[1:], leaf, plan)
        _put(out, path, leaf)
        del full, leaf
    if bits is not None and cfg.language_model_type == "llama":
        quant.fuse_llama_matrices(out["language_model"])
    return tokenizer, out, cfg, processor, ctx


def _has_mm_config(path: Path) -> bool:
    try:
        return "mm_vision_tower" in _read_config(path)
    except (OSError, ValueError):
        return False


def _context_len(path: Path) -> int:
    try:
        d = _read_config(path)
    except (OSError, ValueError):
        return 2048
    if "max_sequence_length" in d:
        return d["max_sequence_length"]
    return d.get("tokenizer_model_max_length", 2048)


def _load_base_plus_projector(path: Path, base: Path, dtype):
    """Stage-1 output: the base LM, the CLIP tower and the trained
    ``mm_projector.bin`` (the reference's builder.py:83-99)."""
    d_ckpt = _read_config(path)
    text_cfg = hf_import.llama_config_from_hf(_read_config(base))
    lm = hf_import.llama_params_from_state_dict(hf_import.load_state_dict_dir(base),
                                                text_cfg, dtype=dtype)
    cfg = LlavaConfig(
        text=text_cfg,
        mm_projector_type=d_ckpt.get("mm_projector_type", "linear"),
        mm_hidden_size=d_ckpt.get("mm_hidden_size", 1024),
        image_aspect_ratio=d_ckpt.get("image_aspect_ratio", "square"),
    )
    proj_sd = torch.load(str(path / "mm_projector.bin"), map_location="cpu", weights_only=True)
    proj_sd = {k.replace("model.mm_projector.", ""): v for k, v in proj_sd.items()}
    proj = hf_import.projector_params_from_state_dict(proj_sd, cfg.mm_projector_type,
                                                      dtype=dtype)
    vt = _load_vision_tower(d_ckpt, cfg, dtype)
    tokenizer = load_tokenizer(str(base))
    return tokenizer, {"language_model": lm, "vision_tower": vt, "mm_projector": proj}, cfg


def _load_vision_tower(cfg_dict: dict, cfg: LlavaConfig, dtype):
    """The CLIP tower that ``mm_vision_tower`` names, read from a local
    directory (nothing is downloaded). Where there is none, the tower is
    random (seed 0) with a warning, as in the JAX package: the logits then do
    not match the reference."""
    name = cfg_dict.get("mm_vision_tower", "openai/clip-vit-large-patch14-336")
    p = Path(name)
    if p.exists():
        return hf_import.clip_params_from_state_dict(hf_import.load_state_dict_dir(p),
                                                     cfg.vision, dtype=dtype)
    warnings.warn(f"vision tower checkpoint {name} not found locally; initializing "
                  "randomly (logits will NOT match the reference)")
    from llava_plus_torch.models import clip_vit

    return clip_vit.init_params(cfg.vision, torch.Generator().manual_seed(0), "cpu",
                                hf_import.torch_dtype(dtype))
