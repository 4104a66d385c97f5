"""HF checkpoint import: safetensors / ``.bin`` state dicts -> the port's
parameter trees.

Counterpart of ``llava_plus_tpu/models/hf_import.py``: full LLaVA
checkpoints (LLaMA and MPT backbones), plain LLaMA / Vicuna LMs, standalone
CLIP towers and ``mm_projector.bin`` adapters. Weights transpose from
torch's [out, in] to the trees' [in, out], and per-layer tensors stack along
a leading L axis: the same tree, key for key and value for value, that
``models/convert.from_numpy`` makes from the JAX package's import.

Everything stays on the host, as torch tensors in ``dtype`` (bf16 by
default, or f32); the caller moves the tree to its device. The ``*_from_
state_dict`` functions consume the keys they read: each tensor leaves the
state dict once it is in the tree, so a 7B load does not hold two full
copies on the host.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Dict, Optional

import torch

from llava_plus_torch.models.configs import (
    ClipVisionConfig,
    LlamaConfig,
    LlavaConfig,
    MptConfig,
)
from llava_plus_torch.models.projector import parse_projector_type

StateDict = Dict[str, torch.Tensor]


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a name ("bfloat16", "float32")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(dtype)]


# ---------------------------------------------------------------------------
# State-dict readers
# ---------------------------------------------------------------------------

def load_state_dict_dir(path, device="cpu") -> StateDict:
    """Every ``*.safetensors`` in a checkpoint directory, or else every
    ``pytorch_model*.bin`` (or, without those, every ``*.bin``), merged into
    one dict of tensors as stored, on ``device``."""
    path = Path(path)
    sd: StateDict = {}
    st_files = sorted(path.glob("*.safetensors"))
    if st_files:
        from safetensors.torch import load_file

        for f in st_files:
            sd.update(load_file(str(f), device=str(device)))
        return sd
    bins = sorted(path.glob("pytorch_model*.bin")) or sorted(path.glob("*.bin"))
    for f in bins:
        sd.update(torch.load(str(f), map_location=device, weights_only=True))
    return sd


def strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _reader(sd: StateDict, prefix: str, dtype):
    """(get, stack): ``get(key)`` pops one tensor as ``dtype``;
    ``stack(fmt, L, transpose)`` pops the L per-layer tensors of ``fmt`` and
    stacks them (each transposed if asked) into one contiguous tensor."""
    dt = torch_dtype(dtype)

    def get(key):
        return sd.pop(prefix + key).to(dt)

    def stack(fmt, L, transpose):
        mats = [sd.pop(prefix + fmt.format(i)) for i in range(L)]
        return torch.stack([m.T if transpose else m for m in mats]).to(dt)

    return get, stack


# ---------------------------------------------------------------------------
# LLaMA
# ---------------------------------------------------------------------------

def llama_params_from_state_dict(sd: StateDict, cfg: LlamaConfig, dtype="bfloat16",
                                 prefix: str = ""):
    """Keys: {prefix}model.embed_tokens.weight, {prefix}model.layers.N.*,
    {prefix}model.norm.weight, {prefix}lm_head.weight."""
    get, stack = _reader(sd, prefix, dtype)
    L = cfg.num_hidden_layers
    params = {
        "embed_tokens": get("model.embed_tokens.weight"),
        "final_norm": get("model.norm.weight"),
        "layers": {
            "attn": {
                "wq": stack("model.layers.{}.self_attn.q_proj.weight", L, True),
                "wk": stack("model.layers.{}.self_attn.k_proj.weight", L, True),
                "wv": stack("model.layers.{}.self_attn.v_proj.weight", L, True),
                "wo": stack("model.layers.{}.self_attn.o_proj.weight", L, True),
            },
            "mlp": {
                "w_gate": stack("model.layers.{}.mlp.gate_proj.weight", L, True),
                "w_up": stack("model.layers.{}.mlp.up_proj.weight", L, True),
                "w_down": stack("model.layers.{}.mlp.down_proj.weight", L, True),
            },
            "input_norm": stack("model.layers.{}.input_layernorm.weight", L, False),
            "post_attn_norm": stack("model.layers.{}.post_attention_layernorm.weight", L,
                                    False),
        },
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight").T.contiguous()
    return params


def llama_config_from_hf(d: dict) -> LlamaConfig:
    rs = d.get("rope_scaling") or {}
    rs_type = rs.get("type") or rs.get("rope_type")
    if rs_type not in (None, "linear", "dynamic"):
        # llama3 / yarn / longrope are not implemented: the model loads and
        # runs within its base context, as before rope scaling existed
        warnings.warn(f"unsupported rope_scaling type {rs_type!r}: ignoring "
                      "(supported: linear, dynamic)")
        rs_type = None
    return LlamaConfig(
        rope_scaling_type=rs_type,
        rope_scaling_factor=rs.get("factor", 1.0) if rs_type else 1.0,
        vocab_size=d["vocab_size"],
        hidden_size=d["hidden_size"],
        intermediate_size=d["intermediate_size"],
        num_hidden_layers=d["num_hidden_layers"],
        num_attention_heads=d["num_attention_heads"],
        num_key_value_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
        max_position_embeddings=d.get("max_position_embeddings", 4096),
        rms_norm_eps=d.get("rms_norm_eps", 1e-5),
        rope_theta=d.get("rope_theta", 10000.0),
        tie_word_embeddings=d.get("tie_word_embeddings", False),
    )


# ---------------------------------------------------------------------------
# MPT
# ---------------------------------------------------------------------------

def mpt_params_from_state_dict(sd: StateDict, cfg: MptConfig, dtype="bfloat16",
                               prefix: str = ""):
    """Keys: {prefix}transformer.wte.weight, {prefix}transformer.blocks.N.*
    (the layout of the reference's vendored MPT and of HF MptForCausalLM)."""
    get, stack = _reader(sd, prefix, dtype)
    L = cfg.n_layers
    params = {
        "wte": get("transformer.wte.weight"),
        "norm_f": get("transformer.norm_f.weight"),
        "layers": {
            "norm1": stack("transformer.blocks.{}.norm_1.weight", L, False),
            "norm2": stack("transformer.blocks.{}.norm_2.weight", L, False),
            "attn": {
                "wqkv": stack("transformer.blocks.{}.attn.Wqkv.weight", L, True),
                "out_proj": stack("transformer.blocks.{}.attn.out_proj.weight", L, True),
            },
            "mlp": {
                "up_proj": stack("transformer.blocks.{}.ffn.up_proj.weight", L, True),
                "down_proj": stack("transformer.blocks.{}.ffn.down_proj.weight", L, True),
            },
        },
    }
    if prefix + "transformer.wpe.weight" in sd:
        params["wpe"] = get("transformer.wpe.weight")
    return params


def mpt_config_from_hf(d: dict) -> MptConfig:
    attn = d.get("attn_config", {}) or {}
    # HF's MptAttentionConfig says attn_type; the vendored config attn_impl
    multiquery = attn.get("attn_type", "multihead_attention") == "multiquery_attention"
    return MptConfig(
        vocab_size=d["vocab_size"],
        d_model=d["d_model"],
        n_layers=d["n_layers"],
        n_heads=d["n_heads"],
        expansion_ratio=d.get("expansion_ratio", 4),
        max_seq_len=d.get("max_seq_len", 2048),
        alibi=attn.get("alibi", True),
        alibi_bias_max=attn.get("alibi_bias_max", 8),
        multiquery=multiquery,
        prefix_lm=attn.get("prefix_lm", False),
        attn_uses_sequence_id=attn.get("attn_uses_sequence_id", False),
        clip_qkv=attn.get("clip_qkv"),
        qk_ln=attn.get("qk_ln", False),
        softmax_scale=attn.get("softmax_scale"),
        no_bias=d.get("no_bias", True),
        learned_pos_emb=d.get("learned_pos_emb", False),
        layer_norm_eps=d.get("layer_norm_epsilon", 1e-5),
        logit_scale=d.get("logit_scale"),
    )


# ---------------------------------------------------------------------------
# CLIP vision tower
# ---------------------------------------------------------------------------

def clip_params_from_state_dict(sd: StateDict, cfg: ClipVisionConfig, dtype="bfloat16",
                                prefix: str = "vision_model."):
    get, stack = _reader(sd, prefix, dtype)
    L = cfg.num_hidden_layers
    patch_w = get("embeddings.patch_embedding.weight")   # [D, 3, P, P]
    D = patch_w.shape[0]

    def layers(fmt, transpose):
        return stack("encoder.layers.{}." + fmt, L, transpose)

    return {
        "class_embedding": get("embeddings.class_embedding").reshape(D),
        "patch_embedding": patch_w.reshape(D, -1).T.contiguous(),   # [(C*P*P), D]
        "position_embedding": get("embeddings.position_embedding.weight"),
        # HF's attribute really is spelled "pre_layrnorm"
        "pre_layernorm": {"scale": get("pre_layrnorm.weight"), "bias": get("pre_layrnorm.bias")},
        "post_layernorm": {"scale": get("post_layernorm.weight"),
                           "bias": get("post_layernorm.bias")},
        "layers": {
            "ln1": {"scale": layers("layer_norm1.weight", False),
                    "bias": layers("layer_norm1.bias", False)},
            "ln2": {"scale": layers("layer_norm2.weight", False),
                    "bias": layers("layer_norm2.bias", False)},
            "attn": {
                "wq": layers("self_attn.q_proj.weight", True),
                "bq": layers("self_attn.q_proj.bias", False),
                "wk": layers("self_attn.k_proj.weight", True),
                "bk": layers("self_attn.k_proj.bias", False),
                "wv": layers("self_attn.v_proj.weight", True),
                "bv": layers("self_attn.v_proj.bias", False),
                "wo": layers("self_attn.out_proj.weight", True),
                "bo": layers("self_attn.out_proj.bias", False),
            },
            "mlp": {
                "w1": layers("mlp.fc1.weight", True),
                "b1": layers("mlp.fc1.bias", False),
                "w2": layers("mlp.fc2.weight", True),
                "b2": layers("mlp.fc2.bias", False),
            },
        },
    }


def clip_config_from_hf(d: dict) -> ClipVisionConfig:
    v = d.get("vision_config", d)
    return ClipVisionConfig(
        hidden_size=v["hidden_size"],
        intermediate_size=v["intermediate_size"],
        num_hidden_layers=v["num_hidden_layers"],
        num_attention_heads=v["num_attention_heads"],
        image_size=v["image_size"],
        patch_size=v["patch_size"],
        layer_norm_eps=v.get("layer_norm_eps", 1e-5),
    )


# ---------------------------------------------------------------------------
# Projector
# ---------------------------------------------------------------------------

def projector_params_from_state_dict(sd: StateDict, projector_type: str, dtype="bfloat16",
                                     prefix: str = ""):
    """The ``mm_projector`` weights: indices 0, 2, 4 ... of the torch
    ``nn.Sequential`` are its linear layers (GELUs between), keys
    ``{prefix}0.weight``; a lone linear layer may also be
    ``{prefix}weight``."""
    depth = parse_projector_type(projector_type)
    if depth == 0:
        return {}
    dt = torch_dtype(dtype)
    layers = []
    for i in range(depth):
        key_w = f"{prefix}{2 * i}.weight"
        if key_w not in sd and depth == 1:
            key_w, key_b = f"{prefix}weight", f"{prefix}bias"
        else:
            key_b = f"{prefix}{2 * i}.bias"
        layers.append({"w": sd.pop(key_w).T.to(dt).contiguous(), "b": sd.pop(key_b).to(dt)})
    return {"layers": layers}


# ---------------------------------------------------------------------------
# Full LLaVA checkpoints
# ---------------------------------------------------------------------------

def llava_config_from_hf_dir(path) -> LlavaConfig:
    d = json.loads((Path(path) / "config.json").read_text())
    vision_name = d.get("mm_vision_tower", "openai/clip-vit-large-patch14-336")
    if "mm_vision_config" in d:
        # the exporters record the tower's own dims (non-CLIP-L towers, tiny
        # checkpoints); the reference's checkpoints carry only its name
        vision = ClipVisionConfig(**d["mm_vision_config"])
    else:
        vision = ClipVisionConfig(
            image_size=336 if "336" in str(vision_name) else 224,
            select_layer=d.get("mm_vision_select_layer", -2),
            select_feature=d.get("mm_vision_select_feature", "patch"),
        )
    common = dict(
        vision=vision,
        mm_projector_type=d.get("mm_projector_type", "linear"),
        mm_hidden_size=d.get("mm_hidden_size", 1024),
        image_aspect_ratio=d.get("image_aspect_ratio", "square"),
        mm_use_im_start_end=d.get("mm_use_im_start_end", False),
        mm_use_im_patch_token=d.get("mm_use_im_patch_token", True),
        max_sequence_length=d.get("tokenizer_model_max_length", 2048),
    )
    # LLaVA-MPT: model_type "llava_mpt", the MPT keys at the top level
    # (the reference's llava_mpt.py)
    if d.get("model_type") == "llava_mpt" or ("d_model" in d and "hidden_size" not in d):
        return LlavaConfig(language_model_type="mpt", mpt=mpt_config_from_hf(d), **common)
    return LlavaConfig(language_model_type="llama", text=llama_config_from_hf(d), **common)


def llava_params_from_hf_dir(path, cfg: Optional[LlavaConfig] = None, dtype="bfloat16"):
    """A full LLaVA HF checkpoint directory -> (params, cfg) (the reference
    builder's "full llava ckpt" path). A checkpoint without the tower's keys
    fails here, as in the JAX package."""
    path = Path(path)
    if cfg is None:
        cfg = llava_config_from_hf_dir(path)
    sd = load_state_dict_dir(path)
    if cfg.language_model_type == "mpt":
        # LLaVA-MPT keeps tower and projector under transformer.* (its model
        # subclasses MptModel)
        lm = mpt_params_from_state_dict(sd, cfg.mpt, dtype=dtype)
        vt_prefix = "transformer.vision_tower.vision_tower.vision_model."
        proj_prefix = "transformer.mm_projector."
    else:
        lm = llama_params_from_state_dict(sd, cfg.text, dtype=dtype)
        vt_prefix = "model.vision_tower.vision_tower.vision_model."
        proj_prefix = "model.mm_projector."
    vt = clip_params_from_state_dict(sd, cfg.vision, dtype=dtype, prefix=vt_prefix)
    proj = projector_params_from_state_dict(sd, cfg.mm_projector_type, dtype=dtype,
                                            prefix=proj_prefix)
    return {"language_model": lm, "vision_tower": vt, "mm_projector": proj}, cfg
