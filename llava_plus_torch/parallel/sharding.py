"""Sharding rule tables: parameter trees -> spec trees.

Counterpart of ``llava_plus_tpu/parallel/sharding.py``, with each JAX
``PartitionSpec`` written as a plain tuple of its entries (None, an axis
name, or a tuple of names; ``parallel/mesh.py``). ZeRO-2/3 (the reference's
DeepSpeed configs) maps to the ``fsdp`` axis: parameters and optimizer
state shard over it. Spec trees mirror the parameter trees exactly (the
stacked layer dim L first).
"""

from __future__ import annotations

from llava_plus_torch.models.configs import LlavaConfig
from llava_plus_torch.models.projector import parse_projector_type


def llama_param_specs(fsdp: str = "fsdp", tp: str = "tp"):
    """Specs for the ``models/llama.py`` tree: tp shards the head / ffn
    output dims, fsdp the other large dim; norms replicate."""
    return {
        # vocab rows over fsdp + tp, D replicated
        "embed_tokens": ((fsdp, tp), None),  # [V, D]
        "final_norm": (None,),               # [D]
        "lm_head": (fsdp, tp),               # [D, V]
        "layers": {
            "attn": {
                "wq": (None, fsdp, tp),      # [L, D, H*Dh]
                "wk": (None, fsdp, tp),
                "wv": (None, fsdp, tp),
                "wo": (None, tp, fsdp),      # [L, H*Dh, D]
            },
            "mlp": {
                "w_gate": (None, fsdp, tp),  # [L, D, F]
                "w_up": (None, fsdp, tp),
                "w_down": (None, tp, fsdp),  # [L, F, D]
            },
            "input_norm": (None, None),
            "post_attn_norm": (None, None),
        },
    }


def mpt_param_specs(fsdp: str = "fsdp", tp: str = "tp"):
    return {
        "wte": (tp, fsdp),
        "norm_f": (None,),
        "layers": {
            "norm1": (None, None),
            "norm2": (None, None),
            "attn": {
                "wqkv": (None, fsdp, tp),
                "out_proj": (None, tp, fsdp),
            },
            "mlp": {
                "up_proj": (None, fsdp, tp),
                "down_proj": (None, tp, fsdp),
            },
        },
    }


def clip_param_specs(fsdp: str = "fsdp", tp: str = "tp"):
    """Vision tower: frozen and comparatively small; only the fat matrices
    shard over fsdp."""
    ln = {"scale": (None, None), "bias": (None, None)}
    return {
        "class_embedding": (None,),
        "patch_embedding": (None, fsdp),
        "position_embedding": (None, None),
        "pre_layernorm": {"scale": (None,), "bias": (None,)},
        "post_layernorm": {"scale": (None,), "bias": (None,)},
        "layers": {
            "ln1": dict(ln),
            "ln2": dict(ln),
            "attn": {
                "wq": (None, None, fsdp), "bq": (None, None),
                "wk": (None, None, fsdp), "bk": (None, None),
                "wv": (None, None, fsdp), "bv": (None, None),
                "wo": (None, fsdp, None), "bo": (None, None),
            },
            "mlp": {
                "w1": (None, None, fsdp), "b1": (None, None),
                "w2": (None, fsdp, None), "b2": (None, None),
            },
        },
    }


def projector_param_specs(projector_type: str, fsdp: str = "fsdp", tp: str = "tp"):
    depth = parse_projector_type(projector_type)
    if depth == 0:
        return {}
    return {"layers": [{"w": (fsdp, None), "b": (None,)} for _ in range(depth)]}


def llava_param_specs(cfg: LlavaConfig, fsdp: str = "fsdp", tp: str = "tp"):
    if cfg.language_model_type == "mpt":
        lm = mpt_param_specs(fsdp, tp)
    else:
        lm = llama_param_specs(fsdp, tp)
        if cfg.text.tie_word_embeddings:
            lm.pop("lm_head", None)
    return {
        "language_model": lm,
        "vision_tower": clip_param_specs(fsdp, tp),
        "mm_projector": projector_param_specs(cfg.mm_projector_type, fsdp, tp),
    }
