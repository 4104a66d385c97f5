"""Operations and bytes that the work needs, from a configuration's sizes.

Model FLOPs count 2 per multiply-add of every product at the real lengths
(no padding, no recompute); causal attention counts the keys each query
reads (QK^T and PV, 2 * 2 * head_dim each). Bytes count each input read once
and each output written once.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

HERE = Path(__file__).resolve().parent


def peaks(device_name: str, root: Path = HERE) -> Dict[str, float]:
    table = json.loads((root / "peaks.json").read_text())
    for key, row in table.items():
        if key in device_name:
            return row
    raise KeyError(f"no peaks for {device_name!r} in peaks.json")


def lm_dims(cfg: dict) -> Dict[str, int]:
    if cfg["family"] == "mpt":
        D, H = cfg["d_model"], cfg["n_heads"]
        return {"D": D, "H": H, "Hkv": H, "Dh": D // H, "L": cfg["n_layers"],
                "V": cfg["vocab_size"], "F": cfg["expansion_ratio"] * D}
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"D": D, "H": H, "Hkv": cfg["num_key_value_heads"], "Dh": D // H,
            "L": cfg["num_hidden_layers"], "V": cfg["vocab_size"],
            "F": cfg["intermediate_size"]}


def layer_matrices(cfg: dict) -> List[Tuple[int, int]]:
    """(K, N) of one decoder layer's products, as the int8 path fuses them."""
    d = lm_dims(cfg)
    D, F, kv = d["D"], d["F"], d["Hkv"] * d["Dh"]
    if cfg["family"] == "mpt":
        return [(D, 3 * D), (D, D), (D, F), (F, D)]
    return [(D, D + 2 * kv), (D, D), (D, 2 * F), (F, D)]


def layer_macs(cfg: dict) -> int:
    return sum(k * n for k, n in layer_matrices(cfg))


def head_macs(cfg: dict) -> int:
    d = lm_dims(cfg)
    return d["D"] * d["V"]


def int8_matrices(cfg: dict) -> List[Tuple[int, int]]:
    """(K, N) of every product the int8 kernels run in a decode step: the
    layers' and, for LLaMA, the quantized head (MPT's head is tied to the
    bf16 embedding and runs in cuBLAS)."""
    d = lm_dims(cfg)
    mats = layer_matrices(cfg) * d["L"]
    if cfg["family"] != "mpt":
        mats.append((d["D"], d["V"]))
    return mats


def int8_weight_bytes(cfg: dict) -> int:
    """int8 values plus one f32 scale a column, over the int8 products."""
    return sum(k * n + 4 * n for k, n in int8_matrices(cfg))


def int8_macs(cfg: dict) -> int:
    return sum(k * n for k, n in int8_matrices(cfg))


def attention_flops(cfg: dict, q_pos: int) -> int:
    """A query at position ``q_pos`` over keys 0 .. q_pos, every layer."""
    d = lm_dims(cfg)
    return 4 * d["H"] * d["Dh"] * (q_pos + 1) * d["L"]


def prefill_attention_flops(cfg: dict, T: int) -> int:
    """Causal attention of a T-token prompt, every layer."""
    d = lm_dims(cfg)
    return 2 * d["H"] * d["Dh"] * T * (T + 1) * d["L"]


def decode_token_flops(cfg: dict, q_pos: int) -> int:
    return 2 * (layer_macs(cfg) * lm_dims(cfg)["L"] + head_macs(cfg)) + attention_flops(cfg, q_pos)


def vision_flops(cfg: dict) -> int:
    """One image through the tower's layers up to the selected one, the
    patch embedding and the projector."""
    v = cfg["vision"]
    Dv, Fv, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    patches = (v["image_size"] // P) ** 2
    T = patches + 1
    layers = cfg["mm_vision_select_layer"] % (v["num_hidden_layers"] + 1)
    per_layer = 2 * T * (4 * Dv * Dv + 2 * Dv * Fv) + 4 * T * T * Dv
    D = lm_dims(cfg)["D"]
    depth = 1 if cfg["mm_projector_type"] == "linear" else int(cfg["mm_projector_type"][3:-6])
    proj = 2 * patches * (cfg["mm_hidden_size"] * D + (depth - 1) * D * D)
    return layers * per_layer + 2 * patches * 3 * P * P * Dv + proj


def prefill_flops(cfg: dict, T: int) -> int:
    """A fused prompt of T tokens (one image): the tower, the decoder over T
    rows, causal attention, and the head at the last row."""
    return (vision_flops(cfg) + 2 * layer_macs(cfg) * lm_dims(cfg)["L"] * T
            + prefill_attention_flops(cfg, T) + 2 * head_macs(cfg))


def kv_entry_bytes(cfg: dict) -> int:
    """One position's int8 keys and values in every layer, with their f32
    scale per (position, kv head)."""
    d = lm_dims(cfg)
    return d["L"] * 2 * d["Hkv"] * (d["Dh"] + 4)


def decode_attention_bytes(cfg: dict, q_pos: int) -> int:
    """What the decode kernel must read and write for one query at
    ``q_pos``: the cache entries 0 .. q_pos, the query and the output (bf16)."""
    d = lm_dims(cfg)
    return (q_pos + 1) * kv_entry_bytes(cfg) + d["L"] * 2 * 2 * d["H"] * d["Dh"]


def num_patches(cfg: dict) -> int:
    v = cfg["vision"]
    return (v["image_size"] // v["patch_size"]) ** 2
