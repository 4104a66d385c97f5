"""Random weights of a configuration, made from the run's seed on the device.

The tree has the layout that ``llava_plus_torch`` serves and trains
(stacked per-layer matrices ``[L, in, out]``, ``x @ w``). Every tensor is
drawn in one call, in a fixed order, by one ``torch.Generator`` on the
device, in the served dtype: N(0, 0.02) matrices and embeddings, norms at 1,
biases at 0. The same seed on the same kind of device gives the same tree,
so the reference (``portbench/reference``) makes it again after the program
has consumed its own copy.
"""

from __future__ import annotations

import torch

STD = 0.02


def _maker(seed: int, device, dtype):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(STD)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    return normal, ones, zeros


def projector_depth(kind: str) -> int:
    if kind == "linear":
        return 1
    if kind.startswith("mlp") and kind.endswith("x_gelu"):
        return int(kind[3:-6])
    raise ValueError(f"unknown projector type {kind!r}")


def hidden_size(cfg: dict) -> int:
    return cfg["d_model"] if cfg["family"] == "mpt" else cfg["hidden_size"]


def make_tree(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{"language_model", "vision_tower", "mm_projector"} of ``cfg`` (a
    ``portbench/configs`` file)."""
    normal, ones, zeros = _maker(seed, device, dtype)
    V = cfg["vocab_size"]
    if cfg["family"] == "mpt":
        D, L = cfg["d_model"], cfg["n_layers"]
        F = cfg["expansion_ratio"] * D
        lm = {
            "wte": normal(V, D),
            "layers": {
                "norm1": ones(L, D), "norm2": ones(L, D),
                "attn": {"wqkv": normal(L, D, 3 * D), "out_proj": normal(L, D, D)},
                "mlp": {"up_proj": normal(L, D, F), "down_proj": normal(L, F, D)},
            },
            "norm_f": ones(D),
        }
    else:
        D, F, L = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
        H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        Dh = D // H
        lm = {
            "embed_tokens": normal(V, D),
            "layers": {
                "attn": {"wq": normal(L, D, H * Dh), "wk": normal(L, D, Hkv * Dh),
                         "wv": normal(L, D, Hkv * Dh), "wo": normal(L, H * Dh, D)},
                "mlp": {"w_gate": normal(L, D, F), "w_up": normal(L, D, F),
                        "w_down": normal(L, F, D)},
                "input_norm": ones(L, D), "post_attn_norm": ones(L, D),
            },
            "final_norm": ones(D),
            "lm_head": normal(D, V),
        }
    v = cfg["vision"]
    Dv, Fv, Lv, P = (v["hidden_size"], v["intermediate_size"], v["num_hidden_layers"],
                     v["patch_size"])
    positions = (v["image_size"] // P) ** 2 + 1

    def ln(*lead):
        return {"scale": ones(*lead, Dv), "bias": zeros(*lead, Dv)}

    vision = {
        "class_embedding": normal(Dv),
        "patch_embedding": normal(P * P * 3, Dv),
        "position_embedding": normal(positions, Dv),
        "pre_layernorm": ln(),
        "layers": {
            "ln1": ln(Lv), "ln2": ln(Lv),
            "attn": {"wq": normal(Lv, Dv, Dv), "bq": zeros(Lv, Dv),
                     "wk": normal(Lv, Dv, Dv), "bk": zeros(Lv, Dv),
                     "wv": normal(Lv, Dv, Dv), "bv": zeros(Lv, Dv),
                     "wo": normal(Lv, Dv, Dv), "bo": zeros(Lv, Dv)},
            "mlp": {"w1": normal(Lv, Dv, Fv), "b1": zeros(Lv, Fv),
                    "w2": normal(Lv, Fv, Dv), "b2": zeros(Lv, Dv)},
        },
        "post_layernorm": ln(),
    }
    layers, d_in = [], cfg["mm_hidden_size"]
    for _ in range(projector_depth(cfg["mm_projector_type"])):
        layers.append({"w": normal(d_in, D), "b": zeros(D)})
        d_in = D
    return {"language_model": lm, "vision_tower": vision, "mm_projector": {"layers": layers}}
