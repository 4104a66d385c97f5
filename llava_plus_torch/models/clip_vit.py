"""CLIP ViT vision tower in PyTorch.

Counterpart of ``llava_plus_tpu/models/clip_vit.py``: same parameter tree,
NHWC input, patches flattened in (channel, py, px) order so the patch conv is
one matmul, quick_gelu MLP, and hidden-layer selection as HF's
``output_hidden_states`` (default layer -2, patch features without CLS).
Attention is plain torch ops (head dim 64; the JAX tower has no kernel).
"""

from __future__ import annotations

import torch

from llava_plus_torch.models.configs import ClipVisionConfig


def init_params(cfg: ClipVisionConfig, generator: torch.Generator, device,
                dtype=torch.bfloat16):
    """Random init made directly on ``device`` (``generator`` lives there)."""
    D, Fd, L, P = (cfg.hidden_size, cfg.intermediate_size,
                   cfg.num_hidden_layers, cfg.patch_size)

    def norm(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype).mul_(0.02)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ln(*lead):
        return {"scale": torch.ones(*lead, D, device=device, dtype=dtype),
                "bias": zeros(*lead, D)}

    return {
        "class_embedding": norm(D),
        "patch_embedding": norm(P * P * 3, D),
        "position_embedding": norm(cfg.num_positions, D),
        "pre_layernorm": ln(),
        "layers": {
            "ln1": ln(L),
            "ln2": ln(L),
            "attn": {
                "wq": norm(L, D, D), "bq": zeros(L, D),
                "wk": norm(L, D, D), "bk": zeros(L, D),
                "wv": norm(L, D, D), "bv": zeros(L, D),
                "wo": norm(L, D, D), "bo": zeros(L, D),
            },
            "mlp": {
                "w1": norm(L, D, Fd), "b1": zeros(L, Fd),
                "w2": norm(L, Fd, D), "b2": zeros(L, D),
            },
        },
        # present in HF checkpoints, unused for hidden-state features
        "post_layernorm": ln(),
    }


def layer_norm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * p["scale"].float() + p["bias"].float()).to(x.dtype)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, C*P*P] in HF Conv2d weight order (c, py, px)."""
    B, H, W, C = images.shape
    P = patch_size
    gh, gw = H // P, W // P
    x = images.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, gh * gw, C * P * P)


def _vit_layer(lp, h: torch.Tensor, cfg: ClipVisionConfig) -> torch.Tensor:
    B, T, D = h.shape
    H, Dh = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.layer_norm_eps
    a = lp["attn"]

    hn = layer_norm(h, lp["ln1"], eps)
    q = (hn @ a["wq"] + a["bq"]).reshape(B, T, H, Dh)
    k = (hn @ a["wk"] + a["bk"]).reshape(B, T, H, Dh)
    v = (hn @ a["wv"] + a["bv"]).reshape(B, T, H, Dh)
    # bidirectional, no padding; f32 logits of the compute-dtype operands
    logits = torch.einsum("bthd,bshd->bhts", (q * Dh ** -0.5).float(), k.float())
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(h.dtype).float(), v.float())
    h = h + out.to(h.dtype).reshape(B, T, D) @ a["wo"] + a["bo"]

    hn = layer_norm(h, lp["ln2"], eps)
    inner = (hn @ lp["mlp"]["w1"] + lp["mlp"]["b1"]).float()
    act = (inner * torch.sigmoid(1.702 * inner)).to(h.dtype)  # quick_gelu
    return h + act @ lp["mlp"]["w2"] + lp["mlp"]["b2"]


def encode(params, cfg: ClipVisionConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] float -> features [B, N(+1), D] of the hidden
    layer ``cfg.select_layer``."""
    L = cfg.num_hidden_layers
    stop = cfg.select_layer % (L + 1)  # hidden_states has L + 1 entries

    patches = patchify(images.to(params["patch_embedding"].dtype), cfg.patch_size)
    h = patches @ params["patch_embedding"]
    cls = params["class_embedding"].expand(h.shape[0], 1, h.shape[-1])
    h = torch.cat([cls, h], dim=1) + params["position_embedding"][None]
    h = layer_norm(h, params["pre_layernorm"], cfg.layer_norm_eps)

    lay = params["layers"]
    for i in range(stop):
        lp = {
            "ln1": {n: w[i] for n, w in lay["ln1"].items()},
            "ln2": {n: w[i] for n, w in lay["ln2"].items()},
            "attn": {n: w[i] for n, w in lay["attn"].items()},
            "mlp": {n: w[i] for n, w in lay["mlp"].items()},
        }
        h = _vit_layer(lp, h, cfg)

    if cfg.select_feature == "patch":
        return h[:, 1:]
    if cfg.select_feature == "cls_patch":
        return h
    raise ValueError(f"Unexpected select feature: {cfg.select_feature}")
