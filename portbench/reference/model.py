"""The plain reference: LLaVA in float32 PyTorch, with no kernel, cache or
batching, and TF32 off.

It follows the published models: CLIP ViT-L/14 (pre-LayerNorm, quick-GELU,
the hidden state of ``mm_vision_select_layer`` without CLS), the projector
(``linear`` or ``mlp<N>x_gelu`` with exact GELU), the splice of the image
features at the image token, and the decoder: MPT (LayerNorm without bias,
fused ``Wqkv``, ALiBi, exact GELU, head tied to ``wte``) or LLaMA / Mistral
(RMSNorm, RoPE, grouped-query attention, SwiGLU). The served system quantizes
the language model's matrices to int8, one scale per output column; the
reference works those values out again from the weights that
``portbench/weights.py`` makes and multiplies in float32. Its keys and
values stay float32 (the served cache's int8 rounding is part of the gap the
check allows).

It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGE = -200  # the image token's place in a prompt's ids


def precise():
    """float32 products in float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def int8_values(w: torch.Tensor) -> torch.Tensor:
    """``w [.., K, N]`` as its int8 quantization reads: per output column,
    scale = max(|w|) over K / 127 (at least 1e-8 / 127), round half to
    even, clip to +-127; returned dequantized in float32."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    return torch.clamp(torch.round(wf / scale), -127, 127) * scale


def pixels(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [N, H, W, 3] at the tower's size -> normalized float32."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def _ln(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"].float(), p["bias"].float(), eps)


def clip_features(vt: dict, v: dict, select_layer: int, images: torch.Tensor) -> torch.Tensor:
    """images [N, H, W, 3] float32 -> [N, patches, width] of the selected
    hidden state, CLS left out."""
    N, Hh, Ww, C = images.shape
    P = v["patch_size"]
    g = Hh // P
    # conv weight order (c, py, px) per patch
    x = images.reshape(N, g, P, g, P, C).permute(0, 1, 3, 5, 2, 4).reshape(N, g * g, C * P * P)
    h = x @ vt["patch_embedding"].float()
    cls = vt["class_embedding"].float().expand(N, 1, h.shape[-1])
    h = torch.cat([cls, h], dim=1) + vt["position_embedding"].float()[None]
    eps = v["layer_norm_eps"]
    h = _ln(h, vt["pre_layernorm"], eps)
    L = v["num_hidden_layers"]
    heads = v["num_attention_heads"]
    Dh = h.shape[-1] // heads
    lay = vt["layers"]
    for i in range(select_layer % (L + 1)):
        a, m = {k: w[i].float() for k, w in lay["attn"].items()}, \
            {k: w[i].float() for k, w in lay["mlp"].items()}
        hn = _ln(h, {k: w[i] for k, w in lay["ln1"].items()}, eps)
        T = hn.shape[1]
        q = (hn @ a["wq"] + a["bq"]).reshape(N, T, heads, Dh).transpose(1, 2)
        k = (hn @ a["wk"] + a["bk"]).reshape(N, T, heads, Dh).transpose(1, 2)
        vv = (hn @ a["wv"] + a["bv"]).reshape(N, T, heads, Dh).transpose(1, 2)
        att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(Dh), dim=-1) @ vv
        h = h + att.transpose(1, 2).reshape(N, T, -1) @ a["wo"] + a["bo"]
        hn = _ln(h, {k: w[i] for k, w in lay["ln2"].items()}, eps)
        inner = hn @ m["w1"] + m["b1"]
        h = h + (inner * torch.sigmoid(1.702 * inner)) @ m["w2"] + m["b2"]
    return h[:, 1:]


def project(pj: dict, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(pj["layers"]):
        if i > 0:
            x = F.gelu(x)
        x = x @ layer["w"].float() + layer["b"].float()
    return x


def alibi_slopes(n_heads: int, bias_max: int) -> torch.Tensor:
    n2 = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, n2 + 1, dtype=torch.float32) * (bias_max / n2)
    slopes = 1.0 / torch.pow(2.0, m)
    if n2 != n_heads:
        slopes = torch.cat([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes


def _attend(q, k, v, bias=None):
    """q [H, T, Dh], k / v [Hkv, T, Dh]: causal softmax attention."""
    H, T, Dh = q.shape
    rep = H // k.shape[0]
    k = k.repeat_interleave(rep, dim=0)
    v = v.repeat_interleave(rep, dim=0)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(Dh)
    if bias is not None:
        s = s + bias
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def _rope(x, theta):
    """x [H, T, Dh], positions 0 .. T-1, rotate-half layout."""
    H, T, Dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, dtype=torch.float32, device=x.device) / Dh)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
    rot = torch.cat([-x[..., Dh // 2:], x[..., :Dh // 2]], dim=-1)
    return x * cos + rot * sin


def _mpt_layers(lm, cfg, hs):
    D, H = cfg["d_model"], cfg["n_heads"]
    Dh = D // H
    a = cfg["attn_config"]
    slopes = alibi_slopes(H, a["alibi_bias_max"]).to(hs[0].device)
    lay = lm["layers"]
    for i in range(cfg["n_layers"]):
        wqkv = int8_values(lay["attn"]["wqkv"][i])
        wo = int8_values(lay["attn"]["out_proj"][i])
        up = int8_values(lay["mlp"]["up_proj"][i])
        down = int8_values(lay["mlp"]["down_proj"][i])
        n1, n2 = lay["norm1"][i].float(), lay["norm2"][i].float()
        for j, h in enumerate(hs):
            T = h.shape[0]
            x = F.layer_norm(h, (D,), n1, None, 1e-5)
            q, k, v = (x @ wqkv).split(D, dim=-1)
            q, k, v = (t.reshape(T, H, Dh).transpose(0, 1) for t in (q, k, v))
            pos = torch.arange(T, device=h.device, dtype=torch.float32)
            bias = -slopes[:, None, None] * (pos[:, None] - pos[None, :]).abs()
            h = h + _attend(q, k, v, bias).transpose(0, 1).reshape(T, D) @ wo
            x = F.layer_norm(h, (D,), n2, None, 1e-5)
            hs[j] = h + F.gelu(x @ up) @ down
    nf = lm["norm_f"].float()
    return [F.layer_norm(h, (D,), nf, None, 1e-5) for h in hs], lm["wte"].float().T


def _llama_layers(lm, cfg, hs):
    D, H, Hkv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = D // H
    eps = cfg["rms_norm_eps"]
    lay = lm["layers"]

    def rms(x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w

    for i in range(cfg["num_hidden_layers"]):
        wq, wk, wv, wo = (int8_values(lay["attn"][n][i]) for n in ("wq", "wk", "wv", "wo"))
        wg, wu, wd = (int8_values(lay["mlp"][n][i]) for n in ("w_gate", "w_up", "w_down"))
        n1, n2 = lay["input_norm"][i].float(), lay["post_attn_norm"][i].float()
        for j, h in enumerate(hs):
            T = h.shape[0]
            x = rms(h, n1)
            q = _rope((x @ wq).reshape(T, H, Dh).transpose(0, 1), cfg["rope_theta"])
            k = _rope((x @ wk).reshape(T, Hkv, Dh).transpose(0, 1), cfg["rope_theta"])
            v = (x @ wv).reshape(T, Hkv, Dh).transpose(0, 1)
            h = h + _attend(q, k, v).transpose(0, 1).reshape(T, D) @ wo
            x = rms(h, n2)
            hs[j] = h + (F.silu(x @ wg) * (x @ wu)) @ wd
    nf = lm["final_norm"].float()
    return [rms(h, nf) for h in hs], int8_values(lm["lm_head"])


def logits(tree: dict, cfg: dict, sequences: Sequence[List[int]],
           images: Sequence[torch.Tensor], rows: Sequence[slice]) -> List[torch.Tensor]:
    """float32 logits [len(rows[i]), V] of each sequence at ``rows[i]``.

    ``sequences[i]`` holds token ids with one ``IMAGE`` entry where the
    image's patches go; ``images[i]`` is its uint8 [H, W, 3] image."""
    lm = tree["language_model"]
    v = cfg["vision"]
    emb = lm["wte"] if cfg["family"] == "mpt" else lm["embed_tokens"]
    feats = project(tree["mm_projector"], clip_features(
        tree["vision_tower"], v, cfg["mm_vision_select_layer"],
        pixels(torch.stack(list(images)))))
    hs = []
    for ids, f in zip(sequences, feats):
        at = ids.index(IMAGE)
        before = emb[torch.tensor(ids[:at], device=emb.device, dtype=torch.long)].float()
        after = emb[torch.tensor(ids[at + 1:], device=emb.device, dtype=torch.long)].float()
        hs.append(torch.cat([before, f, after]))
    layers = _mpt_layers if cfg["family"] == "mpt" else _llama_layers
    hs, head = layers(lm, cfg, hs)
    return [h[r] @ head for h, r in zip(hs, rows)]


def fused_ids(prompt: str, tokenizer, cfg: dict) -> List[int]:
    """A prompt's ids as LLaVA builds them: the text around ``<image>``
    tokenized piece by piece (one BOS, at the front), image start / end
    tokens around it where the model has them, and one ``IMAGE`` entry."""
    before, after = prompt.split("<image>")
    if cfg["mm_use_im_start_end"]:
        before, after = before + " <im_start>", "<im_end> " + after
    head = tokenizer.encode(before)
    tail = tokenizer.encode(after)
    if tokenizer.bos_token_id is not None:
        tail = tail[1:]
    return head + [IMAGE] + tail
