"""Weight-only int8 / int4 quantization for serving (``--load-8bit`` /
``--load-4bit``).

Counterpart of ``llava_plus_tpu/ops/quant.py``, with the same tree format
and byte-identical values: a quantized matrix is a dict, int8
``{"qvalue": int8 [..., in, out], "scale": f32 [..., 1, out]}`` (symmetric
per output channel) or int4 ``{"qvalue4": int8 [..., in/2, out], "scale":
f32 [..., in/32, out]}`` (symmetric per 32-row block, two nibbles a byte in
split-half order). :func:`matmul` dispatches on the leaf, so model code is
the same for plain and quantized weights; on CUDA tensors every quantized
product runs the kernels of ``ops/quant_matmul.py``, at every row count.

A weight that carries LoRA adapters (``train/lora.py``'s lazy attach: the
base under ``"w"`` or the quantized leaves, ``lora_a`` [in, r] and
``lora_b`` [r, out] pre-scaled by alpha / r) is ``x @ base + (x @ a) @ b``
(JAX ``quant.py:190-199``): the frozen int8 / int4 base stays quantized on
the card and runs the kernels, whose gradient reaches x.

Not ported: the W8A8 path (int8 activations for large row counts).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from llava_plus_torch.ops import quant_matmul
from llava_plus_torch.ops.quant_matmul import INT4_BLOCK, unpack_int4 as _unpack_int4  # noqa: F401

QKEY = "qvalue"
Q4KEY = "qvalue4"
SKEY = "scale"
LORA_A = "lora_a"
LORA_B = "lora_b"
WKEY = "w"


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and (QKEY in w or Q4KEY in w)


def quantize_array(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel (last dim) int8 over the contraction dim:
    scale = max(absmax, 1e-8) / 127, round half to even, clip to +-127.

    The scale is computed as ``amax * f32(1 / 127)``: XLA rewrites the JAX
    package's jitted division by a constant into that product, which can
    differ from a true division in the last bit."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {QKEY: q, SKEY: scale}


def quantize_array_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric int4 per block of INT4_BLOCK rows of the contraction dim:
    scale = max(absmax, 1e-8) / 7, values clipped to +-7 and packed two a
    byte, low nibble = rows 0..15 of the block, high nibble = rows 16..31."""
    *lead, d_in, d_out = w.shape
    if d_in % INT4_BLOCK:
        raise ValueError(f"int4 needs an input dim divisible by {INT4_BLOCK}, got {d_in}")
    wf = w.float().reshape(*lead, d_in // INT4_BLOCK, INT4_BLOCK, d_out)
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) * (1.0 / 7.0)  # as XLA computes it
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int32)
    half = INT4_BLOCK // 2
    packed = (q[..., :half, :] & 0x0F) | ((q[..., half:, :] & 0x0F) << 4)
    return {
        Q4KEY: packed.to(torch.uint8).view(torch.int8).reshape(*lead, d_in // 2, d_out),
        SKEY: scale.reshape(*lead, d_in // INT4_BLOCK, d_out),
    }


def dequantize_array(qw: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """values * scales, computed in f32 (in f64 when ``dtype`` is f64)."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    if Q4KEY in qw:
        unpacked = _unpack_int4(qw[Q4KEY]).to(acc)          # [..., nb, 32, out]
        *lead, nb, b, d_out = unpacked.shape
        scale = qw[SKEY].to(acc).reshape(*lead, nb, 1, d_out)
        return (unpacked * scale).reshape(*lead, nb * b, d_out).to(dtype)
    return (qw[QKEY].to(acc) * qw[SKEY].to(acc)).to(dtype)


def matmul(x: torch.Tensor, w, *, out_dtype=None) -> torch.Tensor:
    """x @ w for a plain or quantized w; ``out_dtype`` defaults to x's. A
    quantized product runs the int8 / int4 kernel on the card (which raises
    for shapes it does not take) and its plain version on the CPU."""
    if isinstance(w, dict) and LORA_A in w:
        base = {k: v for k, v in w.items() if k not in (LORA_A, LORA_B)}
        y = matmul(x, base.get(WKEY, base), out_dtype=out_dtype)
        # each product summed in f32 and rounded once, as JAX's
        # preferred_element_type=f32 then astype
        xa = x @ w[LORA_A].to(x.dtype)
        return y + (xa @ w[LORA_B].to(x.dtype)).to(y.dtype)
    if not is_quantized(w):
        out = x @ w
        return out if out_dtype is None else out.to(out_dtype)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if Q4KEY in w:
        out = quant_matmul.matmul_int4(x2, w[Q4KEY], w[SKEY], out_dtype=out_dtype)
    else:
        out = quant_matmul.matmul_int8(x2, w[QKEY], w[SKEY], out_dtype=out_dtype)
    return out.reshape(*lead, out.shape[-1])


# Paths of the LLaMA matrices worth quantizing (stacked [L, in, out]).
LLAMA_QUANT_PATHS = (
    ("layers", "attn", "wq"),
    ("layers", "attn", "wk"),
    ("layers", "attn", "wv"),
    ("layers", "attn", "wo"),
    ("layers", "mlp", "w_gate"),
    ("layers", "mlp", "w_up"),
    ("layers", "mlp", "w_down"),
    ("lm_head",),
)

# Paths of the MPT matrices worth quantizing. ``wqkv`` is one matrix already,
# and the head is tied to ``wte``, which stays as it is (an embedding).
MPT_QUANT_PATHS = (
    ("layers", "attn", "wqkv"),
    ("layers", "attn", "out_proj"),
    ("layers", "mlp", "up_proj"),
    ("layers", "mlp", "down_proj"),
)


def _get(tree, path):
    for p in path:
        if p not in tree:
            return None
        tree = tree[p]
    return tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _quantize_matrix(w: torch.Tensor, bits: int) -> Dict[str, torch.Tensor]:
    """Quantize one matrix, a stacked [L, in, out] one layer at a time into
    preallocated outputs, so the f32 transients are one layer's."""
    quantize = quantize_array if bits == 8 else quantize_array_int4
    if w.dim() == 2:
        return quantize(w)
    out = None
    for i in range(w.shape[0]):
        part = quantize(w[i])
        if out is None:
            out = {k: torch.empty((w.shape[0],) + tuple(v.shape), dtype=v.dtype,
                                  device=v.device) for k, v in part.items()}
        for k, v in part.items():
            out[k][i] = v
    return out


def quantize_lm_params(lm_params, paths: Sequence = LLAMA_QUANT_PATHS, bits: int = 8):
    """Replace the listed matrices with int8 (or int4) dicts IN PLACE, one
    matrix at a time: each bf16 tensor is dropped from the tree as soon as
    its quantized form exists, so peak memory is the model plus one
    quantized matrix and one layer's transients. Norms and embeddings stay
    as they are. Returns the same tree."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    for path in paths:
        w = _get(lm_params, path)
        if w is None:
            continue
        _set(lm_params, path, _quantize_matrix(w, bits))
        del w
    return lm_params


def fuse_llama_matrices(lm_params):
    """Fuse wq/wk/wv -> wqkv (MHA only) and w_gate/w_up -> w_gateup by
    concatenating the output dim, in place. Exact: quantization is per
    output column (int8) or per column block (int4), so quantized dicts
    concatenate leaf by leaf. Call after quantizing."""
    def cat(parts):
        if is_quantized(parts[0]):
            return {k: torch.cat([p[k] for p in parts], dim=-1) for k in parts[0]}
        return torch.cat(parts, dim=-1)

    def shape(w):
        return tuple((w[QKEY if QKEY in w else Q4KEY] if is_quantized(w) else w).shape)

    attn = lm_params["layers"]["attn"]
    if "wq" in attn and shape(attn["wq"]) == shape(attn["wk"]):
        attn["wqkv"] = cat([attn.pop("wq"), attn.pop("wk"), attn.pop("wv")])
    mlp = lm_params["layers"]["mlp"]
    if "w_gate" in mlp:
        mlp["w_gateup"] = cat([mlp.pop("w_gate"), mlp.pop("w_up")])
    return lm_params


def quantize_llava_params(params, model_type: str = "llama", *, bits: int = 8,
                          fuse: bool = False):
    """Quantize the language model of a LLaVA tree in place (and, for LLaMA,
    fuse its matrices when ``fuse``; MPT's are fused already); the vision
    tower and projector stay as they are."""
    if model_type not in ("llama", "mpt"):
        raise ValueError(f"unknown model type {model_type!r}")
    paths = MPT_QUANT_PATHS if model_type == "mpt" else LLAMA_QUANT_PATHS
    lm = quantize_lm_params(params["language_model"], paths, bits=bits)
    if fuse and model_type == "llama":
        lm = fuse_llama_matrices(lm)
    return dict(params, language_model=lm)
