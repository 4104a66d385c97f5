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

:func:`quantize_array_int4_native` gives the int4 measurement tools'
native layout (``ops/quant_matmul.matmul_int4_native``), which no model
path uses.

W8A8 (JAX ``quant.py:112-163``): with it enabled, a product of at least
``_W8A8_MIN_ROWS`` rows of a floating x by a 2-D int8 weight quantizes x by
row and runs an int8 x int8 product (``ops/w8a8.py``), as the JAX gate
(``quant.py:229-231``) routes it; int4 weights never take it, and a LoRA
weight takes it through its base product. It is enabled by
:func:`set_w8a8` or ``LLAVA_W8A8=1`` for the whole process, as in JAX, or
inside :func:`w8a8_scope`, a context variable: the serving engine holds it
around its own forward calls only, since the port runs eagerly and a
process-wide switch would reach every later product (JAX reads its flag
when a program is traced, so it reaches only the engine's programs).

Over a mesh (DTensor activations) a quantized product runs on each rank's
shards (:func:`_sharded_product`); plain products stay DTensor ops between
fixed layouts (:func:`_sharded_plain_product`). Tensor-parallel serving
(``parallel/tp.py``) holds plain local shards instead: a product by a
row-parallel matrix (``matmul(..., row_parallel=True)``) sums the ranks'
partial products over the serving group.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Any, Dict, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from llava_plus_torch.ops import quant_matmul, w8a8
from llava_plus_torch.ops.quant_matmul import INT4_BLOCK, unpack_int4 as _unpack_int4  # noqa: F401
from llava_plus_torch.ops.quant_matmul import pack_int4_native, unpack_int4_native  # noqa: F401
from llava_plus_torch.parallel import tp

QKEY = "qvalue"
Q4KEY = "qvalue4"
SKEY = "scale"
# the int8 values' K-major copy ([.., N, K] contiguous) that a W8A8 engine
# keeps beside each decoder matrix: cuBLASLt's IMMA kernels read a
# row-major [K, N] int8 operand some six times slower (ops/w8a8.py)
QTKEY = "qvalue_t"
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


def quantize_array_int4_native(w: torch.Tensor):
    """The int4 measurement tools' native layout of ``w [..., K, N]``: the
    scales of :func:`quantize_array_int4`, values ``round_half_even(w /
    scale)`` in f32 clipped to [-8, 7], packed by :func:`pack_int4_native`.
    Returns ``(uint8 [..., K, N/2], f32 scale [..., K/32, N])``."""
    *lead, d_in, d_out = w.shape
    scale = quantize_array_int4(w)[SKEY]
    wf = w.float().reshape(*lead, d_in // INT4_BLOCK, INT4_BLOCK, d_out)
    q = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -8, 7).to(torch.int8)
    return pack_int4_native(q.reshape(*lead, d_in, d_out)), scale


def dequantize_array(qw: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """values * scales, computed in f32 (in f64 when ``dtype`` is f64)."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    if Q4KEY in qw:
        unpacked = _unpack_int4(qw[Q4KEY]).to(acc)          # [..., nb, 32, out]
        *lead, nb, b, d_out = unpacked.shape
        scale = qw[SKEY].to(acc).reshape(*lead, nb, 1, d_out)
        return (unpacked * scale).reshape(*lead, nb * b, d_out).to(dtype)
    return (qw[QKEY].to(acc) * qw[SKEY].to(acc)).to(dtype)


_W8A8: Optional[bool] = None  # None: read LLAVA_W8A8; True / False: set_w8a8
_W8A8_MIN_ROWS = 256
_W8A8_SCOPE: contextvars.ContextVar[bool] = contextvars.ContextVar("llava_w8a8_scope",
                                                                   default=False)


def set_w8a8(enabled: bool) -> None:
    """Enable or disable W8A8 for the whole process (over LLAVA_W8A8)."""
    global _W8A8
    _W8A8 = bool(enabled)


def w8a8_enabled() -> bool:
    """Inside a :func:`w8a8_scope`, else :func:`set_w8a8`'s choice, else
    ``LLAVA_W8A8 == "1"``."""
    if _W8A8_SCOPE.get():
        return True
    if _W8A8 is not None:
        return _W8A8
    return os.environ.get("LLAVA_W8A8", "0") == "1"


@contextlib.contextmanager
def w8a8_scope(enabled: bool = True):
    """W8A8 on inside the block, in this thread (or task) only, when
    ``enabled``; without it the process-wide choice holds."""
    token = _W8A8_SCOPE.set(bool(enabled))
    try:
        yield
    finally:
        _W8A8_SCOPE.reset(token)


def _w8a8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                 out_dtype=None, q_t: Optional[torch.Tensor] = None,
                 row_parallel: bool = False) -> torch.Tensor:
    """x [..., K] @ int8 q [K, N] with per-row dynamic int8 activations (JAX
    ``quant.py:146``): ``(xq @ q) * row scale * column scale``, through
    :func:`ops.w8a8.matmul_w8a8`; ``q_t`` is q's K-major copy, if kept."""
    lead, K = x.shape[:-1], x.shape[-1]
    out = w8a8.matmul_w8a8(x.reshape(-1, K), q, scale, out_dtype=out_dtype, qw_t=q_t,
                           row_parallel=row_parallel)
    return out.reshape(*lead, q.shape[-1])


def _takes_w8a8(x: torch.Tensor, w) -> bool:
    """The W8A8 gate (JAX ``quant.py:229-231``): enabled, a 2-D int8 weight,
    a floating x of at least ``_W8A8_MIN_ROWS`` rows."""
    return (QKEY in w and w[QKEY].dim() == 2 and x.numel() >= _W8A8_MIN_ROWS * x.shape[-1]
            and w8a8_enabled() and x.is_floating_point())


def matmul(x: torch.Tensor, w, *, out_dtype=None, row_parallel: bool = False) -> torch.Tensor:
    """x @ w for a plain or quantized w; ``out_dtype`` defaults to x's. A
    quantized product runs the int8 / int4 kernel on the card (which raises
    for shapes it does not take) and its plain version on the CPU; with
    W8A8 enabled, a product of at least ``_W8A8_MIN_ROWS`` rows by a 2-D
    int8 weight runs :func:`ops.w8a8.matmul_w8a8`.

    ``row_parallel``: w is this rank's rows of a matrix split over K across
    the active tensor-parallel group (``parallel/tp.py``), and the ranks'
    partial products are summed over it (in the output dtype; a W8A8
    product quantizes x by the whole K's row absmax and sums its int32
    products). Without an active group, or at tp = 1, it changes nothing."""
    if row_parallel and tp.tp_size() > 1:
        if is_quantized(w) and _takes_w8a8(x, w):
            return _w8a8_matmul(x, w[QKEY], w[SKEY], out_dtype=out_dtype, q_t=w.get(QTKEY),
                                row_parallel=True)
        return tp.reduce_partial(matmul(x, w, out_dtype=out_dtype))
    if isinstance(w, dict) and LORA_A in w:
        base = {k: v for k, v in w.items() if k not in (LORA_A, LORA_B)}
        y = matmul(x, base.get(WKEY, base), out_dtype=out_dtype)
        # each product summed in f32 and rounded once, as JAX's
        # preferred_element_type=f32 then astype
        xa = x @ w[LORA_A].to(x.dtype)
        return y + (xa @ w[LORA_B].to(x.dtype)).to(y.dtype)
    if not is_quantized(w):
        if isinstance(x, DTensor):
            return _sharded_plain_product(x, w, out_dtype)
        out = x @ w
        return out if out_dtype is None else out.to(out_dtype)
    if isinstance(x, DTensor):
        return _sharded_product(x, w, out_dtype)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if Q4KEY in w:
        out = quant_matmul.matmul_int4(x2, w[Q4KEY], w[SKEY], out_dtype=out_dtype)
    elif _takes_w8a8(x, w):
        return _w8a8_matmul(x, w[QKEY], w[SKEY], out_dtype=out_dtype, q_t=w.get(QTKEY))
    else:
        out = quant_matmul.matmul_int8(x2, w[QKEY], w[SKEY], out_dtype=out_dtype)
    return out.reshape(*lead, out.shape[-1])


def add_kmajor_copies(lm_params) -> None:
    """Give every int8 matrix of the decoder layers (the products a prefill
    runs at its full row count; the head runs at one row a prompt) its
    K-major copy under ``QTKEY``, one matrix at a time, in place."""
    def walk(t):
        if isinstance(t, dict) and QKEY in t:
            if QTKEY not in t:
                t[QTKEY] = t[QKEY].transpose(-1, -2).contiguous()
            return
        for v in (t.values() if isinstance(t, dict) else t if isinstance(t, list) else ()):
            walk(v)

    walk(lm_params["layers"])


def _sharded_plain_product(x: DTensor, w, out_dtype) -> DTensor:
    """A plain product over DTensors, a DTensor op between two fixed
    layouts: x and the output over the batch axes with their last dim
    whole (pending sums reduced first), the weight as placed (DTensor
    gathers it as the product needs). Without them DTensor's planner picks
    layouts such as a split fused qkv sharded over T, and then searches
    the backward's redistributions over the 3-axis mesh for minutes."""
    from llava_plus_torch.parallel.mesh import BATCH, constrain

    lead = (BATCH,) + (None,) * (x.dim() - 1)
    out = constrain(constrain(x, *lead) @ w, *lead)
    return out if out_dtype is None else out.to(out_dtype)


def _sharded_product(x: DTensor, w, out_dtype) -> DTensor:
    """A quantized product over DTensors: the kernels have no sharding
    rule, so the weight is redistributed to K replicated and N over ``tp``
    (the all-gather over fsdp that GSPMD inserts in JAX), x to its batch
    shard with K whole, and each rank runs the kernel on its shards; the
    output is N over ``tp`` (x's gradient a partial sum over ``tp``)."""
    from llava_plus_torch.parallel.mesh import BATCH, from_local, to_local

    lead = (BATCH,) + (None,) * (x.dim() - 1)
    local = {k: to_local(v, None, "tp") for k, v in w.items() if k in (QKEY, Q4KEY, SKEY)}
    out = matmul(to_local(x, *lead, partial=("tp",)), local, out_dtype=out_dtype)
    return from_local(out, x.device_mesh, *lead[:-1], "tp")


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
