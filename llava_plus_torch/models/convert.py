"""Parameter trees between numpy and the port, and between its two layer
layouts.

The JAX package's parameters (``init_params`` or ``hf_import``) are nested
dicts and lists of arrays with stacked per-layer weights ``[L, in, out]``;
the port uses the same keys and layout with torch tensors, so one numpy tree
feeds both implementations, for either backbone: LLaMA (``embed_tokens``,
``layers.attn.wq`` ..., ``lm_head``) or MPT (``wte``, ``layers.norm1`` /
``norm2``, ``layers.attn.wqkv`` / ``out_proj``, ``layers.mlp.up_proj`` /
``down_proj``, optional ``q_ln`` / ``k_ln`` and ``wpe``, ``norm_f``).
Quantized matrices (``ops.quant``) are dicts of int8 values and f32 scales
and come across byte for byte.

The trainer holds the language model's layers as a list of per-layer dicts
(:func:`per_layer`), so each layer's weights are separate autograd leaves;
:func:`stacked` and :func:`to_numpy` give the stacked JAX layout back.
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy(tree, device, dtype=None):
    """Map a nested dict/list/tuple of numpy arrays to torch tensors on
    ``device``. Integer leaves (the int8 ``qvalue``/``qvalue4`` of quantized
    weights) keep their dtype. Float leaves go through float32, since torch
    cannot take a numpy bfloat16 (ml_dtypes) array directly, and are cast to
    ``dtype`` when given."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.from_numpy(np.array(arr)).to(device)  # a writable copy
    return torch.tensor(arr.astype(np.float32), device=device,
                        dtype=dtype or torch.float32)


def per_layer(params):
    """The LLaVA tree with ``language_model.layers`` as a list of per-layer
    dicts. The leaves are views of the stacked tensors (no copy): an
    in-place update of either is seen by both."""
    lm = dict(params["language_model"])
    lay = lm["layers"]
    if not isinstance(lay, list):
        L = next(_leaves(lay)).shape[0]   # any stacked leaf: LLaMA's or MPT's tree
        lm["layers"] = [tree_map(lambda x, i=i: x[i], lay) for i in range(L)]
    return dict(params, language_model=lm)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def stacked(params):
    """The LLaVA tree in the stacked ``[L, ...]`` layout (a copy of the
    layers when they are held per layer)."""
    lm = dict(params["language_model"])
    lay = lm["layers"]
    if isinstance(lay, list):
        lm["layers"] = tree_map(lambda *xs: torch.stack(xs), *lay)
    return dict(params, language_model=lm)


def to_numpy(tree):
    """A tree of tensors (either layer layout) as numpy, stacked as the JAX
    package holds it; bf16 goes through f32 (numpy has no bf16)."""
    if isinstance(tree, dict) and "language_model" in tree:
        tree = stacked(tree)
    return tree_map(lambda x: (x.detach().float() if x.dtype == torch.bfloat16
                           else x.detach()).cpu().numpy(), tree)


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists, tuples)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)
