"""Parameter trees from numpy into the port.

The JAX package's parameters (``init_params`` or ``hf_import``) are nested
dicts and lists of arrays with stacked per-layer weights ``[L, in, out]``;
the port uses the same keys and layout with torch tensors, so one numpy tree
feeds both implementations. Quantized matrices (``ops.quant``) are dicts of
int8 values and f32 scales and come across byte for byte.
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
