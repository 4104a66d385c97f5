"""Vision-to-language projector in PyTorch: "linear", "mlp{N}x_gelu" and
"identity" (counterpart of ``llava_plus_tpu/models/projector.py``)."""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F


def parse_projector_type(projector_type: str) -> int:
    """MLP depth: 1 for linear, N for mlpNx_gelu, 0 for identity."""
    if projector_type == "identity":
        return 0
    if projector_type == "linear":
        return 1
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if m:
        return int(m.group(1))
    raise ValueError(f"Unknown projector type: {projector_type}")


def init_params(projector_type: str, mm_hidden_size: int, hidden_size: int,
                generator: torch.Generator, device, dtype=torch.bfloat16):
    depth = parse_projector_type(projector_type)
    if depth == 0:
        return {}
    layers = []
    d_in = mm_hidden_size
    for _ in range(depth):
        layers.append({
            "w": torch.randn(d_in, hidden_size, generator=generator,
                             device=device, dtype=dtype).mul_(0.02),
            "b": torch.zeros(hidden_size, device=device, dtype=dtype),
        })
        d_in = hidden_size
    return {"layers": layers}


def apply(params, projector_type: str, x: torch.Tensor) -> torch.Tensor:
    """x: [..., mm_hidden] -> [..., hidden]; exact (erf) GELU between the
    linear layers, computed in f32."""
    if parse_projector_type(projector_type) == 0:
        return x
    for i, layer in enumerate(params["layers"]):
        if i > 0:
            x = F.gelu(x.float()).to(x.dtype)
        x = x @ layer["w"] + layer["b"]
    return x
