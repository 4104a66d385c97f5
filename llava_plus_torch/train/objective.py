"""Training objective: shifted cross-entropy with IGNORE_INDEX masking.

Counterpart of ``llava_plus_tpu/train/objective.py`` (HF causal-LM loss
semantics: labels aligned with inputs, the shift inside the loss, masked
positions = IGNORE_INDEX).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from llava_plus_torch.constants import IGNORE_INDEX


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = IGNORE_INDEX):
    """(mean loss, metrics) of f32 logits [B, T, V] against labels [B, T]:
    logits[t] predicts labels[t + 1]. The mean is over valid targets (at
    least one); metrics are ``loss``, ``accuracy`` and ``tokens`` (0-d
    tensors). The targets are shifted instead of the logits, so the logits
    are never copied; ``F.cross_entropy`` keeps one f32 log-softmax for the
    backward. Over a mesh (DTensor logits) each rank sums its batch shard's
    losses over the whole vocabulary and the sums are added across the
    batch axes."""
    if isinstance(logits, DTensor):
        return _sharded_loss(logits, labels, ignore_index)
    B, T, V = logits.shape
    targets = torch.full((B, T), ignore_index, dtype=torch.long, device=labels.device)
    targets[:, :-1] = labels[:, 1:]
    valid = targets != ignore_index
    n_valid = valid.sum().clamp_min(1)
    token_loss = F.cross_entropy(logits.reshape(B * T, V), targets.reshape(-1),
                                 ignore_index=ignore_index, reduction="sum")
    loss = token_loss / n_valid
    with torch.no_grad():
        acc = ((logits.argmax(dim=-1) == targets) & valid).sum() / n_valid
    return loss, {"loss": loss.detach(), "accuracy": acc, "tokens": n_valid}


def _sharded_loss(logits: DTensor, labels: DTensor, ignore_index: int):
    """:func:`cross_entropy_loss` over DTensors: the vocabulary gathered on
    each rank's batch shard, the token-loss sum, valid count and correct
    count of each shard added over the batch axes (the values repeat over
    ``tp``)."""
    from torch.distributed.tensor import Partial, Replicate

    from llava_plus_torch.parallel.mesh import BATCH, to_local

    mesh = logits.device_mesh
    lg = to_local(logits, BATCH, None, None)
    lb = to_local(labels, BATCH, None)
    b, T, V = lg.shape
    targets = torch.full((b, T), ignore_index, dtype=torch.long, device=lb.device)
    targets[:, :-1] = lb[:, 1:]
    valid = targets != ignore_index
    token_loss = F.cross_entropy(lg.reshape(b * T, V), targets.reshape(-1),
                                 ignore_index=ignore_index, reduction="sum")
    with torch.no_grad():
        correct = ((lg.argmax(dim=-1) == targets) & valid).sum()
    summed = [Partial() if name in BATCH else Replicate() for name in mesh.mesh_dim_names]

    def total(t):
        return DTensor.from_local(t, mesh, summed, run_check=False).full_tensor()

    n_valid = total(valid.sum()).clamp_min(1)
    loss = total(token_loss) / n_valid
    acc = total(correct) / n_valid
    return loss, {"loss": loss.detach(), "accuracy": acc, "tokens": n_valid}
