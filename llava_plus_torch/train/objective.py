"""Training objective: shifted cross-entropy with IGNORE_INDEX masking.

Counterpart of ``llava_plus_tpu/train/objective.py`` (HF causal-LM loss
semantics: labels aligned with inputs, the shift inside the loss, masked
positions = IGNORE_INDEX).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from llava_plus_torch.constants import IGNORE_INDEX


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = IGNORE_INDEX):
    """(mean loss, metrics) of f32 logits [B, T, V] against labels [B, T]:
    logits[t] predicts labels[t + 1]. The mean is over valid targets (at
    least one); metrics are ``loss``, ``accuracy`` and ``tokens`` (0-d
    tensors). The targets are shifted instead of the logits, so the logits
    are never copied; ``F.cross_entropy`` keeps one f32 log-softmax for the
    backward."""
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
