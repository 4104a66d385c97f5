"""AdamW with per-group schedules, clipping and freezing.

Counterpart of ``llava_plus_tpu/train/optimizer.py``, which builds
``optax.multi_transform`` over three groups (lm / projector / vision), each
the chain clip_by_global_norm -> scale_by_adam -> add_decayed_weights ->
scale_by_schedule -> scale(-1), or ``set_to_zero`` when frozen. This module
writes that chain out per tensor, in optax's order of operations:

- each group is clipped by its OWN global norm (the clip sits inside each
  group's chain), summed as ``optax.global_norm`` sums it;
- the first moment takes ``mu_dtype`` (else the parameter's dtype), the
  second the parameter's dtype; every elementwise operation runs in the
  dtype JAX's promotion gives it (bf16 throughout in the bf16 recipes,
  with each scalar rounded to bf16 as JAX rounds a weakly typed scalar),
  and the Adam update uses the first moment before its cast to
  ``mu_dtype``, as ``scale_by_adam`` does;
- the schedule is evaluated at the count BEFORE the increment, so with
  warmup the first update has lr 0;
- the weight-decay mask is ``ndim > 1`` on the STACKED tree: the per-layer
  norms of the language model ([L, D] stacked) are decayed even when the
  trainer holds them per layer ([D]).

The update is applied to the parameters in place, one tensor at a time, so
the only temporaries are a few copies of the largest tensor (optax returns
a new tree; a foreach pass over 6.7 B parameters would need full-size
temporaries). Over a mesh the parameters, gradients and moments are
DTensors of one placement each: the update is elementwise on every rank's
shard, and the clipping norm is global (:func:`global_norm`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

# label -> key of the parameter tree
GROUPS = {"lm": "language_model", "projector": "mm_projector", "vision": "vision_tower"}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    train_language_model: bool = True
    train_mm_projector: bool = True
    train_vision_tower: bool = False
    schedule: str = "cosine"  # "cosine" | "constant"
    # Adam first-moment dtype ("float32", ...). None inherits the param dtype
    # (bf16 in the published recipes: both moments then cost 1x params each).
    mu_dtype: Optional[str] = None


def make_schedule(cfg: OptimizerConfig, peak_lr: float) -> Callable[[int], float]:
    """The learning rate at optimizer count ``n``: optax's
    ``warmup_cosine_decay_schedule`` (linear warmup from 0, cosine to 0 at
    ``decay_steps = max(total_steps, warmup + 1)``), or a constant with an
    optional linear warmup."""
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 0)

    def linear(n):  # optax.linear_schedule(0, peak, warmup)
        return peak_lr * min(max(n, 0), warmup) / warmup

    if cfg.schedule == "constant":
        return lambda n: peak_lr if warmup == 0 or n >= warmup else linear(n)
    decay = max(cfg.total_steps, warmup + 1) - warmup

    def cosine(n):
        if n < warmup:
            return linear(n)
        t = min(n - warmup, decay)
        return peak_lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return cosine


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in a fixed order (dict insertion order, list order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in :func:`tree_leaves`
    order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def param_labels(params) -> dict:
    """Each leaf's group: lm / projector / vision."""
    return {key: tree_unflatten(params[key], [label] * len(tree_leaves(params[key])))
            for label, key in GROUPS.items()}


def decay_mask(params, key: str) -> List[bool]:
    """Weight decay applies where the STACKED leaf has ndim > 1: leaves the
    trainer holds per layer (``language_model.layers`` as a list) count one
    more dimension."""
    flags = []
    for name, sub in params[key].items():
        extra = int(key == "language_model" and name == "layers" and isinstance(sub, list))
        flags += [x.dim() + extra > 1 for x in tree_leaves(sub)]
    return flags


class AdamW:
    """What :func:`build_optimizer` returns: ``init(params)`` makes the state
    of the trained groups; ``update(grads, state, params)`` applies one step
    to ``params`` in place and returns the new state. ``grads`` maps a
    parameter key (``language_model``, ...) to a tree like that subtree;
    frozen groups are left untouched, as ``set_to_zero`` leaves them."""

    def __init__(self, params, cfg: OptimizerConfig):
        self.cfg = cfg
        proj_lr = cfg.mm_projector_lr or cfg.learning_rate
        trained = {"lm": cfg.train_language_model, "projector": cfg.train_mm_projector,
                   "vision": cfg.train_vision_tower}
        peak = {"lm": cfg.learning_rate, "projector": proj_lr, "vision": cfg.learning_rate}
        self.schedules: Dict[str, Callable[[int], float]] = {
            GROUPS[g]: make_schedule(cfg, peak[g]) for g in GROUPS if trained[g]}
        self.masks = {key: decay_mask(params, key) for key in self.schedules}

    @property
    def trained_keys(self):
        """The parameter keys this optimizer updates, in group order."""
        return tuple(self.schedules)

    def init(self, params):
        mu_dtype = getattr(torch, self.cfg.mu_dtype) if self.cfg.mu_dtype else None
        state = {"count": 0, "mu": {}, "nu": {}}
        for key in self.schedules:
            leaves = tree_leaves(params[key])
            state["mu"][key] = [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in leaves]
            state["nu"][key] = [torch.zeros_like(p) for p in leaves]
        return state

    @torch.no_grad()
    def update(self, grads, state, params):
        cfg = self.cfg
        n = state["count"]
        b1, b2 = cfg.b1, cfg.b2
        # bias corrections in f32, as optax computes 1 - decay**count
        one, count = np.float32(1.0), np.float32(n + 1)
        bc1 = float(one - np.float32(b1) ** count)
        bc2 = float(one - np.float32(b2) ** count)
        for key, schedule in self.schedules.items():
            ps, gs = tree_leaves(params[key]), tree_leaves(grads[key])
            norm = float(global_norm(gs))
            clip = norm >= cfg.max_grad_norm
            lr = schedule(n)
            for p, g, mu, nu, decay in zip(ps, gs, state["mu"][key], state["nu"][key],
                                           self.masks[key]):
                if clip:
                    g = g / _as(norm, g) * cfg.max_grad_norm
                m = _as(1 - b1, g) * g + _as(b1, mu) * mu
                v = _as(1 - b2, g) * (g * g) + _as(b2, nu) * nu
                u = (m / _as(bc1, m)) / (torch.sqrt(v / _as(bc2, v)) + _as(cfg.eps, v))
                mu.copy_(m)
                nu.copy_(v)
                if cfg.weight_decay and decay:
                    u = u + _as(cfg.weight_decay, p) * p
                u = -1.0 * (_as(lr, u) * u)
                p.copy_(p + u)
        state["count"] = n + 1
        return state


def _as(x: float, t: torch.Tensor) -> float:
    """``x`` rounded to ``t``'s dtype: a Python scalar in a torch product
    keeps the tensor's dtype, as a weakly typed scalar does in JAX, but JAX
    also rounds the scalar to that dtype first (bf16 in the bf16 recipes)."""
    return float(torch.tensor(x, dtype=t.dtype))


def global_norm(leaves) -> torch.Tensor:
    """``optax.global_norm``: the sqrt of the sum over leaves of each leaf's
    sum of squares, in the leaves' dtype (bf16 leaves give a bf16 norm, as
    in JAX; each leaf's sum accumulates in f32 and is rounded once).
    DTensor leaves (a mesh) give the norm of the whole tensors, as a plain
    tensor on every rank."""
    if not leaves:
        return torch.zeros(())
    norm = torch.sqrt(sum(torch.square(x).sum() for x in leaves))
    return norm.full_tensor() if isinstance(norm, DTensor) else norm


def build_optimizer(params, cfg: OptimizerConfig) -> AdamW:
    return AdamW(params, cfg)
