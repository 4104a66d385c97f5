"""The training step: loss -> gradients -> AdamW update.

Counterpart of ``llava_plus_tpu/train/step.py`` on one card: no mesh
placement (``place_params`` / ``place_batch`` wait for the port of
``parallel/``). ``remat=True`` recomputes each decoder layer in the backward
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does there.

Only the leaves that take a gradient are differentiated: the projector
always, the language model when it is trained, the vision tower never (it
runs under ``no_grad``; its JAX gradient is 0 through ``stop_gradient``).
So in stage 1 (projector only) the backward through the frozen language
model computes activation gradients only, and ``grad_norm`` is the norm of
the projector's gradients, where the JAX step also counts the frozen LM's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import torch

from llava_plus_torch.models import llava as llava_model
from llava_plus_torch.models.configs import LlavaConfig
from llava_plus_torch.models.llava import MultimodalBatch
from llava_plus_torch.train.objective import cross_entropy_loss
from llava_plus_torch.train.optimizer import AdamW, global_norm, tree_leaves, tree_unflatten


def loss_fn(params, cfg: LlavaConfig, batch: MultimodalBatch, *, remat: bool = True):
    logits, _ = llava_model.forward(params, cfg, batch, remat=remat)
    return cross_entropy_loss(logits, batch.labels)


def micro_batch(batch: MultimodalBatch, i: int) -> MultimodalBatch:
    """Micro-batch ``i`` of a batch stacked [K, B, ...]."""
    return MultimodalBatch(**{f.name: getattr(batch, f.name)[i]
                              for f in dataclasses.fields(batch)})


@contextlib.contextmanager
def _tracked(leaves):
    """Leaves require a gradient inside the block, and no longer after."""
    for p in leaves:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None


def grads_and_metrics(loss_of, params, batch, accum_steps: int = 1,
                      keys: Sequence[str] = ("language_model", "mm_projector")):
    """Gradients of ``loss_of(params, micro_batch) -> (loss, metrics)`` for
    the subtrees ``params[key]``, optionally accumulated over a leading
    micro-batch axis ([K, B, ...], ``--gradient_accumulation_steps``).
    Returns ``({key: tree like params[key]}, metrics)``.

    As in the JAX step, the K gradients are summed in f32, divided by K and
    cast to the parameter dtype, and the metrics are token-weighted. Each
    leaf's gradient is folded into the running sum the moment the backward
    produces it (a post-accumulate hook), so one gradient-sized buffer in the
    parameter dtype holds the partial sum: each addition runs in f32 and is
    rounded once. With f32 parameters that is an f32 sum; with bf16 and
    K = 2 it equals rounding the f32 sum (the first term is exact and
    halving is exact). An f32 buffer would cost 27 GB at 7B."""
    leaves = [x for key in keys for x in tree_leaves(params[key])]
    micros = [batch] if accum_steps <= 1 else [micro_batch(batch, i)
                                               for i in range(accum_steps)]
    acc = [None] * len(leaves)
    slot = {id(p): i for i, p in enumerate(leaves)}

    def fold(p):
        i = slot[id(p)]
        g, p.grad = p.grad, None
        acc[i] = g if acc[i] is None else (acc[i].float() + g.float()).to(g.dtype)

    ms = []
    for mb in micros:
        if not leaves:
            with torch.no_grad():
                ms.append(loss_of(params, mb)[1])
            continue
        with _tracked(leaves):
            hooks = [p.register_post_accumulate_grad_hook(fold) for p in leaves]
            try:
                loss, m = loss_of(params, mb)
                loss.backward(inputs=leaves)
            finally:
                for h in hooks:
                    h.remove()
        ms.append(m)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, acc)]
    if len(micros) > 1:
        grads = [(g.float() / len(micros)).to(p.dtype) for p, g in zip(leaves, grads)]
    out, i = {}, 0
    for key in keys:
        n = len(tree_leaves(params[key]))
        out[key] = tree_unflatten(params[key], grads[i:i + n])
        i += n
    if len(ms) == 1:
        return out, dict(ms[0])
    tokens = torch.stack([m["tokens"] for m in ms])
    w = tokens / tokens.sum().clamp_min(1)
    metrics = {k: (tokens.sum() if k == "tokens" else (torch.stack([m[k] for m in ms]) * w).sum())
               for k in ms[0]}
    return out, metrics


def make_train_step(cfg: LlavaConfig, optimizer: AdamW, *, remat: bool = True,
                    accum_steps: int = 1):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.
    The parameters and the optimizer state are updated IN PLACE (the JAX
    step donates its buffers and returns new ones) and returned.
    ``accum_steps > 1`` expects the batch stacked [K, B, ...]. ``metrics``
    holds 0-d tensors: loss, accuracy, tokens and grad_norm."""
    keys = tuple(k for k in dict.fromkeys(optimizer.trained_keys + ("mm_projector",))
                 if k != "vision_tower")

    def step(params, opt_state, batch: MultimodalBatch):
        grads, metrics = grads_and_metrics(
            lambda p, mb: loss_fn(p, cfg, mb, remat=remat), params, batch, accum_steps,
            keys=keys)
        metrics["grad_norm"] = global_norm([g for k in keys for g in tree_leaves(grads[k])])
        if "vision_tower" in optimizer.trained_keys:
            # the frozen tower's gradient is 0, as stop_gradient makes it in JAX
            vt = params["vision_tower"]
            grads["vision_tower"] = tree_unflatten(vt, [torch.zeros_like(x)
                                                        for x in tree_leaves(vt)])
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, metrics

    return step
