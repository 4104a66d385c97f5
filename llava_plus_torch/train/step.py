"""The training step: loss -> gradients -> AdamW update.

Counterpart of ``llava_plus_tpu/train/step.py``. ``remat=True`` recomputes
each decoder layer in the backward (``torch.utils.checkpoint``), as
``jax.checkpoint`` does there.

Over a (dp, fsdp, tp) mesh (``parallel/mesh.py``), :func:`place_params`
makes every leaf a ``DTensor`` placed by the spec tables
(``parallel/sharding.py``), :func:`place_batch` shards the batch over dp and
fsdp, and ``make_train_step(..., mesh=)`` holds ``activate_mesh`` around the
step, as the JAX step does: the model's ``constrain`` seams then pin the
activations, and the kernels and the decoder's products run on local
shards (column- and row-parallel over ``tp``, ``ops/quant.py``). Each gradient is
redistributed to its parameter's placements as the backward produces it
(the all-reduce over dp and the reduce-scatter over fsdp that GSPMD inserts
in JAX), so the optimizer updates each rank's shard in place.

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
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from llava_plus_torch.models import llava as llava_model
from llava_plus_torch.models.configs import LlavaConfig
from llava_plus_torch.models.llava import MultimodalBatch
from llava_plus_torch.ops import quant
from llava_plus_torch.parallel.mesh import activate_mesh, axis_size, placements
from llava_plus_torch.parallel.sharding import llava_param_specs
from llava_plus_torch.parallel.tp import local_head_counts
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
        if isinstance(g, DTensor) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
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
    del acc
    if len(micros) > 1:
        # leaf by leaf, each sum dropped as its mean replaces it: a second
        # whole set of gradients would cost 13.5 GB at 7B
        for i, p in enumerate(leaves):
            grads[i] = (grads[i].float() / len(micros)).to(p.dtype)
    out, i = {}, 0
    for key in keys:
        n = len(tree_leaves(params[key]))
        out[key] = tree_unflatten(params[key], grads[i:i + n])
        i += n
    ms = [{k: _full(v) for k, v in m.items()} for m in ms]
    if len(ms) == 1:
        return out, dict(ms[0])
    tokens = torch.stack([m["tokens"] for m in ms])
    w = tokens / tokens.sum().clamp_min(1)
    metrics = {k: (tokens.sum() if k == "tokens" else (torch.stack([m[k] for m in ms]) * w).sum())
               for k in ms[0]}
    return out, metrics


def _full(t):
    """A metric as a plain tensor (a DTensor's global value)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(cfg: LlavaConfig, optimizer: AdamW, *, remat: bool = True,
                    accum_steps: int = 1, mesh=None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.
    The parameters and the optimizer state are updated IN PLACE (the JAX
    step donates its buffers and returns new ones) and returned.
    ``accum_steps > 1`` expects the batch stacked [K, B, ...]. ``metrics``
    holds 0-d tensors: loss, accuracy, tokens and grad_norm (plain tensors,
    the same on every rank). With ``mesh`` the step runs inside
    ``activate_mesh(mesh)``, over parameters placed by :func:`place_params`
    and a batch placed by :func:`place_batch`."""
    keys = tuple(k for k in dict.fromkeys(optimizer.trained_keys + ("mm_projector",))
                 if k != "vision_tower")

    def step(params, opt_state, batch: MultimodalBatch):
        with activate_mesh(mesh):
            grads, metrics = grads_and_metrics(
                lambda p, mb: loss_fn(p, cfg, mb, remat=remat), params, batch, accum_steps,
                keys=keys)
            metrics["grad_norm"] = _full(global_norm([g for k in keys
                                                      for g in tree_leaves(grads[k])]))
            if "vision_tower" in optimizer.trained_keys:
                # the frozen tower's gradient is 0, as stop_gradient makes it in JAX
                vt = params["vision_tower"]
                grads["vision_tower"] = tree_unflatten(vt, [torch.zeros_like(x)
                                                            for x in tree_leaves(vt)])
            opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, metrics

    return step


def _quant_specs(spec):
    """The value and scale specs of a quantized leaf from the bf16 weight's
    spec: int8 values [.., K, N] and int4 values [.., K/2, N] keep it, as do
    the int4 block scales [.., K/32, N]; the int8 scale's size-1
    contraction slot is replicated."""
    s = tuple(spec) if spec is not None else ()
    lead, d_in, d_out = s[:-2], s[-2] if len(s) >= 2 else None, s[-1] if s else None
    return {
        "qvalue": (*lead, d_in, d_out),
        "qvalue4": (*lead, d_in, d_out),
        "scale8": (*lead, None, d_out),
        "scale4": (*lead, d_in, d_out),
    }


def _put(t, mesh, spec):
    return distribute_tensor(t, mesh, placements(mesh, spec or ()))


def place_params(params, mesh, cfg: LlavaConfig):
    """The tree (stacked layout) with every leaf a DTensor on ``mesh``,
    placed by the FSDP / TP rule table; each rank passes the same full
    tree. Quantized leaves (the QLoRA base) take specs derived from the
    bf16 weight's rule; leaves the table does not name (and adapters
    passed through this function) are replicated. Raises ValueError where
    the mesh's ``tp`` does not divide the heads or the kv heads, as
    tensor-parallel serving does (``parallel/tp.local_head_counts``)."""
    local_head_counts(cfg, axis_size(mesh, "tp"))
    specs = llava_param_specs(cfg)
    alias = {"wqkv": "wq", "w_gateup": "w_gate"}   # the fused matrices' rules

    def walk(p, s):
        if quant.is_quantized(p):
            qs = _quant_specs(s)
            if quant.Q4KEY in p:
                return {quant.Q4KEY: _put(p[quant.Q4KEY], mesh, qs["qvalue4"]),
                        quant.SKEY: _put(p[quant.SKEY], mesh, qs["scale4"])}
            return {quant.QKEY: _put(p[quant.QKEY], mesh, qs["qvalue"]),
                    quant.SKEY: _put(p[quant.SKEY], mesh, qs["scale8"])}
        if isinstance(p, dict):
            def spec_for(k):
                if not isinstance(s, dict):
                    return s
                return s.get(k, s.get(alias.get(k, k)))

            return {k: walk(v, spec_for(k)) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v, s[i] if isinstance(s, list) else s)
                           for i, v in enumerate(p))
        return _put(p, mesh, s)

    return walk(params, specs)


def place_batch(batch: MultimodalBatch, mesh, accum_steps: int = 1) -> MultimodalBatch:
    """Every batch tensor as a DTensor sharded over (dp, fsdp) on its batch
    dim (dim 1 under gradient accumulation, whose leading [K] micro-batch
    dim every rank walks); each rank passes the same global batch."""
    spec = (None, ("dp", "fsdp")) if accum_steps > 1 else (("dp", "fsdp"),)
    return MultimodalBatch(**{f.name: (None if getattr(batch, f.name) is None
                                       else _put(getattr(batch, f.name), mesh, spec))
                              for f in dataclasses.fields(batch)})
