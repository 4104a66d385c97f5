"""The port's AdamW (``llava_plus_torch/train/optimizer.py``) against the JAX
package's optax chain on identical gradients, on the CPU in f32: the
learning-rate schedules, per-group clipping, weight decay on the stacked
shapes, freezing, a separate projector rate and the first-moment dtype.
The port holds the language model per layer, as its trainer does; the
parameters are compared in the stacked layout. Tolerance rtol 1e-6 (f32,
the same operations in the same order)."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.train.optimizer import OptimizerConfig as JaxOptConfig
from llava_plus_tpu.train.optimizer import _make_schedule as jax_schedule
from llava_plus_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from llava_plus_torch.models.convert import from_numpy, per_layer, to_numpy
from llava_plus_torch.train.optimizer import (
    OptimizerConfig, build_optimizer, decay_mask, make_schedule, param_labels, tree_leaves,
)

torch.set_num_threads(1)
KEYS = ("language_model", "mm_projector", "vision_tower")


@pytest.fixture(scope="module")
def jparams():
    p = jax_llava.init_params(jax_tiny_config(), jax.random.PRNGKey(0), dtype=jnp.float32)
    return jax.tree.map(np.asarray, p)


def _grads(jparams, seed, scale):
    """Random gradients shaped like the parameters: ``scale[key]`` times a
    unit normal per group (the vision tower's are 0, as stop_gradient
    makes them)."""
    rng = np.random.default_rng(seed)
    return {key: jax.tree.map(
        lambda x, s=scale.get(key, 0.0): (rng.normal(size=x.shape) * s).astype(np.float32),
        jparams[key]) for key in KEYS}


def _run_both(jparams, cfg_kw, grad_seq, bf16=False):
    """Params after optax's updates and after the port's, both as f32 numpy
    (bf16 values are exact in f32), and the port's optimizer state."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    if bf16:  # the bf16 values, so both start from the same numbers
        jparams = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jdt), np.float32), jparams)
        grad_seq = [jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jdt), np.float32), g)
                    for g in grad_seq]
    opt = jax_build_optimizer(jparams, JaxOptConfig(**cfg_kw))
    p = jax.tree.map(lambda x: jnp.asarray(x, jdt), jparams)
    s = opt.init(p)
    for g in grad_seq:
        u, s = opt.update(jax.tree.map(lambda x: jnp.asarray(x, jdt), g), s, p)
        p = optax.apply_updates(p, u)
    want = jax.tree.map(lambda x: np.asarray(x, np.float32), p)

    tp = per_layer(from_numpy(jparams, "cpu", tdt))
    topt = build_optimizer(tp, OptimizerConfig(**cfg_kw))
    ts = topt.init(tp)
    for g in grad_seq:
        tg = per_layer(from_numpy(g, "cpu", tdt))
        ts = topt.update({k: tg[k] for k in topt.trained_keys}, ts, tp)
    return to_numpy(tp), want, ts


SCHEDULES = [dict(schedule=s, warmup_ratio=w, total_steps=n)
             for s in ("cosine", "constant") for w in (0.0, 0.03, 0.3) for n in (1, 7, 100)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "{schedule}-w{warmup_ratio}-n{total_steps}"
                         .format(**kw))
def test_schedule_matches_optax(kw):
    sched = make_schedule(OptimizerConfig(**kw), 2e-5)
    want = jax_schedule(JaxOptConfig(**kw), 2e-5)
    for n in range(kw["total_steps"] + 3):
        np.testing.assert_allclose(sched(n), float(want(n)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {n}")
    if kw["warmup_ratio"] and int(kw["total_steps"] * kw["warmup_ratio"]):
        assert sched(0) == 0.0  # the first update of a warmup has lr 0


VARIANTS = {
    "stage2": dict(),
    "stage1": dict(train_language_model=False),
    "weight_decay": dict(weight_decay=0.1),
    "projector_lr": dict(mm_projector_lr=1e-2, schedule="constant"),
    "warmup": dict(warmup_ratio=0.3),
    "mu_bf16": dict(mu_dtype="bfloat16"),
    "vision_trained": dict(train_vision_tower=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_updates_match_optax(jparams, variant):
    """Three updates from the same gradients (LM norm > 1, projector < 1)."""
    kw = dict(dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0), **VARIANTS[variant])
    grads = [_grads(jparams, seed, {"language_model": 0.05, "mm_projector": 1e-3})
             for seed in range(3)]
    got, want, state = _run_both(jparams, kw, grads)
    # a bf16 first moment is m rounded to bf16: where the two f32 values of
    # m differ in the last bit, the rounding can differ by one bf16 step,
    # which moves that element's next update by up to lr * 2**-8
    atol = 3 * kw["learning_rate"] * 2.0 ** -8 if variant == "mu_bf16" else 1e-9
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=atol),
                 got, want)
    assert state["count"] == 3
    if variant == "mu_bf16":
        assert all(m.dtype == torch.bfloat16 for v in state["mu"].values() for m in v)
        assert all(n.dtype == torch.float32 for v in state["nu"].values() for n in v)
    frozen = {"stage1": ["language_model"]}.get(variant, [])
    if variant != "vision_trained":
        frozen.append("vision_tower")
    for key in frozen:
        jax.tree.map(np.testing.assert_array_equal, got[key], jparams[key])


@pytest.mark.parametrize("variant", ["stage2", "weight_decay", "mu_f32"])
def test_bf16_updates_match_optax_bit_for_bit(jparams, variant):
    """The bf16 recipes: bf16 parameters, gradients and moments (or an f32
    first moment). Every elementwise step and the clip norm round as
    optax's chain rounds them, so the parameters are equal bit for bit."""
    extra = {"stage2": {}, "weight_decay": dict(weight_decay=0.1),
             "mu_f32": dict(mu_dtype="float32")}[variant]
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0, **extra)
    grads = [_grads(jparams, seed, {"language_model": 0.05, "mm_projector": 1e-3})
             for seed in range(3)]
    got, want, _ = _run_both(jparams, kw, grads, bf16=True)
    jax.tree.map(np.testing.assert_array_equal, got, want)


def test_clipping_is_per_group(jparams):
    """The LM's gradient norm is far above 1 and the projector's below it:
    optax clips the LM alone, so the projector's update is that of its
    unclipped gradient, and differs from clipping by one global norm."""
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0, b1=0.0, b2=0.0, eps=1.0)
    g = _grads(jparams, 0, {"language_model": 1.0, "mm_projector": 1e-3})
    lm_norm = np.sqrt(sum(float((x * x).sum()) for x in jax.tree.leaves(g["language_model"])))
    proj_norm = np.sqrt(sum(float((x * x).sum()) for x in jax.tree.leaves(g["mm_projector"])))
    assert lm_norm > 10 and proj_norm < 1
    got, want, _ = _run_both(jparams, kw, [g])
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9),
                 got, want)
    # with b1 = b2 = 0 and eps = 1 the update is lr * g / (|g| + 1): the
    # projector's is that of its own gradient, unscaled by the LM's norm
    w0 = jparams["mm_projector"]["layers"][0]["w"]
    g0 = g["mm_projector"]["layers"][0]["w"]
    np.testing.assert_allclose(got["mm_projector"]["layers"][0]["w"],
                               w0 - 1e-3 * g0 / (np.abs(g0) + 1.0), rtol=1e-6, atol=1e-9)
    global_clip = g0 / np.hypot(lm_norm, proj_norm)
    assert not np.allclose(got["mm_projector"]["layers"][0]["w"],
                           w0 - 1e-3 * global_clip / (np.abs(global_clip) + 1.0), atol=1e-9)


def test_decay_mask_and_labels_follow_the_stacked_shapes(jparams):
    """Per-layer norms are [D] in the trainer's layout but [L, D] stacked,
    where optax's ``ndim > 1`` mask decays them; the final norm and the
    projector's biases are 1-D in both layouts and are not decayed."""
    tp = per_layer(from_numpy(jparams, "cpu"))
    lm = tp["language_model"]
    want = []
    for name, sub in lm.items():
        n = len(tree_leaves(sub))
        want += [True] * n if name == "layers" else [x.dim() > 1 for x in tree_leaves(sub)]
    assert decay_mask(tp, "language_model") == want
    assert decay_mask(tp, "mm_projector") == [x.dim() > 1
                                              for x in tree_leaves(tp["mm_projector"])]
    labels = param_labels(tp)
    for key, label in (("language_model", "lm"), ("mm_projector", "projector"),
                       ("vision_tower", "vision")):
        assert set(tree_leaves(labels[key])) == {label}
