"""The port's training step against the JAX package's, on the CPU, in f32
with the tiny config: the loss, its metrics and its gradient tree, remat,
gradient accumulation, and ``grad_norm``. The same numpy parameters and
batches go to both; the port holds the language model per layer, as its
trainer does. Tolerance rtol 1e-5 (f32, sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from llava_plus_tpu.data.multimodal import pad_images, plan_multimodal_batch
from llava_plus_tpu.data.packing import pack_instances
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.models.llava import MultimodalBatch as JaxBatch
from llava_plus_tpu.train import step as jax_step
from llava_plus_tpu.train.optimizer import OptimizerConfig as JaxOptConfig
from llava_plus_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.models.convert import from_numpy, per_layer, to_numpy
from llava_plus_torch.models.llava import MultimodalBatch
from llava_plus_torch.train import step
from llava_plus_torch.train.optimizer import OptimizerConfig, build_optimizer

torch.set_num_threads(1)
CFG = tiny_llava_config()
JCFG = jax_tiny_config()
RTOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def jparams():
    p = jax_llava.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jax.tree.map(np.asarray, p)


def _tparams(jparams):
    return per_layer(from_numpy(jparams, "cpu"))


def _instances(n, seed):
    """Image-text samples of different lengths (ids, labels, one image)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        n_text = int(rng.integers(4, 14))
        ids = np.array([1, IMAGE_TOKEN_INDEX] + list(rng.integers(3, 500, size=n_text)))
        labels = np.where(np.arange(len(ids)) < 4, IGNORE_INDEX, ids)
        img = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
        out.append({"input_ids": ids, "labels": labels, "images": img})
    return out


def _padded(n=4, seed=0):
    inst = _instances(n, seed)
    plan = plan_multimodal_batch([x["input_ids"] for x in inst], [x["labels"] for x in inst],
                                 num_patches=CFG.num_image_tokens, max_len=64, pad_to=32)
    return {"tokens": plan.tokens, "positions": plan.positions,
            "segment_ids": plan.segment_ids, "image_pos": plan.image_pos,
            "labels": plan.labels, "images": pad_images([x["images"] for x in inst], 1,
                                                        (28, 28, 3))}


def _packed(seed=1):
    arrays, consumed = pack_instances(_instances(6, seed), rows=2, max_len=64,
                                      num_patches=CFG.num_image_tokens, image_size=28,
                                      max_images_per_row=3)
    assert consumed == 6 and arrays["segment_ids"].max() == 3
    return arrays


def _both(arrays):
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            MultimodalBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}))


def _stack(*arrays):
    return {k: np.stack([a[k] for a in arrays]) for k in arrays[0]}


def _assert_tree_close(got, want, **tol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **tol), got, want)


@pytest.mark.parametrize("kind", ["padded", "packed"])
def test_loss_fn_and_grads_match_jax(jparams, kind):
    arrays = _padded() if kind == "padded" else _packed()
    jb, tb = _both(arrays)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jax_step.loss_fn(p, JCFG, jb, remat=False), has_aux=True)(jparams)
    tp = _tparams(jparams)
    grads, m = step.grads_and_metrics(lambda p, mb: step.loss_fn(p, CFG, mb, remat=False),
                                      tp, tb)
    for k in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    got = to_numpy({"language_model": grads["language_model"],
                    "mm_projector": grads["mm_projector"]})
    _assert_tree_close(got["language_model"], jg["language_model"], **RTOL)
    _assert_tree_close(got["mm_projector"], jg["mm_projector"], **RTOL)
    # the vision tower gets no gradient in either (JAX: stop_gradient)
    assert max(float(jnp.abs(x).max()) for x in jax.tree.leaves(jg["vision_tower"])) == 0.0
    # nothing is left requiring a gradient
    assert not any(x.requires_grad for x in jax.tree.leaves(tp))


def test_remat_matches_no_remat(jparams):
    _, tb = _both(_packed())
    tp = _tparams(jparams)
    out = [step.grads_and_metrics(lambda p, mb: step.loss_fn(p, CFG, mb, remat=r), tp, tb)[0]
           for r in (False, True)]
    a, b = (to_numpy({"language_model": g["language_model"], "mm_projector": g["mm_projector"]})
            for g in out)
    _assert_tree_close(a, b, atol=1e-6, rtol=0)


def _jax_steps(jparams, opt_cfg, batch, n, accum=1):
    opt = jax_build_optimizer(jparams, JaxOptConfig(**opt_cfg))
    fn = jax_step.make_train_step(JCFG, opt, remat=False, accum_steps=accum)
    p = jax.tree.map(jnp.array, jparams)
    s = opt.init(p)
    metrics = []
    for _ in range(n):
        p, s, m = fn(p, s, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, p), metrics


def _torch_steps(jparams, opt_cfg, batch, n, accum=1):
    tp = _tparams(jparams)
    opt = build_optimizer(tp, OptimizerConfig(**opt_cfg))
    fn = step.make_train_step(CFG, opt, remat=False, accum_steps=accum)
    s = opt.init(tp)
    metrics = []
    for _ in range(n):
        tp, s, m = fn(tp, s, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return tp, metrics


# Adam's update is g / (|g| + eps) per element, so an element whose gradient
# is near 0 (by cancellation) moves by up to lr in a direction the f32
# summation order decides. The two gradients agree to ~1e-8 absolute (1e-6
# of a leaf's largest element); eps 1e-4 keeps every element's update within
# ~1e-4 of lr of optax's. Parameters are held to rtol 1e-5 and atol 1e-3 of
# the largest lr per step (a parameter near 0 has no relative tolerance to
# speak of). The optimizer with the default eps is held to optax on
# identical gradients in test_torch_optimizer.py.
BASE = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0, eps=1e-4)


def _param_tol(opt_cfg, n_steps):
    lr = max(opt_cfg["learning_rate"], opt_cfg.get("mm_projector_lr") or 0.0)
    return dict(rtol=1e-5, atol=1e-3 * lr * n_steps)


VARIANTS = {
    "stage2": {},
    "stage1": dict(train_language_model=False),
    "frozen_projector": dict(train_mm_projector=False),
    "weight_decay": dict(weight_decay=0.1),
    "projector_lr": dict(mm_projector_lr=3e-3, schedule="constant"),
}


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_steps_match_jax(jparams, variant, n_steps):
    opt_cfg = dict(BASE, **VARIANTS[variant])
    jb, tb = _both(_packed())
    want, jm = _jax_steps(jparams, opt_cfg, jb, n_steps)
    tp, tm = _torch_steps(jparams, opt_cfg, tb, n_steps)
    got = to_numpy(tp)
    _assert_tree_close(got, want, **_param_tol(opt_cfg, n_steps))
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    # frozen groups keep their bytes
    frozen = ["vision_tower"] + {"stage1": ["language_model"],
                                 "frozen_projector": ["mm_projector"]}.get(variant, [])
    for key in frozen:
        jax.tree.map(np.testing.assert_array_equal, got[key], jparams[key])
    if variant == "stage1":
        assert not np.array_equal(got["mm_projector"]["layers"][0]["w"],
                                  jparams["mm_projector"]["layers"][0]["w"])


def test_grad_norm_matches_jax(jparams):
    """Stage 2: the norm of every gradient, as JAX. Stage 1: the norm of the
    projector's gradients (the port does not differentiate the frozen LM;
    the JAX step counts it)."""
    jb, tb = _both(_padded())
    _, jm = _jax_steps(jparams, BASE, jb, 1)
    _, tm = _torch_steps(jparams, BASE, tb, 1)
    np.testing.assert_allclose(tm[0]["grad_norm"], jm[0]["grad_norm"], rtol=1e-5)

    _, jg = jax.value_and_grad(lambda p: jax_step.loss_fn(p, JCFG, jb, remat=False),
                               has_aux=True)(jparams)
    proj_norm = np.sqrt(sum(float(jnp.sum(x * x)) for x in jax.tree.leaves(jg["mm_projector"])))
    _, tm1 = _torch_steps(jparams, dict(BASE, train_language_model=False), tb, 1)
    np.testing.assert_allclose(tm1[0]["grad_norm"], proj_norm, rtol=1e-5)
    assert tm1[0]["grad_norm"] < tm[0]["grad_norm"]


def test_accumulation_matches_jax(jparams):
    """K = 2 micro-batches of unequal token counts: one update from the f32
    mean of the two gradients, token-weighted metrics."""
    arrays = _stack(_padded(4, seed=2), _padded(4, seed=3))
    jb, tb = _both(arrays)
    want, jm = _jax_steps(jparams, BASE, jb, 1, accum=2)
    tp, tm = _torch_steps(jparams, BASE, tb, 1, accum=2)
    _assert_tree_close(to_numpy(tp), want, **_param_tol(BASE, 1))
    for k in ("loss", "accuracy", "tokens", "grad_norm"):
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=1e-5)
