"""LLaVA-MPT training in the port against the JAX package, on the CPU, in f32.

The tiny MPT config (ALiBi, 4 heads) from the same numpy weights:

- the gradient of one training step, for every language-model leaf and the
  projector, against ``jax.grad`` of the JAX ``loss_fn``, on padded and on
  packed rows (rtol 1e-5, atol 1e-6: f32 sums in another order, and a norm
  weight's gradient sums over every token); remat on equals remat off;
- the weight-decay mask on MPT's per-layer tree is the JAX rule (``ndim >
  1`` on the stacked tree);
- the port's ``train()`` with ``tiny_debug_arch="mpt", version="mpt"``
  against the JAX ``train()``, step by step: loss, accuracy, tokens and
  grad_norm (rtol 1e-4, compounded over the updates);
- the MPT HF export (the ``transformer.*`` layout of the reference
  ``llava_mpt.py``): keys, shapes, bytes and ``config.json`` equal to the
  JAX export of the same parameters; ``per_layer`` / ``stacked`` round-trip
  MPT's tree.

On the card the same code runs the ALiBi flash forward and backward kernels
(``chip_smoke.py`` phases 8 and 12)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import llava_plus_tpu.train.step as jax_step
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_mpt_config as jax_tiny_mpt
from llava_plus_tpu.models.llava import MultimodalBatch as JaxBatch
from llava_plus_tpu.train import checkpoint as jax_ckpt
from llava_plus_tpu.train import train as jax_train
from llava_plus_torch.models.configs import tiny_llava_mpt_config
from llava_plus_torch.models.convert import from_numpy, per_layer, stacked, to_numpy
from llava_plus_torch.models.llava import MultimodalBatch
from llava_plus_torch.train import checkpoint as ckpt
from llava_plus_torch.train import step
from llava_plus_torch.train import train as port_train
from llava_plus_torch.train.optimizer import decay_mask, tree_leaves

from .test_torch_train_step import _assert_tree_close, _instances
from .test_torch_trainer import corpus  # noqa: F401  (the corpus fixture)

torch.set_num_threads(1)
CFG = tiny_llava_mpt_config()
JCFG = jax_tiny_mpt()
RTOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jparams():
    p = jax_llava.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jax.tree.map(np.asarray, p)


def _arrays(kind):
    from llava_plus_tpu.data.multimodal import pad_images, plan_multimodal_batch
    from llava_plus_tpu.data.packing import pack_instances

    if kind == "packed":
        arrays, consumed = pack_instances(_instances(6, 1), rows=2, max_len=64,
                                          num_patches=CFG.num_image_tokens, image_size=28,
                                          max_images_per_row=3)
        assert consumed == 6 and arrays["segment_ids"].max() == 3
        return arrays
    inst = _instances(4, 0)
    plan = plan_multimodal_batch([x["input_ids"] for x in inst], [x["labels"] for x in inst],
                                 num_patches=CFG.num_image_tokens, max_len=64, pad_to=32)
    return {"tokens": plan.tokens, "positions": plan.positions,
            "segment_ids": plan.segment_ids, "image_pos": plan.image_pos,
            "labels": plan.labels, "images": pad_images([x["images"] for x in inst], 1,
                                                        (28, 28, 3))}


def _grads(params, arrays, remat):
    tb = MultimodalBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()})
    grads, m = step.grads_and_metrics(lambda p, mb: step.loss_fn(p, CFG, mb, remat=remat),
                                      params, tb)
    return to_numpy({"language_model": grads["language_model"],
                     "mm_projector": grads["mm_projector"]}), m


@pytest.mark.parametrize("kind", ["padded", "packed"])
def test_mpt_grads_match_jax(jparams, kind):
    arrays = _arrays(kind)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    (_, jm), jg = jax.value_and_grad(
        lambda p: jax_step.loss_fn(p, JCFG, jb, remat=False), has_aux=True)(jparams)
    tp = per_layer(from_numpy(jparams, "cpu"))
    got, m = _grads(tp, arrays, remat=False)
    for k in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    assert jax.tree.structure(got["language_model"]) == jax.tree.structure(jg["language_model"])
    _assert_tree_close(got["language_model"], jg["language_model"], **RTOL)
    _assert_tree_close(got["mm_projector"], jg["mm_projector"], **RTOL)
    # every leaf of the MPT tree takes a gradient
    assert all(np.abs(x).max() > 0 for x in jax.tree.leaves(got["language_model"]))
    # remat recomputes each layer in the backward: the same numbers
    again, _ = _grads(tp, arrays, remat=True)
    _assert_tree_close(again, got, atol=1e-6, rtol=0)


def test_mpt_trains_after_serving(jparams):
    """The per-device ALiBi slopes, first made by a forward under
    ``torch.inference_mode`` (serving), serve a remat training step after
    it (``torch.utils.checkpoint`` saves them for the backward)."""
    from llava_plus_torch.models import mpt

    mpt._device_slopes.cache_clear()
    tp = per_layer(from_numpy(jparams, "cpu"))
    with torch.inference_mode():
        mpt.forward(tp["language_model"], CFG.mpt, torch.arange(3, 11)[None])
    got, _ = _grads(tp, _arrays("packed"), remat=True)
    want, _ = _grads(tp, _arrays("packed"), remat=False)
    _assert_tree_close(got, want, atol=1e-6, rtol=0)


def test_mpt_decay_mask_is_the_jax_rule(jparams):
    """Decay where the stacked leaf has ndim > 1 (JAX's rule): ``wte`` and
    every ``[L, ...]`` layer leaf, the norms included, yes; ``norm_f`` no."""
    st = from_numpy(jparams, "cpu")["language_model"]
    tp = per_layer(from_numpy(jparams, "cpu"))
    L = CFG.mpt.n_layers
    want = []
    for name, sub in st.items():
        flags = [x.dim() > 1 for x in tree_leaves(sub)]
        want += flags * L if name == "layers" else flags
    assert decay_mask(tp, "language_model") == want
    assert st["wte"].dim() == 2 and st["norm_f"].dim() == 1 and st["layers"]["norm1"].dim() == 2
    assert want.count(False) == 1   # norm_f alone


def test_mpt_train_matches_jax_train(monkeypatch, corpus, tmp_path, jparams):  # noqa: F811
    seen = []
    make = jax_step.make_train_step

    def recording(*args, **kwargs):
        fn = make(*args, **kwargs)

        def run(params, opt_state, batch):
            out = fn(params, opt_state, batch)
            seen.append({k: float(v) for k, v in out[2].items()})
            return out
        return run

    monkeypatch.setattr(jax_step, "make_train_step", recording)
    data_path, img_dir = corpus
    kw = dict(per_device_train_batch_size=4, model_max_length=96, max_steps=3, save_steps=100,
              bf16=False, gradient_checkpointing=False)
    data = dict(data_path=str(data_path), image_folder=str(img_dir), image_aspect_ratio="pad")
    jax_train.train(
        jax_train.ModelArguments(tiny_debug_model=True, tiny_debug_arch="mpt", version="mpt"),
        jax_train.DataArguments(**data),
        jax_train.TrainingArguments(output_dir=str(tmp_path / "jax"), dp=1, fsdp_axis=1, tp=1,
                                    **kw))
    got = []
    port_tok = port_train.build_model(port_train.ModelArguments(tiny_debug_arch="mpt"),
                                      torch.float32, "cpu")[2]
    assert port_tok.bos_token_id is None and port_tok.vocab_size == CFG.mpt.vocab_size
    port_train.train(
        port_train.ModelArguments(tiny_debug_model=True, tiny_debug_arch="mpt", version="mpt"),
        port_train.DataArguments(**data),
        port_train.TrainingArguments(output_dir=str(tmp_path / "port"), device="cpu", **kw),
        build_model=lambda m, dtype, device, seed: (from_numpy(jparams, device, dtype),
                                              tiny_llava_mpt_config(), port_tok),
        on_step=lambda s, m, dt, a: got.append(m))
    assert len(got) == len(seen) == 3
    for i, (a, b) in enumerate(zip(got, seen)):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4, err_msg=f"step {i + 1}")
        assert a["tokens"] == b["tokens"] and a["accuracy"] == pytest.approx(b["accuracy"])
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    assert len({round(m["loss"], 6) for m in got}) == len(got)
    assert json.loads((tmp_path / "port" / "hf_export" / "config.json").read_text()) == \
        json.loads((tmp_path / "jax" / "hf_export" / "config.json").read_text())


def test_mpt_export_matches_jax(jparams, tmp_path):
    from safetensors.numpy import load_file

    jax_ckpt.export_hf_llava(jax.tree.map(jnp.asarray, jparams), JCFG, tmp_path / "jax")
    tp = per_layer(from_numpy(jparams, "cpu"))
    ckpt.export_hf_llava(tp, CFG, tmp_path / "port")
    want = load_file(str(tmp_path / "jax" / "model.safetensors"))
    got = load_file(str(tmp_path / "port" / "model.safetensors"))
    assert sorted(got) == sorted(want)
    assert any(k.startswith("transformer.blocks.1.") for k in got)
    assert any(k.startswith("transformer.mm_projector.") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == \
        json.loads((tmp_path / "jax" / "config.json").read_text())


def test_mpt_tree_round_trips(jparams):
    """``per_layer`` takes L from any stacked leaf (MPT has no
    ``input_norm``); ``stacked`` and ``to_numpy`` give the JAX tree back."""
    tp = per_layer(from_numpy(jparams, "cpu"))
    assert isinstance(tp["language_model"]["layers"], list)
    assert len(tp["language_model"]["layers"]) == CFG.mpt.n_layers
    back = to_numpy(stacked(tp))
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    # the per-layer leaves are views: an in-place update reaches the stack
    st = from_numpy(jparams, "cpu")
    pl = per_layer(st)
    pl["language_model"]["layers"][1]["norm1"].add_(1.0)
    assert np.array_equal(st["language_model"]["layers"]["norm1"][1].numpy(),
                          jparams["language_model"]["layers"]["norm1"][1] + 1.0)
