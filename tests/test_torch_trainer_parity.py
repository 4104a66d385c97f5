"""The port's ``train()`` against the JAX package's ``train()`` on the CPU:
the tiny debug model in f32 from the same initial weights (the port's
``build_model`` replaced by the JAX package's parameters), the same corpus
files, tokenizer, recipe and data order (both draw
``np.random.default_rng(seed).permutation``), compared step by step: each
step's loss, accuracy and target count. Tolerance rtol 1e-4 on the loss (f32
sums in another order, compounded over the steps' updates)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import llava_plus_tpu.train.step as jax_step
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.train import train as jax_train
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.train import train as port_train

from .test_torch_trainer import _tok, corpus  # noqa: F401  (the corpus fixture)

torch.set_num_threads(1)

RECIPES = {
    "padded": dict(),
    "packed_accum": dict(pack_sequences=True, gradient_accumulation_steps=2,
                         per_device_train_batch_size=2, max_steps=2),
}


def _jax_losses(monkeypatch, corpus, tmp_path, kw):
    """Per-step metrics of the JAX package's ``train()``: its step function
    is wrapped to record them."""
    seen = []
    make = jax_step.make_train_step

    def recording(*args, **kwargs):
        fn = make(*args, **kwargs)

        def step(params, opt_state, batch):
            out = fn(params, opt_state, batch)
            seen.append({k: float(v) for k, v in out[2].items()})
            return out
        return step

    monkeypatch.setattr(jax_step, "make_train_step", recording)
    data_path, img_dir = corpus
    jax_train.train(
        jax_train.ModelArguments(tiny_debug_model=True, version="v1"),
        jax_train.DataArguments(data_path=str(data_path), image_folder=str(img_dir),
                                image_aspect_ratio="pad"),
        jax_train.TrainingArguments(**_training_kw(tmp_path / "jax", kw), dp=1, fsdp_axis=1,
                                    tp=1),
        tokenizer=_tok())
    return seen


def _training_kw(out, kw):
    return {**dict(output_dir=str(out), per_device_train_batch_size=4, model_max_length=96,
                   max_steps=3, save_steps=100, bf16=False, gradient_checkpointing=False),
            **kw}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_per_step_losses_match_jax_train(monkeypatch, corpus, tmp_path, recipe):  # noqa: F811
    kw = RECIPES[recipe]
    want = _jax_losses(monkeypatch, corpus, tmp_path, kw)
    jparams = jax.tree.map(np.asarray, jax_llava.init_params(
        jax_tiny_config(), jax.random.PRNGKey(0), dtype=jnp.float32))
    got = []
    data_path, img_dir = corpus
    port_train.train(
        port_train.ModelArguments(tiny_debug_model=True, version="v1"),
        port_train.DataArguments(data_path=str(data_path), image_folder=str(img_dir),
                                 image_aspect_ratio="pad"),
        port_train.TrainingArguments(**_training_kw(tmp_path / "port", kw), device="cpu"),
        tokenizer=_tok(),
        build_model=lambda m, dtype, device, seed: (from_numpy(jparams, device, dtype),
                                              tiny_llava_config(), None),
        on_step=lambda s, m, dt, a: got.append(m))
    assert len(got) == len(want) == kw.get("max_steps", 3)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4, err_msg=f"step {i + 1}")
        assert a["tokens"] == b["tokens"] and a["accuracy"] == pytest.approx(b["accuracy"])
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    assert len({round(m["loss"], 6) for m in got}) == len(got)  # the steps saw new data
