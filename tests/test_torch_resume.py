"""A run of the port's trainer cut after a save and resumed, against the
same run never cut: on the CPU, the tiny debug model in f32 on the corpus
of ``tests/test_trainer.py``. The resumed run takes up the data where the
save left it, so its steps (loss, ``grad_norm``, target count, sample ids,
epoch) and its final leaves equal the uninterrupted run's bit for bit, for
padded rows, packed rows, the length-grouped sampler, gradient
accumulation, and a save in the second epoch whose resume crosses into the
third. The resumed run also matches the JAX package's uninterrupted run
(rtol 1e-4, as ``test_torch_trainer_parity.py``), while the JAX package's
own resume trains the epoch's first batches again. Also: a ``meta.json``
from before positions were recorded, and the optimizer steps of an epoch
under gradient accumulation (the JAX trainer counts micro-batches)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import llava_plus_tpu.train.step as jax_step
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.data.debug_tokenizer import DebugTokenizer as JaxDebugTokenizer
from llava_plus_tpu.train import train as jax_train
from llava_plus_torch.data.debug_tokenizer import DebugTokenizer
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.train import checkpoint as ckpt
from llava_plus_torch.train import train as port_train
from llava_plus_torch.train.optimizer import tree_leaves

from .test_torch_trainer import corpus  # noqa: F401  (the corpus fixture)

torch.set_num_threads(1)

# (recipe, the save step, the last step); the run is cut at the step after
# the save. The corpus holds 8 samples: 4 steps an epoch at 2 rows.
CASES = {
    "padded": (dict(), 2, 4),
    "packed": (dict(pack_sequences=True), 2, 4),
    "grouped": (dict(group_by_modality_length=True), 3, 8),
    "accum2": (dict(gradient_accumulation_steps=2), 1, 3),
    "epoch2": (dict(), 5, 10),
}
KEYS = ("loss", "grad_norm", "tokens", "sample_ids", "epoch")
# a tokenizer whose ids do not depend on the order it meets the words in
# (ids by hash, the same in both packages)
VOCAB = 512


class Cut(Exception):
    pass


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jax_llava.init_params(
        jax_tiny_config(), jax.random.PRNGKey(0), dtype=jnp.float32))


def _training_kw(out, kw):
    return {**dict(output_dir=str(out), per_device_train_batch_size=2, model_max_length=96,
                   save_steps=100, bf16=False, gradient_checkpointing=False), **kw}


def _port(corpus, out, jparams, cut_at=None, **kw):
    """The port's ``train()`` from the JAX package's initial weights:
    ``({step: its record}, the final stacked params or None if cut)``."""
    steps = {}

    def on_data(step, epoch, ids):
        steps[step] = {"epoch": epoch, "sample_ids": ids}

    def on_step(step, m, dt, arrays):
        steps[step].update(loss=m["loss"], grad_norm=m["grad_norm"], tokens=m["tokens"],
                           accuracy=m["accuracy"])
        if step == cut_at:
            raise Cut

    data_path, img_dir = corpus
    try:
        params, _ = port_train.train(
            port_train.ModelArguments(tiny_debug_model=True, version="v1"),
            port_train.DataArguments(data_path=str(data_path), image_folder=str(img_dir),
                                     image_aspect_ratio="pad"),
            port_train.TrainingArguments(**_training_kw(out, kw), device="cpu"),
            tokenizer=DebugTokenizer(vocab_size=VOCAB),
            build_model=lambda m, dtype, device, seed: (from_numpy(jparams, device, dtype),
                                                        tiny_llava_config(), None),
            on_step=on_step, on_data=on_data)
    except Cut:
        params = None
    return steps, params


def _cut_and_resume(corpus, tmp_path, jparams, save, last, kw):
    """The uninterrupted run, the run cut at the step after its save at
    ``save``, and that run resumed to ``last``."""
    kw = dict(kw, save_steps=save, max_steps=last)
    whole, final = _port(corpus, tmp_path / "whole", jparams, **kw)
    cut, _ = _port(corpus, tmp_path / "cut", jparams, cut_at=save + 1, **kw)
    assert ckpt.latest_checkpoint(tmp_path / "cut").name == f"checkpoint-{save}"
    resumed, resumed_final = _port(corpus, tmp_path / "cut", jparams, **kw)
    return whole, final, cut, resumed, resumed_final


@pytest.mark.parametrize("case", list(CASES))
def test_cut_and_resumed_run_equals_the_uninterrupted_run(corpus, tmp_path, jparams,  # noqa: F811
                                                          case):
    kw, save, last = CASES[case]
    whole, final, cut, resumed, resumed_final = _cut_and_resume(corpus, tmp_path, jparams,
                                                                save, last, kw)
    assert list(whole) == list(range(1, last + 1))
    assert list(cut) == list(range(1, save + 2))
    assert list(resumed) == list(range(save + 1, last + 1))
    for s in cut:
        assert {k: cut[s][k] for k in KEYS} == {k: whole[s][k] for k in KEYS}, f"step {s}"
    for s in resumed:
        assert {k: resumed[s][k] for k in KEYS} == {k: whole[s][k] for k in KEYS}, f"step {s}"
    for a, b in zip(tree_leaves(resumed_final), tree_leaves(final)):
        assert torch.equal(a, b)
    assert len({json.dumps(whole[s]["sample_ids"]) for s in whole}) > 1
    position = json.loads((tmp_path / "cut" / f"checkpoint-{save}" / "meta.json").read_text())
    assert position["step"] == save and position["epoch"] == whole[save]["epoch"]
    if case == "epoch2":
        assert whole[save]["epoch"] == 1 and whole[last]["epoch"] == 2
    if case == "grouped":
        # each epoch draws its own order (set_epoch), as HF's sampler does
        orders = [[j for s in whole if whole[s]["epoch"] == e for j in whole[s]["sample_ids"]]
                  for e in (0, 1)]
        assert sorted(orders[0]) == sorted(orders[1]) and orders[0] != orders[1]


def _jax_train(monkeypatch, corpus, out, kw, fake_step=False):
    """The JAX package's ``train()``: each step's metrics and batch tokens.
    ``fake_step`` puts a step that trains nothing in place of its jitted
    step (the data order alone is observed, with no compile)."""
    seen = []
    make = jax_step.make_train_step

    def recording(*args, **kwargs):
        fn = None if fake_step else make(*args, **kwargs)

        def step(params, opt_state, batch):
            if fake_step:
                out = (params, opt_state, {"loss": 0.0, "accuracy": 0.0, "tokens": 0.0,
                                           "grad_norm": 0.0})
            else:
                out = fn(params, opt_state, batch)
            seen.append({"tokens_array": np.asarray(batch.tokens),
                         **{k: float(v) for k, v in out[2].items()}})
            return out
        return step

    monkeypatch.setattr(jax_step, "make_train_step", recording)
    data_path, img_dir = corpus
    jax_train.train(
        jax_train.ModelArguments(tiny_debug_model=True, version="v1"),
        jax_train.DataArguments(data_path=str(data_path), image_folder=str(img_dir),
                                image_aspect_ratio="pad"),
        jax_train.TrainingArguments(**_training_kw(out, kw), dp=1, fsdp_axis=1, tp=1),
        tokenizer=JaxDebugTokenizer(vocab_size=VOCAB))
    monkeypatch.setattr(jax_step, "make_train_step", make)
    return seen


def test_resumed_run_matches_the_jax_uninterrupted_run(monkeypatch, corpus, tmp_path,  # noqa: F811
                                                       jparams):
    want = _jax_train(monkeypatch, corpus, tmp_path / "jax", dict(max_steps=4))
    kw = dict(save_steps=2, max_steps=4)
    cut, _ = _port(corpus, tmp_path / "port", jparams, cut_at=3, **kw)
    resumed, _ = _port(corpus, tmp_path / "port", jparams, **kw)
    got = [cut[1], cut[2], resumed[3], resumed[4]]
    assert len(want) == len(got) == 4
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4, err_msg=f"step {i + 1}")
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
        assert a["tokens"] == b["tokens"] and a["accuracy"] == pytest.approx(b["accuracy"])


def test_jax_resume_trains_the_epochs_first_batches_again(monkeypatch, corpus,  # noqa: F811
                                                          tmp_path):
    """The JAX package's fault, held: a run saved at step 2 and resumed
    trains the epoch's first two batches as its steps 3-4, where the run
    never cut trains the third and fourth."""
    whole = _jax_train(monkeypatch, corpus, tmp_path / "whole", dict(max_steps=4),
                       fake_step=True)
    _jax_train(monkeypatch, corpus, tmp_path / "cut", dict(max_steps=2, save_steps=2),
               fake_step=True)
    resumed = _jax_train(monkeypatch, corpus, tmp_path / "cut", dict(max_steps=4),
                         fake_step=True)
    assert len(whole) == 4 and len(resumed) == 2
    for got, first, right in zip(resumed, whole[:2], whole[2:]):
        np.testing.assert_array_equal(got["tokens_array"], first["tokens_array"])
        assert not np.array_equal(got["tokens_array"], right["tokens_array"])


def test_a_save_without_a_position_resumes_at_step_times_batch(corpus, tmp_path,  # noqa: F811
                                                              jparams):
    kw = dict(save_steps=2, max_steps=4, gradient_accumulation_steps=2, pack_sequences=False,
              per_device_train_batch_size=1)
    whole, final = _port(corpus, tmp_path / "whole", jparams, **kw)
    _port(corpus, tmp_path / "cut", jparams, cut_at=3, **kw)
    meta = tmp_path / "cut" / "checkpoint-2" / "meta.json"
    assert json.loads(meta.read_text()) == {"step": 2, "epoch": 0, "index": 4}
    meta.write_text(json.dumps({"step": 2}))   # as a save before positions wrote it
    assert ckpt.data_position(meta.parent, 2) == (0, 4)
    resumed, resumed_final = _port(corpus, tmp_path / "cut", jparams, **kw)
    assert list(resumed) == [3, 4]
    for s in resumed:
        assert {k: resumed[s][k] for k in KEYS} == {k: whole[s][k] for k in KEYS}
    for a, b in zip(tree_leaves(resumed_final), tree_leaves(final)):
        assert torch.equal(a, b)


def test_data_position_reads_both_meta_formats(tmp_path):
    (tmp_path / "meta.json").write_text(json.dumps({"step": 3, "epoch": 1, "index": 2}))
    assert ckpt.data_position(tmp_path, 4) == (1, 2)
    (tmp_path / "meta.json").write_text(json.dumps({"step": 3}))
    assert ckpt.data_position(tmp_path, 4) == (0, 12)


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_an_epoch_counts_optimizer_steps(monkeypatch, corpus, tmp_path, jparams,  # noqa: F811
                                         packed):
    """Without ``--max-steps``, one epoch of 8 samples at 2 rows x 2
    micro-batches is 2 optimizer steps, and the cosine schedule spans
    them; the JAX trainer counts micro-batches (4 steps, 2 epochs). Packed
    rows keep the JAX trainer's count of rows (a row holds several
    samples)."""
    kw = dict(max_steps=None, gradient_accumulation_steps=2, num_train_epochs=1,
              pack_sequences=packed)
    seen_cfg = []
    real = port_train.build_optimizer

    def build(params, cfg):
        seen_cfg.append(cfg)
        return real(params, cfg)

    monkeypatch.setattr(port_train, "build_optimizer", build)
    steps, _ = _port(corpus, tmp_path / "port", jparams, **kw)
    monkeypatch.setattr(port_train, "build_optimizer", real)
    jax_steps = _jax_train(monkeypatch, corpus, tmp_path / "jax", kw, fake_step=True)
    if packed:
        assert seen_cfg[0].total_steps == len(steps) == len(jax_steps) == 4
    else:
        assert seen_cfg[0].total_steps == len(steps) == 2
        assert len(jax_steps) == 4   # the JAX trainer's count: the fault
        assert sorted(j for s in steps.values() for j in s["sample_ids"]) == list(range(8))
