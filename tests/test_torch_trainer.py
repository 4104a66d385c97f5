"""The port's trainer (``llava_plus_torch/train/train.py``) end to end
on the CPU: the tiny debug model in f32 on a small corpus of real files
(the fixture of ``tests/test_trainer.py``), checkpoints and resume, the
stage-1 adapter-only save and the HF export against the JAX package's
exporters (same keys, shapes and bytes), packing, accumulation, the
length-grouped sampler, the CLI, and the options that are not ported yet."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.train import checkpoint as jax_ckpt
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.models.convert import from_numpy, per_layer, to_numpy
from llava_plus_torch.train import checkpoint as ckpt
from llava_plus_torch.train.train import (
    DataArguments, ModelArguments, TrainingArguments, main, train,
)

from .test_preprocess import SpLikeTokenizer

torch.set_num_threads(1)


@pytest.fixture()
def corpus(tmp_path):
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    records = []
    for i in range(8):
        if i % 2 == 0:
            name = f"img{i}.png"
            Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)).save(
                img_dir / name)
            records.append({"image": name, "conversations": [
                {"from": "human", "value": f"<image>\nwhat is {i}"},
                {"from": "gpt", "value": f"it is thing {i}"}]})
        else:
            records.append({"conversations": [
                {"from": "human", "value": f"compute {i} plus {i}"},
                {"from": "gpt", "value": f"the answer is {2 * i}"}]})
    data_path = tmp_path / "data.json"
    data_path.write_text(json.dumps(records))
    return data_path, img_dir


@pytest.fixture(scope="module")
def jparams():
    p = jax_llava.init_params(jax_tiny_config(), jax.random.PRNGKey(0), dtype=jnp.float32)
    return jax.tree.map(np.asarray, p)


def _args(corpus, tmp_path, model_kw=(), **kw):
    data_path, img_dir = corpus
    model_args = ModelArguments(tiny_debug_model=True, version="v1", **dict(model_kw))
    data_args = DataArguments(data_path=str(data_path), image_folder=str(img_dir),
                              image_aspect_ratio="pad")
    training_args = TrainingArguments(**{
        **dict(output_dir=str(tmp_path / "out"), per_device_train_batch_size=4,
               model_max_length=96, max_steps=3, save_steps=2, bf16=False,
               gradient_checkpointing=False, device="cpu"),
        **kw})
    return model_args, data_args, training_args


def _tok():
    tok = SpLikeTokenizer()
    tok.model_max_length = 96
    return tok


def _from_jax(jparams):
    """A ``build_model`` that starts from the JAX package's weights."""
    return lambda model_args, dtype, device: (from_numpy(jparams, device, dtype),
                                              tiny_llava_config(), None)


def _flat(tree):
    return jax.tree.leaves(to_numpy(tree))


def test_train_checkpoints_and_resumes(corpus, tmp_path):
    """Checkpoints at the save steps and at the end, the HF export, and a
    resume that restores the state saved at step 3 and continues to 4."""
    model_args, data_args, training_args = _args(corpus, tmp_path)
    params, cfg = train(model_args, data_args, training_args, tokenizer=_tok())
    out = tmp_path / "out"
    assert sorted(p.name for p in out.glob("checkpoint-*")) == ["checkpoint-2", "checkpoint-3"]
    assert (out / "hf_export" / "model.safetensors").exists()
    assert json.loads((out / "hf_export" / "config.json").read_text())["model_type"] == "llava"
    assert ckpt.latest_checkpoint(out).name == "checkpoint-3"

    steps = []
    params2, _ = train(model_args, data_args, dataclasses.replace(training_args, max_steps=4),
                       tokenizer=_tok(), on_step=lambda s, m, dt, a: steps.append(s))
    assert steps == [4]
    assert (out / "checkpoint-4" / "meta.json").exists()
    # the restored state is the state saved at step 3 (then one more step)
    state, step = ckpt.restore_train_state(out / "checkpoint-3", per_layer(params2))
    assert step == 3
    for a, b in zip(_flat(state["params"]), _flat(params)):
        np.testing.assert_array_equal(a, b)


def test_interrupted_save_is_skipped(corpus, tmp_path):
    model_args, data_args, training_args = _args(corpus, tmp_path, save_steps=100)
    train(model_args, data_args, dataclasses.replace(training_args, max_steps=1),
          tokenizer=_tok())
    out = tmp_path / "out"
    (out / "checkpoint-7").mkdir()          # a save cut before meta.json
    (out / "checkpoint-7" / ckpt.STATE_FILE).write_bytes(b"")
    assert ckpt.latest_checkpoint(out).name == "checkpoint-1"


def test_stage1_saves_the_adapter_and_trains_only_the_projector(corpus, tmp_path, jparams):
    model_args, data_args, training_args = _args(corpus, tmp_path,
                                                 model_kw={"tune_mm_mlp_adapter": True})
    params, _ = train(model_args, data_args, training_args, tokenizer=_tok(),
                      build_model=_from_jax(jparams))
    out = tmp_path / "out"
    got = torch.load(out / "mm_projector.bin", weights_only=True)
    assert (out / "checkpoint-2" / "mm_projector.bin").exists()
    want_path = jax_ckpt.export_mm_projector_bin(
        jax.tree.map(np.asarray, to_numpy(params)), tmp_path / "jax_mm_projector.bin")
    want = torch.load(want_path, weights_only=True)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    final = to_numpy(params)
    for key in ("language_model", "vision_tower"):
        jax.tree.map(np.testing.assert_array_equal, final[key], jparams[key])
    assert not np.array_equal(final["mm_projector"]["layers"][0]["w"],
                              jparams["mm_projector"]["layers"][0]["w"])
    assert not list(out.glob("checkpoint-*/state.pt"))


def _safetensors(path):
    """(header dict, {name: raw bytes}) of a safetensors file."""
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    data = raw[8 + n:]
    return header, {k: data[v["data_offsets"][0]:v["data_offsets"][1]]
                    for k, v in header.items() if k != "__metadata__"}


@pytest.mark.parametrize("layout", ["stacked", "per_layer"])
def test_hf_export_matches_jax_byte_for_byte(tmp_path, jparams, layout):
    """The same header (names, dtypes, shapes, offsets) and the same bytes
    for every tensor but ``lm_head.weight``: the JAX exporter hands
    safetensors a transposed numpy view, whose raw buffer (the [in, out]
    matrix read as [out, in]) is what it writes; the port writes the
    transpose the key names (ROADMAP Queue 3)."""
    tp = from_numpy(jparams, "cpu")
    if layout == "per_layer":
        tp = per_layer(tp)
    ckpt.export_hf_llava(tp, tiny_llava_config(), tmp_path / "port")
    jax_ckpt.export_hf_llava(jparams, jax_tiny_config(), tmp_path / "jax")
    h_port, port = _safetensors(tmp_path / "port" / "model.safetensors")
    h_jax, theirs = _safetensors(tmp_path / "jax" / "model.safetensors")
    assert h_port == h_jax and len(port) == 64
    for k in port:
        if k != "lm_head.weight":
            assert port[k] == theirs[k], k
    w = jparams["language_model"]["lm_head"]
    assert port["lm_head.weight"] == np.ascontiguousarray(w.T).tobytes()
    assert theirs["lm_head.weight"] == w.tobytes()
    assert (json.loads((tmp_path / "port" / "config.json").read_text())
            == json.loads((tmp_path / "jax" / "config.json").read_text()))


def test_pack_sequences_and_accumulation(corpus, tmp_path):
    """Packed rows (several samples per row, separated by segment ids) and
    gradient accumulation over 2 micro-batches each run to their last
    step and save."""
    model_args, data_args, training_args = _args(corpus, tmp_path, pack_sequences=True,
                                                 pack_max_images=2)
    seen = []
    train(model_args, data_args, training_args, tokenizer=_tok(),
          on_step=lambda s, m, dt, a: seen.append((s, int(a["segment_ids"].max()),
                                                   a["tokens"].shape)))
    assert [s for s, _, _ in seen] == [1, 2, 3]
    assert max(n for _, n, _ in seen) >= 2 and all(sh == (4, 96) for _, _, sh in seen)
    assert (tmp_path / "out" / "hf_export" / "model.safetensors").exists()

    acc_out = tmp_path / "acc"
    seen = []
    train(model_args, data_args,
          dataclasses.replace(training_args, output_dir=str(acc_out), pack_sequences=False,
                              gradient_accumulation_steps=2, per_device_train_batch_size=2,
                              max_steps=2),
          tokenizer=_tok(), on_step=lambda s, m, dt, a: seen.append(a["tokens"].shape[:2]))
    assert seen == [(2, 2), (2, 2)]
    assert (acc_out / "checkpoint-2").exists()


def test_group_by_modality_and_freeze_projector(corpus, tmp_path, jparams):
    model_args, data_args, training_args = _args(
        corpus, tmp_path, group_by_modality_length=True, freeze_mm_mlp_adapter=True,
        max_steps=2, save_steps=100)
    params, _ = train(model_args, data_args, training_args, tokenizer=_tok(),
                      build_model=_from_jax(jparams))
    final = to_numpy(params)
    jax.tree.map(np.testing.assert_array_equal, final["mm_projector"], jparams["mm_projector"])
    assert not np.array_equal(final["language_model"]["lm_head"],
                              jparams["language_model"]["lm_head"])


def test_main_accepts_both_flag_spellings(corpus, tmp_path):
    data_path, img_dir = corpus
    out = tmp_path / "cli"
    main(["--tiny-debug-model", "true", "--data_path", str(data_path),
          "--image-folder", str(img_dir), "--max_steps", "2", "--save-steps", "100",
          "--per-device-train-batch-size", "2", "--bf16", "false",
          "--gradient_checkpointing", "true", "--device", "cpu", "--output-dir", str(out)])
    assert (out / "checkpoint-2" / "meta.json").exists()


@pytest.mark.parametrize("option", ["lora", "bits", "mpt", "model_path", "adapter", "mesh"])
def test_unported_options_raise(corpus, tmp_path, option):
    """Only what is not ported raises ``NotImplementedError`` (checkpoint
    loading, the mesh). LoRA, QLoRA and the MPT backbone train (their
    numbers: ``test_torch_lora.py``, ``test_torch_mpt_train.py``): a step
    each here, and LoRA on the MPT backbone, whose matrices the JAX package's
    targets do not name, raises ``ValueError``."""
    model_kw, kw = {}, {}
    if option == "lora":
        kw = dict(lora_enable=True, lora_r=4, lora_alpha=8)
    elif option == "bits":
        kw = dict(lora_enable=True, bits=4, lora_r=4, lora_alpha=8)
    elif option == "mpt":
        model_kw = dict(tiny_debug_arch="mpt", version="mpt")
    elif option == "model_path":
        model_kw = dict(tiny_debug_model=False, model_name_or_path="liuhaotian/llava-v1.5-7b")
    elif option == "adapter":
        model_kw = dict(pretrain_mm_mlp_adapter=str(tmp_path / "mm_projector.bin"))
    else:
        kw = dict(dp=2)
    data_path, img_dir = corpus
    model_args = dataclasses.replace(ModelArguments(tiny_debug_model=True), **model_kw)
    training_args = dataclasses.replace(_args(corpus, tmp_path)[2], max_steps=1, **kw)
    data_args = DataArguments(data_path=str(data_path), image_folder=str(img_dir))
    out = tmp_path / "out"
    if option in ("lora", "bits"):
        train(model_args, data_args, training_args, tokenizer=_tok())
        assert (out / "adapter_model.safetensors").exists()
        assert (out / "non_lora_trainables.bin").exists()
        with pytest.raises(ValueError, match="LLaMA"):
            train(dataclasses.replace(model_args, tiny_debug_arch="mpt", version="mpt"),
                  data_args, training_args)
    elif option == "mpt":
        train(model_args, data_args, training_args)
        cfg = json.loads((out / "hf_export" / "config.json").read_text())
        assert cfg["model_type"] == "llava_mpt"
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train(model_args, data_args, training_args, tokenizer=_tok())


def test_micro_batches_of_different_lengths_stack_without_changing_the_loss(jparams):
    """Gradient accumulation stacks K collated micro-batches; padding the
    shorter one to the longest T leaves its loss as it was, and its dropped
    image slots (a text-only row's) point past the new T."""
    from llava_plus_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from llava_plus_torch.data.multimodal import pad_images, plan_multimodal_batch
    from llava_plus_torch.models.llava import MultimodalBatch
    from llava_plus_torch.train import step
    from llava_plus_torch.train.train import stack_micro_batches

    cfg = tiny_llava_config()
    rng = np.random.default_rng(0)

    def collated(lengths, with_image):
        ids = [np.concatenate([[1], [IMAGE_TOKEN_INDEX] if img else [],
                               rng.integers(3, 500, n)]).astype(np.int64)
               for n, img in zip(lengths, with_image)]
        labels = [np.where(np.arange(len(x)) < 3, IGNORE_INDEX, x) for x in ids]
        plan = plan_multimodal_batch(ids, labels, num_patches=cfg.num_image_tokens,
                                     max_len=256, pad_to_multiple=64)
        imgs = [rng.normal(size=(1, 28, 28, 3)).astype(np.float32) if img else None
                for img in with_image]
        return {"tokens": plan.tokens, "positions": plan.positions,
                "segment_ids": plan.segment_ids, "image_pos": plan.image_pos,
                "labels": plan.labels, "images": pad_images(imgs, 1, (28, 28, 3))}

    short, long = collated([20, 30], [True, False]), collated([100, 70], [True, True])
    assert short["tokens"].shape[1] == 64 and long["tokens"].shape[1] == 128
    stacked = stack_micro_batches([short, long], 0, 256)
    assert stacked["tokens"].shape == (2, 2, 128)
    assert (stacked["image_pos"][0, 1] == 128).all()
    tp = per_layer(from_numpy(jparams, "cpu"))
    for i, arrays in enumerate((short, long)):
        alone = MultimodalBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
        padded = MultimodalBatch(**{k: torch.from_numpy(v[i]) for k, v in stacked.items()})
        with torch.no_grad():
            a = step.loss_fn(tp, cfg, alone, remat=False)[1]
            b = step.loss_fn(tp, cfg, padded, remat=False)[1]
        assert int(a["tokens"]) == int(b["tokens"])
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]), rtol=1e-6)


def test_delta_weights_match_jax(jparams):
    from llava_plus_tpu.models import llava as jl
    from llava_plus_torch.models.convert import to_numpy as tn

    base = jax.tree.map(np.asarray, jl.init_params(jax_tiny_config(), jax.random.PRNGKey(1),
                                                   dtype=jnp.float32))["language_model"]
    want = jax_ckpt.make_delta(jparams, base)
    got = ckpt.make_delta(from_numpy(jparams, "cpu"), from_numpy(base, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, tn(got), want)
    back = ckpt.apply_delta(got, from_numpy(base, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, tn(back),
                 jax_ckpt.apply_delta(want, base))
