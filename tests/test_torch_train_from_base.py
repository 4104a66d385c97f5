"""The port's trainer from a text-only checkpoint, as every recipe starts:
``--model-name-or-path`` a plain LLaMA (``LlamaForCausalLM.save_pretrained``)
and ``--vision-tower`` a local CLIP directory (``CLIPVisionModel.
save_pretrained``) or a tower's name. The port's ``build_model`` builds the
tower and the projector there, as the reference's
``initialize_vision_modules`` does; the JAX package's ``build_model`` drops
both flags and returns no tower and an ``identity`` projector (its fault,
repaired in the port only). Held against the JAX package's own functions on
the same files: the loaded trees exactly, one training step at
``tests/test_torch_trainer_parity.py``'s rtol 1e-4 on the loss (the
parameters at ``tests/test_torch_train_step.py``'s atol of 1e-3 of lr),
and an export's logits at ``tests/test_torch_loading.py``'s tolerance."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from llava_plus_tpu.data.image_processing import (
    processor_for_vision_tower as jax_processor_for_vision_tower,
)
from llava_plus_tpu.data.multimodal import pad_images, plan_multimodal_batch
from llava_plus_tpu.models import builder as jax_builder
from llava_plus_tpu.models import hf_import as jax_hf
from llava_plus_tpu.models import projector as jax_projector
from llava_plus_tpu.models.configs import LlavaConfig as JaxLlavaConfig
from llava_plus_tpu.models.llava import MultimodalBatch as JaxBatch
from llava_plus_tpu.train import step as jax_step
from llava_plus_tpu.train import train as jax_train
from llava_plus_tpu.train.optimizer import OptimizerConfig as JaxOptConfig
from llava_plus_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from llava_plus_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from llava_plus_torch.conversation import serialize_tool_turn
from llava_plus_torch.data.image_processing import processor_for_vision_tower
from llava_plus_torch.models import builder, hf_import
from llava_plus_torch.models.configs import CLIP_VIT_L_224, CLIP_VIT_L_336
from llava_plus_torch.models.convert import from_numpy, per_layer, to_numpy
from llava_plus_torch.models.llava import MultimodalBatch
from llava_plus_torch.train import step
from llava_plus_torch.train.optimizer import OptimizerConfig, build_optimizer
from llava_plus_torch.train.train import (
    ModelArguments, build_model, build_parser, main, vision_config_for_tower,
)

from .test_torch_loading import (
    TOL, _assert_same_load, _export, _hf_llama, _jax_init, _leaves, _llava_logits_both,
    assert_trees_equal,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOWER_WIDTH, LM_WIDTH = 32, 64
# the parity test's tolerance on the loss; the parameters as
# test_torch_train_step.py holds them (Adam's eps 1e-4, atol 1e-3 of lr)
LOSS_RTOL = 1e-4
OPT = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0, eps=1e-4)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """B: a plain LLaMA as a base model is published (no "llava" in its
    name, no tokenizer files: both packages take the DebugTokenizer)."""
    path = tmp_path_factory.mktemp("base") / "vicuna-tiny-v1.3"
    _hf_llama(seed=0).save_pretrained(str(path))
    return path


@pytest.fixture(scope="module")
def tower(tmp_path_factory):
    """V: a CLIP vision tower directory, 28 px patches of 14 (4 tokens)."""
    from transformers import CLIPVisionConfig, CLIPVisionModel

    path = tmp_path_factory.mktemp("tower") / "clip-tiny"
    torch.manual_seed(1)
    CLIPVisionModel(CLIPVisionConfig(
        hidden_size=TOWER_WIDTH, intermediate_size=2 * TOWER_WIDTH, num_hidden_layers=2,
        num_attention_heads=2, image_size=28, patch_size=14)).save_pretrained(str(path))
    return path


def _model_args(argv):
    args = build_parser().parse_args(argv)
    return ModelArguments(**{f.name: getattr(args, f.name)
                             for f in dataclasses.fields(ModelArguments)})


def _shapes(tree):
    return [(p, tuple(np.shape(x))) for p, x in _leaves(tree)]


# -- (i) build_model -----------------------------------------------------------

@pytest.mark.parametrize("projector", ["linear", "mlp2x_gelu"])
def test_build_model_makes_the_named_modules_from_a_base(base, tower, projector):
    """The language model is the JAX builder's load of B, the tower JAX's
    ``clip_params_from_state_dict`` of V, the config V's with the select
    flags, the projector of JAX ``init_params``' shapes, drawn from
    ``seed``."""
    margs = ModelArguments(model_name_or_path=str(base), vision_tower=str(tower),
                           mm_projector_type=projector, mm_vision_select_layer=-1,
                           mm_vision_select_feature="cls_patch")
    params, cfg, tok = build_model(margs, torch.float32, "cpu", seed=7)
    _, jparams, _, _, _ = jax_builder.load_pretrained_model(str(base), dtype="float32")
    assert_trees_equal(params["language_model"], jparams["language_model"])

    hf_cfg = json.loads((tower / "config.json").read_text())
    want_tower = jax_hf.clip_params_from_state_dict(
        jax_hf.load_state_dict_dir(tower), jax_hf.clip_config_from_hf(hf_cfg), dtype="float32")
    assert_trees_equal(params["vision_tower"], want_tower)
    assert cfg.vision == dataclasses.replace(hf_import.clip_config_from_hf(hf_cfg),
                                             select_layer=-1, select_feature="cls_patch")
    assert (cfg.mm_projector_type, cfg.mm_hidden_size, cfg.num_image_tokens) == (
        projector, TOWER_WIDTH, 4)

    jproj = jax_projector.init_params(projector, TOWER_WIDTH, LM_WIDTH, jax.random.PRNGKey(0),
                                      jnp.float32)
    assert _shapes(params["mm_projector"]) == _shapes(jproj)
    again = build_model(margs, torch.float32, "cpu", seed=7)[0]["mm_projector"]
    other = build_model(margs, torch.float32, "cpu", seed=8)[0]["mm_projector"]
    for (_, a), (_, b), (_, c) in zip(_leaves(params["mm_projector"]), _leaves(again),
                                      _leaves(other)):
        assert torch.equal(a, b)
        assert a.abs().max() == 0 or not torch.equal(a, c)   # biases start at 0
    assert type(tok).__name__ == "DebugTokenizer"


def test_a_tower_by_name_warns_and_is_the_builders_seed0_tower(base):
    """No local directory: CLIP ViT-L/14 at 224 px (the name has no 336),
    random from seed 0 with the builder's warning, the builder's own tower."""
    name = "openai/clip-vit-large-patch14"
    margs = ModelArguments(model_name_or_path=str(base), vision_tower=name,
                           mm_projector_type="linear")
    with pytest.warns(UserWarning, match="not found locally"):
        params, cfg, _ = build_model(margs, torch.bfloat16, "cpu")
    assert cfg.vision == CLIP_VIT_L_224 and cfg.num_image_tokens == 256
    assert cfg.mm_hidden_size == CLIP_VIT_L_224.hidden_size
    with pytest.warns(UserWarning, match="not found locally"):
        want = builder._load_vision_tower({"mm_vision_tower": name}, cfg, torch.bfloat16)
    got = list(_leaves(params["vision_tower"]))
    assert [p for p, _ in got] == [p for p, _ in _leaves(want)]
    for (path, a), (_, b) in zip(got, _leaves(want)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("name", ["openai/clip-vit-large-patch14",
                                  "openai/clip-vit-large-patch14-336",
                                  "laion/CLIP-ViT-L-14-laion2B-s32B-b82K"])
def test_the_tower_config_follows_the_processors_rule(name):
    """A tower given by name: its image size is the one the image
    processor takes for the name, in both packages."""
    vision = vision_config_for_tower(name)
    assert vision in (CLIP_VIT_L_224, CLIP_VIT_L_336)
    assert (vision.image_size == processor_for_vision_tower(name).crop_size
            == jax_processor_for_vision_tower(name).crop_size)


def test_a_checkpoint_with_a_tower_loads_as_before(tmp_path, tower):
    """A full LLaVA checkpoint keeps its own tower and projector whatever
    ``--vision-tower`` names."""
    from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
    from llava_plus_torch.models.configs import tiny_llava_config

    jp = _jax_init(jax_tiny_config())
    path = _export(jp, tiny_llava_config(), tmp_path / "llava-tiny")
    margs = ModelArguments(model_name_or_path=str(path), vision_tower=str(tower),
                           mm_projector_type="linear")
    params, cfg, _ = build_model(margs, torch.float32, "cpu")
    _, loaded, loaded_cfg, _, _ = builder.load_pretrained_model(str(path), dtype=torch.float32)
    assert cfg == loaded_cfg and cfg.mm_projector_type == "mlp2x_gelu"
    assert_trees_equal(params, to_numpy(loaded))


# -- (ii) one step -----------------------------------------------------------------

def _batch(cfg, seed=0, n=4):
    """Image-text samples of different lengths, padded (numpy arrays)."""
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    ids, labels = [], []
    for _ in range(n):
        n_text = int(rng.integers(6, 16))
        row = np.array([1, IMAGE_TOKEN_INDEX] + list(rng.integers(3, 500, n_text)))
        ids.append(row)
        labels.append(np.where(np.arange(len(row)) < 4, IGNORE_INDEX, row))
    plan = plan_multimodal_batch(ids, labels, num_patches=cfg.num_image_tokens, max_len=64,
                                 pad_to=32)
    images = [rng.normal(size=(1, size, size, 3)).astype(np.float32) for _ in range(n)]
    return {"tokens": plan.tokens, "positions": plan.positions,
            "segment_ids": plan.segment_ids, "image_pos": plan.image_pos,
            "labels": plan.labels, "images": pad_images(images, 1, (size, size, 3))}


def test_one_step_from_a_base_matches_the_jax_step(base, tower):
    """The tree the port builds from B and V, as numpy through the JAX
    package's ``make_train_step`` (stage 2: language model and projector
    trained) and through the port's: the loss, grad_norm and every updated
    leaf."""
    margs = ModelArguments(model_name_or_path=str(base), vision_tower=str(tower),
                           mm_projector_type="linear")
    params, cfg, _ = build_model(margs, torch.float32, "cpu", seed=3)
    jparams = to_numpy(params)
    jcfg = JaxLlavaConfig.from_json(cfg.to_json())
    arrays = _batch(cfg)

    opt = jax_build_optimizer(jparams, JaxOptConfig(**OPT))
    p = jax.tree.map(jnp.array, jparams)
    want, _, jm = jax_step.make_train_step(jcfg, opt, remat=False)(
        p, opt.init(p), JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}))

    tp = per_layer(from_numpy(jparams, "cpu"))
    topt = build_optimizer(tp, OptimizerConfig(**OPT))
    tp, _, tm = step.make_train_step(cfg, topt, remat=False)(
        tp, topt.init(tp), MultimodalBatch(**{k: torch.from_numpy(np.asarray(v))
                                              for k, v in arrays.items()}))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=LOSS_RTOL)
    assert float(tm["tokens"]) == float(jm["tokens"]) > 0
    got, want = to_numpy(tp), jax.tree.map(np.asarray, want)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=LOSS_RTOL, atol=1e-3 * OPT["learning_rate"]), got, want)
    # the frozen tower keeps its bytes; the trained groups moved
    jax.tree.map(np.testing.assert_array_equal, got["vision_tower"], jparams["vision_tower"])
    for key in ("language_model", "mm_projector"):
        assert not all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got[key]),
                                                             jax.tree.leaves(jparams[key])))


# -- (iii) the LLaVA-Plus v1.3 recipe through main() ---------------------------------

def _recipe(name, **flags):
    """The launcher's flags for the tiny model on the CPU, f32."""
    return chip_smoke._script_argv(name, bf16="false", device="cpu", **flags)


def test_the_v13_recipe_runs_from_a_base_and_its_export_loads_in_both(base, tower, tmp_path):
    """``training_llava_plus_v1_3_7b.sh``'s flags on two datasets in two
    image folders (image chats; tool-use records, some without an image):
    two steps with gradient accumulation, then the trainer's HF export,
    which both packages' ``load_pretrained_model`` read into equal trees and
    configs that give equal logits on one image prompt; the export holds the
    trained tree."""
    data, folders = chip_smoke._plus_corpus(str(tmp_path / "data"), np.random.default_rng(0),
                                            4, 4, 40)
    assert len(data.split(",")) == len(folders.split(",")) == 2
    records = json.load(open(data.split(",")[1]))
    assert any("image" not in r for r in records) and all(
        "actions" in r["conversations"][1] for r in records)
    # the dataset merges a reply's fields into serialize_tool_turn's grammar
    rendered = "".join(chip_smoke._dataset_texts(data, folders, "v1", 28))
    for r in records:
        for turn in r["conversations"][1::2]:
            assert serialize_tool_turn(turn["thoughts"], turn["actions"],
                                       turn["value"]) in rendered
    out = tmp_path / "out"
    argv, env = _recipe(chip_smoke.PLUS_SCRIPT, model_name_or_path=base, data_path=data,
                        image_folder=folders, vision_tower=tower, output_dir=out,
                        per_device_train_batch_size=2, gradient_accumulation_steps=2,
                        max_steps=2)
    assert env == {} and argv[argv.index("--mm-projector-type") + 1] == "linear"
    steps = []
    params, cfg = main(argv, on_step=lambda s, m, dt, a: steps.append((m, a)))
    assert len(steps) == 2
    for m, a in steps:
        assert math.isfinite(m["loss"]) and m["tokens"] > 0
        assert a["tokens"].shape[0] == 2    # micro-batches
    assert (cfg.mm_projector_type, cfg.num_image_tokens, cfg.vision.image_size) == (
        "linear", 4, 28)

    export = out / "hf_export"
    got = builder.load_pretrained_model(str(export), dtype="float32")
    want = jax_builder.load_pretrained_model(str(export), dtype="float32")
    _assert_same_load(got, want)
    assert_trees_equal(got[1], to_numpy(params))
    logits, jlogits = _llava_logits_both(got[1], want[1], got[2], want[2])
    np.testing.assert_allclose(logits, jlogits, **TOL)


# -- (iv) stage 1, then the v0 recipe over its projector -------------------------------

def test_stage1_then_the_v0_recipe_over_its_projector(base, tower, tmp_path):
    """``pretrain.sh`` from B moves only the projector; its
    ``mm_projector.bin`` is the starting projector of
    ``training_llava_plus_v0_7b.sh`` (``--pretrain-mm-mlp-adapter``), which
    then runs as the launcher runs it: ``python -m`` with
    ``LLAVA_DEFAULT_CONVERSATION=conv_vicuna_v0`` and ``--version v0``."""
    rng = np.random.default_rng(1)
    caps = chip_smoke._write_corpus(str(tmp_path / "caps"), 8, rng, 40, lambda i: [
        {"from": "human", "value": "<image>\n"},
        {"from": "gpt", "value": " ".join(f"w{int(j)}" for j in rng.integers(0, 99, 6))}])
    out1 = tmp_path / "stage1"
    # the reference's default projector: the v0 recipe reads it as linear
    argv, _ = _recipe(chip_smoke.STAGE1_SCRIPT, model_name_or_path=base, data_path=caps,
                      image_folder=os.path.dirname(caps), vision_tower=tower, output_dir=out1,
                      mm_projector_type="linear", per_device_train_batch_size=4, max_steps=2)
    built = {}

    def recording(model_args, dtype, device, seed):
        p, cfg, tok = build_model(model_args, dtype, device, seed)
        built.update({k: [x.clone() for _, x in _leaves(v)] for k, v in p.items()})
        return p, cfg, tok

    params, _ = main(argv, build_model=recording)
    for key in ("language_model", "vision_tower"):
        assert all(torch.equal(a, b) for a, (_, b) in zip(built[key], _leaves(params[key])))
    assert all(not torch.equal(a, b)
               for a, (_, b) in zip(built["mm_projector"], _leaves(params["mm_projector"])))
    assert (out1 / "mm_projector.bin").exists()

    data, folders = chip_smoke._plus_corpus(str(tmp_path / "data"), rng, 2, 2, 40)
    out2 = tmp_path / "v0"
    argv, env = _recipe("llava_plus/training_llava_plus_v0_7b.sh", model_name_or_path=base,
                        pretrain_mm_mlp_adapter=out1 / "mm_projector.bin", data_path=data,
                        image_folder=folders, vision_tower=tower, output_dir=out2,
                        per_device_train_batch_size=2, max_steps=1)
    assert env == {"LLAVA_DEFAULT_CONVERSATION": "conv_vicuna_v0"}
    assert argv[argv.index("--version") + 1] == "v0"
    start = build_model(_model_args(argv), torch.float32, "cpu")[0]["mm_projector"]
    for (_, a), (_, b) in zip(_leaves(start), _leaves(params["mm_projector"])):
        assert torch.equal(a, b)
    run = subprocess.run([sys.executable, "-m", "llava_plus_torch.train.train", *argv],
                         cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT, **env),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "step 1/1 loss=" in run.stdout + run.stderr
    assert (out2 / "hf_export" / "model.safetensors").exists()


def test_save_only_model_writes_the_model_alone(base, tower, tmp_path):
    """``--save-only-model``: a checkpoint at a save step holds the
    parameters and no optimizer state, the run's end (step 3) writes only
    the HF export (the trained tree), and a second run does not resume from
    those checkpoints. Without it (the JAX trainer's saves) the end also
    writes the whole state."""
    data, folders = chip_smoke._plus_corpus(str(tmp_path / "data"), np.random.default_rng(2),
                                            2, 2, 40)
    runs = {}
    for only in ("true", "false"):
        out = tmp_path / f"out-{only}"
        argv, _ = _recipe(chip_smoke.PLUS_SCRIPT, model_name_or_path=base, data_path=data,
                          image_folder=folders, vision_tower=tower, output_dir=out,
                          per_device_train_batch_size=2, max_steps=3, save_steps=2,
                          save_only_model=only)
        steps = []
        params, _ = main(argv, on_step=lambda s, m, dt, a: steps.append(s))
        runs[only] = (out, argv, params, steps)
    out, argv, params, _ = runs["true"]
    assert sorted(p.name for p in out.iterdir()) == ["checkpoint-2", "hf_export"]
    saved = torch.load(out / "checkpoint-2" / "state.pt", weights_only=True)
    assert sorted(saved) == ["params"]
    got = builder.load_pretrained_model(str(out / "hf_export"), dtype="float32")[1]
    assert_trees_equal(got, to_numpy(params))
    out_all = runs["false"][0]
    assert sorted(p.name for p in out_all.iterdir()) == ["checkpoint-2", "checkpoint-3",
                                                          "hf_export"]
    assert sorted(torch.load(out_all / "checkpoint-3" / "state.pt",
                             weights_only=True)) == ["opt_state", "params"]
    steps = []
    main(argv, on_step=lambda s, m, dt, a: steps.append(s))   # from step 0 again
    assert steps == [1, 2, 3]


# -- (v) the JAX package's own result -------------------------------------------------

def test_the_jax_build_model_drops_the_vision_flags(base, tower):
    """The fault the port repairs: on the same B and flags the JAX
    package's ``build_model`` returns an ``identity`` projector, no tower
    and no projector leaves, where the port builds both."""
    jparams, jcfg, _ = jax_train.build_model(jax_train.ModelArguments(
        model_name_or_path=str(base), vision_tower=str(tower), mm_projector_type="linear"),
        "float32")
    assert jcfg.mm_projector_type == "identity"
    assert not jax.tree.leaves(jparams["vision_tower"])
    assert not jax.tree.leaves(jparams["mm_projector"])
    params, cfg, _ = build_model(ModelArguments(
        model_name_or_path=str(base), vision_tower=str(tower), mm_projector_type="linear"),
        torch.float32, "cpu")
    assert cfg.mm_projector_type == "linear" and cfg.num_image_tokens == 4
    assert list(_leaves(params["vision_tower"])) and list(_leaves(params["mm_projector"]))
