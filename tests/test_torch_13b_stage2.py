"""LLaVA-1.5-13B stage 2 (``scripts/v1_5/finetune.sh``) over an fsdp mesh,
on the CPU at a tiny size.

Four gloo ranks run the trainer's CLI (``torch.distributed.run``) at (1,
4, 1) from a base, as the recipe starts: a tiny plain HF LLaMA directory
with 4 kv heads, a tiny HF CLIP directory and a stage-1
``mm_projector.bin``, with ``finetune.sh``'s flags as the port's launcher
gives them (``--bf16 false``: f32, so that the comparison below can hold
the one-process run to f32's tolerance). Their HF export must equal a
one-process run's within ``tests/test_torch_mesh.py``'s ``CLI_TOL``.
Beside them, ``llava_plus_torch/tools/train_13b_mesh.py --device cpu
--tiny`` runs to its end over 4 gloo ranks (its own checks: finite losses,
step 1's loss and gradients against a one-process backward, the
projector's update against the port's AdamW on the gathered gradient, the
export read back bit for bit). The tool's flash bounds count each tensor
once, and its update check refuses planted faults. The mesh step itself
is held to JAX's by ``tests/test_torch_mesh.py``."""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.tools import common
from llava_plus_torch.tools import train_13b_mesh as tool

from .test_torch_loading import _hf_llama
from .test_torch_mesh import CLI_TOL, _start, _wait

torch.set_num_threads(1)
STEPS = 3
ROWS = 8          # the global batch: 2 rows a rank


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """B (a plain HF LLaMA, 4 kv heads), V (an HF CLIP tower) and a
    projector bin; then, started at once: the trainer under 4 gloo ranks at
    (1, 4, 1), the trainer in one process, and the tool's dry run."""
    from transformers import CLIPVisionConfig, CLIPVisionModel

    root = tmp_path_factory.mktemp("stage2")
    base = root / "vicuna-tiny-v1.5"
    _hf_llama(seed=0, num_key_value_heads=4).save_pretrained(str(base))
    tower = root / "clip-tiny"
    torch.manual_seed(1)
    CLIPVisionModel(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
        image_size=28, patch_size=14)).save_pretrained(str(tower))
    cfg = tiny_llava_config()
    proj = tool.write_projector(root / "mm_projector.bin", cfg)
    data = tool.write_corpus(root / "data", ROWS * STEPS, cfg.vision.image_size, tiny=True)
    argv, _ = common.script_argv(
        tool.SCRIPT, model_name_or_path=base, data_path=data, image_folder=data.parent,
        vision_tower=tower, pretrain_mm_mlp_adapter=proj, per_device_train_batch_size=ROWS,
        max_steps=STEPS, save_only_model="true", device="cpu", bf16="false")
    train = ["-m", "llava_plus_torch.train.train", *argv]
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node", "4"]
    procs = (_start(lambda r: [*launch, *train, "--fsdp-axis", "4",
                               "--output-dir", str(root / "mesh")], 1, root, "mesh")
             + _start(lambda r: [sys.executable, *train, "--output-dir", str(root / "one")],
                      1, root, "one")
             + _start(lambda r: [*launch, "-m", "llava_plus_torch.tools.train_13b_mesh",
                                 "--device", "cpu", "--tiny", "--rows", "2",
                                 "--work", str(root / "tool"),
                                 "--out", str(root / "tool.jsonl")], 1, root, "tool"))
    yield root, argv, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


def test_finetune_recipe_flags_reach_the_trainer(runs):
    """The launcher's recipe, as both runs were given it."""
    _, argv, _ = runs
    flag = {argv[i][2:]: argv[i + 1] for i in range(0, len(argv), 2)}
    assert {k: flag[k] for k in ("version", "mm-projector-type", "mm-vision-select-layer",
                                 "image-aspect-ratio", "group-by-modality-length",
                                 "learning-rate", "weight-decay", "warmup-ratio",
                                 "lr-scheduler-type", "model-max-length",
                                 "gradient-checkpointing")} == {
        "version": "v1", "mm-projector-type": "mlp2x_gelu", "mm-vision-select-layer": "-2",
        "image-aspect-ratio": "pad", "group-by-modality-length": "true",
        "learning-rate": "2e-5", "weight-decay": "0.", "warmup-ratio": "0.03",
        "lr-scheduler-type": "cosine", "model-max-length": "2048",
        "gradient-checkpointing": "true"}
    assert flag["max-steps"] == str(STEPS) and flag["save-only-model"] == "true"


def test_finetune_over_four_ranks_matches_one_process(runs):
    """The (1, 4, 1) run's HF export equals the one-process run's within
    CLI_TOL, and neither wrote a training state (``--save-only-model``)."""
    from safetensors.torch import load_file

    root, _, procs = runs
    _wait(procs[:2], timeout=300)
    a = load_file(str(root / "mesh" / "hf_export" / "model.safetensors"))
    b = load_file(str(root / "one" / "hf_export" / "model.safetensors"))
    assert a.keys() == b.keys()
    assert any(k.startswith("model.mm_projector.") for k in a)
    assert any(".vision_tower." in k for k in a)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), err_msg=k, **CLI_TOL)
    for side in ("mesh", "one"):
        assert not list((root / side).glob("checkpoint-*"))
        config = json.loads((root / side / "hf_export" / "config.json").read_text())
        assert config["num_key_value_heads"] == 4
        assert config["mm_projector_type"] == "mlp2x_gelu"


def test_tool_dry_run_runs_to_its_end(runs):
    """``train_13b_mesh --device cpu --tiny`` over 4 gloo ranks: a line a
    rank, every check of rank 0's true, 3 finite losses on every rank."""
    root, _, procs = runs
    _wait(procs[2:], timeout=300)
    lines = [json.loads(x) for x in (root / "tool.jsonl").read_text().splitlines()]
    assert [r["rank"] for r in lines] == [0, 1, 2, 3]
    head = lines[0]
    assert head["ok"] and all(head["checks"].values()), head["checks"]
    assert head["mesh"] == [1, 4, 1] and head["global_batch"] == 8
    step = head["step_check"]
    assert step["loss_rel_diff"] <= tool.LOSS_RTOL
    assert step["grad_norm_rel_diff"] <= tool.GRAD_RTOL
    assert step["projector_grad_rel_diff"] <= tool.PROJ_GRAD_RTOL
    assert head["update_check"]["ok"] and head["update_check"]["moved_share"] > 0
    assert head["export"]["bit_for_bit"] and head["export"]["leaves"] > 0
    for r in lines:
        assert len(r["steps"]) == STEPS
        assert all(np.isfinite(s["loss"]) and s["non_pad_tokens"] > 0 for s in r["steps"])
        assert r["steps"][0]["loss"] == head["steps"][0]["loss"]
    assert not (root / "tool").exists()   # the work directory is removed


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_flash_bounds_count_each_tensor_once(kernel):
    """The bounds at a rank's shape: each [B, T, H, 128] bf16 input read
    once and each output written once (forward: q, k, v -> out; dK/dV:
    q, k, v, dO -> dK, dV; dQ: q, k, v, dO -> dQ), the f32 rows (lse; lse
    and delta) and both int32 segment ids, against 4 / 8 / 6 x D products
    a causal pair and head; the larger time binds."""
    B, T, H, D = 3, 256, 4, tool.HEAD_DIM
    lengths = [256, 100, 7]
    pairs = 256 * 257 // 2 + 100 * 101 // 2 + 7 * 8 // 2
    tensor, rows, seg = B * T * H * D * 2, B * H * T * 4, 2 * B * T * 4
    nbytes = {"fwd": 4 * tensor + rows + seg, "dkv": 6 * tensor + 2 * rows + seg,
              "dq": 5 * tensor + 2 * rows + seg}[kernel]
    flops = {"fwd": 4, "dkv": 8, "dq": 6}[kernel] * H * D * pairs
    got = tool.flash_bounds(B, T, H, lengths)[kernel]
    t_bytes, t_ops = nbytes / tool.HBM_BYTES_S * 1e3, flops / tool.BF16_FLOPS_S * 1e3
    assert got["bound_ms"] == pytest.approx(max(t_bytes, t_ops), rel=1e-12)
    assert got["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")


def _first_update(lr=2e-5):
    """A projector's first AdamW update as ``FirstUpdate`` records it: the
    parameters before and after, the gradient and the two moments (bf16,
    small weights so that lr 2e-5 moves some of them)."""
    from llava_plus_torch.models import projector
    from llava_plus_torch.models.convert import tree_map
    from llava_plus_torch.train.optimizer import AdamW, OptimizerConfig

    gen = torch.Generator().manual_seed(3)
    p0 = tree_map(lambda x: (x * 0.1).bfloat16(), projector.init_params(
        "mlp2x_gelu", 16, 32, gen, "cpu", torch.float32))
    g = tree_map(lambda x: (torch.randn(x.shape, generator=gen) * 0.3).bfloat16(), p0)
    cfg = OptimizerConfig(learning_rate=2e-5, total_steps=3, train_language_model=False)
    tree = {"mm_projector": tree_map(torch.clone, p0)}
    opt = AdamW(tree, dataclasses.replace(cfg, learning_rate=lr))
    state = opt.update({"mm_projector": g}, opt.init(tree), tree)
    return {"cfg": cfg, "p0": p0, "g": g, "p1": tree["mm_projector"],
            "mu": state["mu"]["mm_projector"], "nu": state["nu"]["mm_projector"]}


def _halves_swapped(xs):
    x = xs[0]
    return [torch.cat([x[x.shape[0] // 2:], x[:x.shape[0] // 2]]), *xs[1:]]


@pytest.mark.parametrize("fault", ["none", "moment_shards_swapped", "lr_doubled",
                                   "not_applied"])
def test_update_check_holds_the_update_and_refuses_wrong_ones(fault):
    """``check_update`` passes the port's own update and refuses a first
    moment whose shards came back in the wrong order, an update at twice
    the learning rate, and parameters the update never reached."""
    from llava_plus_torch.train.optimizer import tree_leaves, tree_unflatten

    seen = _first_update()
    if fault == "moment_shards_swapped":
        seen["mu"] = _halves_swapped(seen["mu"])
    elif fault == "lr_doubled":
        seen["p1"] = _first_update(lr=4e-5)["p1"]
    elif fault == "not_applied":
        seen["p1"] = tree_unflatten(seen["p0"], [x.clone() for x in tree_leaves(seen["p0"])])
    got = tool.check_update(seen)
    assert got["ok"] == (fault == "none"), got
    if fault == "none":
        assert got["bf16_steps"] == {"param": 0, "mu": 0, "nu": 0}
        assert got["moved_share"] > 0
