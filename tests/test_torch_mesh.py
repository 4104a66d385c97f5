"""The port's (dp, fsdp, tp) mesh (``llava_plus_torch/parallel/``,
``train/step.py:place_params``) against the JAX package's, on the CPU.

In this process: the spec tables leaf by leaf, ``make_mesh``'s assertions
and ``constrain`` without a mesh. Then ONE launch of 8 gloo ranks (a file
store in ``tmp_path``) on a (2, 2, 2) mesh runs, in JAX-free child
processes: the placements of the fused embeddings and the logits (JAX
``tests/test_sharding_constraints.py:50, :63``), a LLaMA stage-2 step, a
QLoRA int8 step and an MPT stage-1 step; this process holds them to the
port's one-process steps on the same numpy inputs and the stage-2 step also
to the JAX package's 2 x 2 x 2 step (conftest gives JAX 8 CPU devices).
Beside that launch (started with it), the trainer's CLI under 4 gloo ranks
(``torch.distributed.run``, ``--fsdp-axis 2 --tp 2``) saves what a
one-process run saves.

Tolerances (f32): losses and gradient norms rtol 1e-5, as JAX's sharded
step test; parameters rtol 1e-5 with atol 1e-3 of lr a step, since Adam
moves an element whose gradient sums to about 0 by up to lr in a direction
the summation order decides (``tests/test_torch_train_step.py``)."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.models.configs import tiny_llava_mpt_config as jax_tiny_mpt_config
from llava_plus_tpu.ops import quant as jax_quant
from llava_plus_tpu.parallel import mesh as jax_mesh
from llava_plus_tpu.parallel import sharding as jax_sharding
from llava_plus_tpu.train import step as jax_step
from llava_plus_tpu.train.optimizer import OptimizerConfig as JaxOptConfig
from llava_plus_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from llava_plus_torch.models.configs import LlavaConfig, tiny_llava_config
from llava_plus_torch.models.convert import from_numpy, per_layer, to_numpy, tree_map
from llava_plus_torch.models.llava import MultimodalBatch
from llava_plus_torch.ops import quant
from llava_plus_torch.parallel import mesh, sharding
from llava_plus_torch.train import checkpoint
from llava_plus_torch.train import lora as lora_lib
from llava_plus_torch.train import step
from llava_plus_torch.train.optimizer import OptimizerConfig, build_optimizer
from llava_plus_torch.train.train import _lora_step_fn

from .test_torch_train_step import BASE, _padded, _param_tol

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
LORA_LR = 1e-3


def _spec_tree(tree):
    """A JAX spec tree with each PartitionSpec as the port's plain tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("kind", ["llama", "llama_tied", "mpt"])
def test_spec_tables_equal_jax(kind):
    import dataclasses

    jcfg = jax_tiny_mpt_config() if kind == "mpt" else jax_tiny_config()
    if kind == "llama_tied":
        jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text,
                                                                  tie_word_embeddings=True))
    tcfg = LlavaConfig.from_json(jcfg.to_json())
    got = sharding.llava_param_specs(tcfg)
    want = _spec_tree(jax_sharding.llava_param_specs(jcfg))
    assert got == want
    assert ("lm_head" in got["language_model"]) == (kind == "llama")
    if kind != "mpt":
        assert got["language_model"]["embed_tokens"] == (("fsdp", "tp"), None)
    for fn in ("llama_param_specs", "mpt_param_specs", "clip_param_specs"):
        assert getattr(sharding, fn)("f", "t") == _spec_tree(getattr(jax_sharding, fn)("f", "t"))
    for ptype in ("identity", "linear", "mlp2x_gelu"):
        assert (sharding.projector_param_specs(ptype)
                == _spec_tree(jax_sharding.projector_param_specs(ptype)))


@pytest.mark.parametrize("spec", [P(None, "fsdp", "tp"), P(None, "tp", "fsdp"), P("fsdp", "tp"),
                                  P(None), None])
def test_quantized_leaf_specs_equal_jax(spec):
    got = step._quant_specs(None if spec is None else tuple(spec))
    assert got == _spec_tree(jax_step._quant_specs(spec))


def test_make_mesh_shape_rule_and_assertions():
    """The assertions fire before a mesh is built, with JAX's messages, on 8
    devices (JAX's: the 8 CPU devices; the port's: ranks 0-7)."""
    ranks = list(range(8))
    for args, kw in (((3, None, 1), {}), ((2, None, 3), {}), ((2, 4, 2), {}), ((1, 16, 1), {})):
        with pytest.raises(AssertionError) as want:
            jax_mesh.make_mesh(*args, **kw)
        with pytest.raises(AssertionError) as got:
            mesh.make_mesh(*args, devices=ranks, device_type="cpu")
        assert str(got.value) == str(want.value)
    assert mesh.AXES == jax_mesh.AXES
    assert mesh.batch_spec() == tuple(jax_mesh.batch_spec())


def test_constrain_without_mesh_and_placements():
    x = torch.ones(4, 4)
    assert mesh.constrain(x, ("dp", "fsdp"), None) is x
    assert mesh.active_mesh() is None

    class Mesh:   # the names and rank a DeviceMesh exposes
        mesh_dim_names = ("dp", "fsdp", "tp")
        ndim = 3

    from torch.distributed.tensor import Replicate, Shard

    # an axis the mesh lacks is dropped; a tuple shards one dim over both
    assert mesh.placements(Mesh, (("dp", "fsdp"), "model_axis_that_does_not_exist")) == (
        Shard(0), Shard(0), Replicate())
    assert mesh.placements(Mesh, (None, "tp")) == (Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        mesh.placements(Mesh, (("tp", "fsdp"),))


# ---------------------------------------------------------------------------
# 8 gloo ranks on a (2, 2, 2) mesh
# ---------------------------------------------------------------------------

RANK_SCRIPT = r"""
import pickle, sys, time
from pathlib import Path
import numpy as np, torch, torch.distributed as dist

torch.set_num_threads(1)
rank, world, d, trainer = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank, world_size=world)
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from llava_plus_torch.models import llava
from llava_plus_torch.models.configs import LlavaConfig
from llava_plus_torch.models.convert import from_numpy, per_layer, stacked, to_numpy, tree_map
from llava_plus_torch.models.llava import MultimodalBatch
from llava_plus_torch.ops import quant
from llava_plus_torch.ops.attention import attention
from llava_plus_torch.train.optimizer import tree_leaves
from llava_plus_torch.parallel.mesh import make_mesh
from llava_plus_torch.train import checkpoint, lora as lora_lib, step
from llava_plus_torch.train.optimizer import OptimizerConfig, build_optimizer
from llava_plus_torch.train.train import _lora_step_fn

with open(f"{d}/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
mesh = make_mesh(2, None, 2, device_type="cpu")
out = {"mesh": (tuple(mesh.mesh.shape), mesh.mesh_dim_names)}
cfg = LlavaConfig.from_json(inp["cfg"])
batch = step.place_batch(MultimodalBatch(**{k: torch.from_numpy(v)
                                            for k, v in inp["batch"].items()}), mesh)

def full(tree):
    return to_numpy(checkpoint.gathered(tree))

# each group of four ranks as a (1, 2, 2) mesh: another shape to restore on
sub = DeviceMesh("cpu", torch.arange(world).reshape(2, 1, 2, 2),
                 mesh_dim_names=("copy", "dp", "fsdp", "tp"))["dp", "fsdp", "tp"]

# the placements of the fused embeddings and the logits, as the stage-2
# step's forward makes them
params = step.place_params(from_numpy(inp["llama"], "cpu"), mesh, cfg)
fuse, forward = llava.fuse, llava.forward

def seen_fuse(*args, **kwargs):
    fused = fuse(*args, **kwargs)
    out.setdefault("fused", str(tuple(fused.placements)))
    return fused

def seen_forward(*args, **kwargs):
    logits, cache = forward(*args, **kwargs)
    out.setdefault("logits", str(tuple(logits.placements)))
    return logits, cache

llava.fuse, llava.forward = seen_fuse, seen_forward

def _all_dtensor(tree):
    flat = []
    tree_map(lambda x: flat.append(isinstance(x, DTensor)), tree)
    return all(flat)

out["leaves_dtensor"] = _all_dtensor(params)

def run(params, opt_cfg, remat):
    p = per_layer(params)
    opt = build_optimizer(p, OptimizerConfig(**opt_cfg))
    state = opt.init(p)
    calls = attention.mesh_calls
    _, state, m = step.make_train_step(cfg, opt, remat=remat, mesh=mesh)(p, state, batch)
    return {k: float(v) for k, v in m.items()}, attention.mesh_calls - calls

# LLaMA stage 2, its save and its resume into freshly placed trees
p = per_layer(params)
opt = build_optimizer(p, OptimizerConfig(**inp["opt"]))
state = opt.init(p)
calls = attention.mesh_calls
_, state, m = step.make_train_step(cfg, opt, remat=True, mesh=mesh)(p, state, batch)
out["stage2"] = {k: float(v) for k, v in m.items()}
out["stage2_attention_calls"] = attention.mesh_calls - calls
out["stage2_params"] = full(params)
# every rank writes its own shards
checkpoint.save_train_state(f"{d}/ckpt", 1, p, state)
fresh = per_layer(step.place_params(from_numpy(inp["llama"], "cpu"), mesh, cfg))
fresh_state = opt.init(fresh)
restored, at = checkpoint.restore_train_state(f"{d}/ckpt/checkpoint-1", fresh, fresh_state)

def moments(s):
    return tree_map(lambda x: x.numpy(), checkpoint.gathered(s["mu"]))

out["resume"] = (at, full(restored["params"]), moments(restored["opt_state"]),
                 _all_dtensor(fresh), moments(state))

# the same save on the (1, 2, 2) mesh of each group of four ranks
def on_sub(tree):
    return checkpoint.gathered(tree, rank)

fresh = per_layer(step.place_params(from_numpy(inp["llama"], "cpu"), sub, cfg))
restored, at = checkpoint.restore_train_state(f"{d}/ckpt/checkpoint-1", fresh, opt.init(fresh))
p_sub, mu_sub = on_sub(restored["params"]), on_sub(restored["opt_state"]["mu"])
if rank == 0:
    out["resume_122"] = (at, to_numpy(p_sub), tree_map(lambda x: x.numpy(), mu_sub),
                         tuple(fresh["language_model"]["embed_tokens"].device_mesh.shape))

# the trainer CLI's 4-rank checkpoint (started with this launch), restored
# on the (1, 2, 2) mesh into trees shaped as the one-process run's state
deadline = time.time() + 240
while not all((trainer / run / "checkpoint-2" / "meta.json").exists() for run in ("mesh", "one")):
    assert time.time() < deadline, "the trainer runs wrote no checkpoint-2"
    time.sleep(1)
one = torch.load(trainer / "one" / "checkpoint-2" / "state.pt", weights_only=True)
tcfg = LlavaConfig.load(trainer / "one" / "checkpoint-2" / "config.json")
like = per_layer(step.place_params(stacked(one["params"]), sub, tcfg))
like_state = {"count": 0, **{m: {k: [torch.zeros_like(x) for x in tree_leaves(like[k])]
                                 for k in one["opt_state"][m]} for m in ("mu", "nu")}}
restored, at = checkpoint.restore_train_state(trainer / "mesh" / "checkpoint-2", like, like_state)
p_sub, mu_sub = on_sub(restored["params"]), on_sub(restored["opt_state"]["mu"])
if rank == 0:
    out["trainer_122"] = (at, restored["opt_state"]["count"], to_numpy(p_sub),
                          tree_map(lambda x: x.numpy(), mu_sub), _all_dtensor(like))

# QLoRA int8: the quantized base placed by _quant_specs, the adapters replicated
base = quant.quantize_llava_params(from_numpy(inp["llama"], "cpu"), "llama", bits=8)
base = step.place_params(base, mesh, cfg)
out["qlora_placements"] = str(tuple(base["language_model"]["layers"]["attn"]["wq"]["scale"]
                                    .placements))
adapters = tree_map(lambda x: distribute_tensor(x, mesh, [Replicate()] * 3),
                    from_numpy(inp["lora"], "cpu"))
lstep = _lora_step_fn(per_layer(base), cfg, lora_lib.LoraConfig(**inp["lora_cfg"]),
                      lora_lib.lora_per_layer(adapters), inp["lora_lr"], False, 1, mesh)
out["qlora"] = {k: float(v) for k, v in lstep(batch).items()}
out["qlora_adapters"] = full(adapters)

# MPT stage 1
cfg = LlavaConfig.from_json(inp["mpt_cfg"])
params = step.place_params(from_numpy(inp["mpt"], "cpu"), mesh, cfg)
out["mpt"], _ = run(params, dict(inp["opt"], train_language_model=False), False)
out["mpt_projector"] = full(params["mm_projector"])
if rank == 0:
    with open(f"{d}/out.pkl", "wb") as f:
        pickle.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def _start(args_of, n, cwd, tag):
    """``n`` processes, each writing to ``cwd/<tag><i>.log`` (a file, so that
    nothing blocks on a full pipe while this process works)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = []
    for r in range(n):
        with open(Path(cwd) / f"{tag}{r}.log", "w") as log:
            procs.append(subprocess.Popen(args_of(r), cwd=cwd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
        procs[-1].log = Path(cwd) / f"{tag}{r}.log"
    return procs


def _wait(procs, timeout):
    for p in procs:
        p.wait(timeout=timeout)
    for p in procs:
        assert p.returncode == 0, p.log.read_text()[-4000:]


def _inputs():
    jcfg = jax_tiny_config()
    mcfg = jax_tiny_mpt_config()
    rng = np.random.default_rng(5)
    L, D, F = jcfg.text.num_hidden_layers, jcfg.text.hidden_size, jcfg.text.intermediate_size
    lora = {}
    for path, (din, dout) in {"layers/attn/wq": (D, D), "layers/attn/wk": (D, D // 2),
                              "layers/attn/wv": (D, D // 2), "layers/attn/wo": (D, D),
                              "layers/mlp/w_gate": (D, F), "layers/mlp/w_up": (D, F),
                              "layers/mlp/w_down": (F, D)}.items():
        lora[path] = {"a": (rng.normal(size=(L, din, 4)) * 0.02).astype(np.float32),
                      "b": (rng.normal(size=(L, 4, dout)) * 0.02).astype(np.float32)}
    return {
        "cfg": jcfg.to_json(), "mpt_cfg": mcfg.to_json(),
        "llama": jax.tree.map(np.asarray, jax_llava.init_params(
            jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)),
        "mpt": jax.tree.map(np.asarray, jax_llava.init_params(
            mcfg, jax.random.PRNGKey(1), dtype=jnp.float32)),
        "batch": {k: np.asarray(v) for k, v in _padded().items()},
        "opt": dict(BASE), "lora": lora, "lora_cfg": dict(r=4, alpha=8), "lora_lr": LORA_LR,
    }


def _one_process(inp):
    """The port's steps without a mesh, on the same inputs."""
    batch = MultimodalBatch(**{k: torch.from_numpy(v) for k, v in inp["batch"].items()})
    out = {}

    def run(cfg, tree, opt_cfg, remat):
        p = per_layer(from_numpy(tree, "cpu"))
        opt = build_optimizer(p, OptimizerConfig(**opt_cfg))
        _, _, m = step.make_train_step(cfg, opt, remat=remat)(p, opt.init(p), batch)
        return {k: float(v) for k, v in m.items()}, to_numpy(p)

    cfg = tiny_llava_config()
    out["stage2"], out["stage2_params"] = run(cfg, inp["llama"], inp["opt"], True)
    base = per_layer(quant.quantize_llava_params(from_numpy(inp["llama"], "cpu"), "llama",
                                                 bits=8))
    adapters = from_numpy(inp["lora"], "cpu")
    lstep = _lora_step_fn(base, cfg, lora_lib.LoraConfig(**inp["lora_cfg"]),
                          lora_lib.lora_per_layer(adapters), inp["lora_lr"], False, 1)
    out["qlora"] = {k: float(v) for k, v in lstep(batch).items()}
    out["qlora_adapters"] = to_numpy(adapters)
    mcfg = LlavaConfig.from_json(inp["mpt_cfg"])
    out["mpt"], p = run(mcfg, inp["mpt"], dict(inp["opt"], train_language_model=False), False)
    out["mpt_projector"] = p["mm_projector"]
    return out


def _jax_mesh_step(inp):
    """JAX's stage-2 step on its 2 x 2 x 2 mesh."""
    jcfg = jax_tiny_config()
    m = jax_mesh.make_mesh(2, 2, 2)
    params = jax_step.place_params(jax.tree.map(jnp.asarray, inp["llama"]), m, jcfg)
    opt = jax_build_optimizer(inp["llama"], JaxOptConfig(**inp["opt"]))
    fn = jax_step.make_train_step(jcfg, opt, remat=True, mesh=m)
    jb = jax_llava.MultimodalBatch(**{k: jnp.asarray(v) for k, v in inp["batch"].items()})
    p, _, metrics = fn(params, jax_step.init_opt_state(opt, params),
                       jax_step.place_batch(jb, m))
    return jax.tree.map(np.asarray, jax.device_get(p)), {k: float(v) for k, v in metrics.items()}


def _close(got, want, tol):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), **tol), got, want)


def test_eight_ranks_match_one_process_and_jax(tmp_path, trainer_runs):
    inp = _inputs()
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    trainer_root, _ = trainer_runs
    procs = _start(lambda r: [sys.executable, "-c", RANK_SCRIPT, str(r), "8", str(tmp_path),
                              str(trainer_root)], 8, tmp_path, "rank")
    one = _one_process(inp)            # while the ranks run
    want_params, want_m = _jax_mesh_step(inp)
    _wait(procs, timeout=240)
    with open(tmp_path / "out.pkl", "rb") as f:
        got = pickle.load(f)
    assert got["mesh"] == ((2, 2, 2), ("dp", "fsdp", "tp"))
    assert got["leaves_dtensor"]
    # JAX :50 and :63: fused embeds over the batch, logits over batch and tp
    assert got["fused"] == "(Shard(dim=0), Shard(dim=0), Replicate())"
    assert got["logits"] == "(Shard(dim=0), Shard(dim=0), Shard(dim=2))"
    # the int8 scale's contraction slot replicated, N over tp
    assert got["qlora_placements"] == "(Replicate(), Replicate(), Shard(dim=2))"
    assert got["stage2_attention_calls"] > 0
    # resume: the sharded save, loaded into freshly placed DTensors on the
    # same mesh and on a (1, 2, 2) mesh, is the trained tree and optimizer
    # state bit for bit
    at, r_params, r_mu, r_dtensor, mu = got["resume"]
    assert at == 1 and r_dtensor
    jax.tree.map(np.testing.assert_array_equal, r_params, got["stage2_params"])
    jax.tree.map(np.testing.assert_array_equal, r_mu, mu)
    at, r_params, r_mu, shape = got["resume_122"]
    assert at == 1 and shape == (1, 2, 2)
    jax.tree.map(np.testing.assert_array_equal, r_params, got["stage2_params"])
    jax.tree.map(np.testing.assert_array_equal, r_mu, mu)
    # the trainer CLI's 4-rank sharded checkpoint on a (1, 2, 2) mesh: the
    # one-process run's state, within that test's tolerance
    at, count, r_params, r_mu, r_dtensor = got["trainer_122"]
    sb = torch.load(trainer_root / "one" / "checkpoint-2" / "state.pt", weights_only=True)
    assert at == count == sb["opt_state"]["count"] == CLI_STEPS and r_dtensor
    _close({"params": r_params, "mu": r_mu},
           {"params": to_numpy(sb["params"]),
            "mu": tree_map(lambda x: x.numpy(), sb["opt_state"]["mu"])}, CLI_TOL)
    ptol = _param_tol(inp["opt"], 1)
    for ref_m, ref_p in ((one["stage2"], one["stage2_params"]), (want_m, want_params)):
        for k in ("loss", "accuracy", "tokens", "grad_norm"):
            np.testing.assert_allclose(got["stage2"][k], ref_m[k], rtol=RTOL)
        _close(got["stage2_params"], ref_p, ptol)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got["qlora"][k], one["qlora"][k], rtol=RTOL)
        np.testing.assert_allclose(got["mpt"][k], one["mpt"][k], rtol=RTOL)
    _close(got["qlora_adapters"], one["qlora_adapters"], dict(rtol=RTOL, atol=1e-3 * LORA_LR))
    _close(got["mpt_projector"], one["mpt_projector"], ptol)
    # the steps moved what they train
    assert not np.array_equal(got["qlora_adapters"]["layers/attn/wq"]["b"],
                              inp["lora"]["layers/attn/wq"]["b"])


CLI_LR, CLI_STEPS = 2e-5, 2
CLI_TOL = dict(rtol=1e-5, atol=5e-2 * CLI_LR * CLI_STEPS)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The trainer's CLI under 4 gloo ranks (``torch.distributed.run``,
    ``--fsdp-axis 2 --tp 2``) and in one process, started at once on a tiny
    corpus, two micro-batches a step. The 8-rank test asks for it too, so
    that these runs overlap that launch."""
    from PIL import Image
    import json

    root = tmp_path_factory.mktemp("trainer")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    records = []
    for i in range(8):
        if i % 2 == 0:
            Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)).save(
                img_dir / f"img{i}.png")
            records.append({"image": f"img{i}.png", "conversations": [
                {"from": "human", "value": f"<image>\nwhat is {i}"},
                {"from": "gpt", "value": f"it is thing {i}"}]})
        else:
            records.append({"conversations": [
                {"from": "human", "value": f"compute {i} plus {i}"},
                {"from": "gpt", "value": f"the answer is {2 * i}"}]})
    (root / "data.json").write_text(json.dumps(records))
    argv = ["-m", "llava_plus_torch.train.train", "--tiny-debug-model", "true",
            "--data-path", str(root / "data.json"), "--image-folder", str(img_dir),
            "--max-steps", str(CLI_STEPS), "--per-device-train-batch-size", "4",
            "--gradient-accumulation-steps", "2",
            "--model-max-length", "96", "--bf16", "false", "--gradient-checkpointing", "false",
            "--learning-rate", str(CLI_LR), "--device", "cpu", "--image-aspect-ratio", "pad"]
    procs = (_start(lambda r: [sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc-per-node", "4", *argv, "--fsdp-axis", "2", "--tp", "2",
                               "--output-dir", str(root / "mesh")], 1, root, "mesh")
             + _start(lambda r: [sys.executable, *argv, "--output-dir", str(root / "one")],
                      1, root, "one"))
    yield root, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


def test_trainer_cli_under_four_ranks_saves_what_one_process_saves(trainer_runs):
    """The final HF export and the training state of the 4-rank run equal
    the one-process run's (rtol 1e-5, atol 5e-2 of lr a step: Adam's
    near-zero elements, as above)."""
    from safetensors.torch import load_file

    root, procs = trainer_runs
    _wait(procs, timeout=300)
    tol = CLI_TOL
    a = load_file(str(root / "mesh" / "hf_export" / "model.safetensors"))
    b = load_file(str(root / "one" / "hf_export" / "model.safetensors"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), **tol)
    # the mesh run's sharded state, read in this process into trees shaped
    # as the one-process run's
    sb = torch.load(root / "one" / "checkpoint-2" / "state.pt", weights_only=True)
    like = tree_map(lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else x, sb)
    sa, at = checkpoint.restore_train_state(root / "mesh" / "checkpoint-2", like["params"],
                                            like["opt_state"])
    assert at == sa["opt_state"]["count"] == sb["opt_state"]["count"] == CLI_STEPS
    tree_map(lambda x, y: np.testing.assert_allclose(x.numpy(), y.numpy(), **tol),
             {"params": sa["params"], "mu": sa["opt_state"]["mu"]},
             {"params": sb["params"], "mu": sb["opt_state"]["mu"]})


def test_trainer_cli_mesh_checkpoint_holds_each_shard_once(trainer_runs):
    """The 4-rank run's training state is written by every rank, each its
    own shards: every saved tensor's chunks tile it exactly once, a leaf
    sharded over fsdp has chunks in more than one rank's file, and the
    files hold the state's bytes once over all ranks (not once a rank)."""
    import torch.distributed.checkpoint as dcp

    root, procs = trainer_runs
    _wait(procs, timeout=300)
    state_dir = root / "mesh" / "checkpoint-2" / checkpoint.SHARDED_DIR
    assert not (root / "mesh" / "checkpoint-2" / checkpoint.STATE_FILE).exists()
    md = dcp.FileSystemReader(state_dir).read_metadata()
    files = {}
    payload = 0
    for key, tmd in md.state_dict_metadata.items():
        if not hasattr(tmd, "chunks"):
            continue           # a plain value (the step count)
        numel = int(np.prod(tmd.size))
        assert sum(int(np.prod(c.sizes)) for c in tmd.chunks) == numel, key
        files[key] = {info.relative_path for idx, info in md.storage_data.items()
                      if idx.fqn == key}
        payload += numel * tmd.properties.dtype.itemsize
    one = torch.load(root / "one" / "checkpoint-2" / "state.pt", weights_only=True)
    leaves = [x for _, x in checkpoint._flat([one["params"], one["opt_state"]])
              if isinstance(x, torch.Tensor)]
    assert len(files) == len(leaves)
    assert payload == sum(x.numel() * x.element_size() for x in leaves)
    written = sum(f.stat().st_size for f in state_dir.glob("*.distcp"))
    assert len(list(state_dir.glob("*.distcp"))) == 4
    # each chunk is written once, with a few hundred bytes of framing
    # (many small chunks at this width): far below one copy a rank (4x)
    assert payload <= written < 1.5 * payload
    # the embedding is sharded over fsdp: two ranks wrote its halves
    assert len(files["params/language_model/embed_tokens"]) >= 2
