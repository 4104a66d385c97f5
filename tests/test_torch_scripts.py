"""The port's scripts (``llava_plus_torch/scripts/``) against the JAX
package's (``scripts/``), on the CPU.

- Each of the 30 shell launchers is its ``scripts/`` original with
  ``llava_plus_tpu`` -> ``llava_plus_torch`` and ``scripts/`` ->
  ``llava_plus_torch/scripts/``, and nothing else; every ``python -m
  llava_plus_torch.*`` command in them (backslash continuations joined,
  each ``$VAR`` replaced by a placeholder of its flag's type) parses with
  that module's own ``build_parser()``, and every ``python
  llava_plus_torch/scripts/*.py`` it runs exists.
- ``merge_lora_weights.py`` of both packages, on a tiny base and a LoRA
  adapter, writes the same ``model.safetensors`` keys, dtypes and shapes,
  with values within one f32 ulp (the merge sums the r products in another
  order than XLA's einsum; ROADMAP, "a LoRA merge").
- ``extract_mm_projector.py`` of both writes equal tensors.
- The EvalAI converters (VQAv2, VizWiz) and the GQA / MM-Vet / SEED
  converters of both write the same files.

The JAX scripts run in fresh interpreters (``python scripts/<name>.py``),
the port's too, with the CPU forced for JAX."""

import importlib
import json
import os
import re
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
JAX_SCRIPTS = ROOT / "scripts"
PORT_SCRIPTS = ROOT / "llava_plus_torch" / "scripts"
LAUNCHERS = sorted(p.relative_to(JAX_SCRIPTS).as_posix() for p in JAX_SCRIPTS.rglob("*.sh"))
VAR = re.compile(r"\$\{?\w+\}?")

torch.set_num_threads(1)


def _mirror(text: str) -> str:
    return text.replace("llava_plus_tpu", "llava_plus_torch").replace(
        "scripts/", "llava_plus_torch/scripts/")


def test_thirty_launchers_mirrored():
    assert len(LAUNCHERS) == 30
    assert sorted(p.relative_to(PORT_SCRIPTS).as_posix()
                  for p in PORT_SCRIPTS.rglob("*.sh")) == LAUNCHERS


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_is_its_original_after_the_two_substitutions(name):
    ours, theirs = PORT_SCRIPTS / name, JAX_SCRIPTS / name
    assert ours.read_text() == _mirror(theirs.read_text())
    assert os.access(ours, os.X_OK) == os.access(theirs, os.X_OK)


def _commands(text: str):
    """The ``python ...`` commands of a launcher, continuations joined and
    a trailing ``&`` dropped."""
    joined = re.sub(r"\\\n", " ", text)
    for line in joined.splitlines():
        line = line.strip()
        if line.startswith("python "):
            yield line.rstrip("&").strip()


def _placeholder(action) -> str:
    if action.type is int:
        return "1"
    if action.type is float:
        return "0.5"
    if action.type is not None and action.type is not str:
        return "true"    # the trainer's booleans
    return "x"


def _filled(args, parser):
    """``args`` with each ``$VAR`` replaced by a placeholder of the type of
    the flag it is the value of."""
    out = []
    for i, tok in enumerate(args):
        if "$" in tok:
            flag = next(a for a in reversed(args[:i]) if a.startswith("-"))
            action = parser._option_string_actions[flag]
            value = _placeholder(action)
            tok = value if VAR.fullmatch(tok) else VAR.sub("x", tok)   # a path or a name
        out.append(tok)
    return out


def _module_commands():
    for name in LAUNCHERS:
        for cmd in _commands((PORT_SCRIPTS / name).read_text()):
            args = shlex.split(cmd)
            if args[1] == "-m":
                yield name, args[2], args[3:]


MODULE_COMMANDS = list(_module_commands())


def test_launchers_run_only_the_port():
    mods = {m for _, m, _ in MODULE_COMMANDS}
    assert len(MODULE_COMMANDS) >= 30 and all(m.startswith("llava_plus_torch.") for m in mods)
    assert mods >= {"llava_plus_torch.train.train", "llava_plus_torch.serve.controller",
                    "llava_plus_torch.serve.model_worker",
                    "llava_plus_torch.eval.model_vqa_loader"}
    for name in LAUNCHERS:
        text = (PORT_SCRIPTS / name).read_text()
        assert "llava_plus_tpu" not in text
        for cmd in _commands(text):
            args = shlex.split(cmd)
            if args[1] != "-m":
                assert args[1].startswith("llava_plus_torch/scripts/"), cmd
                assert (ROOT / args[1]).is_file(), cmd


@pytest.mark.parametrize("name,module,args", MODULE_COMMANDS,
                         ids=[f"{n}:{m.rsplit('.', 1)[1]}" for n, m, _ in MODULE_COMMANDS])
def test_launcher_command_parses_with_the_module_parser(name, module, args):
    parser = importlib.import_module(module).build_parser()
    ns = parser.parse_args(_filled(args, parser))
    assert ns is not None


# -- the Python scripts, both packages in fresh interpreters -----------------

def _start(script: Path, *args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return subprocess.Popen([sys.executable, str(script), *map(str, args)], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _done(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return out


def _run(script: Path, *args, cwd):
    return _done(_start(script, *args, cwd=cwd))


def _both(name, *args, cwd, out_of):
    """Run ``name`` of each package, at once; ``out_of(tag)`` gives the
    output path argument for that package's run."""
    procs = [_start(where / name, *args, *out_of(tag), cwd=cwd)
             for tag, where in (("jax", JAX_SCRIPTS), ("port", PORT_SCRIPTS))]
    for proc in procs:
        _done(proc)


@pytest.fixture(scope="module")
def lora_run(tmp_path_factory):
    """A tiny HF LLaMA base, a LoRA adapter as the JAX trainer writes it
    (nested ``LlavaConfig``, tiny CLIP config) and, where the config's
    default tower name points (``openai/clip-vit-large-patch14-336``
    under the working directory), a tiny local CLIP tower, so that both
    packages load the same tower; then each package's merge script."""
    from transformers import CLIPVisionConfig, CLIPVisionModel

    from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config

    from .test_torch_loading import _hf_llama, _jax_adapter_dir, _jax_init

    root = tmp_path_factory.mktemp("merge")
    base = root / "vicuna-tiny"
    model = _hf_llama()
    model.save_pretrained(str(base))
    jp = _jax_init(jax_tiny_config(hidden_size=64))
    adapter = _jax_adapter_dir(root, jp, model)
    vis = jax_tiny_config().vision
    torch.manual_seed(0)
    CLIPVisionModel(CLIPVisionConfig(
        hidden_size=vis.hidden_size, intermediate_size=vis.intermediate_size,
        num_hidden_layers=vis.num_hidden_layers, num_attention_heads=vis.num_attention_heads,
        image_size=vis.image_size, patch_size=vis.patch_size)).save_pretrained(
            str(root / "openai" / "clip-vit-large-patch14-336"))
    _both("merge_lora_weights.py", "--model-path", adapter, "--model-base", base, cwd=root,
          out_of=lambda tag: ("--save-model-path", root / f"merged-{tag}"))
    return root


MERGED_HF = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def test_merge_lora_weights_equals_jax_within_one_ulp(lora_run):
    """Every tensor bit for bit but the merged LoRA targets. There the f32
    sums of both merges agree to one f32 ulp of their operands (the r
    products summed in another order), and the scripts' bf16 checkpoint
    rounds them once more: so, as ``tests/test_torch_loading.py`` holds a
    bf16 merge, within one bf16 ulp (rtol 2**-8), and 1e-7 absolute where
    base and delta cancel to about 0."""
    from safetensors.torch import load_file

    got = load_file(str(lora_run / "merged-port" / "model.safetensors"))
    want = load_file(str(lora_run / "merged-jax" / "model.safetensors"))
    assert got.keys() == want.keys()
    assert any("vision_tower" in k for k in got) and any("mm_projector" in k for k in got)
    merged = 0
    for k in got:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape, k
        if k.startswith("model.layers.") and k.split(".")[-2] in MERGED_HF:
            merged += 1
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2 ** -8,
                                       atol=1e-7, err_msg=k)
        else:
            assert torch.equal(a, b), k
    assert merged == 14
    assert (json.loads((lora_run / "merged-port" / "config.json").read_text())
            == json.loads((lora_run / "merged-jax" / "config.json").read_text()))


def test_extract_mm_projector_equals_jax(lora_run):
    _both("extract_mm_projector.py", "--model-path", lora_run / "merged-port", cwd=lora_run,
          out_of=lambda tag: ("--output", lora_run / f"proj-{tag}" / "mm_projector.bin"))
    got = torch.load(lora_run / "proj-port" / "mm_projector.bin", weights_only=True)
    want = torch.load(lora_run / "proj-jax" / "mm_projector.bin", weights_only=True)
    assert list(got) == list(want) and len(got) == 4
    for k in want:
        # the port keeps the checkpoint's bf16; the JAX script's numpy read
        # widens it to f32, exactly
        assert got[k].dtype == torch.bfloat16, k
        assert torch.equal(got[k].to(want[k].dtype), want[k]), k


def _answers(path, n, rng):
    words = ["Yes.", "two", "A red car", "3", "The Cat.", "no", "C", "b) blue"]
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"question_id": i, "text": str(rng.choice(words))}) + "\n")


def test_answer_converters_equal_jax(tmp_path):
    """VQAv2 and VizWiz (through each package's ``EvalAIAnswerProcessor``),
    GQA, MM-Vet and SEED-Bench: the same files from the same answers."""
    rng = np.random.default_rng(0)
    d, split = tmp_path / "vqav2", "test-dev"
    _answers(d / "answers" / split / "ckpt" / "merge.jsonl", 12, rng)
    with open(d / f"llava_{split}.jsonl", "w") as f:
        for i in range(14):     # two questions without an answer
            f.write(json.dumps({"question_id": i}) + "\n")
    results = {}
    for tag, where in (("jax", JAX_SCRIPTS), ("port", PORT_SCRIPTS)):
        _run(where / "convert_vqav2_for_submission.py", "--dir", d, "--ckpt", "ckpt",
             "--split", split, cwd=tmp_path)
        results[tag] = (d / "answers_upload" / split / "ckpt.json").read_text()
    assert results["jax"] == results["port"] and len(json.loads(results["port"])) == 14

    _answers(tmp_path / "answers.jsonl", 10, rng)
    (tmp_path / "vizwiz.json").write_text(json.dumps(
        [{"question_id": i, "image": f"v{i}.jpg"} for i in range(11)]))
    (tmp_path / "seed.json").write_text(json.dumps({"questions": [
        {"question_id": i, "question_type_id": i % 3, "answer": "ABCD"[i % 4]}
        for i in range(10)]}))
    runs = {
        "convert_vizwiz_for_submission.py": lambda out: (
            "--annotation-file", tmp_path / "vizwiz.json", "--result-file",
            tmp_path / "answers.jsonl", "--result-upload-file", out),
        "convert_gqa_for_eval.py": lambda out: (
            "--src", tmp_path / "answers.jsonl", "--dst", out),
        "convert_mmvet_for_eval.py": lambda out: (
            "--src", tmp_path / "answers.jsonl", "--dst", out),
        "convert_seed_for_submission.py": lambda out: (
            "--annotation-file", tmp_path / "seed.json", "--result-file",
            tmp_path / "answers.jsonl", "--result-upload-file", out),
    }
    for name, args in runs.items():
        outs = {}
        for tag, where in (("jax", JAX_SCRIPTS), ("port", PORT_SCRIPTS)):
            out = tmp_path / tag / name.replace(".py", ".out")
            out.parent.mkdir(exist_ok=True)
            printed = _run(where / name, *args(out), cwd=tmp_path)
            outs[tag] = (out.read_text(), printed)
        assert outs["jax"] == outs["port"] and outs["port"][0], name
