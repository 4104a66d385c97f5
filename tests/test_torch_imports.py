"""The port stands alone: in a fresh interpreter, import every
``llava_plus_torch`` module and run the tiny slice on the CPU (through
``Generator.stream`` on the LLaMA and the MPT backbone, and through the
port's HTTP worker as a client reaches it, single stream and on the paged
engine with a prefix hit, and the training CLI for a stage-1, a stage-2, a
QLoRA and an MPT run), then check that neither ``jax`` nor ``triton`` nor any module of the
JAX package (``llava_plus_tpu``) was imported and that no kernel build
(``nvcc``) ran.
And the port's own copies of the JAX package's framework-free modules
(configs, the multimodal planner, tokenizer, image processing, prompt
tokenization, the prefix-cache hashing, the wire framing) give what the
originals give on seeded inputs."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
# top-level module names the port must never load
FOREIGN = ("jax", "jaxlib", "triton", "llava_plus_tpu")

SCRIPT = r"""
import importlib, pkgutil, sys
import torch
import llava_plus_torch
names = [m.name for m in pkgutil.walk_packages(llava_plus_torch.__path__, "llava_plus_torch.")]
assert "llava_plus_torch.train.lora" in names
for name in names:
    importlib.import_module(name)

from llava_plus_torch.data import DebugTokenizer
from llava_plus_torch.generate import Generator
from llava_plus_torch.kernels import build
from llava_plus_torch.models import llava
from llava_plus_torch.models.configs import tiny_llava_config, tiny_llava_mpt_config

def no_build(*args, **kwargs):
    raise AssertionError("a kernel build (nvcc) was attempted")

build.build = no_build
for cfg in (tiny_llava_config(), tiny_llava_mpt_config()):
    params = llava.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    tok = DebugTokenizer(vocab_size=512)
    if cfg.language_model_type == "mpt":
        tok.bos_token_id = None   # GPT-NeoX style, as MPT's tokenizer
    gen = Generator(params, cfg, tok, device="cpu", max_seq_len=128, prefill_bucket=32,
                    cache_dtype=torch.int8)
    img = torch.randn(1, 28, 28, 3).numpy()
    text = list(gen.stream("<image>\ndescribe it", img, max_new_tokens=4))
    assert text and len(gen._last_output_ids) >= 1
bad = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
assert not bad, bad
assert build._lib is None
print("modules", len(names))
"""

HTTP_SCRIPT = r"""
import asyncio, base64, io, socket, sys, threading
import numpy as np
import requests
import torch
from aiohttp import web
from PIL import Image
from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
from llava_plus_torch.kernels import build
from llava_plus_torch.models import llava
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.serve.model_worker import (
    ModelWorker, TorchBackend, build_app, iter_chunks_requests,
)

def no_build(*args, **kwargs):
    raise AssertionError("a kernel build (nvcc) was attempted")

build.build = no_build
paged = sys.argv[1] == "paged"
cfg = tiny_llava_config()
size = cfg.vision.image_size
params = llava.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
backend = TorchBackend(params, cfg, DebugTokenizer(vocab_size=cfg.text.vocab_size),
                       ClipImageProcessor(shortest_edge=size, crop_size=size),
                       device="cpu", use_engine=paged, paged=paged, kv_int8=paged,
                       max_seq_len=256 if paged else 128)
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
worker = ModelWorker("http://127.0.0.1:9", f"http://127.0.0.1:{port}", backend,
                     ["tiny-llava-torch"], no_register=True, heartbeats=False)
loop = asyncio.new_event_loop()
started = threading.Event()

def serve():
    asyncio.set_event_loop(loop)
    runner = web.AppRunner(build_app(worker))
    loop.run_until_complete(runner.setup())
    loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
    started.set()
    loop.run_forever()

threading.Thread(target=serve, daemon=True).start()
assert started.wait(10)
buf = io.BytesIO()
pixels = np.random.default_rng(0).integers(0, 256, size=(size, size, 3), dtype=np.uint8)
Image.fromarray(pixels).save(buf, format="PNG")
prompt = "<image>\nwhat is shown " + " ".join(f"w{i}" for i in range(140 if paged else 2))
body = {"prompt": prompt, "temperature": 0.0, "max_new_tokens": 4,
        "images": [base64.b64encode(buf.getvalue()).decode()]}
chunks = []
# on the paged engine the second turn re-sends the first: a prefix hit
for turn in ([body, dict(body, prompt=prompt + " and then")] if paged else [body]):
    r = requests.post(f"http://127.0.0.1:{port}/worker_generate_stream", json=turn,
                      stream=True, timeout=60)
    got = list(iter_chunks_requests(r))
    assert got and all(c["error_code"] == 0 for c in got), got
    chunks += got
if paged:
    metrics = requests.post(f"http://127.0.0.1:{port}/worker_metrics", timeout=10).json()
    assert metrics["engine_prefix_hit_tokens"] >= 128, metrics
    backend.stop()
worker.stop()
loop.call_soon_threadsafe(loop.stop)
bad = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
assert not bad, bad
assert build._lib is None
print("chunks", len(chunks))
"""

TRAIN_SCRIPT = r"""
import json, sys, tempfile
from pathlib import Path
import numpy as np
from PIL import Image
from llava_plus_torch.kernels import build
from llava_plus_torch.train import train

def no_build(*args, **kwargs):
    raise AssertionError("a kernel build (nvcc) was attempted")

build.build = no_build
tmp = Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
records = []
for i in range(4):
    Image.fromarray(rng.integers(0, 255, (30, 40, 3), dtype=np.uint8)).save(tmp / f"{i}.png")
    records.append({"image": f"{i}.png", "conversations": [
        {"from": "human", "value": "<image>\nwhat is it"}, {"from": "gpt", "value": f"thing {i}"}]})
(tmp / "data.json").write_text(json.dumps(records))
argv = ["--tiny-debug-model", "true", "--data_path", str(tmp / "data.json"),
        "--image-folder", str(tmp), "--max-steps", "2", "--per-device-train-batch-size", "2",
        "--bf16", "false", "--gradient-checkpointing", "true", "--device", "cpu",
        "--output-dir", str(tmp / "out")]
want = "checkpoint-2/state.pt"
if sys.argv[1] == "stage1":
    argv += ["--tune-mm-mlp-adapter", "true", "--version", "plain"]
    want = "mm_projector.bin"
elif sys.argv[1] == "qlora":
    argv += ["--lora-enable", "true", "--bits", "4", "--lora-r", "4", "--lora-alpha", "8"]
    want = "adapter_model.safetensors"
elif sys.argv[1] == "mpt":
    argv += ["--tiny-debug-arch", "mpt", "--version", "mpt"]
    want = "hf_export/model.safetensors"
train.main(argv)
out = tmp / "out"
assert (out / want).exists()
assert ("llava_plus_torch.train.lora" in sys.modules) and (
    sys.argv[1] != "mpt" or "llava_plus_torch.models.mpt" in sys.modules)
bad = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
assert not bad, bad
assert build._lib is None
print("steps", 2)
"""


def _run(script, *args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    script = f"FOREIGN = {FOREIGN!r}\n" + script
    out = subprocess.run([sys.executable, "-c", script, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return int(out.stdout.strip().splitlines()[-1].split()[-1])


def test_port_imports_no_jax_and_runs_without_kernels():
    assert _run(SCRIPT) >= 20  # every module of the package was imported


def test_port_http_path_imports_no_jax():
    assert _run(HTTP_SCRIPT, "generator") >= 1


def test_port_paged_engine_over_http_imports_no_jax():
    assert _run(HTTP_SCRIPT, "paged") >= 2


@pytest.mark.parametrize("stage", ["stage1", "stage2", "qlora", "mpt"])
def test_port_trainer_cli_imports_no_jax(stage):
    """The training CLI (dataset, collator, remat, the flash Function's
    plain path, AdamW, checkpoints and exports) in a fresh interpreter; also
    QLoRA (``train/lora.py``, the quantized matmuls' backward Function, the
    PEFT export) and the MPT backbone (the ALiBi backward's plain path, the
    MPT HF export)."""
    assert _run(TRAIN_SCRIPT, stage) == 2


# -- the port's own copies against the JAX package's originals -------------

@pytest.mark.parametrize("name", ["LLAVA_15_7B", "LLAVA_15_13B", "tiny_llava_config",
                                  "tiny_llava_mpt_config"])
def test_configs_match_jax_field_for_field(name):
    from llava_plus_tpu.models import configs as jax_configs
    from llava_plus_torch.models import configs

    mine, theirs = getattr(configs, name), getattr(jax_configs, name)
    if callable(mine):
        mine, theirs = mine(), theirs()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.num_image_tokens == theirs.num_image_tokens
    assert mine.text.head_dim == theirs.text.head_dim
    assert mine.hidden_size == theirs.hidden_size


def test_llava_mpt_7b_is_what_hf_import_reads(tmp_path):
    """``LLAVA_MPT_7B`` is the JAX ``llava_config_from_hf_dir`` reading of a
    LLaVA-Lightning-MPT-7B config (mosaicml/mpt-7b-chat's decoder fields,
    CLIP ViT-L/14 at 224 px, image start/end tokens) in every field that
    shapes the model."""
    import json

    from llava_plus_tpu.models.hf_import import llava_config_from_hf_dir
    from llava_plus_torch.models.configs import LLAVA_MPT_7B

    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "llava_mpt", "d_model": 4096, "n_layers": 32, "n_heads": 32,
        "expansion_ratio": 4, "max_seq_len": 2048, "vocab_size": 50432, "no_bias": True,
        "attn_config": {"alibi": True, "alibi_bias_max": 8, "attn_impl": "torch"},
        "mm_vision_tower": "openai/clip-vit-large-patch14", "mm_hidden_size": 1024,
        "mm_use_im_start_end": True, "mm_vision_select_layer": -2}))
    theirs = llava_config_from_hf_dir(tmp_path)
    for field in ("language_model_type", "mpt", "vision", "mm_projector_type",
                  "mm_hidden_size", "mm_use_im_start_end", "max_sequence_length"):
        assert (dataclasses.asdict(LLAVA_MPT_7B)[field]
                == dataclasses.asdict(theirs)[field]), field
    assert LLAVA_MPT_7B.num_image_tokens == 256 and LLAVA_MPT_7B.hidden_size == 4096


def test_planner_matches_jax():
    from llava_plus_tpu.data import multimodal as jax_mm
    from llava_plus_torch.data import multimodal

    rng = np.random.default_rng(0)
    ids = [np.concatenate([[1], rng.integers(3, 500, size=n), [-200], rng.integers(3, 500, 4)])
           for n in (3, 9, 20)]
    labels = [np.where(x < 0, -100, x) for x in ids]
    for kw in (dict(num_patches=4, max_len=16, pad_to_multiple=8),
               dict(num_patches=6, max_len=64, padding_side="left", max_images=2),
               dict(num_patches=4, max_len=12, pad_to=12)):
        a = multimodal.plan_multimodal_batch(ids, labels, **kw)
        b = jax_mm.plan_multimodal_batch(ids, labels, **kw)
        for field in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, field.name), getattr(b, field.name))
    imgs = [rng.normal(size=(1, 4, 4, 3)), None, rng.normal(size=(3, 4, 4, 3))]
    np.testing.assert_array_equal(multimodal.pad_images(imgs, 2, (4, 4, 3)),
                                  jax_mm.pad_images(imgs, 2, (4, 4, 3)))


def test_tokenizers_and_image_processing_match_jax():
    from llava_plus_tpu import mm_utils as jax_mm_utils
    from llava_plus_tpu.data.debug_tokenizer import DebugTokenizer as JaxTok
    from llava_plus_tpu.data.image_processing import ClipImageProcessor as JaxProc
    from llava_plus_tpu.models.configs import LLAVA_15_7B as JAX_7B
    from llava_plus_torch import mm_utils
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.models.configs import LLAVA_15_7B

    mine, theirs = DebugTokenizer(vocab_size=32000), JaxTok(vocab_size=32000)
    prompt = "USER: <image>\nwhat is in it </s> ASSISTANT: a cat \n<image> and more "
    ids = mm_utils.tokenizer_image_token(prompt, mine)
    assert ids == jax_mm_utils.tokenizer_image_token(prompt, theirs)
    np.testing.assert_array_equal(mm_utils.tokenizer_image_token(prompt, mine, return_tensors="np"),
                                  jax_mm_utils.tokenizer_image_token(prompt, theirs,
                                                                     return_tensors="np"))
    assert mine.decode(ids) == theirs.decode(ids)
    rng = np.random.default_rng(1)
    images = [Image.fromarray(rng.integers(0, 256, size=s, dtype=np.uint8))
              for s in ((300, 420, 3), (336, 336, 3), (500, 200, 3))]
    np.testing.assert_array_equal(
        mm_utils.process_images(images, ClipImageProcessor(), LLAVA_15_7B),
        jax_mm_utils.process_images(images, JaxProc(), JAX_7B))
    assert mm_utils.expand2square(images[0], (1, 2, 3)).size == (420, 420)


def test_prefix_hashing_and_wire_framing_match_jax():
    from llava_plus_tpu.serve import prefix_cache as jax_pc
    from llava_plus_tpu.serve import protocol as jax_protocol
    from llava_plus_torch.serve import prefix_cache, protocol

    rng = np.random.default_rng(2)
    toks = rng.integers(0, 32000, size=700)
    img = rng.normal(size=(336, 336, 3)).astype(np.float32)
    assert prefix_cache.image_digest(img) == jax_pc.image_digest(img)
    spans = [(1, prefix_cache.image_digest(img))]
    for kw in (dict(), dict(n_pages=3)):
        assert (prefix_cache.page_keys(toks, spans, 576, 128, **kw)
                == jax_pc.page_keys(toks, spans, 576, 128, **kw))
    payload = {"text": "hi \u00e9", "error_code": 0}
    assert protocol.encode_chunk(payload) == jax_protocol.encode_chunk(payload)
