"""The port imports without JAX: in a fresh interpreter, import every
``llava_plus_torch`` module and run the tiny slice on the CPU (through
``Generator.stream``, and through the shared HTTP worker as a client reaches
it), then check that neither ``jax`` nor ``triton`` was imported and that no
kernel build (``nvcc``) ran."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
import torch
import llava_plus_torch
names = [m.name for m in pkgutil.walk_packages(llava_plus_torch.__path__, "llava_plus_torch.")]
for name in names:
    importlib.import_module(name)

from llava_plus_torch.data import DebugTokenizer
from llava_plus_torch.generate import Generator
from llava_plus_torch.kernels import build
from llava_plus_torch.models import llava
from llava_plus_torch.models.configs import tiny_llava_config

def no_build(*args, **kwargs):
    raise AssertionError("a kernel build (nvcc) was attempted")

build.build = no_build
cfg = tiny_llava_config()
params = llava.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
gen = Generator(params, cfg, DebugTokenizer(vocab_size=cfg.text.vocab_size),
                device="cpu", max_seq_len=128, prefill_bucket=32, cache_dtype=torch.int8)
img = torch.randn(1, 28, 28, 3).numpy()
text = list(gen.stream("<image>\ndescribe it", img, max_new_tokens=4))
assert text and len(gen._last_output_ids) >= 1
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "triton"))
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
cfg = tiny_llava_config()
size = cfg.vision.image_size
params = llava.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
backend = TorchBackend(params, cfg, DebugTokenizer(vocab_size=cfg.text.vocab_size),
                       ClipImageProcessor(shortest_edge=size, crop_size=size),
                       device="cpu", use_engine=False, kv_int8=False, max_seq_len=128)
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
body = {"prompt": "<image>\nwhat is shown", "temperature": 0.0, "max_new_tokens": 4,
        "images": [base64.b64encode(buf.getvalue()).decode()]}
r = requests.post(f"http://127.0.0.1:{port}/worker_generate_stream", json=body,
                  stream=True, timeout=60)
chunks = list(iter_chunks_requests(r))
assert chunks and all(c["error_code"] == 0 for c in chunks), chunks
worker.stop()
loop.call_soon_threadsafe(loop.stop)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "triton"))
assert not bad, bad
assert build._lib is None
print("chunks", len(chunks))
"""


def _run(script):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return int(out.stdout.strip().splitlines()[-1].split()[-1])


def test_port_imports_no_jax_and_runs_without_kernels():
    assert _run(SCRIPT) >= 12  # every module of the package was imported


def test_port_http_path_imports_no_jax():
    assert _run(HTTP_SCRIPT) >= 1
