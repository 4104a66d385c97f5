"""The port behind its HTTP model worker, on the CPU: a tiny single-stream
``TorchBackend`` (``use_engine=False``) served by the port's
``ModelWorker``/``build_app`` over real HTTP, checked for the wire
format, ``error_code == 0`` on every chunk, and text equal to the port's
``Generator.stream``. The engine-backed worker is tested in
``test_torch_engine.py``."""

import asyncio
import base64
import io
import socket
import threading

import numpy as np
import pytest
import requests
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
from llava_plus_torch.mm_utils import process_images
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.serve.model_worker import (
    ModelWorker, TorchBackend, build_app, iter_chunks_requests,
)

torch.set_num_threads(1)
CFG = tiny_llava_config()
SIZE = CFG.vision.image_size


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class AppThread:
    """Run an aiohttp app on a dedicated event-loop thread."""

    def __init__(self, app, port):
        from aiohttp import web

        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            runner = web.AppRunner(app)
            self.loop.run_until_complete(runner.setup())
            self.loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
            started.set()
            self.loop.run_forever()

        threading.Thread(target=run, daemon=True).start()
        assert started.wait(10)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)


@pytest.fixture(scope="module")
def served():
    p = jax_llava.init_params(jax_tiny_config(), jax.random.PRNGKey(0), dtype=jnp.float32)
    params = from_numpy(jax.tree.map(np.asarray, p), "cpu")
    processor = ClipImageProcessor(shortest_edge=SIZE, crop_size=SIZE)
    backend = TorchBackend(params, CFG, DebugTokenizer(vocab_size=CFG.text.vocab_size),
                           processor, device="cpu", use_engine=False, kv_int8=True,
                           max_seq_len=128)
    port = _free_port()
    worker = ModelWorker("http://127.0.0.1:9", f"http://127.0.0.1:{port}", backend,
                         ["tiny-llava-torch"], no_register=True, heartbeats=False)
    app = AppThread(build_app(worker), port)
    yield backend, worker, f"http://127.0.0.1:{port}"
    worker.stop()
    app.stop()


def _png_b64(seed):
    arr = np.random.default_rng(seed).integers(0, 256, size=(SIZE, SIZE, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url, body):
    r = requests.post(f"{url}/worker_generate_stream", json=body, stream=True, timeout=60)
    return list(iter_chunks_requests(r))


@pytest.mark.parametrize("with_image", [False, True])
def test_stream_over_http_matches_generator(served, with_image):
    backend, _, url = served
    prompt = ("<image>\nwhat is shown" if with_image else "tell me about the sea")
    body = {"prompt": prompt, "temperature": 0.0, "max_new_tokens": 10}
    images = None
    if with_image:
        b64 = _png_b64(0)
        body["images"] = [b64]
        pil = Image.open(io.BytesIO(base64.b64decode(b64)))
        images = process_images([pil], backend.image_processor, CFG)
    chunks = _post(url, body)
    assert chunks
    for c in chunks:
        assert c["error_code"] == 0, c["text"]
        assert c["text"].startswith(prompt)
    want = list(backend.generator.stream(prompt, images, max_new_tokens=10))
    assert [c["text"] for c in chunks] == [prompt + t for t in want]


def test_stop_string_and_metrics(served):
    backend, _, url = served
    prompt = "one two three"
    full = _post(url, {"prompt": prompt, "temperature": 0.0, "max_new_tokens": 8})
    stop = full[3]["text"][len(prompt):].split(" ")[-1]
    chunks = _post(url, {"prompt": prompt, "temperature": 0.0, "max_new_tokens": 8,
                         "stop": stop})
    assert all(c["error_code"] == 0 for c in chunks)
    assert stop not in chunks[-1]["text"][len(prompt):]
    m = requests.post(f"{url}/worker_metrics", timeout=10).json()
    assert m["requests"] >= 2 and m["total_tokens"] > 0


def test_image_count_mismatch_is_an_error_chunk(served):
    _, _, url = served
    chunks = _post(url, {"prompt": "no image marker", "images": [_png_b64(1)]})
    assert len(chunks) == 1 and chunks[0]["error_code"] == 1
