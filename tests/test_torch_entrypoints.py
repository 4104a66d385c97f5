"""The port's command-line entry points on the CPU: the model worker's
``main`` (``python -m llava_plus_torch.serve.model_worker``) and the chat CLI
(``python -m llava_plus_torch.serve.cli``), each from a tiny checkpoint
written in ``tmp_path``, with ``--device cpu``.

In a fresh interpreter the worker serves one streamed request whose greedy
text equals an in-process ``TorchBackend``'s built by the same factory
(``load_backend``), loading nothing of JAX or of the JAX package; without
``--device`` on a machine with no card it exits non-zero, and the flags whose
modules are not ported yet exit with a message naming their ROADMAP item.
The CLI, with its input piped, answers as ``Generator`` does."""

import argparse
import base64
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from llava_plus_torch.conversation import conv_templates
from llava_plus_torch.generate import Generator
from llava_plus_torch.mm_utils import process_images
from llava_plus_torch.models import llava
from llava_plus_torch.models.builder import load_pretrained_model
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.serve import cli, model_worker
from llava_plus_torch.train import checkpoint as ckpt

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
FOREIGN = ("jax", "jaxlib", "triton", "llava_plus_tpu")

WORKER_SCRIPT = r"""
import json, os, sys, threading, time
import requests
from llava_plus_torch.kernels import build
from llava_plus_torch.serve import model_worker

def no_build(*args, **kwargs):
    raise AssertionError("a kernel build (nvcc) was attempted")

build.build = no_build
port, body, argv = int(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3:]

def client():
    url = f"http://127.0.0.1:{port}"
    deadline = time.time() + 120
    while True:
        try:
            requests.post(url + "/worker_get_status", timeout=5)
            break
        except requests.ConnectionError:
            if time.time() > deadline:
                os._exit(3)
            time.sleep(0.1)
    r = requests.post(url + "/worker_generate_stream", json=body, stream=True, timeout=60)
    chunks = list(model_worker.iter_chunks_requests(r))
    bad = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    print(json.dumps({"chunks": chunks, "foreign": bad}), flush=True)
    os._exit(0)

threading.Thread(target=client, daemon=True).start()
model_worker.main(argv + ["--host", "127.0.0.1", "--port", str(port)])
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def word_tokenizer(vocab_size):
    """A word-level fast tokenizer (no download) that names every id below
    ``vocab_size`` ("<unk>", "w1", "w2", ...), so greedy texts compare
    token for token; its EOS lies past the model's logits, so random
    weights never stop a stream early."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<unk>": 0, **{f"w{i}": i for i in range(1, vocab_size)}}
    core = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    core.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=core, unk_token="<unk>", eos_token="</s>")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny LLaVA-1.5 checkpoint (random f32 weights, seed 0) with
    tokenizer files, and a PNG."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = tiny_llava_config()
    params = llava.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    path = ckpt.export_hf_llava(params, cfg, root / "llava-v1.5-tiny",
                                word_tokenizer(cfg.text.vocab_size))
    size = cfg.vision.image_size
    pixels = np.random.default_rng(0).integers(0, 256, size=(size, size, 3), dtype=np.uint8)
    Image.fromarray(pixels).save(root / "image.png")
    return path, root / "image.png"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_worker_main_serves_the_checkpoint_like_an_in_process_backend(checkpoint):
    path, png = checkpoint
    argv = ["--model-path", str(path), "--device", "cpu", "--no-register", "--warmup", "0",
            "--kv-int8", "--max-slots", "4"]
    body = {"prompt": "USER: <image>\nwhat is shown here ASSISTANT:", "temperature": 0.0,
            "max_new_tokens": 8,
            "images": [base64.b64encode(png.read_bytes()).decode()]}
    script = f"FOREIGN = {FOREIGN!r}\n" + WORKER_SCRIPT
    out = subprocess.run([sys.executable, "-c", script, str(_free_port()), json.dumps(body),
                          *argv], cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["foreign"] == []
    chunks = got["chunks"]
    assert chunks and all(c["error_code"] == 0 for c in chunks), chunks

    backend, names = model_worker.load_backend(model_worker.parse_args(argv))
    try:
        want = list(backend.generate_stream(body))
    finally:
        backend.stop()
    assert names == ["llava-v1.5-tiny"] and type(backend.tokenizer).__name__ != "DebugTokenizer"
    assert len(chunks) == len(want) == body["max_new_tokens"]
    assert [c["text"] for c in chunks] == want
    assert want[-1].startswith(body["prompt"]) and len(want[-1]) > len(body["prompt"])


def test_worker_without_a_device_flag_needs_a_card(checkpoint):
    """``--device`` is ``cuda`` unless asked otherwise; with no card the
    worker stops with a message and never runs on the CPU instead."""
    path, _ = checkpoint
    out = subprocess.run([sys.executable, "-m", "llava_plus_torch.serve.model_worker",
                          "--model-path", str(path), "--no-register"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr


def test_worker_main_serves_with_speculation(checkpoint):
    """``--speculate 4 --spec-chunk 4``: the worker started as a user starts
    it streams the greedy text of the plain in-process backend."""
    path, _ = checkpoint
    argv = ["--model-path", str(path), "--device", "cpu", "--no-register", "--warmup", "0",
            "--max-slots", "2"]
    body = {"prompt": "USER: say it again and again and again ASSISTANT:",
            "temperature": 0.0, "max_new_tokens": 10}
    script = f"FOREIGN = {FOREIGN!r}\n" + WORKER_SCRIPT
    out = subprocess.run([sys.executable, "-c", script, str(_free_port()), json.dumps(body),
                          *argv, "--speculate", "4", "--spec-chunk", "4"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["foreign"] == []
    spec, _ = model_worker.load_backend(model_worker.parse_args(
        argv + ["--speculate", "4", "--spec-chunk", "4"]))
    plain, _ = model_worker.load_backend(model_worker.parse_args(argv))
    try:
        assert (spec.engine.speculate, spec.engine.spec_chunk) == (4, 4)
        want = list(plain.generate_stream(body))
        assert list(spec.generate_stream(body)) == want
        assert spec.engine.spec_steps > 0
    finally:
        spec.stop()
        plain.stop()
    assert [c["text"] for c in got["chunks"]] == want


@pytest.mark.parametrize("flags, item", [(["--w8a8"], 7), (["--tp", "2"], 10)])
def test_unported_worker_flags_exit_with_their_roadmap_item(checkpoint, flags, item):
    """Both flags of the JAX worker that once exited with their ROADMAP item
    (Queue 1 item ``item``) are ported: ``--w8a8`` reaches the engine, and
    ``--tp 2 --device cpu`` serves in a fresh interpreter over two gloo
    ranks (rank 0 spawns its follower, sends the checkpoint leaf by leaf,
    each rank quantizing whole and keeping its int8 slice), answering a
    request with the one-rank worker's greedy text."""
    path, png = checkpoint
    argv = ["--model-path", str(path), "--device", "cpu", "--no-register", "--warmup", "0"]
    if flags != ["--w8a8"]:
        argv.append("--load-8bit")
    if flags == ["--w8a8"]:
        backend, _ = model_worker.load_backend(model_worker.parse_args(argv + flags))
        try:
            assert backend.engine.w8a8 is True
        finally:
            backend.stop()
        return
    body = {"prompt": "USER: <image>\nwhat is shown here ASSISTANT:", "temperature": 0.0,
            "max_new_tokens": 6, "images": [base64.b64encode(png.read_bytes()).decode()]}
    script = f"FOREIGN = {FOREIGN!r}\n" + WORKER_SCRIPT
    out = subprocess.run([sys.executable, "-c", script, str(_free_port()), json.dumps(body),
                          *argv, *flags], cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["foreign"] == []
    plain, _ = model_worker.load_backend(model_worker.parse_args(argv))
    try:
        want = list(plain.generate_stream(body))
    finally:
        plain.stop()
    assert [c["text"] for c in got["chunks"]] == want and len(want) == 6


def test_worker_rope_scaling_and_echo(checkpoint):
    path, _ = checkpoint
    args = model_worker.parse_args(["--model-path", str(path), "--device", "cpu", "--warmup",
                                    "0", "--no-engine", "--rope-scaling", "dynamic:2.0"])
    backend, _ = model_worker.load_backend(args)
    assert (backend.cfg.text.rope_scaling_type, backend.cfg.text.rope_scaling_factor) == (
        "dynamic", 2.0)
    assert backend.generator is not None and backend.is_multimodal
    with pytest.raises(SystemExit, match="unsupported type"):
        model_worker.load_backend(argparse.Namespace(**{**vars(args),
                                                        "rope_scaling": "yarn:2"}))

    from llava_plus_tpu.serve.model_worker import EchoBackend as JaxEcho

    echo, names = model_worker.load_backend(model_worker.parse_args(["--echo"]))
    body = {"prompt": "hi", "stop": "ok"}
    assert names == ["echo"]
    assert list(echo.generate_stream(body)) == list(JaxEcho().generate_stream(body))


def test_cli_answers_like_the_generator(checkpoint):
    """``python -m llava_plus_torch.serve.cli`` with one question piped in:
    the answer is ``Generator``'s greedy text for the llava_v1 prompt."""
    path, png = checkpoint
    out = subprocess.run([sys.executable, "-m", "llava_plus_torch.serve.cli", "--model-path",
                          str(path), "--image-file", str(png), "--temperature", "0",
                          "--max-new-tokens", "8", "--device", "cpu"],
                         input="what is shown here\n", cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.rstrip().endswith("exit...")

    tok, params, cfg, proc, ctx = load_pretrained_model(str(path))
    assert cli.pick_conv_mode(path.name) == "llava_v1"
    conv = conv_templates["llava_v1"].copy()
    conv.append_message(conv.roles[0], "<image>\nwhat is shown here")
    conv.append_message(conv.roles[1], None)
    images = process_images([cli.load_image(str(png))], proc, cfg)
    gen = Generator(params, cfg, tok, proc, device="cpu", max_seq_len=ctx)
    want = list(gen.stream(conv.get_prompt(), images=images, max_new_tokens=8,
                           temperature=0.0, stop_strings=[conv.sep2]))[-1]
    assert want
    assert f"{conv.roles[1]}: {want}\n" in out.stdout


def test_cli_without_a_device_flag_needs_a_card(checkpoint):
    path, _ = checkpoint
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--model-path", str(path)])


@pytest.mark.parametrize("name, mode", [("llava-v1.5-7b", "llava_v1"),
                                        ("llava-llama-2-13b-chat", "llava_llama_2"),
                                        ("LLaVA-Lightning-MPT-7B-preview", "mpt"),
                                        ("llava-13b", "llava_v0")])
def test_conv_mode_matches_jax(name, mode):
    from llava_plus_tpu.serve.cli import pick_conv_mode

    assert cli.pick_conv_mode(name) == pick_conv_mode(name) == mode


def test_cli_image_loader_matches_jax(checkpoint):
    from llava_plus_tpu.serve.cli import load_image

    _, png = checkpoint
    np.testing.assert_array_equal(np.asarray(cli.load_image(str(png))),
                                  np.asarray(load_image(str(png))))
    assert cli.load_image(str(png)).mode == "RGB"


def test_worker_app_streams_every_admitted_request_at_once():
    """Each admitted stream waits for its next chunk in a thread of its own:
    24 streams that each wait for all the others (a barrier) all finish,
    though the loop's default executor has only cpu_count + 4 threads."""
    import asyncio
    import threading

    import requests
    from aiohttp import web

    n = 24

    class Rendezvous:
        is_multimodal = False
        barrier = threading.Barrier(n, timeout=30)

        def generate_stream(self, params):
            self.barrier.wait()
            yield params["prompt"] + " done"

    worker = model_worker.ModelWorker("http://127.0.0.1:9", "http://127.0.0.1:0", Rendezvous(),
                                      ["rendezvous"], limit_model_concurrency=n,
                                      no_register=True)
    port = _free_port()
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(model_worker.build_app(worker))
    started = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        started.set()
        loop.run_forever()

    server = threading.Thread(target=serve, daemon=True)
    server.start()
    assert started.wait(30)
    results = [None] * n

    def client(i):
        r = requests.post(f"http://127.0.0.1:{port}/worker_generate_stream",
                          json={"prompt": f"p{i}"}, stream=True, timeout=60)
        results[i] = list(model_worker.iter_chunks_requests(r))

    clients = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    try:
        for t in clients:
            t.start()
        for t in clients:
            t.join(60)
        assert not any(t.is_alive() for t in clients)
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        server.join(30)
    assert [r[-1] for r in results] == [{"text": f"p{i} done", "error_code": 0}
                                        for i in range(n)]
