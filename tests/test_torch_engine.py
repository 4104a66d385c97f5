"""The port's continuous-batching engine against its own single-stream
``Generator`` and the JAX package's ``BatchedEngine``, on the CPU with the
tiny config in f32 (mirrors ``tests/test_engine.py``): greedy text is
compared exactly; quantized engines too, since both packages run the same
quantized values through f32 products. Also the engine-backed
``TorchBackend`` over HTTP in a JAX-free subprocess, held to the JAX
backend's request handling."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.ops import quant as jax_quant
from llava_plus_tpu.serve import engine as jax_engine
from llava_plus_torch.generate import Generator
from llava_plus_torch.models.configs import LlavaConfig, tiny_llava_config
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.serve.engine import BatchedEngine, Request, counter_uniform

from .test_generate import CharTokenizer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CFG = tiny_llava_config()
JCFG = jax_tiny_config()  # the same config, the JAX package's own
S = 96


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _text(gen, prompt, n, **kw):
    out = list(gen.stream(prompt, max_new_tokens=n, **kw))
    return out[-1] if out else ""


@pytest.fixture(scope="module")
def setup():
    jp = jax_llava.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = from_numpy(_np(jp), "cpu")
    tok = CharTokenizer()
    engine = BatchedEngine(tp, CFG, tok, max_slots=4, max_seq_len=S, prefill_bucket=32,
                           cache_dtype=torch.float32)
    gen = Generator(tp, CFG, tok, device="cpu", max_seq_len=S, prefill_bucket=32,
                    cache_dtype=torch.float32)
    jeng = jax_engine.BatchedEngine(jp, JCFG, tok, max_slots=4, max_seq_len=S,
                                    prefill_bucket=32, cache_dtype=jnp.float32)
    yield engine, gen, jeng
    engine.stop()
    jeng.stop()


def test_engine_matches_generator_and_jax_engine_greedy(setup):
    engine, gen, jeng = setup
    for prompt in ["hello", "xyz", "abab"]:
        want = jeng.generate(jax_engine.Request(prompt=prompt, max_new_tokens=6))
        assert _text(gen, prompt, 6) == want
        assert engine.generate(Request(prompt=prompt, max_new_tokens=6)) == want


def test_engine_concurrent_requests(setup):
    engine, gen, _ = setup
    prompts = ["aa", "bb", "cc", "dd", "ee", "ff"]  # more than the 4 slots
    want = {p: _text(gen, p, 5) for p in prompts}
    got = {}
    threads = [threading.Thread(target=lambda p=p: got.__setitem__(
        p, engine.generate(Request(prompt=p, max_new_tokens=5)))) for p in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert got == want


def test_engine_batched_prefill_matches_single(setup):
    """Four requests admitted as ONE batched prefill emit the first token
    each would get alone (no contamination through the shared [N, S1] cache),
    then decode on as usual."""
    engine, gen, _ = setup
    prompts = ["hello", "xyz", "abab", "qq"]
    first = [_text(gen, p, 1) for p in prompts]
    full = [_text(gen, p, 4) for p in prompts]
    reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts]
    preps = engine._prepare(reqs)  # deterministic: bypass the queue
    for req, want in zip(reqs, first):
        assert req._chunks.get(timeout=60) == want
    for prep in preps:
        if prep is not None:
            engine._ready.put(prep)
    assert [engine.drain(r) for r in reqs] == full


def test_engine_streaming_cumulative(setup):
    engine, _, _ = setup
    chunks = list(engine.stream(Request(prompt="stream me", max_new_tokens=5)))
    assert len(chunks) == 5  # one cumulative chunk per token
    for a, b in zip(chunks, chunks[1:]):
        assert b.startswith(a)


def test_engine_stop_string(setup):
    engine, gen, jeng = setup
    full = _text(gen, "qq", 6)
    stop = full[2]
    want = jeng.generate(jax_engine.Request(prompt="qq", max_new_tokens=6,
                                            stop_strings=[stop]))
    got = engine.generate(Request(prompt="qq", max_new_tokens=6, stop_strings=[stop]))
    assert got == want == full.split(stop)[0]


def test_engine_multimodal_request(setup):
    engine, gen, jeng = setup
    img = np.random.default_rng(1).normal(size=(1, 28, 28, 3)).astype(np.float32)
    want = jeng.generate(jax_engine.Request(prompt="<image>\nwhat?", images=img,
                                            max_new_tokens=4))
    assert _text(gen, "<image>\nwhat?", 4, images=img) == want
    assert engine.generate(Request(prompt="<image>\nwhat?", images=img,
                                   max_new_tokens=4)) == want


def test_engine_chunk1_matches_chunk4(setup):
    engine, _, _ = setup
    e1 = BatchedEngine(engine.params, CFG, engine.tokenizer, max_slots=2, max_seq_len=S,
                       prefill_bucket=32, cache_dtype=torch.float32, decode_chunk=1)
    try:
        for prompt in ["hello", "zq"]:
            assert (e1.generate(Request(prompt=prompt, max_new_tokens=7))
                    == engine.generate(Request(prompt=prompt, max_new_tokens=7)))
    finally:
        e1.stop()


def test_engine_int8_kv_cache_matches_generator(setup):
    """An int8 KV cache in the engine gives the single-stream generator's
    int8-cache text exactly (same per-(token, head) quantization; the
    generator's int8 path is held to the JAX package in test_torch_llava)."""
    engine, _, _ = setup
    g8 = Generator(engine.params, CFG, engine.tokenizer, device="cpu", max_seq_len=S,
                   prefill_bucket=32, cache_dtype=torch.int8)
    e8 = BatchedEngine(engine.params, CFG, engine.tokenizer, max_slots=2, max_seq_len=S,
                       prefill_bucket=32, cache_dtype=torch.int8)
    try:
        for prompt in ["hello", "abc def"]:
            assert (e8.generate(Request(prompt=prompt, max_new_tokens=8))
                    == _text(g8, prompt, 8))
    finally:
        e8.stop()


def test_engine_budget_clamp_matches_generator(setup):
    """Asking for more tokens than the window holds emits exactly as many as
    the single-stream generator (and the JAX engine)."""
    engine, gen, jeng = setup
    for prompt in ["hello", "ab"]:
        want = _text(gen, prompt, 500)
        assert jeng.generate(jax_engine.Request(prompt=prompt, max_new_tokens=500)) == want
        assert engine.generate(Request(prompt=prompt, max_new_tokens=500)) == want


def test_engine_stop_while_prefill_in_flight(setup):
    """stop() arriving while a prefill batch is queued but not fetched still
    ends its requests (their readers would otherwise wait for the queue
    timeout)."""
    engine, _, _ = setup
    eng = BatchedEngine(engine.params, CFG, engine.tokenizer, max_slots=2, max_seq_len=S,
                        prefill_bucket=32, cache_dtype=torch.float32)
    dispatch = eng._dispatch_prefill

    def dispatch_then_stop(reqs):
        inflight = dispatch(reqs)
        eng._stop.set()  # stop() lands right after the prefill is queued
        return inflight

    eng._dispatch_prefill = dispatch_then_stop
    req = eng.submit(Request(prompt="hello", max_new_tokens=4))
    assert req._done.wait(timeout=60)
    eng.stop()
    assert not eng._prefill_thread.is_alive() and not eng._thread.is_alive()
    assert eng.drain(req) == ""  # ended without a token


def test_sampled_request_same_alone_and_among_others(setup):
    """A sampled request's tokens depend only on its seed and positions: the
    same text alone and sharing decode steps with other requests (which also
    changes how its decode is chunked)."""
    engine, _, _ = setup
    sampled = dict(prompt="xyz xyz", max_new_tokens=10, temperature=0.8, top_p=0.95, seed=7)
    alone = engine.generate(Request(**sampled))
    others = [Request(prompt=p, max_new_tokens=10) for p in ("aa", "bb")]
    others.append(Request(prompt="xyz xyz", max_new_tokens=10, temperature=0.8, seed=8))
    reqs = [engine.submit(r) for r in others[:2]] + [engine.submit(Request(**sampled))]
    reqs.append(engine.submit(others[2]))
    texts = [engine.drain(r) for r in reqs]
    assert texts[2] == alone and alone
    assert texts[3] != alone  # another seed, another draw


@pytest.mark.parametrize("int8", [False, True])
def test_one_token_cache_write_matches_jax(int8):
    """The decode step's sync-free cache write: rows at positions >= max_len
    (idle engine slots, requests past their budget) leave the cache as it
    was, as the JAX package's dropping scatter does; the others land at
    their positions, with their segment ids."""
    from llava_plus_tpu.models import llama as jax_llama
    from llava_plus_torch.models import llama

    rng = np.random.default_rng(3)
    L, B, Sc, H, D = 2, 3, 8, 2, 16
    new = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    positions = np.array([[2], [Sc], [Sc - 1]], np.int32)
    seg_ids = np.array([[1], [0], [1]], np.int32)
    vals = rng.normal(size=(L, B, Sc, H, D)).astype(np.float32)
    scales = rng.uniform(0.1, 1, size=(L, B, Sc, H, 1)).astype(np.float32)
    if int8:
        vals = rng.integers(-127, 128, size=vals.shape).astype(np.int8)
    want_v, want_s = jax_llama._cache_write(
        jnp.asarray(vals), jnp.asarray(scales) if int8 else None, jnp.asarray(new), 1,
        jnp.arange(B)[:, None], jnp.asarray(positions))
    cache = llama.KVCache(k=torch.from_numpy(vals.copy()), v=torch.from_numpy(vals.copy()),
                          seg=torch.ones(B, Sc, dtype=torch.int32) * 5,
                          k_scale=torch.from_numpy(scales.copy()) if int8 else None,
                          v_scale=torch.from_numpy(scales.copy()) if int8 else None)
    sel = llama._write_slots(cache, torch.from_numpy(positions), torch.from_numpy(seg_ids))
    llama._cache_write(cache.k, cache.k_scale, torch.from_numpy(new), 1, sel)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(want_v))
    if int8:
        np.testing.assert_array_equal(cache.k_scale.numpy(), np.asarray(want_s))
    seg = np.full((B, Sc), 5, np.int32)
    seg[0, 2], seg[2, Sc - 1] = 1, 1
    np.testing.assert_array_equal(cache.seg.numpy(), seg)


def test_counter_uniform_rows_are_independent():
    seeds = torch.tensor([7, 1, 7, 123456789012])
    pos = torch.tensor([5, 5, 6, 5])
    u = counter_uniform(seeds, pos, 1000)
    assert torch.equal(counter_uniform(seeds[:1], pos[:1], 1000), u[:1])
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_engine_matches_jax_engine(bits):
    """Fused quantized weights (MHA: wqkv and w_gateup fuse), the JAX tree
    carried across: the engines' greedy text is the same."""
    cfg = dataclasses.replace(JCFG, text=dataclasses.replace(JCFG.text, num_key_value_heads=4))
    tcfg = LlavaConfig.from_json(cfg.to_json())  # the port's own copy of cfg
    jp = jax_quant.quantize_llava_params(
        jax_llava.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32),
        bits=bits, fuse=True)
    tp = from_numpy(_np(jp), "cpu")
    assert "wqkv" in tp["language_model"]["layers"]["attn"]
    tok = CharTokenizer()
    kw = dict(max_slots=2, max_seq_len=S, prefill_bucket=32)
    jeng = jax_engine.BatchedEngine(jp, cfg, tok, cache_dtype=jnp.float32, **kw)
    eng = BatchedEngine(tp, tcfg, tok, cache_dtype=torch.float32, **kw)
    try:
        for prompt in ["hello", "quantized"]:
            want = jeng.generate(jax_engine.Request(prompt=prompt, max_new_tokens=8))
            assert eng.generate(Request(prompt=prompt, max_new_tokens=8)) == want
    finally:
        eng.stop()
        jeng.stop()


def test_unported_engine_options_raise(setup):
    engine, _, _ = setup
    for kw in (dict(w8a8=True), dict(mesh=object())):
        with pytest.raises(NotImplementedError):
            BatchedEngine(engine.params, CFG, engine.tokenizer, **kw)
    # both backbones serve (tests/test_torch_mpt.py); another one raises
    other = dataclasses.replace(CFG, language_model_type="gpt2")
    with pytest.raises(ValueError):
        BatchedEngine(engine.params, other, engine.tokenizer)


HTTP_SCRIPT = r"""
import asyncio, json, pickle, socket, sys, threading
import requests
from aiohttp import web
from llava_plus_torch.data import ClipImageProcessor
from llava_plus_torch.kernels import build
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.serve.model_worker import (
    ModelWorker, TorchBackend, build_app, iter_chunks_requests,
)

class CharTokenizer:  # tests/test_generate.py's, without its JAX imports
    bos_token_id, eos_token_id = 1, 2
    def __call__(self, text):
        return type("Enc", (), {"input_ids": [1] + [min(ord(c) + 3, 500) for c in text]})()
    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i - 3) for i in ids if i > 2)

def no_build(*args, **kwargs):
    raise AssertionError("a kernel build (nvcc) was attempted")

build.build = no_build
params_path, cases_path, ctx = sys.argv[1], sys.argv[2], int(sys.argv[3])
with open(params_path, "rb") as f:
    params = from_numpy(pickle.load(f), "cpu")
cfg = tiny_llava_config()
size = cfg.vision.image_size
backend = TorchBackend(params, cfg, CharTokenizer(),
                       ClipImageProcessor(shortest_edge=size, crop_size=size),
                       device="cpu", max_seq_len=ctx, stream_interval=2)
assert backend.engine is not None
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
with open(cases_path) as f:
    cases = json.load(f)
results = {}

def post(name, body):
    r = requests.post(f"http://127.0.0.1:{port}/worker_generate_stream", json=body,
                      stream=True, timeout=120)
    results[name] = list(iter_chunks_requests(r))

for item in cases.items():  # one at a time: prefill batch shapes as on the JAX side
    post(*item)
metrics = requests.post(f"http://127.0.0.1:{port}/worker_metrics", timeout=10).json()
backend.stop()
worker.stop()
loop.call_soon_threadsafe(loop.stop)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "triton"))
assert not bad, bad
assert build._lib is None
print(json.dumps({"results": results, "metrics": metrics}))
"""


def _png_b64(seed, size):
    import base64
    import io

    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, size=(size, size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_engine_backend_over_http_matches_jax_backend(tmp_path):
    """Requests to the engine-backed TorchBackend, served in a subprocess
    that must load no JAX module, give the chunks the JAX
    backend's ``generate_stream`` gives: an image request, a text request, a
    near-zero temperature (greedy), a stop string, the token-budget clamp,
    the "Exceeds max token length" reply and the image-count error."""
    from llava_plus_tpu.data.image_processing import ClipImageProcessor
    from llava_plus_tpu.serve.model_worker import JaxBackend

    ctx = 256  # the engine's default 256-token prefill bucket fits the window
    jp = jax_llava.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tok = CharTokenizer()
    size = CFG.vision.image_size
    jb = object.__new__(JaxBackend)  # a loaded backend, without the checkpoint
    jb.tokenizer, jb.cfg, jb.context_len, jb.is_multimodal = tok, JCFG, ctx, True
    jb.image_processor = ClipImageProcessor(shortest_edge=size, crop_size=size)
    jb.stream_interval, jb.generator = 2, None
    jb.engine = jax_engine.BatchedEngine(jp, JCFG, tok, max_slots=8, max_seq_len=ctx,
                                         cache_dtype=jnp.bfloat16)
    png = _png_b64(0, size)
    text = {"prompt": "tell me about the sea", "temperature": 0.0, "max_new_tokens": 12}
    cases = {
        "image": {"prompt": "<image>\nwhat is shown here", "images": [png],
                  "temperature": 0.0, "max_new_tokens": 8},
        "text": text,
        "near_zero_temperature": dict(text, temperature=0.0005),
        "clamp": {"prompt": "x" * 240, "temperature": 0.0, "max_new_tokens": 1024},
        "exceeds": {"prompt": "y" * 300, "temperature": 0.0},
        "image_count": {"prompt": "no marker here", "images": [png]},
    }
    want = {}
    try:
        for name, body in cases.items():
            try:
                want[name] = [t for t in jb.generate_stream(body)]
            except ValueError as e:
                want[name] = e
        generated = want["text"][-1][len(text["prompt"]):]
        stop = generated[len(generated) // 2]
        cases["stop"] = dict(text, stop=stop)
        want["stop"] = list(jb.generate_stream(cases["stop"]))
    finally:
        jb.engine.stop()
    assert len(want["clamp"][-1]) - 240 == ctx - 241  # 15 tokens, one char each
    assert want["exceeds"][-1].endswith("Exceeds max token length. Please start a new "
                                        "conversation, thanks.")

    params_path, cases_path = tmp_path / "params.pkl", tmp_path / "cases.json"
    with open(params_path, "wb") as f:
        pickle.dump(_np(jp), f)
    cases_path.write_text(json.dumps(cases))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", HTTP_SCRIPT, str(params_path),
                          str(cases_path), str(ctx)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    got = report["results"]
    for name, chunks in want.items():
        if isinstance(chunks, ValueError):
            assert len(got[name]) == 1 and got[name][0]["error_code"] == 1
            assert str(chunks) in got[name][0]["text"]
            continue
        assert all(c["error_code"] == 0 for c in got[name]), got[name]
        assert [c["text"] for c in got[name]] == chunks, name
    assert stop not in got["stop"][-1]["text"][len(text["prompt"]):]
    assert report["metrics"]["engine_max_slots"] == 8
    assert report["metrics"]["engine_prefill_requests"] >= 5
