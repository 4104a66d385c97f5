"""The LLaVA-Plus topology on the port's stack against the JAX package's,
over real HTTP on the CPU: controller, model worker, fake tool workers and
web server, each side built from its own package's modules.

(a) The JAX tests' scripted-backend scenarios (``test_orchestrator.py``,
    ``test_web_server.py``, ``test_web_server_plus.py``): the full tool loop,
    segment then inpaint across turns, a fresh session with no mask,
    incremental events, the sketch mask, the SEEM reference image, a plain
    chat and the page's small endpoints; both stacks give equal event
    streams and send equal tool calls.
(b) The slice as a whole: one tiny LLaMA tree with a planted tool-call chain
    (``llava_plus_torch.tools.planted``) behind a loaded ``JaxBackend`` on
    the JAX stack, and the same tree behind ``TorchBackend(device="cpu",
    paged=True)`` on the port's: ``/api/chat`` with an image turn and a
    follow-up gives equal events, in JAX's order, with greedy texts equal.
(c) The port's entry points in fresh interpreters (``python -m``): the
    controller, the fake tool worker, the web server with ``--llava-plus``
    and the model worker on a tiny planted checkpoint with ``--device cpu``;
    one tool turn goes through them, and no process loads a module of JAX
    or of the JAX package. Every entry point's ``--help`` runs so too.
"""

import asyncio
import base64
import importlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import requests
import torch
from PIL import Image

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
FOREIGN = ("jax", "jaxlib", "triton", "llava_plus_tpu")
PKGS = ("llava_plus_tpu", "llava_plus_torch")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class AppThread:
    """An aiohttp app on its own event-loop thread; ``stop`` runs the app's
    cleanup (the model worker's executor) and ends the loop."""

    def __init__(self, app, port):
        from aiohttp import web

        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(app)
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.runner.setup())
            self.loop.run_until_complete(web.TCPSite(self.runner, "127.0.0.1", port).start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(10)

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class Stack:
    """Controller, one model worker, one fake tool worker per tool name (each
    recording the calls it serves) and a web server (``--llava-plus``), plus
    a plain web server, all from package ``pkg``."""

    def __init__(self, pkg, backend, model_name, tools):
        ctrl, mw = _mod(pkg, "serve.controller"), _mod(pkg, "serve.model_worker")
        base = _mod(pkg, "serve.tool_workers.base")
        fake = _mod(pkg, "serve.tool_workers.fake_tool_worker")
        web = _mod(pkg, "serve.web_server")
        self.calls = []
        calls = self.calls

        class Recording(fake.FakeToolWorker):
            def generate(self, params):
                calls.append((self.model_names[0], dict(params)))
                return super().generate(params)

        self.controller = ctrl.Controller("shortest_queue", start_expiration_thread=False)
        cport = _free_port()
        self.controller_url = f"http://127.0.0.1:{cport}"
        self.apps = [AppThread(ctrl.build_app(self.controller), cport)]
        lport = _free_port()
        self.worker = mw.ModelWorker(self.controller_url, f"http://127.0.0.1:{lport}", backend,
                                     [model_name], heartbeats=False)
        self.apps.append(AppThread(mw.build_app(self.worker), lport))
        self.tools = []
        for name in tools:
            tport = _free_port()
            tool = Recording(self.controller_url, f"http://127.0.0.1:{tport}", [name],
                             heartbeats=False)
            self.tools.append(tool)
            self.apps.append(AppThread(base.build_tool_app(tool), tport))
        self.web, self.plain_web = _free_port(), _free_port()
        self.apps.append(AppThread(web.build_app(self.controller_url, llava_plus=True),
                                   self.web))
        self.apps.append(AppThread(web.build_app(self.controller_url), self.plain_web))
        self.orchestrator = _mod(pkg, "serve.orchestrator").ToolOrchestrator(self.controller_url)
        self.pkg = pkg

    def chat(self, payload, plain=False):
        port = self.plain_web if plain else self.web
        r = requests.post(f"http://127.0.0.1:{port}/api/chat", json=payload, stream=True,
                          timeout=120)
        return list(_mod("llava_plus_torch", "serve.protocol").iter_chunks_requests(r))

    def stop(self):
        for app in self.apps:
            app.stop()
        self.worker.stop()
        for tool in self.tools:
            tool.stop()
        self.controller.stop()


# -- (a) scripted scenarios --------------------------------------------------

class Scripted:
    """Round 2 (a summarize prompt): a final answer. Round 1: grounding_dino
    for 'find', inpainting for 'remove', seem for 'reference', a plain
    answer for 'plain', else sam. Streams word by word; records prompts."""

    is_multimodal = True
    context_len = 2048

    def __init__(self, pkg):
        self.serialize = _mod(pkg, "conversation").serialize_tool_turn
        self.prompts = []

    def generate_stream(self, params):
        prompt = params["prompt"]
        self.prompts.append(prompt)
        tail = prompt[-600:]
        if "Please summarize the model outputs" in tail:
            reply = "Done: summarized the tool output."
        elif "plain" in tail:
            reply = "just a plain answer"
        else:
            api, kw, why = next((a, k, w) for key, a, k, w in (
                ("find", "grounding_dino", {"caption": "a cat"}, "locate the object."),
                ("remove", "inpainting", {"prompt": "background"}, "inpaint it."),
                ("reference", "seem", {}, "segment like the reference."),
                ("", "sam", {}, "segment the object first.")) if key in tail)
            reply = self.serialize(thoughts=f"I need to {why}",
                                   actions=[{"API_name": api, "API_params": kw}],
                                   value="Working on it.")
        words = reply.split(" ")
        for i in range(len(words)):
            yield prompt + " " + " ".join(words[:i + 1])


TOOLS = ["grounding_dino", "sam", "inpainting", "seem"]


@pytest.fixture(scope="module")
def stacks():
    made = {pkg: Stack(pkg, Scripted(pkg), "llava-plus-7b", TOOLS) for pkg in PKGS}
    yield made
    for s in made.values():
        s.stop()


def _img_b64(seed=0, w=100, h=80):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _sketch_b64(box):
    mask = np.zeros((80, 100, 4), np.uint8)
    if box:
        y0, y1, x0, x1 = box
        mask[y0:y1, x0:x1] = 255
    buf = io.BytesIO()
    Image.fromarray(mask, mode="RGBA").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _final(chunks):
    return [c for c in chunks if "text" in c][-1]["text"]


def _scenario(stack, name):
    """One scenario on one stack: what a client sees, the tool calls the
    tool workers served and the prompts the model saw."""
    stack.calls.clear()
    stack.worker.backend.prompts.clear()
    img = _img_b64()
    base = {"model": "llava-plus-7b", "history": [], "image": img, "temperature": 0.0}
    out = []
    if name == "full_tool_loop":
        conv_mod = _mod(stack.pkg, "conversation")
        conv = conv_mod.conv_templates["v1"].copy()
        pil = Image.open(io.BytesIO(base64.b64decode(img))).convert("RGB")
        events = []
        for ev in stack.orchestrator.stream_turn(conv, "llava-plus-7b", "find the cat",
                                                 image=pil, max_new_tokens=64, stop="</s>"):
            if "final" in ev:
                r = ev["final"]
                ann = r.annotated_image
                ev = {"final": [r.text, r.round1_text, r.api_name, r.tool_response, r.error,
                                None if ann is None else (ann.size, ann.tobytes().hex())]}
            events.append(ev)
        out += [events, [list(m) for m in conv.messages]]
        result = stack.orchestrator.run_turn(conv_mod.conv_templates["v1"].copy(),
                                             "llava-plus-7b", "find the cat", image=pil)
        assert result.api_name == "grounding_dino" and result.annotated_image.size == (100, 80)
        out.append(result.text)
    elif name == "segment_then_inpaint":
        sid = "sess-segment-inpaint"
        c1 = stack.chat(dict(base, text="segment the cat", session_id=sid))
        c2 = stack.chat(dict(base, text="now remove it", session_id=sid,
                             history=[["segment the cat", _final(c1)]]))
        out += [c1, c2]
        inpaint = [p for n, p in stack.calls if n == "inpainting"]
        assert inpaint and isinstance(inpaint[-1]["mask"], dict)
    elif name == "fresh_session_no_mask":
        out.append(stack.chat(dict(base, text="remove it please", session_id="sess-fresh")))
        assert [p["mask"] for n, p in stack.calls if n == "inpainting"] == [None]
    elif name == "incremental_events":
        chunks = stack.chat(dict(base, text="segment the dog", session_id="sess-events"))
        kinds = [next(iter(c)) for c in chunks]
        assert kinds.index("prog") < kinds.index("status") < kinds.index("tool") < \
            kinds.index("image") and kinds.count("text") > 4, kinds
        out.append(chunks)
    elif name in ("sketch_mask", "empty_sketch_mask"):
        box = (20, 40, 25, 75) if name == "sketch_mask" else None
        out.append(stack.chat(dict(base, text="segment this", session_id=f"sess-{name}",
                                   sketch_mask=_sketch_b64(box))))
        has_box = any("Input box: [0.25, 0.25, 0.75, 0.5]" in p
                      for p in stack.worker.backend.prompts)
        assert has_box == (box is not None)
    elif name == "seem_reference":
        out.append(stack.chat(dict(base, text="segment like the reference",
                                   session_id="sess-seem", reference_image="REFIMG64",
                                   reference_mask="REFMASK64")))
        seem = [p for n, p in stack.calls if n == "seem"]
        assert seem and (seem[0]["refimg"], seem[0]["refmask"]) == ("REFIMG64", "REFMASK64")
    elif name == "plain_chat":
        out.append(stack.chat({"model": "llava-plus-7b", "text": "a plain question",
                               "history": [["hi", "hello"]], "image": img}, plain=True))
        out.append(stack.chat({"model": "llava-plus-7b", "text": "plain, no image",
                               "history": []}, plain=True))
    elif name == "endpoints":
        url = f"http://127.0.0.1:{stack.web}"
        page = requests.get(url + "/", timeout=10).text
        assert "LLaVA-Plus" in page and 'id="regen"' in page
        out.append(requests.post(url + "/api/models", timeout=10).json())
        out.append(requests.post(url + "/api/examples", timeout=10).json())
        out.append(requests.post(url + "/api/reset", json={"session_id": "x"}, timeout=10).json())
        out.append(requests.post(url + "/api/vote", json={"type": "upvote"}, timeout=10).json())
        out.append(requests.post(stack.controller_url + "/list_models", timeout=10).json())
    out.append(stack.calls)
    out.append(stack.worker.backend.prompts)
    return json.loads(json.dumps(out, sort_keys=True))


SCENARIOS = ["full_tool_loop", "segment_then_inpaint", "fresh_session_no_mask",
             "incremental_events", "sketch_mask", "empty_sketch_mask", "seem_reference",
             "plain_chat", "endpoints"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scripted_scenario_streams_equal(stacks, name):
    want = _scenario(stacks["llava_plus_tpu"], name)
    got = _scenario(stacks["llava_plus_torch"], name)
    assert got == want


# -- (b) the planted tiny model on both stacks ---------------------------------

def _planted_tree():
    """A tiny LLaVA tree (the JAX package's init, PRNGKey 0, f32) with the
    canned tool reply planted, as torch tensors, and its tokenizer."""
    import jax
    import jax.numpy as jnp

    from llava_plus_tpu.models import llava as jax_llava
    from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny
    from llava_plus_torch.models.convert import from_numpy
    from llava_plus_torch.models.configs import tiny_llava_config
    from llava_plus_torch.tools import planted

    cfg = tiny_llava_config()
    jp = jax_llava.init_params(jax_tiny(), jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    reply = planted.canned_reply()
    tok = planted.tool_tokenizer(cfg.text.vocab_size, reply,
                                 [" find the cat what is next"])
    ids = planted.chain_ids(tok, reply)
    planted.plant_chain(tp, ids)
    return tp, cfg, tok, reply, ids


def _jax_backend(tp, tok, ctx):
    import jax.numpy as jnp

    from llava_plus_tpu.data.image_processing import ClipImageProcessor
    from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny
    from llava_plus_tpu.serve import engine as jax_engine
    from llava_plus_tpu.serve.model_worker import JaxBackend
    from llava_plus_torch.models.convert import to_numpy

    jcfg = jax_tiny()
    jp = to_numpy(tp)
    size = jcfg.vision.image_size
    jb = object.__new__(JaxBackend)  # a loaded backend, without the checkpoint
    jb.tokenizer, jb.cfg, jb.context_len, jb.is_multimodal = tok, jcfg, ctx, True
    jb.image_processor = ClipImageProcessor(shortest_edge=size, crop_size=size)
    jb.stream_interval, jb.generator = 1, None
    jb.engine = jax_engine.BatchedEngine(jp, jcfg, tok, max_slots=4, max_seq_len=ctx,
                                         cache_dtype=jnp.bfloat16)
    return jb


def _events(chunks):
    """The kinds of a /api/chat stream in order, with runs of text chunks
    merged: JAX's order is text, prog, status, tool, text, image."""
    kinds = []
    for c in chunks:
        k = next(iter(c))
        if not kinds or kinds[-1] != k or k != "text":
            kinds.append(k)
    return kinds


def test_planted_model_on_both_stacks_gives_equal_tool_turns():
    from llava_plus_torch.data import ClipImageProcessor
    from llava_plus_torch.serve.model_worker import TorchBackend
    from llava_plus_torch.utils.demo_assets import demo_image_b64

    tp, cfg, tok, reply, ids = _planted_tree()
    ctx = 512
    size = cfg.vision.image_size
    jb = _jax_backend(tp, tok, ctx)
    backend = TorchBackend(tp, cfg, tok, ClipImageProcessor(shortest_edge=size, crop_size=size),
                           device="cpu", use_engine=True, max_slots=4, paged=True,
                           max_seq_len=ctx, warmup_len=0)
    made = {}
    try:
        for pkg, b in (("llava_plus_tpu", jb), ("llava_plus_torch", backend)):
            made[pkg] = Stack(pkg, b, "llava-plus-tiny", ["grounding_dino"])
        image = demo_image_b64("cat")
        # long enough that each round's prompt fills a 128-token page
        question = "find the cat " + " ".join(f"w{i}" for i in range(100))
        streams = {}
        for pkg, stack in made.items():
            first = {"model": "llava-plus-tiny", "text": question, "history": [],
                     "image": image, "temperature": 0.0, "max_new_tokens": 32,
                     "session_id": "s1"}
            c1 = stack.chat(first)
            c2 = stack.chat(dict(first, text="what is next",
                                 history=[["<image>\n" + question, _final(c1)]]))
            streams[pkg] = (c1, c2, stack.calls)
        engine = backend.engine
        hits = engine.prefix_hit_tokens
    finally:
        for s in made.values():
            s.stop()
        backend.stop()
        jb.engine.stop()
    assert streams["llava_plus_torch"] == streams["llava_plus_tpu"]
    c1, c2, calls = streams["llava_plus_torch"]
    for chunks in (c1, c2):
        assert _events(chunks) == ["text", "prog", "status", "tool", "text", "image"], chunks
        texts = [c["text"] for c in chunks if "text" in c]
        prog = next(c["prog"] for c in chunks if "prog" in c)
        assert prog == reply.strip() and texts[-1] == reply.strip()
        # every streamed update is one more token of the chain
        n = len(ids) - 2
        assert texts[:n] == [tok.decode(ids[1:i + 2]).strip() for i in range(n)]
        tool = next(c["tool"] for c in chunks if "tool" in c)
        assert tool["api_name"] == "grounding_dino" and tool["response"]["phrases"] == ["object"]
        png = Image.open(io.BytesIO(base64.b64decode(next(c["image"] for c in chunks
                                                          if "image" in c))))
        assert png.size == (336, 336)
    assert [name for name, _ in calls] == ["grounding_dino"] * 2
    assert hits > 0    # round 2 and the follow-up reuse pooled pages


# -- (c) fresh interpreters -----------------------------------------------------

WRAPPER = r"""
import json, runpy, sys
out, module = sys.argv[1], sys.argv[2]
sys.argv = [module] + sys.argv[3:]
try:
    from llava_plus_torch.kernels import build

    def no_build(*args, **kwargs):
        raise AssertionError("a kernel build (nvcc) was attempted")

    build.build = no_build
    runpy.run_module(module, run_name="__main__", alter_sys=True)
except SystemExit as e:
    if e.code not in (0, None):
        raise
finally:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    with open(out, "w") as f:
        json.dump(bad, f)
"""


def _env():
    """The caller's environment with the repository as the only extra path:
    the processes run in a directory of their own, where their logs go."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def _spawn(tmp_path, module, *args):
    out = tmp_path / f"{module.rsplit('.', 1)[-1]}.modules.json"
    log = open(tmp_path / f"{module.rsplit('.', 1)[-1]}.log", "w")
    proc = subprocess.Popen([sys.executable, "-c", f"FOREIGN = {FOREIGN!r}\n" + WRAPPER,
                             str(out), module, *args], cwd=tmp_path, env=_env(),
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, out, log


def _wait(url, procs, deadline_s=180):
    deadline = time.time() + deadline_s
    while True:
        try:
            return requests.post(url, timeout=5)
        except requests.ConnectionError:
            dead = [p.args[3] for p in procs if p.poll() is not None]
            if dead or time.time() > deadline:
                raise AssertionError(f"{url} did not answer (exited: {dead})")
            time.sleep(0.2)


def test_port_entry_points_serve_a_tool_turn_without_jax(tmp_path):
    from llava_plus_torch.train import checkpoint as ckpt

    tp, cfg, tok, reply, _ = _planted_tree()
    path = ckpt.export_hf_llava(tp, cfg, tmp_path / "llava-plus-tiny", tok)
    c, t, w, m = (_free_port() for _ in range(4))
    ctrl = f"http://127.0.0.1:{c}"
    procs = []
    try:
        procs.append(_spawn(tmp_path, "llava_plus_torch.serve.controller",
                            "--host", "127.0.0.1", "--port", str(c)))
        _wait(ctrl + "/list_models", [p for p, _, _ in procs])
        procs.append(_spawn(tmp_path, "llava_plus_torch.serve.tool_workers.fake_tool_worker",
                            "--host", "127.0.0.1", "--port", str(t), "--controller-address",
                            ctrl, "--worker-address", f"http://127.0.0.1:{t}",
                            "--model-names", "grounding_dino"))
        procs.append(_spawn(tmp_path, "llava_plus_torch.serve.model_worker",
                            "--host", "127.0.0.1", "--port", str(m), "--controller-address",
                            ctrl, "--worker-address", f"http://127.0.0.1:{m}",
                            "--model-path", str(path), "--device", "cpu", "--paged",
                            "--max-seq-len", "256", "--max-slots", "4", "--warmup", "0"))
        procs.append(_spawn(tmp_path, "llava_plus_torch.serve.web_server", "--host",
                            "127.0.0.1", "--port", str(w), "--controller-url", ctrl,
                            "--llava-plus"))
        deadline = time.time() + 180
        while sorted(_wait(ctrl + "/list_models", [p for p, _, _ in procs]).json()["models"]) \
                != ["grounding_dino", "llava-plus-tiny"]:
            assert time.time() < deadline, "the workers did not register"
            time.sleep(0.2)
        _wait(f"http://127.0.0.1:{w}/api/models", [p for p, _, _ in procs])
        from llava_plus_torch.utils.demo_assets import demo_image_b64

        r = requests.post(f"http://127.0.0.1:{w}/api/chat", json={
            "model": "llava-plus-tiny", "text": "find the cat", "history": [],
            "image": demo_image_b64("cat"), "temperature": 0.0, "max_new_tokens": 32},
            stream=True, timeout=120)
        from llava_plus_torch.serve.protocol import iter_chunks_requests

        chunks = list(iter_chunks_requests(r))
        status = requests.post(ctrl + "/worker_get_status", timeout=30).json()
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        codes = []
        for p, _, log in procs:
            try:
                codes.append(p.wait(60))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait(30))
            log.close()
    logs = {p.args[3]: Path(log.name).read_text()[-2000:] for p, _, log in procs}
    assert codes == [0] * 4, (codes, logs)
    assert _events(chunks) == ["text", "prog", "status", "tool", "text", "image"], chunks
    assert next(c["prog"] for c in chunks if "prog" in c) == reply.strip()
    assert status["queue_length"] == 0 and sorted(status["model_names"]) == [
        "grounding_dino", "llava-plus-tiny"]
    for _, out, _ in procs:
        assert json.loads(out.read_text()) == [], out.name


ENTRY_POINTS = [
    "serve.controller", "serve.register_worker", "serve.test_message", "serve.web_server",
    "serve.tool_workers.fake_tool_worker", "serve.tool_workers.test_message",
    "tools.generate_grounding_data", "tools.planted",
] + [f"serve.tool_workers.{n}" for n in (
    "blip2_worker", "blip2grounding_worker", "clip_retrieval_worker", "grounded_sam_worker",
    "grounding_dino_worker", "inpainting_worker", "instructpix2pix_worker", "ocr_worker",
    "openseed_controlnet_worker", "ram_grounding_worker", "ram_worker", "sam_worker",
    "seem_worker", "semantic_sam_worker", "stablediffusion_worker")]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_help_without_jax(name, tmp_path):
    """``python -m llava_plus_torch.<name> --help`` in a fresh interpreter:
    exits 0 with a usage line, loading nothing of JAX or the JAX package."""
    out = tmp_path / "modules.json"
    proc = subprocess.run([sys.executable, "-c", f"FOREIGN = {FOREIGN!r}\n" + WRAPPER, str(out),
                           f"llava_plus_torch.{name}", "--help"], cwd=tmp_path, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert proc.stdout.startswith("usage:"), proc.stdout[:200]
    assert json.loads(out.read_text()) == []
