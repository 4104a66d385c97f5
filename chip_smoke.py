"""Smoke run of the PyTorch port (``llava_plus_torch``) on one CUDA card.

Run from anywhere, on a machine with one NVIDIA Hopper card and nvcc:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build the CUDA kernels from ``llava_plus_torch/csrc``;
3. each kernel against its plain PyTorch version at the main path's shapes,
   both measured against an f64 ground truth, with CUDA-event timings;
4. a narrow LLaMA (head dim 128, GQA) on the card against the same weights
   on the CPU plain path: 16 greedy tokens and the prefill logits;
5. LLaVA-1.5-7B at full width, random bf16 weights, behind the HTTP model
   worker: an image request and three text requests, one of them short
   enough for a single 128-token prefill (and a repeat of the image
   request), with a bf16 and an int8 KV cache, checking every chunk and the
   kernels' launch counts.

The script reaches the model, tokenizer, image processor and worker only
through ``llava_plus_torch`` and checks at the end that no JAX module was
imported. The line before the last is a JSON summary of the kernels; the
last line is the JSON result. Without a CUDA device it prints no result and
exits 1.
"""

import base64
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

FLASH_REPLACES = "llava_plus_tpu/ops/flash_attention.py:46"
DECODE_REPLACES = "llava_plus_tpu/ops/decode_attention.py:41"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def within(kernel_err, ref_err):
    return kernel_err <= max(2.5 * ref_err, 2e-3)


# ---------------------------------------------------------------------------
# 1-2. environment and build
# ---------------------------------------------------------------------------

def phase_env():
    import torch
    from llava_plus_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log("env", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
               f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log("env", f"nvcc {nvcc}")
    return smi


def phase_build():
    from llava_plus_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build(extra_flags=["-Xptxas", "-v"])
    build.lib()
    log("build", f"{os.path.relpath(path, HERE)} in {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(tag, B, T, H, Hkv, pad_tail, gen):
    import torch
    from llava_plus_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference,
    )

    dev, D = "cuda", 128
    q = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
    seg = torch.ones(B, T, dtype=torch.int32, device=dev)
    seg[-1, T - pad_tail:] = 0
    scale = D ** -0.5

    out, lse = flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
    p_out, p_lse = flash_attention_reference(q, k, v, seg, seg, causal=True, sm_scale=scale)
    t_out, t_lse = flash_attention_reference(q.double(), k.double(), v.double(), seg, seg,
                                             causal=True, sm_scale=scale)
    torch.cuda.synchronize()
    rows = seg > 0
    lse_rows = rows[:, None, :].expand(B, H, T)
    k_err = (out.double() - t_out)[rows].abs().max().item()
    r_err = (p_out.double() - t_out)[rows].abs().max().item()
    k_lse = (lse.double() - t_lse)[lse_rows].abs().max().item()
    r_lse = (p_lse.double() - t_lse)[lse_rows].abs().max().item()
    ms = time_ms(lambda: flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, seg, seg, causal=True,
                                                         sm_scale=scale))
    ok = within(k_err, r_err) and within(k_lse, r_lse)
    log("kernels", f"flash_fwd {tag} B={B} T={T} H={H} Hkv={Hkv} D={D} pad={pad_tail}: "
                   f"out err {k_err:.3e} (plain {r_err:.3e}), lse err {k_lse:.3e} "
                   f"(plain {r_lse:.3e}), {ms:.4f} ms vs plain {plain_ms:.4f} ms "
                   f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_fwd {tag} disagrees with its plain version")
    return {"max_abs_err": k_err, "ms": ms, "plain_ms": plain_ms}


def check_decode(tag, B, S, H, Hkv, gen, rng):
    import torch
    from llava_plus_torch.models.llama import quantize_kv
    from llava_plus_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference,
    )

    dev, D = "cuda", 128
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).bfloat16()
    # a layer slice of a stacked [L, B, S, Hkv, D] cache, as the model passes it
    k_all = torch.randn(2, B, S, Hkv, D, generator=gen, device=dev).bfloat16()
    v_all = torch.randn(2, B, S, Hkv, D, generator=gen, device=dev).bfloat16()
    fills = rng.integers(1, S + 1, size=B)
    fills[0], fills[1 % B] = S, 1
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for b, f in enumerate(fills):
        seg[b, :f] = 1
    q_pos = torch.as_tensor(fills - 1, dtype=torch.int32, device=dev)
    ks = vs = None
    if tag == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k_all), quantize_kv(v_all)
        k_all, v_all = kq, vq
        ks, vs = ks[1], vs[1]
    kc, vc = k_all[1], v_all[1]
    scale = D ** -0.5

    def kernel():
        return decode_attention(q, kc, vc, seg, q_pos, ks, vs)

    def plain():
        return decode_attention_reference(q, kc, vc, seg, q_pos, ks, vs, sm_scale=scale)

    dbl = lambda x: None if x is None else x.double()
    truth = decode_attention_reference(q.double(), kc, vc, seg, q_pos, dbl(ks), dbl(vs),
                                       sm_scale=scale)
    out, p_out = kernel(), plain()
    torch.cuda.synchronize()
    k_err = (out.double() - truth).abs().max().item()
    r_err = (p_out.double() - truth).abs().max().item()
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    # the kernel reads the slots up to each query's position, k and v (+ scales)
    rows = int(fills.sum()) * Hkv
    nbytes = 2 * rows * (D * kc.element_size() + (0 if ks is None else 4))
    ok = within(k_err, r_err)
    log("kernels", f"decode_attention {tag} B={B} S={S} H={H} Hkv={Hkv} D={D} "
                   f"(mean fill {fills.mean():.0f}): "
                   f"err {k_err:.3e} (plain {r_err:.3e}), {ms:.4f} ms "
                   f"({nbytes / ms / 1e6:.1f} GB/s of cache read) vs plain {plain_ms:.4f} ms "
                   f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode_attention {tag} disagrees with its plain version")
    return {"max_abs_err": k_err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    flash_mha = check_flash("MHA", B=2, T=768, H=32, Hkv=32, pad_tail=100, gen=gen)
    flash_gqa = check_flash("GQA", B=2, T=768, H=32, Hkv=8, pad_tail=100, gen=gen)
    dec_bf16 = check_decode("bf16", B=16, S=1024, H=32, Hkv=32, gen=gen, rng=rng)
    dec_int8 = check_decode("int8", B=16, S=1024, H=32, Hkv=32, gen=gen, rng=rng)
    flash = dict(flash_mha, max_abs_err=max(flash_mha["max_abs_err"],
                                            flash_gqa["max_abs_err"]))
    return {"flash_fwd": flash, "decode_attention[bf16]": dec_bf16,
            "decode_attention[int8]": dec_int8}


# ---------------------------------------------------------------------------
# 4. the kernels inside a narrow model, card against CPU
# ---------------------------------------------------------------------------

def phase_narrow_model():
    import torch
    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.generate import Generator
    from llava_plus_torch.models import llama, llava as llava_model
    from llava_plus_torch.models.configs import ClipVisionConfig, LlamaConfig, LlavaConfig
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention

    cfg = LlavaConfig(
        text=LlamaConfig(vocab_size=32000, hidden_size=512, intermediate_size=1024,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2),
        vision=ClipVisionConfig(hidden_size=64, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=2,
                                image_size=28, patch_size=14),
        mm_hidden_size=64, max_sequence_length=1024,
    )
    cpu_params = llava_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    # With plain random weights the top two of 32000 logits lie ~1e-2 apart,
    # which is also the size of the bf16 difference between the card's and
    # the CPU's matrix products (measured with the reference attention on
    # both sides): free-running greedy tokens would split on a near tie with
    # or without the kernels. So the head is a fixed permutation of the
    # (doubled) embeddings: each step's argmax then wins by a wide margin
    # (about a third of the top logit), and the kernels' numbers are checked
    # through the logits at the prefill and at every decode step. Swapping k
    # and v in the decode call, or shifting its kv heads, moves those logits
    # by about half of the top logit on the CPU, far past the bound below.
    lm = cpu_params["language_model"]
    lm["embed_tokens"].mul_(2.0)
    perm = torch.randperm(cfg.text.vocab_size, generator=torch.Generator().manual_seed(1))
    lm["lm_head"] = lm["embed_tokens"][perm].T.contiguous()
    gpu_params = _tree_to(cpu_params, "cuda")
    tok = DebugTokenizer(vocab_size=cfg.text.vocab_size)
    prompt = " ".join(f"token{i}" for i in range(320))
    L, new = cfg.text.num_hidden_layers, 16
    # bf16 on both sides; on the CPU the reference attention and the plain
    # decode. Measured card-vs-CPU logit differences of random bf16 models are
    # ~0.5-0.9% of the largest logit, so 2% of it is the bound.
    tol = 2e-2

    def step_logits(g, params, dev, tokens):
        """Prefill logits, then those of each decode step fed ``tokens``."""
        batch, plan = g.prepare_batch([prompt])
        cache = llama.KVCache.create(cfg.text, 1, 1024, g.cache_dtype, device=dev)
        seg = torch.ones(1, 1, dtype=torch.int32, device=dev)
        pos = int(plan.lengths[0])
        with torch.inference_mode():
            out = [g._prefill(cache, batch).float().cpu()]
            for i, t in enumerate(tokens[:-1]):
                logits, _ = llava_model.decode_step(
                    params, cfg, torch.tensor([[t]], device=dev),
                    torch.tensor([[pos + i]], dtype=torch.int32, device=dev), seg, cache)
                out.append(logits[:, 0].float().cpu())
        return out, int(batch.tokens.shape[1])

    for cache_dtype in (torch.bfloat16, torch.int8):
        name = "int8" if cache_dtype == torch.int8 else "bf16"
        ids, logits = {}, {}
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            g = Generator(params, cfg, tok, device=dev, max_seq_len=1024,
                          cache_dtype=cache_dtype)
            f0, d0 = flash_attention.launches, decode_attention.launches
            for _ in g.stream(prompt, max_new_tokens=new):
                pass
            ids[dev] = list(g._last_output_ids)
            if dev == "cuda":
                steps = len(ids[dev]) - 1 if len(ids[dev]) == new else len(ids[dev])
                if (flash_attention.launches - f0 != L
                        or decode_attention.launches - d0 != steps * L):
                    raise AssertionError("narrow model did not run through the kernels")
            logits[dev], T = step_logits(g, params, dev, ids["cpu"])
        ratios = [(c - g).abs().max().item() / c.abs().max().item()
                  for c, g in zip(logits["cpu"], logits["cuda"])]
        margins = [c.topk(2).values[0] for c in logits["cpu"]]
        min_margin = min((m[0] - m[1]).item() / m[0].abs().item() for m in margins)
        log("narrow", f"{name} KV, T={T}: greedy tokens equal={ids['cuda'] == ids['cpu']} "
                      f"({len(ids['cpu'])} tokens); logits max diff / max |logit|: "
                      f"prefill {ratios[0]:.3e}, decode steps up to {max(ratios[1:]):.3e} "
                      f"(bound {tol}); smallest top-2 margin {min_margin:.3f} of the top logit")
        if ids["cuda"] != ids["cpu"]:
            raise AssertionError(f"greedy tokens differ: {ids['cuda']} vs {ids['cpu']}")
        if max(ratios) > tol:
            raise AssertionError("logits differ beyond the bf16 tolerance")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# 5. the slice at full width behind the HTTP worker
# ---------------------------------------------------------------------------

class _Server:
    """The worker's aiohttp app on its own event-loop thread."""

    def __init__(self, app):
        import asyncio

        from aiohttp import web

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(app)
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.runner.setup())
            site = web.TCPSite(self.runner, "127.0.0.1", self.port)
            self.loop.run_until_complete(site.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not started.wait(30):
            raise RuntimeError("worker app did not start")

    def stop(self):
        import asyncio

        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


def _png_b64(rng, size):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def phase_full_slice(smi):
    import requests
    import torch
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.serve.model_worker import (
        ModelWorker, TorchBackend, build_app, iter_chunks_requests,
    )

    cfg = LLAVA_15_7B
    dev = "cuda:0"
    L = cfg.text.num_hidden_layers
    new_tokens = 32
    t0 = time.perf_counter()
    params = llava_model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log("7b", f"random bf16 weights on {dev}: {n_params / 1e9:.3f} B parameters in "
              f"{time.perf_counter() - t0:.1f} s")
    tok = DebugTokenizer(vocab_size=cfg.text.vocab_size)
    rng = np.random.default_rng(0)
    image = _png_b64(rng, cfg.vision.image_size)
    # 576 image slots + BOS + newline + 184 words fuse to 762 tokens -> T = 768;
    # the short text request fuses to 61 tokens, one 128-token prefill bucket
    requests_ = [
        ("image", "<image>\n" + " ".join(f"word{i}" for i in range(184)), [image]),
        ("text-short", " ".join(f"gamma{i}" for i in range(60)), None),
        ("text-a", " ".join(f"alpha{i}" for i in range(200)), None),
        ("text-b", " ".join(f"beta{i}" for i in range(300)), None),
        ("image-repeat", "<image>\n" + " ".join(f"word{i}" for i in range(184)), [image]),
    ]
    launches = {"flash": 0, "bf16": 0, "int8": 0}
    flash_attention.launches = 0
    decode_attention.launches = 0
    for kv_int8 in (False, True):
        kv = "int8" if kv_int8 else "bf16"
        backend = TorchBackend(params, cfg, tok, ClipImageProcessor(), device=dev,
                               kv_int8=kv_int8, max_seq_len=2048)
        worker = ModelWorker("http://127.0.0.1:9", "http://127.0.0.1:0", backend,
                             ["llava-1.5-7b-random"], no_register=True, heartbeats=False)
        server = _Server(build_app(worker))
        url = f"http://127.0.0.1:{server.port}/worker_generate_stream"
        ttfts, rates, ids_by_name = {}, [], {}
        d_start = decode_attention.launches
        try:
            for name, prompt, images in requests_:
                f0, d0 = flash_attention.launches, decode_attention.launches
                body = {"prompt": prompt, "temperature": 0.0, "max_new_tokens": new_tokens}
                if images:
                    body["images"] = images
                t_send = time.perf_counter()
                resp = requests.post(url, json=body, stream=True, timeout=600)
                stamps, last = [], None
                for chunk in iter_chunks_requests(resp):
                    stamps.append(time.perf_counter())
                    if chunk["error_code"] != 0:
                        raise AssertionError(f"{name}: worker error: {chunk['text']}")
                    last = chunk["text"]
                ids = list(backend.generator._last_output_ids)
                ids_by_name[name] = ids
                if not stamps or not last.startswith(prompt):
                    raise AssertionError(f"{name}: no well-formed chunks")
                steps = len(ids) - 1 if len(ids) == new_tokens else len(ids)
                df, dd = flash_attention.launches - f0, decode_attention.launches - d0
                if df != L or dd != steps * L:
                    raise AssertionError(
                        f"{name}: flash launches {df} (want {L}), decode launches {dd} "
                        f"(want {steps * L})")
                ttft = stamps[0] - t_send
                rate = (len(stamps) - 1) / (stamps[-1] - stamps[0]) if len(stamps) > 1 else 0.0
                ttfts[name] = ttft
                rates.append(rate)
                log("7b", f"{kv} KV {name}: prompt {backend.generator._last_prompt_len} "
                          f"fused tokens, {len(ids)} new tokens, {len(stamps)} chunks, "
                          f"TTFT {ttft * 1e3:.1f} ms, decode {rate:.2f} tok/s, "
                          f"flash +{df}, decode +{dd}")
        finally:
            server.stop()
            worker.stop()
        if ids_by_name["image-repeat"] != ids_by_name["image"]:
            raise AssertionError(f"{kv}: a repeated request gave other tokens")
        launches[kv] = decode_attention.launches - d_start
        ttft_ms = ", ".join(f"{n} {t * 1e3:.1f} ms" for n, t in ttfts.items())
        log("7b", f"{kv} KV: TTFT {ttft_ms}; decode {np.mean(rates):.2f} tok/s mean "
                  f"over {len(rates)} requests; card {smi}")
        del backend, worker
    launches["flash"] = flash_attention.launches
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "llava_plus_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    smi = phase_env()
    phase_build()
    stats = phase_kernels()
    phase_narrow_model()
    launches = phase_full_slice(smi)

    entries = []
    for name, source, replaces, count in (
        ("flash_fwd", "llava_plus_torch/csrc/flash_fwd.cu", FLASH_REPLACES,
         launches["flash"]),
        ("decode_attention[bf16]", "llava_plus_torch/csrc/decode_attention.cu",
         DECODE_REPLACES, launches["bf16"]),
        ("decode_attention[int8]", "llava_plus_torch/csrc/decode_attention.cu",
         DECODE_REPLACES, launches["int8"]),
    ):
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": count, **stats[name]})
    jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if jax_modules:
        raise AssertionError(f"the port pulled in JAX: {jax_modules[:5]}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
