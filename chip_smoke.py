"""Smoke run of the PyTorch port (``llava_plus_torch``) on one CUDA card.

Run from anywhere, on a machine with one NVIDIA Hopper card and nvcc:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build the CUDA kernels from ``llava_plus_torch/csrc``;
3. each kernel against its plain PyTorch version at the main path's shapes,
   both measured against an f64 ground truth, with CUDA-event timings: flash
   forward, decode attention (bf16 and int8 cache), and the int8 / int4
   weight-only matmuls at the 7B fused matrices (wqkv, w_down, lm_head) for
   1, 16 and 768 rows;
4. a narrow LLaMA (head dim 128, GQA) on the card against the same weights
   on the CPU plain path: 16 greedy tokens, and the logits of the prefill and
   of every decode step, with bf16 weights (bf16 and int8 KV) and with fused
   int8 and int4 weights;
5. LLaVA-1.5-7B at full width, random bf16 weights, behind the HTTP model
   worker on the single-stream path: an image request and three text
   requests, one of them short enough for a single 128-token prefill (and a
   repeat of the image request), with a bf16 and an int8 KV cache, checking
   every chunk and the kernels' launch counts;
6. the same model on the continuous-batching engine behind the HTTP worker,
   as the JAX worker serves by default: weights quantized in place to int8
   and fused, int8 KV cache, 16 slots, decode chunks of 4; 16 concurrent
   requests (8 image, 8 text) of 32 greedy tokens, with TTFT p50 and
   aggregate tokens/s; then int4 weights on a fresh backend (4 requests).
   Every chunk, every request's token count, batched admission, shared
   decode steps and every kernel's launch count are checked.

The script reaches the model, tokenizer, image processor and worker only
through ``llava_plus_torch`` and checks at the end that no JAX module was
imported. The line before the last is a JSON summary of the kernels; the
last line is the JSON result. Without a CUDA device it prints no result and
exits 1.
"""

import base64
import copy
import gc
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
INT8_REPLACES = "llava_plus_tpu/ops/quant_matmul.py:71"
INT4_REPLACES = "llava_plus_tpu/ops/quant_matmul.py:127"


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


# 7B matrices with fused weights (K x N) and the row counts the engine gives
# the quantized kernels: one decode row, 16 decode slots, one 768-token prefill.
QUANT_SHAPES = (("wqkv", 4096, 12288), ("w_down", 11008, 4096), ("lm_head", 4096, 32000))
QUANT_ROWS = (1, 16, 768)


def check_quant(bits, name, K, N, gen):
    """One weight, every row count: kernel and plain version against the f64
    product of the dequantized weight, errors relative to the largest output."""
    import torch
    from llava_plus_torch.ops import quant
    from llava_plus_torch.ops import quant_matmul as qm

    dev = "cuda"
    w = torch.randn(K, N, generator=gen, device=dev).mul_(0.02).bfloat16()
    qw = quant.quantize_array(w) if bits == 8 else quant.quantize_array_int4(w)
    del w
    q = qw[quant.QKEY if bits == 8 else quant.Q4KEY]
    s = qw[quant.SKEY]
    w64 = quant.dequantize_array(qw, torch.float64)
    kernel_fn = qm.matmul_int8 if bits == 8 else qm.matmul_int4
    plain_fn = qm.matmul_int8_reference if bits == 8 else qm.matmul_int4_reference
    out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
    nbytes = q.numel() + s.numel() * 4
    rows = {}
    for R in QUANT_ROWS:
        x = torch.randn(R, K, generator=gen, device=dev).bfloat16()
        truth = x.double() @ w64
        top = truth.abs().max().item()
        out = kernel_fn(x, q, s, out_dtype=out_dtype)
        p_out = plain_fn(x, q, s, out_dtype=out_dtype)
        torch.cuda.synchronize()
        if out.shape != (R, N) or out.dtype != out_dtype:
            raise AssertionError(f"quant_matmul[int{bits}] {name}: {out.shape} {out.dtype}")
        k_err = (out.double() - truth).abs().max().item() / top
        r_err = (p_out.double() - truth).abs().max().item() / top
        ms = time_ms(lambda: kernel_fn(x, q, s, out_dtype=out_dtype))
        plain_ms = time_ms(lambda: plain_fn(x, q, s, out_dtype=out_dtype))
        ok = within(k_err, r_err)
        rate = f", {nbytes / ms / 1e6:.0f} GB/s of weights" if R <= 16 else (
            f", {2 * R * K * N / ms / 1e9:.1f} TFLOP/s")
        log("kernels", f"quant_matmul int{bits} {name} R={R} K={K} N={N} -> "
                       f"{str(out_dtype)[6:]}: rel err {k_err:.3e} (plain {r_err:.3e}), "
                       f"{ms:.4f} ms{rate} vs plain {plain_ms:.4f} ms "
                       f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"quant_matmul[int{bits}] {name} R={R} disagrees with "
                                 "its plain version")
        rows[R] = {"max_abs_err": k_err, "ms": ms, "plain_ms": plain_ms}
    return rows


def phase_quant_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    stats = {}
    for bits in (8, 4):
        per = {name: check_quant(bits, name, K, N, gen) for name, K, N in QUANT_SHAPES}
        # the line reports the engine's decode call (wqkv at 16 slots) and the
        # largest relative error over every shape and row count
        stats[f"quant_matmul[int{bits}]"] = dict(
            per["wqkv"][16], shape="wqkv K=4096 N=12288 R=16",
            max_abs_err=max(r["max_abs_err"] for rows in per.values() for r in rows.values()))
    return stats


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
            "decode_attention[int8]": dec_int8, **phase_quant_kernels()}


# ---------------------------------------------------------------------------
# 4. the kernels inside a narrow model, card against CPU
# ---------------------------------------------------------------------------

def phase_narrow_model():
    import torch
    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.generate import Generator
    from llava_plus_torch.models import llama, llava as llava_model
    from llava_plus_torch.models.configs import ClipVisionConfig, LlamaConfig, LlavaConfig
    from llava_plus_torch.ops import quant
    from llava_plus_torch.ops import quant_matmul as qm
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

    # Quantized weights (fused as the worker fuses them; this GQA model keeps
    # wq/wk/wv apart, so 6 products a layer and the head): the same quantized
    # tree on both sides. The CPU's plain product rounds each dequantized
    # weight to bf16 where the int8 kernel multiplies the exact int8 values
    # and applies the f32 scale after the sum, so the bound is 3% there.
    variants = [("bf16 weights, bf16 KV", None, torch.bfloat16, tol),
                ("bf16 weights, int8 KV", None, torch.int8, tol),
                ("int8 weights, bf16 KV", 8, torch.bfloat16, 3e-2),
                ("int4 weights, bf16 KV", 4, torch.bfloat16, 3e-2)]
    for name, bits, cache_dtype, bound in variants:
        cpu_tree = cpu_params
        if bits:
            cpu_tree = quant.quantize_llava_params(copy.deepcopy(cpu_params), bits=bits,
                                                   fuse=True)
        counter = {None: None, 8: qm.matmul_int8, 4: qm.matmul_int4}[bits]
        ids, logits = {}, {}
        for dev, params in (("cpu", cpu_tree), ("cuda", _tree_to(cpu_tree, "cuda"))):
            g = Generator(params, cfg, tok, device=dev, max_seq_len=1024,
                          cache_dtype=cache_dtype)
            f0, d0 = flash_attention.launches, decode_attention.launches
            q0 = counter.launches if counter else 0
            for _ in g.stream(prompt, max_new_tokens=new):
                pass
            ids[dev] = list(g._last_output_ids)
            if dev == "cuda":
                steps = len(ids[dev]) - 1 if len(ids[dev]) == new else len(ids[dev])
                want_q = (steps + 1) * (6 * L + 1) if counter else 0
                if (flash_attention.launches - f0 != L
                        or decode_attention.launches - d0 != steps * L
                        or (counter.launches - q0 if counter else 0) != want_q):
                    raise AssertionError(f"narrow model ({name}) did not run through the kernels")
            logits[dev], T = step_logits(g, params, dev, ids["cpu"])
        ratios = [(c - g).abs().max().item() / c.abs().max().item()
                  for c, g in zip(logits["cpu"], logits["cuda"])]
        margins = [c.topk(2).values[0] for c in logits["cpu"]]
        min_margin = min((m[0] - m[1]).item() / m[0].abs().item() for m in margins)
        log("narrow", f"{name}, T={T}: greedy tokens equal={ids['cuda'] == ids['cpu']} "
                      f"({len(ids['cpu'])} tokens); logits max diff / max |logit|: "
                      f"prefill {ratios[0]:.3e}, decode steps up to {max(ratios[1:]):.3e} "
                      f"(bound {bound}); smallest top-2 margin {min_margin:.3f} of the top logit")
        if ids["cuda"] != ids["cpu"]:
            raise AssertionError(f"greedy tokens differ: {ids['cuda']} vs {ids['cpu']}")
        if max(ratios) > bound:
            raise AssertionError(f"logits differ beyond the tolerance ({name})")


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

    def __init__(self, app, threads=8):
        import asyncio
        from concurrent.futures import ThreadPoolExecutor

        from aiohttp import web

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.loop = asyncio.new_event_loop()
        # the worker reads each stream's next chunk in the loop's default
        # executor: one thread per concurrent request
        self.loop.set_default_executor(ThreadPoolExecutor(max_workers=threads))
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


def _init_7b(dev):
    """LLaVA-1.5-7B at full width and depth, random bf16 weights from seed 0."""
    import torch
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_15_7B

    t0 = time.perf_counter()
    params = llava_model.init_params(LLAVA_15_7B, torch.Generator(device=dev).manual_seed(0),
                                     dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log("7b", f"random bf16 weights on {dev}: {n_params / 1e9:.3f} B parameters in "
              f"{time.perf_counter() - t0:.1f} s")
    return params


def phase_full_slice(smi, params, dev):
    """The single-stream path (``use_engine=False``) at full width."""
    import requests
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.serve.model_worker import (
        ModelWorker, TorchBackend, build_app, iter_chunks_requests,
    )

    cfg = LLAVA_15_7B
    L = cfg.text.num_hidden_layers
    new_tokens = 32
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
                               use_engine=False, kv_int8=kv_int8, max_seq_len=2048)
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


# ---------------------------------------------------------------------------
# 6. the engine at full width behind the HTTP worker, quantized weights
# ---------------------------------------------------------------------------

def _engine_bodies(rng, size, n_image, n_text, new_tokens):
    """Image prompts of 762 fused tokens (576 image slots + BOS + newline +
    184 words, one 768 bucket) and text prompts of 61..301 fused tokens."""
    bodies = []
    for j in range(n_image):
        prompt = "<image>\n" + " ".join(f"img{j}word{i}" for i in range(184))
        bodies.append({"prompt": prompt, "images": [_png_b64(rng, size)]})
    for j, n in enumerate(np.linspace(60, 300, n_text).round().astype(int)):
        bodies.append({"prompt": " ".join(f"txt{j}word{i}" for i in range(n))})
    for b in bodies:
        b.update(temperature=0.0, max_new_tokens=new_tokens)
    return bodies


def _post_all(url, bodies):
    """POST every body at once; per request (chunks, send time, chunk stamps)."""
    import requests
    from llava_plus_torch.serve.model_worker import iter_chunks_requests

    results = [None] * len(bodies)

    def run(i):
        t_send = time.perf_counter()
        resp = requests.post(url, json=bodies[i], stream=True, timeout=600)
        chunks, stamps = [], []
        for chunk in iter_chunks_requests(resp):
            stamps.append(time.perf_counter())
            chunks.append(chunk)
        results[i] = (chunks, t_send, stamps)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if any(r is None for r in results):
        raise AssertionError("a request did not complete")
    return results


def serve_engine(smi, params, quantize, n_image, n_text):
    """``TorchBackend(use_engine=True)`` with fused ``quantize`` weights and
    an int8 KV cache, 16 slots, decode chunks of 4, warmed at 768 tokens;
    every request sent at once. Checks every chunk, each request's full
    token count, batched admission, decode steps shared by several slots,
    and every kernel's launch count against the engine's own counts of
    prefill dispatches and decode steps. Returns the launch counts."""
    import torch
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.serve.model_worker import ModelWorker, TorchBackend, build_app

    cfg = LLAVA_15_7B
    L, new_tokens = cfg.text.num_hidden_layers, 32
    qmm = qm.matmul_int8 if quantize == "int8" else qm.matmul_int4
    tok = DebugTokenizer(vocab_size=cfg.text.vocab_size)
    # Random weights give eos no meaning; without it every request runs its
    # full 32 tokens and the launch counts below are exact.
    tok.eos_token_id = -1
    gc.collect()  # an earlier backend's engine threads hold it in a cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = TorchBackend(params, cfg, tok, ClipImageProcessor(), device="cuda",
                           use_engine=True, max_slots=16, decode_chunk=4, quantize=quantize,
                           kv_int8=True, max_seq_len=2048, warmup_len=768)
    del params  # quantized in place into the backend's tree
    engine = backend.engine
    log("engine", f"{quantize} weights, fused; int8 KV, 16 slots x 2048, decode chunks of "
                  f"4: built and warmed in {time.perf_counter() - t0:.1f} s (warmup "
                  f"{engine.warmup_s:.1f} s)")
    bodies = _engine_bodies(np.random.default_rng(1), cfg.vision.image_size, n_image, n_text,
                            new_tokens)
    worker = ModelWorker("http://127.0.0.1:9", "http://127.0.0.1:0", backend,
                         ["llava-1.5-7b-random"], limit_model_concurrency=len(bodies),
                         no_register=True, heartbeats=False)
    server = _Server(build_app(worker), threads=len(bodies) + 4)
    url = f"http://127.0.0.1:{server.port}/worker_generate_stream"
    try:
        flash_attention.launches = decode_attention.launches = qmm.launches = 0
        e0 = (engine.prefill_dispatches, engine.prefill_requests, engine.decode_steps,
              engine.multi_slot_steps)
        t_start = time.perf_counter()
        results = _post_all(url, bodies)
        launches = {"flash": flash_attention.launches, "decode": decode_attention.launches,
                    "quant": qmm.launches}
        dp, dr, ds, dm = (b - a for a, b in zip(e0, (
            engine.prefill_dispatches, engine.prefill_requests, engine.decode_steps,
            engine.multi_slot_steps)))
    finally:
        server.stop()
        worker.stop()
        backend.stop()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for body, (chunks, _, _) in zip(bodies, results):
        bad = [c for c in chunks if c["error_code"] != 0]
        if bad:
            raise AssertionError(f"worker error: {bad[0]['text']}")
        if len(chunks) != new_tokens or not chunks[-1]["text"].startswith(body["prompt"]):
            raise AssertionError(f"a request ended with {len(chunks)} of {new_tokens} tokens")
    want = {"flash": L * dp, "decode": L * ds, "quant": (4 * L + 1) * (dp + ds)}
    log("engine", f"{quantize}: {len(bodies)} requests in {dp} prefill dispatches, "
                  f"{ds} decode steps ({dm} with more than one active slot); launches "
                  f"{launches} (want {want})")
    if dr != len(bodies) or dp >= dr or dm <= 0:
        raise AssertionError("no batched admission or no shared decode steps")
    if launches != want:
        raise AssertionError(f"launch counts {launches} differ from {want}")
    ttfts = sorted(stamps[0] - t_send for _, t_send, stamps in results)
    t_end = max(stamps[-1] for _, _, stamps in results)
    rate = len(bodies) * new_tokens / (t_end - t_start)
    # each request's own stream after its first token
    per = [(len(st) - 1) / (st[-1] - st[0]) for _, _, st in results]
    log("engine", f"{quantize}: TTFT p50 {np.median(ttfts) * 1e3:.1f} ms (min "
                  f"{ttfts[0] * 1e3:.1f}, max {ttfts[-1] * 1e3:.1f}); {rate:.1f} tokens/s "
                  f"aggregate in {t_end - t_start:.2f} s, per request {np.mean(per):.1f} "
                  f"tokens/s after the first, over {len(bodies)} concurrent requests of "
                  f"{new_tokens} tokens "
                  f"({n_image} image, {n_text} text); peak device memory {peak:.2f} GiB; "
                  f"card {smi}")
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
    dev = "cuda:0"
    params = _init_7b(dev)
    single = phase_full_slice(smi, params, dev)
    # phase 6 quantizes these weights in place; int4 starts from fresh ones
    int8 = serve_engine(smi, params, "int8", n_image=8, n_text=8)
    del params
    int4 = serve_engine(smi, _init_7b(dev), "int4", n_image=2, n_text=2)

    entries = []
    for name, source, replaces, count in (
        ("flash_fwd", "llava_plus_torch/csrc/flash_fwd.cu", FLASH_REPLACES,
         single["flash"] + int8["flash"] + int4["flash"]),
        ("decode_attention[bf16]", "llava_plus_torch/csrc/decode_attention.cu",
         DECODE_REPLACES, single["bf16"]),
        ("decode_attention[int8]", "llava_plus_torch/csrc/decode_attention.cu",
         DECODE_REPLACES, single["int8"] + int8["decode"] + int4["decode"]),
        ("quant_matmul[int8]", "llava_plus_torch/csrc/quant_matmul.cu", INT8_REPLACES,
         int8["quant"]),
        ("quant_matmul[int4]", "llava_plus_torch/csrc/quant_matmul.cu", INT4_REPLACES,
         int4["quant"]),
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
