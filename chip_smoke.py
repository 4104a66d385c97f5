"""Smoke run of the PyTorch port (``llava_plus_torch``) on one CUDA card.

Run from anywhere, on a machine with one NVIDIA Hopper card and nvcc:

    python3 chip_smoke.py
    python3 chip_smoke.py --device-times [ROOT]   # phases 1, 2 and 15 only
                                                  # (and the int8, int4,
                                                  # native int4, decode1 and
                                                  # general rows through
                                                  # their wrappers), for the
                                                  # package under ROOT

Phases (each prints its own lines; any failure raises and exits non-zero):

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build the CUDA kernels from ``llava_plus_torch/csrc``;
3. each kernel against its plain PyTorch version at the main path's shapes,
   both measured against an f64 ground truth (the flash kernels launched
   twice, bit for bit the same), with CUDA-event timings: flash
   forward, decode attention (bf16 and int8 cache), the int8 / int4
   weight-only matmuls at the 7B fused matrices (wqkv, w_down, lm_head) and
   MPT-7B's (out_proj, up_proj, down_proj) for 1, 16, 64, 768 and 3,072
   rows and on both sides of each one's decode / prefill cut (int4 also at
   QLoRA's 8,192), each row launched twice, bit for bit the same, beside the
   bf16 ``torch.matmul`` yardstick, the native int4 matmul (the int4 tools'
   kernel) at their five shapes and one whose N is not a multiple of 128,
   for 1, 16, 64, 768 and 3,072 rows and both sides of its cut, each row
   launched twice, bit for bit the same, and the paged
   kernels at 16 slots of 16 pages (decode1 also over pages of 32 with a
   full and a 1-token slot, and at the paged engine's 32 pages of 128, plain
   and ALiBi; the general kernel also at a 7B engine's width, 8-token chunks
   over 32 pages, plain and ALiBi; every paged row launched twice, bit for
   bit the same); and
   the ALiBi variants (MPT) of the flash forward, both flash backward
   kernels (T = 2048, MPT-7B's 32 slopes, MHA and 32 heads over one kv
   head, and a non-causal call), the dense decode and both paged kernels;
   and the dense decode kernel for a group wider than 8 (32 heads over one
   kv head, bf16 and int8 caches, with and without slopes), and its cache
   chunks at the engine's shapes (batch 1 over 2048 slots; 16 slots of 2048
   filled 1-900, one at fill 1 and one whose visible slots all have segment
   id 0; MHA and G = 32), every decode row launched twice, bit for bit the
   same; the MHA backward on the draw where the dQ kernel that rounded dS to
   bf16 failed; the flash forward's edges (T = 704, where the last 128-row tile lies half past T,
   with a row packed as 3 segments; the training shape T = 2048) and a
   backward row at T = 1984 (MQA with slopes: the head split and the ragged
   kv tile); the dense decode kernel at the speculative verify chunks (2, 5
   and 8 query tokens a row at 16 slots of 2048, bf16 and int8, MHA with and
   without ALiBi, GQA at 8 tokens; the library call for bf16 is sdpa with a
   boolean mask), and the int8 and int4 matmuls on wqkv and w_down also at
   a 16-slot verify step's 80 and 128 rows;
4. a narrow LLaMA (head dim 128, GQA) on the card against the same weights
   on the CPU plain path: 16 greedy tokens, and the logits of the prefill and
   of every decode step, with bf16 weights (bf16 and int8 KV) and with fused
   int8 and int4 weights; then a narrow MPT (ALiBi, MHA and MQA) the same
   way, with int8 weights and over paged pools, and a wide MQA MPT (16 heads
   over one kv head) over dense and paged bf16 and int8 caches;
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
   decode steps and every kernel's launch count are checked, and that the
   int8 (then the int4) matmul ran both its kernels (decode rows and
   prefill rows, counted apart; int8 so in phases 7 and 11);
7. the paged engine (``TorchBackend(paged=True)``) on fresh int8 weights:
   an int8 KV pool of 256 pages shared by 16 slots of up to 4096 tokens,
   the prefix cache on; 16 concurrent requests (one of 3,000 tokens), then 8
   multi-turn follow-ups that reuse their pooled prefixes, with prefix hits,
   vision encodes, launch counts and page accounting checked;
8. training on the narrow models, card (bf16, the flash forward and both
   backward kernels, remat) against the CPU (f32, plain): the loss, the
   gradient of the projector and of every language-model leaf, one AdamW
   step and the kernels' launch counts, on packed and padded rows, for the
   narrow LLaMA and for the narrow MPT (MHA and MQA, the ALiBi kernels);
   then LoRA and QLoRA (int8 and int4 base) on the narrow LLaMA: the
   gradient of every adapter leaf, the base's bytes and the launch counts
   of the quantized kernels and of their backward;
9. LLaVA-1.5-7B stage 1 through the port's ``train()`` with the
   ``scripts/v1_5/pretrain.sh`` recipe (projector only, batch 32) on 96
   synthetic image-caption records: 3 steps, frozen bytes, the
   ``mm_projector.bin`` export and the launch counts;
10. LLaVA-1.5-7B stage 2 through ``make_train_step`` with the
   ``scripts/v1_5/finetune.sh`` recipe reduced to batch 4 with gradient
   accumulation 2, on 24 synthetic multi-turn image records of 700-2048
   tokens: 3 steps, every trained leaf updated, the vision tower frozen, the
   launch counts and the peak memory;
11. (run after 7, before the training phases) LLaVA-MPT-7B at full width,
   random bf16 weights quantized to int8, int8 KV, behind the HTTP worker:
   the dense engine (8 concurrent ``conv_mpt`` requests, 4 image and 4 text,
   of 32 greedy tokens), then the paged engine with the prefix cache (128
   pages of 128; 8 requests, then 4 multi-turn follow-ups that hit their
   pooled prefixes), with TTFT p50, tokens/s, peak memory, page accounting
   and every ALiBi kernel's launch count checked;
12. LLaVA-MPT-7B stage 1 through ``train()`` at full width and depth with
   the ``scripts/pretrain.sh`` recipe (projector only, batch 32) on 96
   synthetic image-caption records: 3 steps, frozen bytes, the
   ``mm_projector.bin`` export and the ALiBi kernels' launch counts (the
   backward to the projector runs both ALiBi backward kernels);
13. LLaVA-1.5-7B QLoRA through ``train()`` with the
   ``scripts/finetune_qlora.sh`` recipe (``--lora-enable --bits 4``, r 128,
   alpha 256, remat) reduced to batch 4 and 3 steps on records of 700-2048
   tokens: every adapter leaf updated, the int4 base unchanged, the PEFT
   export, the peak memory and the int4 kernel's forward launches and
   backward calls;
14. the port's int4 measurement tools (``llava_plus_torch.tools.
   bench_int4_variants`` and ``bench_int4``) in-process through their
   ``main``: split-half int4, native int4 and int8 kernels at the five
   shapes of the JAX tool and at LLaVA-1.5-7B's three, each checked against
   its plain version and timed, with exact launch counts;
15. (phase 3's device times, taken last because a ``torch.profiler``
   session can leave CUPTI attached and slow the host clocks of later
   phases) the flash forward, dK/dV, dQ and dense decode rows, the int8
   and int4 matmuls at every shape and row of phase 3, the native int4
   matmul at the tools' five shapes and phase 3's rows (each alternated
   with the split-half int4 kernel on the same values; 7B q/o at 16 rows
   also with ``torch._weight_int4pack_mm``, 768 and 3,072 rows with the
   yardstick; 13B down and 7B q/o at 16 rows again with L2 flushed before
   every call), and paged decode1 and
   the general kernel at their phase-3 rows (bf16 and int8 pools, ALiBi,
   pages of 32, the paged engine's 32 pages, GQA, MQA, chunks of 4 and 8)
   timed by the kernel's own device time from ``torch.profiler``, so the
   host path around the wrapper drops out, alternated with the library call
   or yardstick (kernel, library, library, kernel; on wqkv at 16, 768 and
   3,072 rows and, int4, w_down at 8,192) in one process, with TFLOP/s and
   the share of the bound;
17. (run after 7, before 11) speculative serving on fresh int8 LLaVA-1.5-7B
   weights, int8 KV: ``llava_plus_torch.tools.bench_spec``'s stream (160
   repetitive words and an image, 128 greedy tokens, speculation off then
   on; acceptance > 1 required), the dense engine at 16 slots behind the
   HTTP worker with ``speculate=4`` on 8 image and 8 repetitive text
   requests of 64 tokens after the plain engine on the same requests (per
   request the tokens equal to the plain engine's; at a divergence the
   plain step's top-2 logit gap, which must lie within phase 4's bound),
   the paged engine (256 pages, prefix cache) on them and 8 prefix-hit
   follow-ups (the paged general kernel once a layer a verify step), a
   verify chunk and a plain step queued under
   ``set_sync_debug_mode("error")``, a plain and a verify step at 16 slots
   with host ms and device busy by class, and the narrow LLaMA and MPT
   (bf16: the kernels take no f32) dense and paged, spec against plain;
16. (run after 5, before 6, which quantizes its weights) the 7B tree of
   phase 5 exported as an HF checkpoint under ``.smoke/`` (one
   ``model.safetensors``, 14.1 GB, with a word-level tokenizer that names
   every id) and served from disk: ``load_pretrained_model`` in this
   process, every leaf equal to the exported one bit for bit; the worker
   started as a user starts it (``python -m llava_plus_torch.serve.
   model_worker --model-path ... --load-8bit --kv-int8 --max-slots 16
   --limit-model-concurrency 16``)
   answering phase 6's burst, then requests one at a time whose greedy texts
   equal a ``TorchBackend`` built in this process by the worker's own
   factory on the loaded tree; the worker stopped by SIGTERM; one turn of
   ``python -m llava_plus_torch.serve.cli`` with its input piped. Write and
   load times, host GB/s, the worker's first served token from its start,
   TTFT p50, tokens/s and its peak device memory.

Phase 3 also holds both paged kernels (decode1 and general) and both flash
backward kernels (dK/dV and dQ, at T = 2048, MHA and GQA, a padded and a
packed row) against their plain version, and phase 4 runs the narrow model
over a paged cache with a bf16 and an int8 pool. Each kernel's line gives
its bound (bytes over the H100's 3.35 TB/s or bf16 flops over 989 TFLOP/s,
whichever is larger) and, where one PyTorch call computes the same
function, that call's time (with ALiBi: ``scaled_dot_product_attention``
with the bias as a float mask). The kernels build with one ``nvcc`` for
each source, all started together.

The script reaches the model, tokenizer, image processor and worker only
through ``llava_plus_torch`` (phase 16 makes its checkpoint's tokenizer
with ``tokenizers`` and ``transformers``) and checks at the end that no module of JAX or
of the JAX package (``llava_plus_tpu``) was imported. The line before the
last is a JSON summary of the kernels; the last line is the JSON result.
Without a CUDA device it prints no result and exits 1.
"""

import base64
import copy
import gc
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# git-ignored scratch for the training phases' synthetic corpora and outputs
SMOKE_DIR = os.path.join(HERE, ".smoke")

FLASH_REPLACES = "llava_plus_tpu/ops/flash_attention.py:46"
DKV_REPLACES = "llava_plus_tpu/ops/flash_attention.py:217"
DQ_REPLACES = "llava_plus_tpu/ops/flash_attention.py:310"
DECODE_REPLACES = "llava_plus_tpu/ops/decode_attention.py:41"
INT8_REPLACES = "llava_plus_tpu/ops/quant_matmul.py:71"
INT4_REPLACES = "llava_plus_tpu/ops/quant_matmul.py:127"
INT4N_REPLACES = "tools/bench_int4_variants.py:74"
PAGED_DECODE1_REPLACES = "llava_plus_tpu/ops/paged_attention.py:305"
PAGED_GENERAL_REPLACES = "llava_plus_tpu/ops/paged_attention.py:95"
# the ALiBi branches (MPT) of those Pallas kernels; the dense decode kernel
# has none in Pallas: on the card its ALiBi variant stands in for XLA's
# quant_cache_attention(bias=...) (llava_plus_tpu/models/mpt.py:175)
FLASH_ALIBI_REPLACES = "llava_plus_tpu/ops/flash_attention.py:82"
DECODE_ALIBI_REPLACES = "llava_plus_tpu/ops/decode_attention.py:41"
PAGED_DECODE1_ALIBI_REPLACES = "llava_plus_tpu/ops/paged_attention.py:420"
PAGED_GENERAL_ALIBI_REPLACES = "llava_plus_tpu/ops/paged_attention.py:209"
# the use_alibi branches of the Pallas backward kernels (MPT training)
DKV_ALIBI_REPLACES = "llava_plus_tpu/ops/flash_attention.py:258"
DQ_ALIBI_REPLACES = "llava_plus_tpu/ops/flash_attention.py:348"

# Published peaks of one H100 SXM (dense): HBM3 bytes/s and bf16 tensor-core
# flop/s. A kernel's bound is the larger of its bytes over the first and its
# flops over the second.
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12


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


def bound(nbytes, flops):
    """The least time (ms) the card could take to move ``nbytes`` and do
    ``flops`` bf16 operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    # phase 16 writes a 14.1 GB checkpoint under .smoke/
    df = subprocess.run(["df", "-h", HERE], capture_output=True, text=True).stdout.strip()
    log("env", "disk: " + " | ".join(df.splitlines()))
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

def _slopes(H, alibi):
    """MPT's ALiBi slopes for H heads on the card (alibi_bias_max 8), or None."""
    from llava_plus_torch.models.mpt import alibi_slopes

    return alibi_slopes(H, 8, "cuda") if alibi else None


def check_flash(tag, B, T, H, Hkv, pad_tail, gen, alibi=False, packed=1):
    """The forward kernel against its plain version and the f64 truth: the
    last row padded over its last ``pad_tail`` tokens; with ``packed`` > 1
    the first row packed as that many segments of about equal length."""
    import torch
    from llava_plus_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference,
    )

    dev, D = "cuda", 128
    slopes = _slopes(H, alibi)
    q = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
    seg = torch.ones(B, T, dtype=torch.int32, device=dev)
    seg[-1, T - pad_tail:] = 0
    for i in range(1, packed):
        seg[0, i * T // packed:] = i + 1
    scale = D ** -0.5

    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, alibi_slopes=slopes)
    ref_kw = dict(causal=True, sm_scale=scale, alibi_slopes=slopes)
    n0 = flash_attention.alibi_launches if alibi else flash_attention.launches
    out, lse = flash_attention(q, k, v, **kw)
    if (flash_attention.alibi_launches if alibi else flash_attention.launches) != n0 + 1:
        raise AssertionError(f"flash_fwd {tag}: the call did not launch the kernel")
    # a second launch on the same inputs must give the same bits: each block
    # computes its rows alone, in a fixed order
    out2, lse2 = flash_attention(q, k, v, **kw)
    same = torch.equal(out, out2) and torch.equal(lse, lse2)
    del out2, lse2
    p_out, p_lse = flash_attention_reference(q, k, v, seg, seg, **ref_kw)
    t_out, t_lse = flash_attention_reference(q.double(), k.double(), v.double(), seg, seg,
                                             **ref_kw)
    torch.cuda.synchronize()
    # the largest error over the rows that are not padding (a masked maximum,
    # so no data-dependent gather)
    rows = (seg > 0)[:, :, None, None]
    lse_rows = (seg > 0)[:, None, :]

    def err(x, truth, live):
        return torch.where(live, (x.double() - truth).abs(), 0.0).amax().item()

    k_err, r_err = err(out, t_out, rows), err(p_out, t_out, rows)
    k_lse, r_lse = err(lse, t_lse, lse_rows), err(p_lse, t_lse, lse_rows)
    ms = time_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, seg, seg, **ref_kw))
    # the library's causal attention on the same tensors, heads-major as it
    # takes them (the copies are made before the timing); on every row that
    # is not padding it computes the kernel's function. With ALiBi the bias
    # goes in as a float mask (-inf above the diagonal), made beforehand.
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if alibi:
        pos = torch.arange(T, device=dev)
        dist = (pos[:, None] - pos[None, :]).float()
        mask = torch.where(dist >= 0, -dist * slopes[:, None, None], -torch.inf)
        mask = mask[None].bfloat16()
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=Hkv != H))
        del mask
    else:
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=Hkv != H))
    # q, k, v read once, out and lse written once; the causal pairs of the
    # rows that are not padding, 4 flops per pair and head dim
    nbytes = 2 * (2 * B * T * H * D + 2 * B * T * Hkv * D) + 4 * B * H * T + 2 * 4 * B * T
    flops = 4 * H * D * _causal_pairs(seg, True)
    b = bound(nbytes, flops)
    ok = within(k_err, r_err) and within(k_lse, r_lse) and same
    log("kernels", f"flash_fwd{'[alibi]' if alibi else ''} {tag} B={B} T={T} H={H} "
                   f"Hkv={Hkv} D={D} pad={pad_tail} segments in row 0: {packed}: "
                   f"out err {k_err:.3e} (plain {r_err:.3e}), lse err {k_lse:.3e} "
                   f"(plain {r_lse:.3e}), a second launch bit-identical {same}, "
                   f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, "
                   f"library (sdpa) {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                   f"({b['bound_by']}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_fwd {tag} (alibi={alibi}) disagrees with its plain "
                             "version")
    return {"max_abs_err": k_err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": library_ms}


def _causal_pairs(seg, causal):
    """The (causal) query-key pairs within each non-zero segment of the
    [B, T] ids: the pairs the attention kernels must compute."""
    pairs = 0
    for row in seg.cpu().numpy():
        for s_id in set(row.tolist()) - {0}:
            n = int((row == s_id).sum())
            pairs += n * (n + 1) // 2 if causal else n * n
    return pairs


def check_flash_bwd(tag, B, T, H, Hkv, gen, alibi=False, causal=True):
    """Both backward kernels at a training shape: causal (or not), the first
    row padded over its last 100 tokens, the second packed as two segments
    of T/2. dq, dk and dv of the kernels (fed the forward kernel's output and
    lse) and of the plain backward (fed the plain forward's) against the
    f64 gradient of the f64 forward, every row included (padding rows and
    padded keys must come out 0). With ``alibi`` MPT's slopes for H heads
    select the ALiBi kernels, whose launches must count apart. The library
    yardstick is the backward of ``scaled_dot_product_attention`` on the same
    q/k/v and dO, heads-major (``is_causal``, or with ALiBi the bias as a
    float mask made beforehand): one call that computes what both kernels
    compute."""
    import torch
    import torch.nn.functional as F
    from llava_plus_torch.ops import flash_attention as fa

    dev, D = "cuda", 128
    scale = D ** -0.5
    slopes = _slopes(H, alibi)
    counter = "alibi_launches" if alibi else "launches"
    q = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
    do = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
    seg = torch.ones(B, T, dtype=torch.int32, device=dev)
    seg[0, T - 100:] = 0
    seg[1, T // 2:] = 2
    kw = dict(causal=causal, sm_scale=scale, alibi_slopes=slopes)

    out, lse = fa._launch(q, k, v, seg, seg, causal, scale, slopes)
    n0 = (getattr(fa.flash_bwd_dkv, counter), getattr(fa.flash_bwd_dq, counter))
    grads = fa.flash_attention_backward(q, k, v, seg, seg, out, lse, do, **kw)
    if (getattr(fa.flash_bwd_dkv, counter), getattr(fa.flash_bwd_dq, counter)) != (n0[0] + 1,
                                                                                  n0[1] + 1):
        raise AssertionError(f"flash_bwd {tag}: the call did not launch both {counter} kernels")
    # a second call must give the same bits (the head split sums its
    # partials in a fixed order; nothing is accumulated by atomics)
    same = all(torch.equal(a, b) for a, b in zip(
        grads, fa.flash_attention_backward(q, k, v, seg, seg, out, lse, do, **kw)))
    p_out, p_lse = fa.flash_attention_reference(q, k, v, seg, seg, **kw)
    plain = fa.flash_attention_backward_reference(q, k, v, seg, seg, p_out, p_lse, do, **kw)
    q64, k64, v64 = q.double(), k.double(), v.double()
    t_out, t_lse = fa.flash_attention_reference(q64, k64, v64, seg, seg, **kw)
    truth = fa.flash_attention_backward_reference(q64, k64, v64, seg, seg, t_out, t_lse,
                                                  do.double(), **kw)
    del t_out, t_lse
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    k_err = {n: (g.double() - t).abs().max().item() for n, g, t in zip(names, grads, truth)}
    r_err = {n: (g.double() - t).abs().max().item() for n, g, t in zip(names, plain, truth)}
    pad_rows = (seg == 0)[:, :, None, None]
    zero_pad = all(torch.where(pad_rows, g.abs(), 0).amax().item() == 0.0 for g in grads)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    del plain, truth, q64, k64, v64

    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    dkv_ms = time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, seg, seg, lse, delta, **kw))
    dq_ms = time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, seg, seg, lse, delta, **kw))
    plain_ms = time_ms(lambda: fa.flash_attention_backward_reference(
        q, k, v, seg, seg, p_out, p_lse, do, **kw), iters=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    mask = None
    if alibi:
        pos = torch.arange(T, device=dev)
        dist = (pos[:, None] - pos[None, :]).float()
        mask = -dist.abs() * slopes[:, None, None]
        if causal:
            mask = torch.where(dist >= 0, mask, -torch.inf)
        mask = mask[None].bfloat16()
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                           is_causal=causal and not alibi, enable_gqa=Hkv != H)
    g_lib = do.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), g_lib,
                                                     retain_graph=True))
    del o_lib, qt, kt, vt, mask

    # the (causal) pairs within each segment; dK/dV does 4 products of 2*D
    # flops per pair and head (JAX's 8*T*T*D), dQ 3 (6*T*T*D); the slopes add
    # one multiply-add per pair, no bytes worth counting
    pairs = _causal_pairs(seg, causal)
    qo_bytes = 2 * 2 * B * T * H * D             # q and dO
    kv_bytes = 2 * 2 * B * T * Hkv * D           # k and v
    small = 2 * 4 * B * H * T + 2 * 4 * B * T    # lse, delta; segment ids
    b_dkv = bound(qo_bytes + kv_bytes + small + kv_bytes, 8 * D * H * pairs)
    b_dq = bound(qo_bytes + kv_bytes + small + qo_bytes // 2, 6 * D * H * pairs)
    ok_dkv = within(k_err["dk"], r_err["dk"]) and within(k_err["dv"], r_err["dv"])
    ok_dq = within(k_err["dq"], r_err["dq"])
    ok = ok_dkv and ok_dq and zero_pad and finite and same
    errs = ", ".join(f"{n} err {k_err[n]:.3e} (plain {r_err[n]:.3e})" for n in names)
    log("kernels", f"flash_bwd{'[alibi]' if alibi else ''} {tag} B={B} T={T} H={H} Hkv={Hkv} "
                   f"D={D} S={fa.flash_bwd_dkv.last_splits} "
                   f"{'causal' if causal else 'non-causal'}, row 0 padded "
                   f"over 100, row 1 two segments: {errs}; padding rows zero={zero_pad}; a second "
                   f"call bit-identical {same}; "
                   f"dkv {dkv_ms:.4f} ms (bound {b_dkv['bound_ms']:.4f}, {b_dkv['bound_by']}; "
                   f"{8 * D * H * pairs / dkv_ms / 1e9:.1f} TFLOP/s), dq {dq_ms:.4f} ms (bound "
                   f"{b_dq['bound_ms']:.4f}; {6 * D * H * pairs / dq_ms / 1e9:.1f} TFLOP/s) vs "
                   f"plain backward {plain_ms:.4f} ms, library (sdpa backward) {library_ms:.4f} "
                   f"ms -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_bwd {tag} (alibi={alibi}) disagrees with its plain "
                             "version")
    return ({"max_abs_err": max(k_err["dk"], k_err["dv"]), "ms": dkv_ms, "plain_ms": plain_ms,
             **b_dkv, "library_ms": library_ms},
            {"max_abs_err": k_err["dq"], "ms": dq_ms, "plain_ms": plain_ms, **b_dq,
             "library_ms": library_ms})


def _decode_inputs(tag, B, S, H, Hkv, gen, rng, fills=None, masked_row=None, Tq=1):
    """A dense-decode call at a 7B width: q of ``Tq`` tokens, a layer slice
    of a stacked [L, B, S, Hkv, D] cache (int8 with scales for ``tag``
    "int8"), segment ids and the first query token's positions (a row's last
    token at its last written slot). ``fills`` (slots each row has written)
    are drawn from ``rng`` unless given, the first row full and the second at
    1; ``masked_row``: a row whose visible slots all have segment id 0."""
    import torch
    from llava_plus_torch.models.llama import quantize_kv

    dev, D = "cuda", 128
    q = torch.randn(B, Tq, H, D, generator=gen, device=dev).bfloat16()
    k_all = torch.randn(2, B, S, Hkv, D, generator=gen, device=dev).bfloat16()
    v_all = torch.randn(2, B, S, Hkv, D, generator=gen, device=dev).bfloat16()
    if fills is None:
        fills = rng.integers(1, S + 1, size=B)
        fills[0], fills[1 % B] = S, 1
    fills = np.asarray(fills)
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for b, f in enumerate(fills):
        seg[b, :f] = 0 if b == masked_row else 1
    q_pos = torch.as_tensor(np.maximum(fills - Tq, 0), dtype=torch.int32, device=dev)
    ks = vs = None
    if tag == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k_all), quantize_kv(v_all)
        k_all, v_all = kq, vq
        ks, vs = ks[1], vs[1]
    return q, k_all[1], v_all[1], seg, q_pos, ks, vs, fills


def _decode_library(q, kc, vc, q_pos, slopes):
    """The library's attention over the same bf16 cache (heads-major copies
    made before the timing) with a boolean mask over the slots up to the
    query, with ALiBi a float mask carrying the bias."""
    import torch
    import torch.nn.functional as F

    S, Tq = kc.shape[1], q.shape[1]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    pos = torch.arange(S, device=q.device)
    qp = q_pos[:, None] + torch.arange(Tq, device=q.device)                # [B, Tq]
    mask = (pos <= qp[:, :, None])[:, None]                                 # [B, 1, Tq, S]
    if slopes is not None:
        dist = (qp[:, :, None] - pos).float()
        bias = -dist[:, None] * slopes[None, :, None, None]                 # [B, H, Tq, S]
        mask = torch.where(mask, bias, -torch.inf).bfloat16()
    gqa = kc.shape[2] != q.shape[2]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=gqa)


def _decode_bound(fills, B, H, Hkv, S, elem, quantized, Tq=1):
    """The cache bytes up to each row's last query (k and v, + scales), q,
    out, seg and q_pos moved once, against 4 flops per visible slot, query
    token, head and dim (token t of a row sees slots up to q_pos + t)."""
    D = 128
    rows = int(np.sum(fills)) * Hkv
    nbytes = 2 * rows * (D * elem + (4 if quantized else 0))
    q_pos = np.maximum(np.asarray(fills) - Tq, 0)
    visible = float(sum(min(int(p) + t + 1, S) for p in q_pos for t in range(Tq)))
    return nbytes, bound(nbytes + 2 * 2 * B * Tq * H * D + 4 * B * (S + 1),
                         4 * H * D * visible)


def check_decode(tag, B, S, H, Hkv, gen, rng, alibi=False, fills=None, masked_row=None, Tq=1):
    """The dense decode kernel against its plain version and the f64 truth,
    launched twice (every bit must repeat: the chunks' partials are summed
    in a fixed order), with the cache chunks it was split into; ``Tq`` query
    tokens a row (a speculative verify chunk)."""
    import torch
    from llava_plus_torch.ops.decode_attention import (
        WIDE_GROUP, decode_attention, decode_attention_reference,
    )

    D = 128
    q, kc, vc, seg, q_pos, ks, vs, fills = _decode_inputs(tag, B, S, H, Hkv, gen, rng, fills,
                                                          masked_row, Tq)
    scale = D ** -0.5
    slopes = _slopes(H, alibi)
    counter = ("wide_launches" if H // Hkv > WIDE_GROUP else
               "alibi_launches" if alibi else "launches")

    def kernel():
        return decode_attention(q, kc, vc, seg, q_pos, ks, vs, alibi_slopes=slopes)

    def plain():
        return decode_attention_reference(q, kc, vc, seg, q_pos, ks, vs, sm_scale=scale,
                                          alibi_slopes=slopes)

    dbl = lambda x: None if x is None else x.double()
    truth = decode_attention_reference(q.double(), kc, vc, seg, q_pos, dbl(ks), dbl(vs),
                                       sm_scale=scale, alibi_slopes=slopes)
    n0, c0 = getattr(decode_attention, counter), decode_attention.chunk_launches
    out, p_out = kernel(), plain()
    torch.cuda.synchronize()
    if (getattr(decode_attention, counter) != n0 + 1
            or decode_attention.chunk_launches != c0 + (Tq > 1)):
        raise AssertionError(f"decode_attention {tag}: the call did not launch the kernel")
    splits = decode_attention.last_splits
    same = torch.equal(out, kernel())
    k_err = (out.double() - truth).abs().max().item()
    r_err = (p_out.double() - truth).abs().max().item()
    finite = bool(torch.isfinite(out).all())
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    # an int8 cache has no single library call
    library_ms = None if ks is not None else time_ms(_decode_library(q, kc, vc, q_pos, slopes))
    nbytes, b = _decode_bound(fills, B, H, Hkv, S, kc.element_size(), ks is not None, Tq)
    ok = within(k_err, r_err) and same and finite
    log("kernels", f"decode_attention{'[alibi]' if alibi else ''} {tag} B={B} Tq={Tq} S={S} "
                   f"H={H} Hkv={Hkv} D={D} (fills {int(fills.min())}-{int(fills.max())}, mean "
                   f"{fills.mean():.0f}{f', row {masked_row} all seg 0' if masked_row is not None else ''}"
                   f"; {splits} chunks a row): "
                   f"err {k_err:.3e} (plain {r_err:.3e}), a second launch bit-identical {same}, "
                   f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s of cache read) vs plain "
                   f"{plain_ms:.4f} ms, "
                   f"library {'none' if library_ms is None else f'(sdpa) {library_ms:.4f} ms'}, "
                   f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) "
                   f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"decode_attention {tag} (alibi={alibi}) disagrees with its "
                             "plain version")
    return {"max_abs_err": k_err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": library_ms}


# 7B matrices with fused weights (K x N) and the row counts the engine gives
# the quantized kernels: one decode row, 16 decode slots, one 768-token prefill.
# LLaVA-1.5-7B's, then LLaVA-MPT-7B's other three (its wqkv is 4096 x 12288
# too), which it serves in int8 or, with --load-4bit, in int4.
QUANT_SHAPES = (("wqkv", 4096, 12288), ("w_down", 11008, 4096), ("lm_head", 4096, 32000))
MPT_QUANT_SHAPES = (("mpt out_proj", 4096, 4096), ("mpt up_proj", 4096, 16384),
                    ("mpt down_proj", 16384, 4096))
# the native int4 kernel at the int4 measurement tools' five shapes
# (LLaVA-1.5-7B's unfused projections, then LLaVA-1.5-13B's MLP); phase 3
# also at a shape whose N is not a multiple of 128 (a half strip, a quarter
# of a prefill tile) and whose K is 9 decode tiles
INT4N_SHAPES = (("7B q/o", 4096, 4096), ("7B gate/up", 4096, 11008), ("7B down", 11008, 4096),
                ("13B gate/up", 5120, 13824), ("13B down", 13824, 5120))
INT4N_EDGE = ("edge", 1152, 4160)
# the int8 kernel's rows (phases 3 and 15): both regimes (decode rows up to
# the cut, wgmma above it) at one row, 16 slots, 64, a 768-token prefill and
# the engine's 4-prompt batch of 3,072, plus one row on each side of the cut
# (ops/quant_matmul.INT8_CUT = 32; phase 3 checks that it is there)
INT8_ROWS = (1, 16, 32, 33, 64, 768, 3072)
# the int4 kernel's rows: the same, with its own cut (ops/quant_matmul.
# INT4_CUT; phase 3 checks that both sides are here) and QLoRA's 4 x 2048
INT4_ROWS = (1, 16, 48, 49, 64, 768, 3072, 8192)
# the native int4 kernel's rows: the int8 rows with its own cut (INT4N_CUT)
INT4N_ROWS = (1, 16, 48, 49, 64, 768, 3072)
# a 16-slot verify step's rows (16 x (k + 1) for k = 4 and 7), on wqkv and
# w_down (int8 and int4)
VERIFY_ROWS = (80, 128)


def _quantize(kind, w):
    """(packed weight, scale) of ``w`` in the layout of ``kind``: int8,
    int4 (split-half) or int4n (native)."""
    from llava_plus_torch.ops import quant

    if kind == "int4n":
        return quant.quantize_array_int4_native(w)
    qw = quant.quantize_array(w) if kind == "int8" else quant.quantize_array_int4(w)
    return qw[quant.QKEY if kind == "int8" else quant.Q4KEY], qw[quant.SKEY]


def _dequant64(kind, q, s):
    import torch
    from llava_plus_torch.ops import quant_matmul as qm

    if kind == "int4n":
        return qm.dequantize_int4_native(q, s, torch.float64)
    return qm.dequantize(8 if kind == "int8" else 4, q, s, torch.float64)


def _dequant16(kind, q, s):
    import torch
    from llava_plus_torch.ops import quant_matmul as qm

    if kind == "int4n":
        return qm.dequantize_int4_native(q, s, torch.bfloat16)
    return qm.dequantize(8 if kind == "int8" else 4, q, s, torch.bfloat16)


def check_quant(kind, name, K, N, gen, extra_rows=()):
    """One weight, every row count: kernel and plain version against the f64
    product of the dequantized weight, errors relative to the largest output.
    Every row also launches the kernel a second time (every bit must repeat:
    the K chunks' partials are summed in a fixed order) and times the
    yardstick, ``torch.matmul`` on the same weight dequantized to bf16 (the
    port never calls it)."""
    import torch
    from llava_plus_torch.ops import quant_matmul as qm

    dev = "cuda"
    w = torch.randn(K, N, generator=gen, device=dev).mul_(0.02).bfloat16()
    q, s = _quantize(kind, w)
    del w
    w64 = _dequant64(kind, q, s)
    kernel_fn, plain_fn = {
        "int8": (qm.matmul_int8, qm.matmul_int8_reference),
        "int4": (qm.matmul_int4, qm.matmul_int4_reference),
        "int4n": (qm.matmul_int4_native, qm.matmul_int4_native_reference)}[kind]
    # the native kernel always writes f32, as its Pallas variant does
    out_dtype = torch.float32 if name == "lm_head" or kind == "int4n" else torch.bfloat16
    kw = {} if kind == "int4n" else {"out_dtype": out_dtype}
    nbytes = q.numel() + s.numel() * 4
    w16 = _dequant16(kind, q, s)
    for rows_, cut in ((INT8_ROWS, qm.INT8_CUT), (INT4_ROWS, qm.INT4_CUT),
                       (INT4N_ROWS, qm.INT4N_CUT)):
        if not {cut, cut + 1} <= set(rows_):
            raise AssertionError(f"the rows {rows_} must hold both sides of the cut {cut}")
    rows = {}
    for R in {"int8": INT8_ROWS, "int4": INT4_ROWS, "int4n": INT4N_ROWS}[kind] + extra_rows:
        x = torch.randn(R, K, generator=gen, device=dev).bfloat16()
        truth = x.double() @ w64
        top = truth.abs().max().item()
        out = kernel_fn(x, q, s, **kw)
        plan = kernel_fn.last_plan
        same = torch.equal(out, kernel_fn(x, q, s, **kw))
        p_out = plain_fn(x, q, s, **kw)
        torch.cuda.synchronize()
        if out.shape != (R, N) or out.dtype != out_dtype:
            raise AssertionError(f"quant_matmul[{kind}] {name}: {out.shape} {out.dtype}")
        k_err = (out.double() - truth).abs().max().item() / top
        r_err = (p_out.double() - truth).abs().max().item() / top
        del truth, p_out
        ms = time_ms(lambda: kernel_fn(x, q, s, **kw))
        plain_ms = time_ms(lambda: plain_fn(x, q, s, **kw))
        yard_ms = time_ms(lambda: torch.matmul(x, w16))
        out_bytes = R * N * (4 if out_dtype == torch.float32 else 2)
        b = bound(nbytes + 2 * R * K + out_bytes, 2 * R * K * N)
        ok = within(k_err, r_err) and same
        rate = (f", {nbytes / ms / 1e6:.0f} GB/s of weights" if R <= 64 else "") + (
            f", {2 * R * K * N / ms / 1e9:.1f} TFLOP/s" if R >= 64 else "")
        log("kernels", f"quant_matmul {kind} {name} R={R} K={K} N={N} -> "
                       f"{str(out_dtype)[6:]} {plan}: rel err {k_err:.3e} (plain {r_err:.3e}), "
                       f"a second launch bit-identical {same}, "
                       f"{ms:.4f} ms{rate} vs plain {plain_ms:.4f} ms, "
                       f"yardstick (bf16 matmul) {yard_ms:.4f} ms, "
                       f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) -> "
                       f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"quant_matmul[{kind}] {name} R={R} disagrees with "
                                 "its plain version or does not repeat its bits")
        rows[R] = {"max_abs_err": k_err, "ms": ms, "plain_ms": plain_ms, **b,
                   "yardstick_ms": yard_ms}
    if name in ("wqkv", "7B q/o"):
        rows[16]["library_ms"] = library_quant(kind, q, s, gen)
    return rows


def _library_call(kind, q, s, x):
    """The library's weight-only product of x and the same weight, after
    checking that it computes the same function: int8 through
    ``torch._weight_int8pack_mm`` (int8 [N, K], bf16 per-channel scales),
    int4 through ``torch._weight_int4pack_mm`` (the weight repacked as its
    unsigned nibbles minus 8, bf16 scales and zero points per 32-row group;
    the native layout's values are repacked the same way). Both round the f32
    scales to bf16, so the check allows 2% of the largest output (a wrong
    layout is off by far more). Returns (the call, its relative error)."""
    import torch
    from llava_plus_torch.ops import quant_matmul as qm

    K = x.shape[1]
    N = q.shape[1] * (2 if kind == "int4n" else 1)
    if kind == "int8":
        wt = q.t().contiguous()
        scales = s.reshape(-1).bfloat16()
        call = lambda: torch._weight_int8pack_mm(x, wt, scales)
    else:
        vals = (qm.unpack_int4(q).reshape(K, N) if kind == "int4"
                else qm.unpack_int4_native(q)).int() + 8                 # [K, N] in 0..15
        u = vals.t().contiguous()                                       # [N, K]
        packed = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)       # [N, K / 2]
        wpack = torch._convert_weight_to_int4pack(packed, 8)
        sz = torch.stack([s, torch.zeros_like(s)], dim=-1).bfloat16().contiguous()
        call = lambda: torch._weight_int4pack_mm(x, wpack, qm.INT4_BLOCK, sz)
    truth = x.double() @ _dequant64(kind, q, s)
    err = (call().double() - truth).abs().max().item() / truth.abs().max().item()
    if err > 2e-2:
        raise AssertionError(f"library {kind} product differs from the kernel's function "
                             f"(rel err {err:.3e})")
    return call, err


def library_quant(kind, q, s, gen, R=16):
    """Time the library's weight-only product (:func:`_library_call`) at R
    rows on the same weight."""
    import torch

    K = q.shape[0] * (2 if kind == "int4" else 1)
    N = q.shape[1] * (2 if kind == "int4n" else 1)
    x = torch.randn(R, K, generator=gen, device="cuda").bfloat16()
    call, err = _library_call(kind, q, s, x)
    ms = time_ms(call)
    log("kernels", f"library {kind} weight-only product R={R} K={K} N={N}: rel err "
                   f"{err:.3e}, {ms:.4f} ms")
    return ms


def phase_quant_kernels():
    """The int8 and int4 kernels at LLaVA-1.5-7B's and LLaVA-MPT-7B's shapes,
    the native int4 kernel at the int4 tools' five and INT4N_EDGE. A line
    reports the
    engine's decode call (wqkv at 16 slots; the native kernel: 4096 x 4096
    at 16 rows, the tools' default) with the largest relative error over
    every shape and row count."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    stats = {}
    for kind, shapes, head in (("int8", QUANT_SHAPES + MPT_QUANT_SHAPES, "wqkv"),
                               ("int4", QUANT_SHAPES + MPT_QUANT_SHAPES, "wqkv"),
                               ("int4n", INT4N_SHAPES + (INT4N_EDGE,), "7B q/o")):
        per = {name: check_quant(kind, name, K, N, gen,
                                 VERIFY_ROWS if name in ("wqkv", "w_down") else ())
               for name, K, N in shapes}
        K, N = next((K, N) for name, K, N in shapes if name == head)
        stats[f"quant_matmul[{kind}]"] = dict(
            per[head][16], shape=f"{head} K={K} N={N} R=16",
            max_abs_err=max(r["max_abs_err"] for rows in per.values() for r in rows.values()))
        # the prefill regime's rows on the same weight
        regime_rows = (768, 3072) + (VERIFY_ROWS if kind != "int4n" else ())
        stats[f"quant_matmul[{kind}]"].update(
            {f"r{R}_ms": per[head][R]["ms"] for R in regime_rows},
            **{f"r{R}_yardstick_ms": per[head][R]["yardstick_ms"] for R in regime_rows})
    return stats


def _paged_inputs(Hkv, Tq, quantized, gen, rng, B=16, H=32, P=128, pages_per_slot=16,
                  edges=False, max_past=None):
    """A paged kernel's inputs at a 7B-wide batch: B slots of
    ``pages_per_slot`` pages, page ids a random permutation of the pool,
    past lengths of 1 to ``max_past`` (every page by default) and chunk
    prefixes from a seed, the last slot dead (no past tokens, no valid chunk
    token); with ``edges`` the first slot at its full length and the second
    at one token. Returns (q, pool, scale, page_ids, lens, ck, cv, vals) on
    the card and the lengths and valid prefixes as numpy arrays."""
    import torch
    from llava_plus_torch.models.llama import _paged_quant

    dev, D = "cuda", 128
    NP = B * pages_per_slot
    page_ids = torch.as_tensor(rng.permutation(NP).reshape(B, pages_per_slot),
                               dtype=torch.int32, device=dev)
    lengths = rng.integers(1, (max_past or pages_per_slot * P) + 1, size=B)
    valid = rng.integers(1, Tq + 1, size=B)
    lengths[-1] = valid[-1] = 0
    if edges:
        lengths[0], lengths[1] = pages_per_slot * P, 1
    pool = torch.randn(NP, 2, P, Hkv, D, generator=gen, device=dev).bfloat16()
    scale = None
    if quantized:
        pool, scale = _paged_quant(pool)
        scale = scale.transpose(2, 3).contiguous()      # head-major [NP, 2, Hkv, P]
    q = torch.randn(B, Tq, H, D, generator=gen, device=dev).bfloat16()
    ck = torch.randn(B, Tq, Hkv, D, generator=gen, device=dev).bfloat16()
    cv = torch.randn(B, Tq, Hkv, D, generator=gen, device=dev).bfloat16()
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    vals = torch.as_tensor(valid, dtype=torch.int32, device=dev)
    return (q, pool, scale, page_ids, lens, ck, cv, vals), lengths, valid


def _paged_bound(lengths, valid, B, H, Hkv, Tq, P, quantized, elem):
    """The pages the slots use, read once (k and v, + scales), the page ids,
    q and the chunk read once, the output written once; and the products.
    Returns (page bytes, bound)."""
    D = 128
    page_bytes = 2 * int(lengths.sum()) * Hkv * (D * elem + (4 if quantized else 0))
    small = (4 * int(np.ceil(lengths / P).sum()) + 2 * B * Tq * H * D * 2
             + 2 * B * Tq * Hkv * D * 2 + 8 * B)
    t = np.arange(Tq)
    self_pairs = sum(int(np.minimum(t + 1, v).sum()) for v in valid)
    return page_bytes, bound(page_bytes + small,
                             4 * D * (H // Hkv) * Hkv * (Tq * int(lengths.sum()) + self_pairs))


def check_paged(tag, Hkv, Tq, quantized, gen, rng, B=16, H=32, P=128, pages_per_slot=16,
                alibi=False, edges=False, max_past=None):
    """A paged kernel on :func:`_paged_inputs`: kernel and plain version
    against the f64 truth on the live slots; the kernel launched twice, bit
    for bit the same (the decode1 kernel sums its chunks' partials in a
    fixed order)."""
    import torch
    from llava_plus_torch.ops import paged_attention as pa

    D = 128
    (q, pool, scale, page_ids, lens, ck, cv, vals), lengths, valid = _paged_inputs(
        Hkv, Tq, quantized, gen, rng, B, H, P, pages_per_slot, edges, max_past)
    sm = D ** -0.5
    wrapper = pa.paged_decode1 if (H // Hkv) * Tq == 1 else pa.paged_attention_general
    slopes = _slopes(H, alibi)
    counter = "alibi_launches" if alibi else "launches"

    def kernel():
        return pa.paged_decode_attention(q, pool, page_ids, lens, scale, ck, cv, vals,
                                         alibi_slopes=slopes)

    def plain():
        return pa.paged_attention_reference(q, pool, page_ids, lens, scale, ck, cv, vals,
                                            sm_scale=sm, alibi_slopes=slopes)

    truth = pa.paged_attention_reference(q.double(), pool, page_ids, lens,
                                         None if scale is None else scale.double(),
                                         ck.double(), cv.double(), vals, sm_scale=sm,
                                         alibi_slopes=slopes)
    n0 = getattr(wrapper, counter)
    out, p_out = kernel(), plain()
    torch.cuda.synchronize()
    if getattr(wrapper, counter) != n0 + 1:
        raise AssertionError(f"paged {tag}: the call did not launch {wrapper.__name__}")
    splits = getattr(wrapper, "last_splits", None)
    same = torch.equal(out, kernel())
    live = slice(0, B - 1)
    k_err = (out.double() - truth)[live].abs().max().item()
    r_err = (p_out.double() - truth)[live].abs().max().item()
    if not torch.isfinite(out).all():
        raise AssertionError(f"paged {tag}: non-finite output (dead slot included)")
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    page_bytes, b = _paged_bound(lengths, valid, B, H, Hkv, Tq, P, quantized,
                                 pool.element_size())
    ok = within(k_err, r_err) and same
    log("kernels", f"paged {tag} ({wrapper.__name__}{', alibi' if alibi else ''}) "
                   f"{'int8' if quantized else 'bf16'} pool "
                   f"B={B} H={H} Hkv={Hkv} Tq={Tq} D={D} P={P} pages/slot={pages_per_slot} "
                   f"(mean past {lengths[:-1].mean():.0f}, one dead slot"
                   f"{', one full, one of 1 token' if edges else ''}"
                   f"{f'; {splits} chunks a slot' if splits else ''}): err {k_err:.3e} "
                   f"(plain {r_err:.3e}), a second launch bit-identical {same}, "
                   f"{ms:.4f} ms ({page_bytes / ms / 1e6:.1f} GB/s of "
                   f"pages read) vs plain {plain_ms:.4f} ms, library none, bound "
                   f"{b['bound_ms']:.4f} ms ({b['bound_by']}; pages alone "
                   f"{page_bytes / HBM_BYTES_S * 1e3:.4f} ms) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"paged {tag} disagrees with its plain version or does not "
                             "repeat its bits")
    # no single library call reads a paged pool (it would need a gather first)
    return {"max_abs_err": k_err, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}


def phase_paged_kernels(gen, rng):
    """Both paged kernels: decode1 at H = Hkv = 32, Tq = 1 (and over pages
    of 32 with a full and a 1-token slot, and at the paged engine's 32
    pages of 128, plain and ALiBi); the general one for GQA (Hkv = 8,
    Tq = 1) and for 4-token chunks (Hkv = 32); bf16 and int8 pools. Their
    ALiBi variants (MPT) on int8 pools: decode1 at Hkv = 32 (LLaVA-MPT-7B's
    paged decode), the general kernel for 4-token chunks (Hkv = 32) and for
    MQA (4 query heads over one kv head, the narrow MQA MPT); and the
    general kernel at a 7B engine's width (H = Hkv = 32, chunks of 8 tokens,
    32 pages a slot, int8 pool, plain and ALiBi); and the general kernel's
    rows of more than 8 a kv head (16 heads over one kv head, bf16 and int8
    pools, plain and ALiBi; GQA chunks of 4 tokens). The lines report decode1
    with an int8 pool (the 7B paged engines') and the general kernel at the
    GQA int8 case and at the MQA one, with the largest error over every case
    of the variant."""
    import torch

    runs = {}
    for tag, Hkv, Tq in (("decode1", 32, 1), ("general GQA", 8, 1), ("general chunk", 32, 4)):
        for quantized in (False, True):
            runs[tag, quantized] = check_paged(tag, Hkv, Tq, quantized, gen, rng)
    alibi = {tag: check_paged(tag, Hkv, Tq, True, gen, rng, H=H, alibi=True)
             for tag, H, Hkv, Tq in (("decode1", 32, 32, 1), ("general chunk", 32, 32, 4),
                                     ("general MQA", 4, 1, 1))}
    # decode1 over pages of 32 (a 64-token tile spans two pages), with a slot
    # at its full 2,048 tokens and one of 1 token (its own generator: no
    # earlier row's inputs move)
    gen_p = torch.Generator(device="cuda").manual_seed(4)
    edge = check_paged("decode1", 32, 1, True, gen_p, np.random.default_rng(4), P=32,
                       pages_per_slot=64, edges=True)
    # decode1 at the paged engine's own page list (16 slots of 32 pages of
    # 128, past lengths up to 1,024 as its prompts', a full and a 1-token
    # slot), where its split cuts a slot into more chunks than at 16 pages
    # and most of them start past the slot's length; int8 pool, plain and
    # ALiBi (each its own generator)
    engine = {}
    for alibi_row in (False, True):
        seed = 6 + alibi_row
        engine[alibi_row] = check_paged(
            "decode1 engine", 32, 1, True, torch.Generator(device="cuda").manual_seed(seed),
            np.random.default_rng(seed), pages_per_slot=32, alibi=alibi_row, edges=True,
            max_past=1024)
    # the general kernel at a 7B engine's width: H = Hkv = 32, chunks of 8
    # tokens (a k = 7 speculation's verify step, the longest suffix that
    # takes this kernel), the paged engine's 16 slots x 32 pages of 128,
    # pasts up to 1,024, a full and a 1-token slot; int8 pool, plain and
    # ALiBi (each its own generator)
    wide = {}
    for alibi_row in (False, True):
        seed = 8 + alibi_row
        wide[alibi_row] = check_paged(
            "general 7B", 32, 8, True, torch.Generator(device="cuda").manual_seed(seed),
            np.random.default_rng(seed), pages_per_slot=32, alibi=alibi_row, edges=True,
            max_past=1024)
    # the general kernel where a kv head's query rows are more than one n8
    # tile holds: phase 15's rows of more than 8 (each from phase 15's seed)
    groups = {False: [], True: []}
    for i, (tag, _, H, Hkv, Tq, quantized, alibi_row, pages, edges, max_past) in enumerate(
            GENERAL_ROWS):
        if (H // Hkv) * Tq > 8:
            groups[alibi_row].append(check_paged(
                f"general {tag}", Hkv, Tq, quantized,
                torch.Generator(device="cuda").manual_seed(30 + i),
                np.random.default_rng(30 + i), H=H, pages_per_slot=pages, alibi=alibi_row,
                edges=edges, max_past=max_past))
    d1 = [runs["decode1", qz] for qz in (False, True)] + [edge, engine[False]]
    gen_runs = ([r for (tag, _), r in runs.items() if tag.startswith("general")] + [wide[False]]
                + groups[False])
    return {
        "paged_attention[decode1]": dict(runs["decode1", True],
                                         max_abs_err=max(r["max_abs_err"] for r in d1)),
        "paged_attention[general]": dict(runs["general GQA", True],
                                         max_abs_err=max(r["max_abs_err"] for r in gen_runs)),
        "paged_attention[decode1,alibi]": dict(
            alibi["decode1"], max_abs_err=max(alibi["decode1"]["max_abs_err"],
                                              engine[True]["max_abs_err"])),
        "paged_attention[general,alibi]": dict(
            alibi["general MQA"], max_abs_err=max(alibi["general MQA"]["max_abs_err"],
                                                  alibi["general chunk"]["max_abs_err"],
                                                  wide[True]["max_abs_err"],
                                                  *(r["max_abs_err"] for r in groups[True]))),
    }


def _dq_fault_generator():
    """Generator seed 0 advanced past phase 3's earlier rows as they once
    drew from it, the forward rows at T = 704 and 2048 included: the next
    draw is the one on which the dQ kernel that rounded dS to bf16 read dq
    err 3.199e-2 against the plain version's 1.141e-2."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    D = 128
    decode = [(16, 1, 32, D), (2, 16, 1024, 32, D), (2, 16, 1024, 32, D)]
    draws = ([(2, 768, 32, D)] * 3 + [(2, 768, 32, D), (2, 768, 8, D), (2, 768, 8, D)]
             + decode * 2 + [(2, 704, 32, D)] * 3 + [(2, 2048, 32, D)] * 3
             + [(2, 768, 32, D)] * 3 + decode * 2)
    for shape in draws:
        torch.randn(*shape, generator=gen, device="cuda")
    return gen


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    flash_mha = check_flash("MHA", B=2, T=768, H=32, Hkv=32, pad_tail=100, gen=gen)
    flash_gqa = check_flash("GQA", B=2, T=768, H=32, Hkv=8, pad_tail=100, gen=gen)
    dec_bf16 = check_decode("bf16", B=16, S=1024, H=32, Hkv=32, gen=gen, rng=rng)
    dec_int8 = check_decode("int8", B=16, S=1024, H=32, Hkv=32, gen=gen, rng=rng)
    # the forward's edges: T % 128 = 64 (the last 128-row tile half past T)
    # with a row packed as 3 segments, and the training shape (T = 2048);
    # drawn from a generator of their own, so every earlier row keeps its
    # inputs
    gen_edges = torch.Generator(device="cuda").manual_seed(1)
    flash_ragged = check_flash("MHA", B=2, T=704, H=32, Hkv=32, pad_tail=100, gen=gen_edges,
                               packed=3)
    flash_train = check_flash("MHA", B=2, T=2048, H=32, Hkv=32, pad_tail=100, gen=gen_edges)
    flash = dict(flash_mha, max_abs_err=max(
        r["max_abs_err"] for r in (flash_mha, flash_gqa, flash_ragged, flash_train)))
    # the ALiBi variants at LLaVA-MPT-7B's widths (MHA, 32 heads of 128); the
    # decode line reports the bf16 cache (it has a library call) with the
    # largest error of both caches
    flash_alibi = check_flash("MHA", B=2, T=768, H=32, Hkv=32, pad_tail=100, gen=gen,
                              alibi=True)
    dec_alibi_bf16 = check_decode("bf16", B=16, S=1024, H=32, Hkv=32, gen=gen, rng=rng,
                                  alibi=True)
    dec_alibi_int8 = check_decode("int8", B=16, S=1024, H=32, Hkv=32, gen=gen, rng=rng,
                                  alibi=True)
    # the backward at the 7B stage-2 row length; the lines report MHA (the
    # 7B model's) with the largest error of both
    dkv_mha, dq_mha = check_flash_bwd("MHA", B=2, T=2048, H=32, Hkv=32, gen=gen)
    dkv_gqa, dq_gqa = check_flash_bwd("GQA", B=2, T=2048, H=32, Hkv=8, gen=gen)
    # their ALiBi variants with LLaVA-MPT-7B's 32 slopes at the same row
    # length, MHA (the 7B model's) and MQA (32 heads over one kv head), and a
    # non-causal MQA call (MPT's prefix-LM without a prefix mask), and MQA at
    # T = 1984 (T % 128 = 64: the last 128-row kv tile half past T); the
    # lines report MHA with the largest error of the four
    alibi_bwd = [check_flash_bwd(tag, B=2, T=T, H=32, Hkv=Hkv, gen=g, alibi=True,
                                 causal=causal)
                 for tag, T, Hkv, causal, g in (("MHA", 2048, 32, True, gen),
                                                ("MQA", 2048, 1, True, gen),
                                                ("MQA", 512, 1, False, gen),
                                                ("MQA", 1984, 1, True, gen_edges))]
    # the dense decode kernel for a group wider than one block's 8 rows: 32
    # query heads over one kv head (an MQA MPT), bf16 and int8 caches, with
    # and without slopes; the line reports the bf16 cache without slopes
    # (it has a library call) with the largest error of the four
    wide = [check_decode(tag, B=16, S=1024, H=32, Hkv=1, gen=gen, rng=rng, alibi=alibi)
            for alibi in (False, True) for tag in ("bf16", "int8")]
    # the draw on which the dQ kernel that rounded dS to bf16 erred 2.8x the
    # plain version (on its own generator: no earlier row's inputs move)
    dkv_fault, dq_fault = check_flash_bwd("MHA (the bf16-dS failing draw)", B=2, T=2048, H=32,
                                          Hkv=32, gen=_dq_fault_generator())
    # the dense decode kernel's cache chunks at the engine's shapes (their own
    # generator): batch 1 over S = 2048 (11 chunks a row), and 16 slots of
    # 2048 filled 1-900 (chunks wholly past the query), one of them at fill 1
    # and one whose visible slots all have segment id 0; MHA and G = 32
    gen_dec = torch.Generator(device="cuda").manual_seed(2)
    rng_dec = np.random.default_rng(2)
    short = rng_dec.integers(1, 901, size=16)
    short[0] = 1
    dec_new = {(tag, Hkv, alibi, B): check_decode(
                   tag, B=B, S=2048, H=32, Hkv=Hkv, gen=gen_dec, rng=rng_dec, alibi=alibi,
                   fills=np.array([1700]) if B == 1 else short,
                   masked_row=None if B == 1 else 1)
               for tag, Hkv, alibi, B in (("bf16", 32, False, 1), ("int8", 32, False, 1),
                                          ("bf16", 32, False, 16), ("int8", 32, False, 16),
                                          ("bf16", 1, False, 16), ("int8", 1, True, 16))}

    def worst(row, *more):
        return dict(row, max_abs_err=max(r["max_abs_err"] for r in (row,) + more))

    dec_bf16 = worst(dec_bf16, dec_new["bf16", 32, False, 1], dec_new["bf16", 32, False, 16])
    dec_int8 = worst(dec_int8, dec_new["int8", 32, False, 1], dec_new["int8", 32, False, 16])
    return {"flash_fwd": flash,
            "decode_attention[verify]": phase_verify_decode(),
            "flash_bwd[dkv,alibi]": dict(alibi_bwd[0][0], max_abs_err=max(
                r[0]["max_abs_err"] for r in alibi_bwd)),
            "flash_bwd[dq,alibi]": dict(alibi_bwd[0][1], max_abs_err=max(
                r[1]["max_abs_err"] for r in alibi_bwd)),
            "decode_attention[G>8]": worst(*wide, dec_new["bf16", 1, False, 16],
                                           dec_new["int8", 1, True, 16]),
            "flash_bwd[dkv]": worst(dkv_mha, dkv_gqa, dkv_fault),
            "flash_bwd[dq]": worst(dq_mha, dq_gqa, dq_fault),
            "decode_attention[bf16]": dec_bf16,
            "decode_attention[int8]": dec_int8,
            "flash_fwd[alibi]": flash_alibi,
            "decode_attention[alibi]": dict(dec_alibi_bf16, max_abs_err=max(
                dec_alibi_bf16["max_abs_err"], dec_alibi_int8["max_abs_err"])),
            **phase_quant_kernels(),
            **phase_paged_kernels(gen, rng)}


def phase_verify_decode():
    """The dense decode kernel at the speculative verify chunks (Tq = 2, 5
    and 8 tokens a row: k = 1, 4 and 7 proposals) at 16 slots of 2048, bf16
    and int8 caches, MHA with and without ALiBi, and GQA (G = 4) at Tq = 8,
    on a generator of their own. The line reports the bf16 MHA row at Tq = 8
    (it has a library call) with the largest error of all."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    rows = {(tag, Hkv, alibi, Tq): check_decode(tag, B=16, S=2048, H=32, Hkv=Hkv, gen=gen,
                                                rng=rng, alibi=alibi, Tq=Tq)
            for Tq in VERIFY_TQ for tag in ("bf16", "int8") for alibi in (False, True)
            for Hkv in ((32, 8) if Tq == 8 and not alibi else (32,))}
    head = rows["bf16", 32, False, 8]
    return dict(head, shape="B=16 Tq=8 S=2048 H=32 Hkv=32 bf16",
                max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                **{f"tq{Tq}_{tag}_ms": rows[tag, 32, False, Tq]["ms"]
                   for Tq in VERIFY_TQ for tag in ("bf16", "int8")})


# the verify chunks phase 3 holds the dense decode kernel at (k + 1 tokens
# for k = 1, 4 and 7 proposals)
VERIFY_TQ = (2, 5, 8)


def device_ms(fn, names=None, iters=20, warmup=3, sessions=6):
    """Mean device time of ``fn`` per call in ms, read from ``torch.profiler``:
    the kernels whose name holds one of ``names``, or every device event the
    call launches (``names`` None: a library call's whole work). A session
    in which CUPTI delivered no device event (seen in long runs, three
    sessions in a row once) is taken again, up to ``sessions`` times. A
    named kernel counts as its mean time a launch times its launches a call,
    so a session that lost some of its events still reads the kernel's time
    (the sum over the calls would read it short)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and (names is None or any(n in e.key for n in names))]
        us = sum(e.self_device_time_total for e in events)
        if us <= 0:
            continue
        if names is None:
            return us / iters / 1e3
        if any(e.count % iters for e in events):
            log("device", f"{names}: {[e.count for e in events]} events for {iters} calls "
                          "(some lost); the mean a launch is used")
        return sum(e.self_device_time_total / e.count * max(1, round(e.count / iters))
                   for e in events) / 1e3
    raise AssertionError(f"the profiler saw no device time of {names or 'the call'} "
                         f"in {sessions} sessions")


def _alternated(kernel, names, *others):
    """Kernel-alone and each other call's device ms, taken in turns (kernel,
    the others, the others in reverse, kernel) and averaged, so drift in the
    card's clocks falls on all. An other call is a library call or yardstick
    (all its device work) or a (call, kernel names) pair."""
    others = [o if isinstance(o, tuple) else (o, None) for o in others]
    k1 = device_ms(kernel, names)
    first = [device_ms(f, n) for f, n in others]
    second = [device_ms(f, n) for f, n in reversed(others)][::-1]
    k2 = device_ms(kernel, names)
    return ((k1 + k2) / 2, *((a + b) / 2 for a, b in zip(first, second)))


FWD_KERNEL = ("flash_fwd_kernel",)
DKV_KERNEL = ("flash_bwd_dkv_kernel", "dkv_sum_kernel")
DQ_KERNEL = ("flash_bwd_dq_kernel",)


def phase_device_times(stats):
    """Phase 3's flash rows timed by the kernel's own device time (the host
    path around the wrapper drops out), alternated with the library call in
    one process. Run after every other phase: once a profiler session has
    run, CUPTI may stay attached and slow the host clocks of later phases.
    Adds ``device_ms`` / ``library_device_ms`` to the rows of ``stats``."""
    import torch
    import torch.nn.functional as F
    from llava_plus_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    dev, D, B, H = "cuda", 128, 2, 32
    scale = D ** -0.5
    fwd = {}
    for tag, T, Hkv, alibi in (("MHA", 768, 32, False), ("GQA", 768, 8, False),
                               ("MHA", 768, 32, True), ("MHA", 2048, 32, False)):
        slopes = _slopes(H, alibi)
        q = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
        seg = torch.ones(B, T, dtype=torch.int32, device=dev)
        seg[-1, T - 100:] = 0
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if alibi:
            pos = torch.arange(T, device=dev)
            dist = (pos[:, None] - pos[None, :]).float()
            mask = torch.where(dist >= 0, -dist * slopes[:, None, None], -torch.inf)[None]
            mask = mask.bfloat16()
        kern_ms, lib_ms = _alternated(
            lambda: fa.flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg,
                                       alibi_slopes=slopes),
            FWD_KERNEL,
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   is_causal=not alibi,
                                                   enable_gqa=Hkv != H))
        flops = 4 * H * D * _causal_pairs(seg, True)
        nbytes = 2 * (2 * B * T * H * D + 2 * B * T * Hkv * D) + 4 * B * H * T + 2 * 4 * B * T
        b = bound(nbytes, flops)
        fwd[(tag, T, alibi)] = kern_ms
        log("device", f"flash_fwd{'[alibi]' if alibi else ''} {tag} B={B} T={T}: kernel "
                      f"{kern_ms:.4f} ms device, library (sdpa) {lib_ms:.4f} ms device, "
                      f"x{kern_ms / lib_ms:.2f} of the library, "
                      f"{flops / kern_ms / 1e9:.1f} TFLOP/s, {b['bound_ms'] / kern_ms:.1%} of "
                      f"the bound ({b['bound_ms']:.4f} ms, {b['bound_by']})")
        row = {("MHA", 768, False): "flash_fwd",
               ("MHA", 768, True): "flash_fwd[alibi]"}.get((tag, T, alibi))
        if row:
            stats[row].update(device_ms=kern_ms, library_device_ms=lib_ms)
        del q, k, v, qt, kt, vt, mask
    log("device", f"flash_fwd[alibi] / flash_fwd (MHA, T=768, device): "
                  f"{fwd[('MHA', 768, True)] / fwd[('MHA', 768, False)]:.3f}")

    dkv = {}
    for tag, Hkv, alibi in (("MHA", 32, False), ("GQA", 8, False), ("MHA", 32, True),
                            ("MQA", 1, True)):
        T = 2048
        slopes = _slopes(H, alibi)
        q = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
        do = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
        seg = torch.ones(B, T, dtype=torch.int32, device=dev)
        seg[0, T - 100:] = 0
        seg[1, T // 2:] = 2
        kw = dict(causal=True, sm_scale=scale, alibi_slopes=slopes)
        out, lse = fa._launch(q, k, v, seg, seg, True, scale, slopes)
        delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        mask = None
        if alibi:
            pos = torch.arange(T, device=dev)
            dist = (pos[:, None] - pos[None, :]).float()
            mask = torch.where(dist >= 0, -dist.abs() * slopes[:, None, None], -torch.inf)
            mask = mask[None].bfloat16()
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, is_causal=not alibi,
                                               enable_gqa=Hkv != H)
        g_lib = do.transpose(1, 2).contiguous()
        kern_ms, lib_ms = _alternated(
            lambda: fa.flash_bwd_dkv(q, k, v, do, seg, seg, lse, delta, **kw), DKV_KERNEL,
            lambda: torch.autograd.grad(o_lib, (qt, kt, vt), g_lib, retain_graph=True))
        dq_ms, dq_lib_ms = _alternated(
            lambda: fa.flash_bwd_dq(q, k, v, do, seg, seg, lse, delta, **kw), DQ_KERNEL,
            lambda: torch.autograd.grad(o_lib, (qt, kt, vt), g_lib, retain_graph=True))
        pairs = _causal_pairs(seg, True)
        kv_bytes = 2 * 2 * B * T * Hkv * D
        nbytes = 2 * 2 * B * T * H * D + 2 * kv_bytes + 2 * 4 * B * H * T + 2 * 4 * B * T
        b = bound(nbytes, 8 * D * H * pairs)
        dkv[(tag, alibi)] = kern_ms
        log("device", f"flash_bwd[dkv{',alibi' if alibi else ''}] {tag} B={B} T={T} "
                      f"S={fa.flash_bwd_dkv.last_splits}: kernel {kern_ms:.4f} ms device, "
                      f"library (sdpa backward: dq, dk, dv) {lib_ms:.4f} ms device, "
                      f"x{kern_ms / lib_ms:.2f} of the library, "
                      f"{8 * D * H * pairs / kern_ms / 1e9:.1f} TFLOP/s, "
                      f"{b['bound_ms'] / kern_ms:.1%} of the bound ({b['bound_ms']:.4f} ms); "
                      f"dq kernel {dq_ms:.4f} ms device (library {dq_lib_ms:.4f} in turns with "
                      f"it), x{dq_ms / dq_lib_ms:.2f} of the library, "
                      f"{6 * D * H * pairs / dq_ms / 1e9:.1f} TFLOP/s; dkv + dq "
                      f"x{(kern_ms + dq_ms) / ((lib_ms + dq_lib_ms) / 2):.2f} of the library")
        for kind, k_ms, l_ms in (("dkv", kern_ms, lib_ms), ("dq", dq_ms, dq_lib_ms)):
            row = f"flash_bwd[{kind}{',alibi' if alibi else ''}]"
            if tag == "MHA":
                stats[row].update(device_ms=k_ms, library_device_ms=l_ms)
            elif tag == "MQA":
                stats[row].update(mqa_device_ms=k_ms, mqa_library_device_ms=l_ms)
        del q, k, v, do, out, lse, delta, qt, kt, vt, o_lib, g_lib, mask
    log("device", f"flash_bwd[dkv,alibi] / flash_bwd[dkv] (MHA, T=2048, device): "
                  f"{dkv[('MHA', True)] / dkv[('MHA', False)]:.3f}")
    _device_times_decode(stats, gen)
    for kind in ("int8", "int4"):
        _device_times_quant(stats, kind)
    _device_times_int4n(stats)
    for kind in ("decode1", "general"):
        _device_times_paged(stats, kind)


DECODE_KERNEL = ("decode_kernel",)
# the quantized kernels of this tree and of an older one (--device-times ROOT:
# before its redesign each product ran quant_matmul_kernel)
INT8_KERNEL = ("int8_stream_kernel", "int8_wgmma_kernel", "quant_matmul_kernel")
INT4_KERNEL = ("int4_stream_kernel", "int4_wgmma_kernel", "quant_matmul_kernel")
INT4N_KERNEL = ("int4n_stream_kernel", "int4n_wgmma_kernel", "quant_matmul_kernel")
INT4_SIBLING = INT4_KERNEL[:2]   # the split-half kernels alone, beside the native one
# the native rows also timed with L2 flushed before every call, as a model's
# decode step finds each weight (its layers' weights pass through L2 in turn):
# a write of L2_FLUSH_BYTES (twice the H100's 50 MB L2, at least), whose
# kernel is not among the timed names
INT4N_COLD = ("13B down", "7B q/o")
L2_FLUSH_BYTES = 128 * 2 ** 20
DECODE1_KERNEL = ("paged_decode1_kernel",)
GENERAL_KERNEL = ("paged_general_kernel",)


# the quantized rows timed beside the bf16 yardstick in phase 15, and the
# key their times take in the kernel's stats row
YARD_ROWS = {("wqkv", 16): "", ("wqkv", 768): "r768_", ("wqkv", 3072): "r3072_",
             ("w_down", 8192): "w_down_r8192_"}


def _quant_cases(kind):
    """Phase 3's int8 or int4 shapes and rows, one at a time, from their own
    seed: (row name, R, K, N, out dtype, the wrapper's call, x, the bf16
    weight for the yardstick where YARD_ROWS has the shape, else None, the
    weight's bytes, the shape's name)."""
    import torch
    from llava_plus_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(2 if kind == "int8" else 3)
    wrapper = qm.matmul_int8 if kind == "int8" else qm.matmul_int4
    bits = 8 if kind == "int8" else 4
    for name, K, N in QUANT_SHAPES + MPT_QUANT_SHAPES:
        q, s = _quantize(kind, torch.randn(K, N, generator=gen, device="cuda").mul_(0.02)
                         .bfloat16())
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        yard = any(n == name for n, _ in YARD_ROWS)
        w16 = qm.dequantize(bits, q, s, torch.bfloat16) if yard else None
        for R in (INT8_ROWS if kind == "int8" else INT4_ROWS):
            x = torch.randn(R, K, generator=gen, device="cuda").bfloat16()
            yield (f"{name} R={R}", R, K, N, out_dtype,
                   lambda: wrapper(x, q, s, out_dtype=out_dtype), x, w16,
                   q.numel() + 4 * s.numel(), name)
        del q, s, w16


def _device_times_quant(stats, kind):
    """The int8 or int4 matmul at phase 3's shapes and rows, the kernel
    alone; on LLaVA-1.5-7B's wqkv at 16 decode slots, a 768-token prefill
    and the engine's 4-prompt prefill (3,072 rows), and (int4) on w_down at
    QLoRA's 8,192 rows, alternated with the yardstick, ``torch.matmul`` on
    the same weight dequantized to bf16."""
    import torch
    from llava_plus_torch.ops import quant_matmul as qm

    names = INT8_KERNEL if kind == "int8" else INT4_KERNEL
    wrapper = qm.matmul_int8 if kind == "int8" else qm.matmul_int4
    rows = stats.setdefault(f"{kind} rows", {})
    for row, R, K, N, out_dtype, call, x, w16, wbytes, name in _quant_cases(kind):
        yard = (name, R) in YARD_ROWS
        if yard:
            kern_ms, yard_ms = _alternated(call, names, lambda: torch.matmul(x, w16))
        else:
            kern_ms = (device_ms(call, names) + device_ms(call, names)) / 2
        out_bytes = R * N * (4 if out_dtype == torch.float32 else 2)
        b = bound(wbytes + 2 * R * K + out_bytes, 2 * R * K * N)
        rows.setdefault(row, {}).update(device_ms=kern_ms, **b)
        vs = (f", yardstick (bf16 matmul) {yard_ms:.4f} ms device, "
              f"x{kern_ms / yard_ms:.2f} of the yardstick" if yard else "")
        log("device", f"quant_matmul[{kind}] {row} K={K} N={N} "
                      f"({getattr(wrapper, 'last_plan', None)}): kernel "
                      f"{kern_ms:.4f} ms device{vs}, "
                      f"{2 * R * K * N / kern_ms / 1e9:.1f} TFLOP/s, "
                      f"{wbytes / kern_ms / 1e6:.1f} GB/s of weights, "
                      f"{b['bound_ms'] / kern_ms:.1%} of the bound ({b['bound_ms']:.4f} ms, "
                      f"{b['bound_by']})")
        if yard:
            key = YARD_ROWS[name, R]
            stats[f"quant_matmul[{kind}]"].update({f"{key}device_ms": kern_ms,
                                                   f"{key}yardstick_device_ms": yard_ms})


def _int4n_cases():
    """Phase 3's native-int4 shapes (the int4 tools' five) and rows, one at a
    time, from their own seed: (shape name, R, K, N, x, the native weight and
    scales, the split-half weight and scales of the same values, the bf16
    weight for the yardstick, the weight's bytes). The two quantizers must
    give the same values and scales."""
    import torch
    from llava_plus_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, K, N in INT4N_SHAPES:
        w = torch.randn(K, N, generator=gen, device="cuda").mul_(0.02).bfloat16()
        qn, sn = _quantize("int4n", w)
        qs, ss = _quantize("int4", w)
        del w
        if not (torch.equal(sn, ss)
                and torch.equal(qm.unpack_int4_native(qn), qm.unpack_int4(qs).reshape(K, N))):
            raise AssertionError(f"{name}: the native and split-half quantizers disagree")
        w16 = _dequant16("int4n", qn, sn)
        for R in INT4N_ROWS:
            x = torch.randn(R, K, generator=gen, device="cuda").bfloat16()
            yield name, R, K, N, x, (qn, sn), (qs, ss), w16, qn.numel() + 4 * sn.numel()
        del qn, sn, qs, ss, w16


def _device_times_int4n(stats):
    """The native int4 matmul at phase 3's tool shapes and rows, the kernel
    alone, alternated with its split-half sibling (``matmul_int4``, f32 out)
    on the same values and scales; on 7B q/o at 16 rows also with
    ``torch._weight_int4pack_mm`` (the values repacked, as phase 3 checks
    them), at 768 and 3,072 rows with the bf16 yardstick. The INT4N_COLD
    shapes at 16 rows are taken again with L2 flushed before every call of
    either kernel. The bound counts HBM bytes: the tools' shapes fit in L2
    (10.9-45.3 MB at 16 rows), so a warm time can beat it."""
    import torch
    from llava_plus_torch.ops import quant_matmul as qm

    rows = stats.setdefault("int4n rows", {})
    head = stats["quant_matmul[int4n]"]
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for name, R, K, N, x, (qn, sn), (qs, ss), w16, wbytes in _int4n_cases():
        row = f"{name} R={R}"
        native = lambda: qm.matmul_int4_native(x, qn, sn)
        sibling = lambda: qm.matmul_int4(x, qs, ss, out_dtype=torch.float32)
        others = [(sibling, INT4_SIBLING)]
        library = row == "7B q/o R=16"
        if library:
            others.append(_library_call("int4n", qn, sn, x)[0])
        if R in (768, 3072):
            others.append(lambda: torch.matmul(x, w16))
        kern_ms, sib_ms, *more = _alternated(native, INT4N_KERNEL, *others)
        b = bound(wbytes + 2 * R * K + 4 * R * N, 2 * R * K * N)
        rows.setdefault(row, {}).update(device_ms=kern_ms, sibling_device_ms=sib_ms, **b)
        vs = f", library (int4pack_mm) {more[0]:.4f} ms device" if library else ""
        if R in (768, 3072):
            rows[row]["yardstick_device_ms"] = more[0]
            vs = (f", yardstick (bf16 matmul) {more[0]:.4f} ms device "
                  f"({2 * R * K * N / more[0] / 1e9:.1f} TFLOP/s; the kernel "
                  f"x{kern_ms / more[0]:.2f} of it)")
        log("device", f"quant_matmul[int4n] {row} K={K} N={N} "
                      f"({getattr(qm.matmul_int4_native, 'last_plan', None)}): kernel "
                      f"{kern_ms:.4f} ms device, split-half {sib_ms:.4f} ms device "
                      f"(x{kern_ms / sib_ms:.3f}){vs}, "
                      f"{2 * R * K * N / kern_ms / 1e9:.1f} TFLOP/s, "
                      f"{wbytes / kern_ms / 1e6:.1f} GB/s of weights, "
                      f"{b['bound_ms'] / kern_ms:.1%} of the bound ({b['bound_ms']:.4f} ms, "
                      f"{b['bound_by']}; L2 warm)")
        if library:
            head.update(device_ms=kern_ms, sibling_device_ms=sib_ms, library_device_ms=more[0])
        elif name == "7B q/o" and R in (768, 3072):
            head.update({f"r{R}_device_ms": kern_ms, f"r{R}_yardstick_device_ms": more[0]})
        if R == 16 and name in INT4N_COLD:
            def cold(f):
                return lambda: (flush.fill_(1.0), f())
            cold_ms, cold_sib = _alternated(cold(native), INT4N_KERNEL,
                                            (cold(sibling), INT4_SIBLING))
            rows[row].update(cold_device_ms=cold_ms, cold_sibling_device_ms=cold_sib)
            log("device", f"quant_matmul[int4n] {row} K={K} N={N}, L2 flushed before every "
                          f"call: kernel {cold_ms:.4f} ms device, split-half {cold_sib:.4f} ms "
                          f"device (x{cold_ms / cold_sib:.3f}), {b['bound_ms'] / cold_ms:.1%} "
                          f"of the bound ({b['bound_ms']:.4f} ms, bytes; split-half "
                          f"{b['bound_ms'] / cold_sib:.1%})")
            head[f"cold_device_ms[{name}]"] = cold_ms


# phase 3's decode1 rows, all on int8 pools but the first: (tag, stats row,
# ALiBi, page size, pages a slot, edges, largest past length)
DECODE1_ROWS = (
    ("bf16", None, False, 128, 16, False, None),
    ("int8", "paged_attention[decode1]", False, 128, 16, False, None),
    ("int8 alibi", "paged_attention[decode1,alibi]", True, 128, 16, False, None),
    ("int8 P=32", None, False, 32, 64, True, None),
    ("int8 engine", None, False, 128, 32, True, 1024),
    ("int8 engine alibi", None, True, 128, 32, True, 1024),
)


def _decode1_cases():
    """Phase 3's decode1 rows (16 slots, a dead slot), one at a time, each
    from its own seed: (tag, stats row, the wrapper's call, P, pages a
    slot, past lengths, page bytes, bound)."""
    import torch
    from llava_plus_torch.ops import paged_attention as pa

    B, H = 16, 32
    for i, (tag, row, alibi, P, pages, edges, max_past) in enumerate(DECODE1_ROWS):
        quantized = tag.startswith("int8")
        (q, pool, scale, page_ids, lens, ck, cv, vals), lengths, valid = _paged_inputs(
            H, 1, quantized, torch.Generator(device="cuda").manual_seed(10 + i),
            np.random.default_rng(10 + i), B, H, P, pages, edges, max_past)
        slopes = _slopes(H, alibi)
        page_bytes, b = _paged_bound(lengths, valid, B, H, H, 1, P, quantized,
                                     pool.element_size())
        yield (tag, row, lambda: pa.paged_decode_attention(
            q, pool, page_ids, lens, scale, ck, cv, vals, alibi_slopes=slopes),
            P, pages, lengths, page_bytes, b)
        del q, pool, scale, page_ids, lens, ck, cv, vals


# phase 3's general rows: (tag, stats row, H, Hkv, Tq, int8 pool, ALiBi,
# pages a slot, edges, largest past length)
GENERAL_ROWS = (
    ("GQA bf16", None, 32, 8, 1, False, False, 16, False, None),
    ("GQA int8", "paged_attention[general]", 32, 8, 1, True, False, 16, False, None),
    ("chunk bf16", None, 32, 32, 4, False, False, 16, False, None),
    ("chunk int8", None, 32, 32, 4, True, False, 16, False, None),
    ("chunk int8 alibi", None, 32, 32, 4, True, True, 16, False, None),
    ("MQA int8 alibi", "paged_attention[general,alibi]", 4, 1, 1, True, True, 16, False, None),
    ("7B Tq=8 int8", None, 32, 32, 8, True, False, 32, True, 1024),
    ("7B Tq=8 int8 alibi", None, 32, 32, 8, True, True, 32, True, 1024),
    # a kv head's rows past one n8 tile: the wide MQA MPT's 16 heads over one
    # kv head, and GQA chunks of 4 tokens (4 x 4 rows)
    ("MQA16 bf16", None, 16, 1, 1, False, False, 16, False, None),
    ("MQA16 int8", None, 16, 1, 1, True, False, 16, False, None),
    ("MQA16 bf16 alibi", None, 16, 1, 1, False, True, 16, False, None),
    ("MQA16 int8 alibi", None, 16, 1, 1, True, True, 16, False, None),
    ("GQA chunk int8", None, 32, 8, 4, True, False, 16, False, None),
)


def _general_cases():
    """Phase 3's general rows (16 slots, a dead slot), one at a time, each
    from its own seed: (tag, stats row, the wrapper's call, Tq, pages a
    slot, past lengths, page bytes, bound)."""
    import torch
    from llava_plus_torch.ops import paged_attention as pa

    B, P = 16, 128
    for i, (tag, row, H, Hkv, Tq, quantized, alibi, pages, edges, max_past) in enumerate(
            GENERAL_ROWS):
        (q, pool, scale, page_ids, lens, ck, cv, vals), lengths, valid = _paged_inputs(
            Hkv, Tq, quantized, torch.Generator(device="cuda").manual_seed(30 + i),
            np.random.default_rng(30 + i), B, H, P, pages, edges, max_past)
        slopes = _slopes(H, alibi)
        page_bytes, b = _paged_bound(lengths, valid, B, H, Hkv, Tq, P, quantized,
                                     pool.element_size())
        yield (tag, row, lambda: pa.paged_decode_attention(
            q, pool, page_ids, lens, scale, ck, cv, vals, alibi_slopes=slopes),
            Tq, pages, lengths, page_bytes, b)
        del q, pool, scale, page_ids, lens, ck, cv, vals


def _device_times_paged(stats, kind):
    """Phase 3's decode1 or general rows, the kernel alone, taken twice (no
    library call reads a paged pool)."""
    from llava_plus_torch.ops import paged_attention as pa

    cases, names, wrapper = ((_decode1_cases, DECODE1_KERNEL, pa.paged_decode1)
                             if kind == "decode1" else
                             (_general_cases, GENERAL_KERNEL, pa.paged_attention_general))
    rows = stats.setdefault(f"{kind} rows", {})
    for tag, row, kernel, arg, pages, lengths, page_bytes, b in cases():
        kern_ms = (device_ms(kernel, names) + device_ms(kernel, names)) / 2
        log("device", f"paged_attention[{kind}] {tag} B=16 "
                      f"{'P' if kind == 'decode1' else 'Tq'}={arg} pages/slot={pages} "
                      f"(mean past {lengths[:-1].mean():.0f}; "
                      f"{getattr(wrapper, 'last_splits', 1)} chunks a slot): kernel "
                      f"{kern_ms:.4f} ms device, {page_bytes / kern_ms / 1e6:.1f} GB/s of pages "
                      f"read, {b['bound_ms'] / kern_ms:.1%} of the bound "
                      f"({b['bound_ms']:.4f} ms, {b['bound_by']})")
        rows.setdefault(tag, {}).update(device_ms=kern_ms, **b)
        if row:
            stats[row].update(device_ms=kern_ms)


def wrapper_times(stats):
    """Phase 3's int8, int4, native int4, decode1 and general rows timed
    through their wrappers (CUDA events over 20 back-to-back calls, so the host path counts
    where it is longer than the kernel), before any profiler session can
    slow the host clocks: the A/B of ``--device-times``, where phase 3 does
    not run."""
    from llava_plus_torch.ops import quant_matmul as qm

    for kind in ("int8", "int4"):
        rows = stats.setdefault(f"{kind} rows", {})
        for row, R, K, N, out_dtype, call, *_ in _quant_cases(kind):
            rows.setdefault(row, {})["wrapper_ms"] = ms = time_ms(call)
            log("wrapper", f"quant_matmul[{kind}] {row} K={K} N={N}: {ms:.4f} ms")
    rows = stats.setdefault("int4n rows", {})
    for name, R, K, N, x, (qn, sn), *_ in _int4n_cases():
        rows.setdefault(f"{name} R={R}", {})["wrapper_ms"] = ms = time_ms(
            lambda: qm.matmul_int4_native(x, qn, sn))
        log("wrapper", f"quant_matmul[int4n] {name} R={R} K={K} N={N}: {ms:.4f} ms")
    for kind, cases in (("decode1", _decode1_cases), ("general", _general_cases)):
        rows = stats.setdefault(f"{kind} rows", {})
        for tag, row, kernel, arg, pages, *_ in cases():
            rows.setdefault(tag, {})["wrapper_ms"] = ms = time_ms(kernel)
            log("wrapper", f"paged_attention[{kind}] {tag} pages/slot={pages}: {ms:.4f} ms")


def _device_times_decode(stats, gen):
    """Phase 3's dense-decode rows (16 slots of 1024: bf16, int8, ALiBi bf16,
    G = 32; batch 1 over 2048 filled to 1700; and the verify chunk of 8
    tokens at 16 slots of 2048, bf16 and int8), the kernel alone
    alternated with ``scaled_dot_product_attention`` over the same bf16
    cache and masks (an int8 cache has no library call: the kernel alone,
    taken twice)."""
    from llava_plus_torch.ops.decode_attention import decode_attention

    rng = np.random.default_rng(3)
    for name, tag, B, S, Hkv, alibi, fills, Tq, key in (
            ("decode_attention[bf16]", "bf16", 16, 1024, 32, False, None, 1, ""),
            ("decode_attention[int8]", "int8", 16, 1024, 32, False, None, 1, ""),
            ("decode_attention[alibi]", "bf16", 16, 1024, 32, True, None, 1, ""),
            ("decode_attention[G>8]", "bf16", 16, 1024, 1, False, None, 1, ""),
            ("decode_attention[bf16]", "bf16", 1, 2048, 32, False, np.array([1700]), 1, "b1_"),
            ("decode_attention[verify]", "bf16", 16, 2048, 32, False, None, 8, ""),
            ("decode_attention[verify]", "int8", 16, 2048, 32, False, None, 8, "int8_")):
        H = 32
        slopes = _slopes(H, alibi)
        q, kc, vc, seg, q_pos, ks, vs, fills = _decode_inputs(tag, B, S, H, Hkv, gen, rng, fills,
                                                              Tq=Tq)
        kernel = lambda: decode_attention(q, kc, vc, seg, q_pos, ks, vs, alibi_slopes=slopes)
        if ks is None:
            kern_ms, lib_ms = _alternated(kernel, DECODE_KERNEL,
                                          _decode_library(q, kc, vc, q_pos, slopes))
        else:
            kern_ms, lib_ms = (device_ms(kernel, DECODE_KERNEL)
                               + device_ms(kernel, DECODE_KERNEL)) / 2, None
        nbytes, b = _decode_bound(fills, B, H, Hkv, S, kc.element_size(), ks is not None, Tq)
        lib = "none" if lib_ms is None else (f"{lib_ms:.4f} ms device, "
                                             f"x{kern_ms / lib_ms:.2f} of the library")
        log("device", f"{name} {tag} B={B} Tq={Tq} S={S} H={H} Hkv={Hkv} (mean fill "
                      f"{fills.mean():.0f}; {getattr(decode_attention, 'last_splits', 1)} chunks "
                      f"a row): kernel {kern_ms:.4f} ms device, library (sdpa) {lib}, "
                      f"{nbytes / kern_ms / 1e6:.1f} GB/s of cache read, "
                      f"{b['bound_ms'] / kern_ms:.1%} of the bound ({b['bound_ms']:.4f} ms, "
                      f"{b['bound_by']})")
        stats[name].update({f"{key}device_ms": kern_ms, f"{key}library_device_ms": lib_ms})
        del q, kc, vc, seg, q_pos, ks, vs


# ---------------------------------------------------------------------------
# 4. the kernels inside a narrow model, card against CPU
# ---------------------------------------------------------------------------

def _narrow_cfg():
    """A narrow LLaVA: LLaMA hidden 512 with head dim 128 (4 query heads over
    2 kv heads), 2 layers, vocab 32000; a 2-layer CLIP tower on 28 px."""
    from llava_plus_torch.models.configs import ClipVisionConfig, LlamaConfig, LlavaConfig

    return LlavaConfig(
        text=LlamaConfig(vocab_size=32000, hidden_size=512, intermediate_size=1024,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2),
        vision=ClipVisionConfig(hidden_size=64, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=2,
                                image_size=28, patch_size=14),
        mm_hidden_size=64, max_sequence_length=1024,
    )


def phase_narrow_model():
    import torch
    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.generate import Generator
    from llava_plus_torch.models import llama, llava as llava_model
    from llava_plus_torch.ops import quant
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention

    cfg = _narrow_cfg()
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

    # Quantized weights (fused as the worker fuses them; this GQA model keeps
    # wq/wk/wv apart, so 6 products a layer and the head): the same quantized
    # tree on both sides. The CPU's plain product rounds each dequantized
    # weight to bf16 where the int8 kernel multiplies the exact int8 values
    # and applies the f32 scale after the sum, so the bound is 3% there.
    variants = [("bf16 weights, bf16 KV", None, torch.bfloat16, tol),
                ("bf16 weights, int8 KV", None, torch.int8, tol),
                ("int8 weights, bf16 KV", 8, torch.bfloat16, 3e-2),
                ("int4 weights, bf16 KV", 4, torch.bfloat16, 3e-2)]
    for name, bits, cache_dtype, limit in variants:
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
            logits[dev], T = _step_logits(cfg, g, params, dev, prompt, ids["cpu"])
        ratios = [(c - g).abs().max().item() / c.abs().max().item()
                  for c, g in zip(logits["cpu"], logits["cuda"])]
        margins = [c.topk(2).values[0] for c in logits["cpu"]]
        min_margin = min((m[0] - m[1]).item() / m[0].abs().item() for m in margins)
        log("narrow", f"{name}, T={T}: greedy tokens equal={ids['cuda'] == ids['cpu']} "
                      f"({len(ids['cpu'])} tokens); logits max diff / max |logit|: "
                      f"prefill {ratios[0]:.3e}, decode steps up to {max(ratios[1:]):.3e} "
                      f"(bound {limit}); smallest top-2 margin {min_margin:.3f} of the top logit")
        if ids["cuda"] != ids["cpu"]:
            raise AssertionError(f"greedy tokens differ: {ids['cuda']} vs {ids['cpu']}")
        if max(ratios) > limit:
            raise AssertionError(f"logits differ beyond the tolerance ({name})")
    return phase_narrow_paged(cfg, cpu_params, tok, prompt, new, tol)


def _step_logits(cfg, g, params, dev, prompt, tokens):
    """Prefill logits of ``prompt`` through the generator ``g``, then those of
    each decode step fed ``tokens``, over a dense cache of 1024."""
    import torch
    from llava_plus_torch.models import llama, llava as llava_model

    batch, plan = g.prepare_batch([prompt])
    cache = llama.KVCache.create(llava_model.backbone(cfg)[1], 1, 1024, g.cache_dtype,
                                 device=dev)
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


def _paged_steps(cfg, params, tok, prompt, dev, cache_dtype, n, feed=None):
    """A prefill into a paged cache (page size 128, the slot's 8 pages
    scattered over a pool of 11), then ``n - 1`` decode steps, each fed
    ``feed`` (or its own greedy token). Returns the logits of every step and
    the greedy token of each."""
    import torch
    from llava_plus_torch.generate import prepare_multimodal_request
    from llava_plus_torch.models import llama, llava as llava_model

    P, S = 128, 1024
    cache = llama.PagedKVCache.create(llava_model.backbone(cfg)[1], 1, num_pages=11,
                                      max_pages_per_slot=S // P, page_size=P,
                                      dtype=cache_dtype, device=dev)
    cache.page_table[0] = torch.tensor([9, 2, 7, 0, 5, 10, 3, 1], dtype=torch.int32)
    batch, plan = prepare_multimodal_request(cfg, tok, [prompt], None, max_seq_len=S,
                                             device=dev, prefill_bucket=P)
    n0 = int(plan.lengths[0])
    seg = torch.ones(1, 1, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        logits, _ = llava_model.forward(params, cfg, batch, cache=cache, fresh_prefill=True,
                                        logits_positions=torch.tensor([n0 - 1], device=dev))
        out = [logits[:, 0].float().cpu()]
        for i in range(n - 1):
            t = feed[i] if feed is not None else int(out[-1].argmax())
            logits, _ = llava_model.decode_step(
                params, cfg, torch.tensor([[t]], device=dev),
                torch.tensor([[n0 + i]], dtype=torch.int32, device=dev), seg, cache)
            out.append(logits[:, 0].float().cpu())
    return out, [int(x.argmax()) for x in out]


def phase_narrow_paged(cfg, cpu_params, tok, prompt, new, tol):
    """The narrow model over a paged KV cache, card against CPU, with a bf16
    and an int8 pool: the CPU's greedy tokens are fed to both, the logits of
    the prefill and of every decode step compared against ``tol`` of the
    largest logit, and the card's own greedy tokens against the CPU's. Its 4
    query heads over 2 kv heads take the general paged kernel. Returns the
    general kernel's launches on this path."""
    import torch
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.ops.paged_attention import paged_attention_general, paged_decode1

    L = cfg.text.num_hidden_layers
    cuda_params = _tree_to(cpu_params, "cuda")
    total = 0
    for name, cache_dtype in (("paged bf16 KV", torch.bfloat16), ("paged int8 KV", torch.int8)):
        cpu_logits, cpu_ids = _paged_steps(cfg, cpu_params, tok, prompt, "cpu", cache_dtype, new)
        flash_attention.launches = paged_attention_general.launches = paged_decode1.launches = 0
        logits, ids = _paged_steps(cfg, cuda_params, tok, prompt, "cuda", cache_dtype, new,
                                   feed=cpu_ids)
        launched = (flash_attention.launches, paged_attention_general.launches,
                    paged_decode1.launches)
        if launched != (L, (new - 1) * L, 0):
            raise AssertionError(f"narrow model ({name}) launches {launched}, want "
                                 f"{(L, (new - 1) * L, 0)}")
        total += launched[1]
        ratios = [(c - g).abs().max().item() / c.abs().max().item()
                  for c, g in zip(cpu_logits, logits)]
        log("narrow", f"bf16 weights, {name}: greedy tokens equal={ids == cpu_ids} ({new} "
                      f"steps); logits max diff / max |logit|: prefill {ratios[0]:.3e}, decode "
                      f"steps up to {max(ratios[1:]):.3e} (bound {tol}); flash +{launched[0]}, "
                      f"paged general +{launched[1]}")
        if ids != cpu_ids:
            raise AssertionError(f"greedy tokens differ ({name}): {ids} vs {cpu_ids}")
        if max(ratios) > tol:
            raise AssertionError(f"logits differ beyond the tolerance ({name})")
    return total


def _narrow_mpt_cfg(multiquery, n_heads=4):
    """A narrow LLaVA-MPT: head dim 128 (``n_heads`` heads over as many kv
    heads, or over one with ``multiquery``; d_model 512 at 4 heads), 2
    layers, vocab 50432, ALiBi; a 2-layer CLIP tower on 28 px and a linear
    projector."""
    from llava_plus_torch.models.configs import ClipVisionConfig, LlavaConfig, MptConfig

    return LlavaConfig(
        language_model_type="mpt",
        mpt=MptConfig(vocab_size=50432, d_model=128 * n_heads, n_layers=2, n_heads=n_heads,
                      expansion_ratio=4, multiquery=multiquery),
        vision=ClipVisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                                num_attention_heads=2, image_size=28, patch_size=14),
        mm_hidden_size=64, mm_projector_type="linear", max_sequence_length=1024,
    )


def phase_narrow_mpt():
    """The ALiBi kernels inside a narrow MPT (``_narrow_mpt_cfg``), card
    against the same weights on the CPU plain path, in both forms: MHA (the
    dense decode kernel at G = 1, paged decode1) and MQA (G = 4: the dense
    decode kernel's group, the general paged kernel). Through ``Generator``:
    bf16 weights with a bf16 and an int8 KV cache, and int8 weights (the
    four MPT matrices of each layer), 16 greedy tokens with every ALiBi
    launch counted; then the logits of the prefill and of every decode step,
    both sides fed the CPU's greedy tokens, within 2% of the largest logit
    (3% with int8 weights, as phase 4's LLaMA). Then over a paged cache,
    bf16 and int8 pools, the same way. The head is tied to the random
    embeddings, so top-2 margins are ~0.2% of the top logit, below bf16
    GEMM noise: the card's own greedy tokens may split from the CPU's on a
    near tie and are reported, not required equal. The logits check is
    sensitive: on the CPU, dropping ALiBi, flipping its sign or shifting the
    slopes by one head moves them by more than the top logit. Last, a wide
    MQA MPT (16 heads over one kv head, d_model 2048: a group of 16, two
    blocks of 8 query rows per kv head in the dense decode kernel) with bf16
    weights over a dense bf16 and int8 cache and over both pools, the same
    way. Returns the
    ALiBi launches of the dense decode, decode1 and general kernels, and
    the wide-group launches of the dense decode kernel."""
    import torch
    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.generate import Generator
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.ops import quant
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.ops.paged_attention import paged_attention_general, paged_decode1

    prompt = " ".join(f"token{i}" for i in range(320))
    new, tol = 16, 2e-2
    totals = {"decode": 0, "decode1": 0, "general": 0, "wide": 0}
    for multiquery, n_heads in ((False, 4), (True, 4), (True, 16)):
        cfg = _narrow_mpt_cfg(multiquery, n_heads)
        wide = n_heads > 8
        form = f"MQA {n_heads} heads" if wide else "MQA" if multiquery else "MHA"
        L = cfg.mpt.n_layers
        tok = DebugTokenizer(vocab_size=cfg.mpt.vocab_size)
        tok.bos_token_id = None   # GPT-NeoX style, as MPT's tokenizer
        cpu_params = llava_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        variants = (("bf16 weights, bf16 KV", None, torch.bfloat16, tol),
                    ("bf16 weights, int8 KV", None, torch.int8, tol),
                    ("int8 weights, int8 KV", 8, torch.int8, 3e-2))
        for name, bits, cache_dtype, limit in variants[:2] if wide else variants:
            cpu_tree = cpu_params
            if bits:
                cpu_tree = quant.quantize_llava_params(copy.deepcopy(cpu_params), "mpt",
                                                       bits=bits, fuse=True)
            ids, logits = {}, {}
            for dev, params in (("cpu", cpu_tree), ("cuda", _tree_to(cpu_tree, "cuda"))):
                g = Generator(params, cfg, tok, device=dev, max_seq_len=1024,
                              cache_dtype=cache_dtype)
                counters = (flash_attention, decode_attention, qm.matmul_int8)
                for k in counters:
                    k.launches = k.alibi_launches = 0
                decode_attention.wide_launches = 0
                for _ in g.stream(prompt, max_new_tokens=new):
                    pass
                ids[dev] = list(g._last_output_ids)
                if dev == "cuda":
                    steps = len(ids[dev]) - 1 if len(ids[dev]) == new else len(ids[dev])
                    got = (flash_attention.alibi_launches, decode_attention.alibi_launches,
                           decode_attention.wide_launches, qm.matmul_int8.launches,
                           flash_attention.launches, decode_attention.launches)
                    want = (L, 0 if wide else steps * L, steps * L if wide else 0,
                            (steps + 1) * 4 * L if bits else 0, 0, 0)
                    if got != want:
                        raise AssertionError(f"narrow MPT {form} ({name}): launches {got}, "
                                             f"want {want}")
                    totals["decode"] += got[1]
                    totals["wide"] += got[2]
                logits[dev], T = _step_logits(cfg, g, params, dev, prompt, ids["cpu"])
            ratios = [(c - g).abs().max().item() / c.abs().max().item()
                      for c, g in zip(logits["cpu"], logits["cuda"])]
            margins = [c.topk(2).values[0] for c in logits["cpu"]]
            min_margin = min((m[0] - m[1]).item() / m[0].abs().item() for m in margins)
            log("narrow", f"MPT {form}, {name}, T={T}: greedy tokens equal="
                          f"{ids['cuda'] == ids['cpu']} ({len(ids['cpu'])} tokens); logits max "
                          f"diff / max |logit|: prefill {ratios[0]:.3e}, decode steps up to "
                          f"{max(ratios[1:]):.3e} (bound {limit}); smallest top-2 margin "
                          f"{min_margin:.3f} of the top logit")
            if max(ratios) > limit:
                raise AssertionError(f"logits differ beyond the tolerance (MPT {form}, {name})")
        cuda_params = _tree_to(cpu_params, "cuda")
        paged_kernel = paged_attention_general if multiquery else paged_decode1
        for name, cache_dtype in (("paged bf16 KV", torch.bfloat16),
                                  ("paged int8 KV", torch.int8)):
            cpu_logits, cpu_ids = _paged_steps(cfg, cpu_params, tok, prompt, "cpu", cache_dtype,
                                               new)
            for k in (flash_attention, paged_decode1, paged_attention_general):
                k.launches = k.alibi_launches = 0
            logits, ids = _paged_steps(cfg, cuda_params, tok, prompt, "cuda", cache_dtype, new,
                                       feed=cpu_ids)
            got = (flash_attention.alibi_launches, paged_kernel.alibi_launches,
                   paged_decode1.launches + paged_attention_general.launches
                   + (paged_decode1 if multiquery else paged_attention_general).alibi_launches)
            if got != (L, (new - 1) * L, 0):
                raise AssertionError(f"narrow MPT {form} ({name}) launches {got}, want "
                                     f"{(L, (new - 1) * L, 0)}")
            totals["general" if multiquery else "decode1"] += got[1]
            ratios = [(c - g).abs().max().item() / c.abs().max().item()
                      for c, g in zip(cpu_logits, logits)]
            log("narrow", f"MPT {form}, bf16 weights, {name}: greedy tokens equal="
                          f"{ids == cpu_ids} ({new} steps); logits max diff / max |logit|: "
                          f"prefill {ratios[0]:.3e}, decode steps up to {max(ratios[1:]):.3e} "
                          f"(bound {tol}); flash[alibi] +{got[0]}, "
                          f"{paged_kernel.__name__}[alibi] +{got[1]}")
            if max(ratios) > tol:
                raise AssertionError(f"logits differ beyond the tolerance (MPT {form}, {name})")
    return totals


def _tree_to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.to(device, dtype)


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
# 16. a 7B checkpoint on disk, through the loader and the entry points
# ---------------------------------------------------------------------------

CKPT_NAME = "llava-v1.5-7b-random"
WORKER_FLAGS = ["--load-8bit", "--kv-int8", "--max-slots", "16",
                "--limit-model-concurrency", "16"]


def _word_tokenizer(vocab_size):
    """A word-level fast tokenizer made here (no download) that names every
    id of the model ("<unk>", "w1", ... "w31999"), so two greedy texts
    compare token for token. Its EOS is an added token past the model's
    logits: on random weights every stream runs its full budget, as phase
    6's ``eos_token_id = -1`` makes it."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<unk>": 0, **{f"w{i}": i for i in range(1, vocab_size)}}
    core = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    core.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=core, unk_token="<unk>", eos_token="</s>")


def _in_vocab(bodies, vocab_size):
    """Phase 6's bodies with each prompt word swapped for a word of the
    checkpoint's tokenizer (the same count of tokens)."""
    n = 0
    for b in bodies:
        lines = []
        for line in b["prompt"].split("\n"):
            words = []
            for w in line.split(" "):
                if w and w != "<image>":
                    n += 1
                    w = f"w{1 + (n * 7919) % (vocab_size - 1)}"
                words.append(w)
            lines.append(" ".join(words))
        b["prompt"] = "\n".join(lines)
    return bodies


def _wait_status(url, proc, deadline_s):
    import requests

    t_end = time.perf_counter() + deadline_s
    while time.perf_counter() < t_end:
        if proc.poll() is not None:
            raise AssertionError(f"the worker exited with {proc.returncode} before serving")
        try:
            requests.post(url + "/worker_get_status", timeout=5)
            return
        except requests.ConnectionError:
            time.sleep(0.25)
    raise AssertionError(f"the worker did not answer /worker_get_status in {deadline_s} s")


def _tail(path, n=3000):
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def phase_checkpoint(smi, params, cfg=None, device="cuda"):
    """The 7B tree of phase 5 (before phase 6 quantizes it) written as an HF
    checkpoint with the port's exporter, then served from disk:

    1. ``load_pretrained_model`` in this process: every leaf equal to the
       exported tree, bit for bit; load seconds and host GB/s;
    2. ``python -m llava_plus_torch.serve.model_worker --model-path ...
       --load-8bit --kv-int8 --max-slots 16 --limit-model-concurrency 16``
       as a child process: phase 6's 16-request burst (its words swapped into the tokenizer's vocabulary),
       every stream checked; its first served token counted from the
       process's start, TTFT p50, tokens/s and peak device memory;
    3. a few requests one at a time to the worker and to a ``TorchBackend``
       in this process, built by the worker's own factory
       (``model_worker.backend_for``) on the loaded tree with the same
       flags: equal greedy texts (one request at a time gives both sides the
       same rows, so the same int8 plans); this backend's launches are
       counted and checked;
    4. the worker stopped (SIGTERM) and its exit checked; then one turn of
       ``python -m llava_plus_torch.serve.cli`` with its input piped, which
       must answer.

    Returns this process's launch counts (flash, int8 decode, int8 matmul)."""
    import signal

    import requests
    import torch
    from llava_plus_torch.models.builder import load_pretrained_model
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.serve import model_worker as mw
    from llava_plus_torch.train.checkpoint import export_hf_llava

    cfg = cfg or LLAVA_15_7B
    L, V = cfg.text.num_hidden_layers, cfg.text.vocab_size
    path = os.path.join(SMOKE_DIR, CKPT_NAME)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(SMOKE_DIR, exist_ok=True)
    disk = shutil.disk_usage(SMOKE_DIR)
    log("ckpt", f"free disk under {SMOKE_DIR}: {disk.free / 1e9:.1f} GB of "
                f"{disk.total / 1e9:.1f}")

    # the checkpoint, written once -------------------------------------------
    t0 = time.perf_counter()
    export_hf_llava(params, cfg, path, _word_tokenizer(V))
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
                 if f.endswith(".safetensors"))
    log("ckpt", f"exported {nbytes / 1e9:.2f} GB of safetensors in {write_s:.1f} s "
                f"({nbytes / 1e9 / write_s:.2f} GB/s from the card to disk); card {smi}")

    # 1. loaded in this process, bit for bit --------------------------------
    t0 = time.perf_counter()
    tok, loaded, lcfg, proc_, ctx = load_pretrained_model(path)
    load_s = time.perf_counter() - t0
    if lcfg != cfg or ctx != cfg.max_sequence_length:
        raise AssertionError(f"the loaded config differs: {lcfg} (context {ctx})")
    got, want = dict(_named_leaves(loaded)), dict(_named_leaves(params))
    if sorted(got) != sorted(want):
        raise AssertionError("the loaded tree's leaves differ from the exported tree's")
    for name, a in got.items():
        b = want[name]
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a.to(b.device), b):
            raise AssertionError(f"{name}: the loaded leaf differs from the exported one")
    n_leaves = len(got)
    del got, want, a, b   # the host tree stays referenced by ``loaded`` alone
    log("ckpt", f"load_pretrained_model: {n_leaves} leaves, {nbytes / 1e9:.2f} GB in "
                f"{load_s:.1f} s ({nbytes / 1e9 / load_s:.2f} GB/s on the host), every leaf "
                f"equal to the exported tree bit for bit; tokenizer "
                f"{type(tok).__name__}, processor {proc_.crop_size} px; card {smi}")

    # 2. the worker as a user starts it -------------------------------------
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    argv = ["--model-path", path, *WORKER_FLAGS, "--device", device, "--no-register",
            "--host", "127.0.0.1", "--port", str(port)]
    worker_log = os.path.join(SMOKE_DIR, "worker.log")
    env = dict(os.environ, PYTHONPATH=HERE)
    bodies = _in_vocab(_engine_bodies(np.random.default_rng(1), cfg.vision.image_size, 8, 8, 32),
                       V)
    with open(worker_log, "w") as logf:
        t_start = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "llava_plus_torch.serve.model_worker",
                                 *argv], cwd=HERE, env=env, stdout=logf,
                                stderr=subprocess.STDOUT)
    try:
        try:
            _wait_status(url, proc, 600)
            ready_s = time.perf_counter() - t_start
            t_burst = time.perf_counter()
            results = _post_all(url + "/worker_generate_stream", bodies)
            _check_streams(bodies, results, 32)
            first = min(st[0] for _, _, st in results)
            t_end = max(st[-1] for _, _, st in results)
            ttfts = sorted(st[0] - t_send for _, t_send, st in results)
            log("ckpt", f"worker: answering {ready_s:.1f} s after its start; burst of "
                        f"{len(bodies)} requests x 32 tokens, every stream whole: first "
                        f"served token {first - t_start:.1f} s after the process started, "
                        f"TTFT p50 {np.median(ttfts) * 1e3:.1f} ms (max "
                        f"{ttfts[-1] * 1e3:.1f}), {len(bodies) * 32 / (t_end - t_burst):.1f} "
                        f"tokens/s aggregate; card {smi}")

            # 3. one at a time, the worker against this process ---------------
            backend = mw.backend_for(mw.parse_args(argv), (tok, loaded, lcfg, proc_, ctx))
            del loaded
            engine = backend.engine
            flash_attention.launches = decode_attention.launches = qm.matmul_int8.launches = 0
            regimes0 = _regimes(qm.matmul_int8)
            e0 = (engine.prefill_dispatches, engine.decode_steps)
            matched = 0
            for body in bodies[:2] + bodies[8:10]:
                body = dict(body, max_new_tokens=24)
                r = requests.post(url + "/worker_generate_stream", json=body, stream=True,
                                  timeout=600)
                theirs = [c["text"] for c in mw.iter_chunks_requests(r)]
                mine = list(backend.generate_stream(body))
                if theirs != mine or len(mine) != 24:
                    raise AssertionError(f"greedy texts differ: worker {theirs[-1:]!r}, "
                                         f"in-process {mine[-1:]!r}")
                matched += 1
            launches = {"flash": flash_attention.launches, "decode": decode_attention.launches,
                        "quant": qm.matmul_int8.launches}
            dp, ds = (b - a for a, b in zip(e0, (engine.prefill_dispatches,
                                                  engine.decode_steps)))
            backend.stop()
            want = {"flash": L * dp, "decode": L * ds, "quant": (4 * L + 1) * (dp + ds)}
            if launches != want:
                raise AssertionError(f"in-process launches {launches}, want {want}")
            launches["quant_regimes"] = _quant_regimes("ckpt", "int8", regimes0,
                                                       launches["quant"])
            log("ckpt", f"{matched} requests one at a time: the worker's greedy texts equal "
                        f"the in-process backend's token for token; in-process launches "
                        f"{launches}")
            metrics = requests.post(url + "/worker_metrics", timeout=30).json()
            log("ckpt", f"worker: peak device memory {metrics['device_peak_gib']:.2f} GiB, "
                        f"{metrics['requests']} requests; card {smi}")
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                code = proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
                raise AssertionError("the worker did not stop within 60 s of SIGTERM")
    except BaseException:
        print(_tail(worker_log), file=sys.stderr, flush=True)
        raise
    if code != 0:
        print(_tail(worker_log), file=sys.stderr, flush=True)
        raise AssertionError(f"the worker exited with {code}")
    log("ckpt", "worker stopped by SIGTERM, exit code 0")
    del backend
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the chat CLI -----------------------------------------------------------
    png = os.path.join(SMOKE_DIR, "image.png")
    from PIL import Image

    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, size=(cfg.vision.image_size,) * 2 + (3,), dtype=np.uint8)).save(png)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "llava_plus_torch.serve.cli", "--model-path",
                          path, "--image-file", png, "--temperature", "0",
                          "--max-new-tokens", "16", "--device", device],
                         input="w5 w17 w99 w7\n", cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    # stdout: "USER: ASSISTANT: <answer>\nUSER: exit..."
    answer = out.stdout.partition("ASSISTANT: ")[2].partition("\n")[0].strip()
    if out.returncode != 0 or not answer:
        raise AssertionError(f"the CLI failed (exit {out.returncode}): "
                             f"{out.stdout[-1500:]}{out.stderr[-1500:]}")
    log("ckpt", f"cli: one turn in {cli_s:.1f} s (load included), answer of "
                f"{len(answer.split())} words: {answer[:60]!r}; card {smi}")
    shutil.rmtree(path, ignore_errors=True)
    return launches


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


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
    server = _Server(build_app(worker))
    url = f"http://127.0.0.1:{server.port}/worker_generate_stream"
    try:
        flash_attention.launches = decode_attention.launches = qmm.launches = 0
        regimes0 = _regimes(qmm)
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
    _check_streams(bodies, results, new_tokens)
    want = {"flash": L * dp, "decode": L * ds, "quant": (4 * L + 1) * (dp + ds)}
    log("engine", f"{quantize}: {len(bodies)} requests in {dp} prefill dispatches, "
                  f"{ds} decode steps ({dm} with more than one active slot); launches "
                  f"{launches} (want {want})")
    if dr != len(bodies) or dp >= dr or dm <= 0:
        raise AssertionError("no batched admission or no shared decode steps")
    if launches != want:
        raise AssertionError(f"launch counts {launches} differ from {want}")
    launches["quant_regimes"] = _quant_regimes("engine", quantize, regimes0, launches["quant"])
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


def _regimes(wrapper):
    """A quantized matmul's launches at decode rows and at prefill rows so far."""
    return wrapper.decode_launches, wrapper.prefill_launches


def _quant_regimes(phase, kind, before, total):
    """The int8 or int4 launches at decode rows and at prefill rows since
    ``before`` (the counts ``matmul_int8`` / ``matmul_int4`` keep apart); an
    engine's path must run both kernels, and together they are its ``total``
    launches."""
    from llava_plus_torch.ops import quant_matmul as qm

    wrapper, cut = ((qm.matmul_int8, qm.INT8_CUT) if kind == "int8"
                    else (qm.matmul_int4, qm.INT4_CUT))
    got = tuple(b - a for a, b in zip(before, _regimes(wrapper)))
    log(phase, f"{kind} launches by regime: {got[0]} at decode rows (R <= {cut}, the "
               f"split-K stream), {got[1]} at prefill rows (wgmma); {total} in all")
    if min(got) <= 0 or sum(got) != total:
        raise AssertionError(f"{phase}: the {kind} regimes ran {got} of {total} launches")
    return got


def _paged_bodies(rng, size, new_tokens):
    """Round 1 of the paged phase: 8 image prompts of 762 fused tokens, 7
    text prompts of 61..301, and one text prompt of 3,000 tokens, which no
    dense 2048 slot could hold."""
    bodies = _engine_bodies(rng, size, 8, 7, new_tokens)
    bodies.append({"prompt": " ".join(f"long{i}" for i in range(2999)),
                   "temperature": 0.0, "max_new_tokens": new_tokens})
    return bodies


def _check_streams(bodies, results, new_tokens):
    for body, (chunks, _, _) in zip(bodies, results):
        bad = [c for c in chunks if c["error_code"] != 0]
        if bad:
            raise AssertionError(f"worker error: {bad[0]['text']}")
        if len(chunks) != new_tokens or not chunks[-1]["text"].startswith(body["prompt"]):
            raise AssertionError(f"a request ended with {len(chunks)} of {new_tokens} tokens")


def serve_paged_engine(smi):
    """The paged engine at full width behind the HTTP worker, as the JAX
    worker's ``--paged`` serves: fresh random 7B weights (seed 0) quantized
    to int8 and fused, an int8 KV pool of 256 pages of 128 tokens (the
    memory a dense 16 x 2048 cache would take, shared by 16 slots that may
    each reach 4096 tokens), the prefix cache on, decode chunks of 4, warmed
    at 768 tokens. Round 1: 16 concurrent requests of 32 greedy tokens (8
    image, 7 text, one of 3,000 tokens). Round 2: 8 follow-ups, each a round-1
    image prompt, its answer and a new user turn of 40 words, as the
    LLaVA-Plus loop re-sends its history. Checks every chunk and token
    count, the prefix hits (at least 5 pages of each follow-up), that round
    2 runs no vision encode, every kernel's launch count against the
    engine's counts, and that every page is free or held only by the prefix
    cache at the end. Returns the launch counts of both rounds."""
    import torch
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.ops.paged_attention import paged_attention_general, paged_decode1
    from llava_plus_torch.serve.model_worker import ModelWorker, TorchBackend, build_app

    cfg = LLAVA_15_7B
    L, new_tokens, P = cfg.text.num_hidden_layers, 32, 128
    tok = DebugTokenizer(vocab_size=cfg.text.vocab_size)
    tok.eos_token_id = -1  # random weights give eos no meaning: every request runs 32 tokens
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = TorchBackend(_init_7b("cuda:0"), cfg, tok, ClipImageProcessor(), device="cuda",
                           use_engine=True, max_slots=16, decode_chunk=4, quantize="int8",
                           kv_int8=True, max_seq_len=4096, paged=True, pool_tokens=32768,
                           prefix_cache=True, warmup_len=768)
    engine = backend.engine
    if engine.num_pages != 256:
        raise AssertionError(f"pool of {engine.num_pages} pages, want 256")
    log("paged", f"int8 weights, fused; int8 KV pool of {engine.num_pages} pages x {P} "
                 f"tokens, 16 slots up to 4096 tokens, prefix cache on, decode chunks of 4: "
                 f"built and warmed in {time.perf_counter() - t0:.1f} s (warmup "
                 f"{engine.warmup_s:.1f} s)")
    encodes = [0]
    encode_images = llava_model.encode_images

    def counted_encode(*args, **kwargs):
        encodes[0] += 1
        return encode_images(*args, **kwargs)

    llava_model.encode_images = counted_encode
    rng = np.random.default_rng(2)
    bodies1 = _paged_bodies(rng, cfg.vision.image_size, new_tokens)
    worker = ModelWorker("http://127.0.0.1:9", "http://127.0.0.1:0", backend,
                         ["llava-1.5-7b-random"], limit_model_concurrency=len(bodies1),
                         no_register=True, heartbeats=False)
    server = _Server(build_app(worker))
    url = f"http://127.0.0.1:{server.port}/worker_generate_stream"
    kernels = {"flash": flash_attention, "decode1": paged_decode1,
               "general": paged_attention_general, "dense decode": decode_attention,
               "quant": qm.matmul_int8}
    counts = lambda: (engine.prefill_dispatches, engine.decode_steps, engine.prefix_hit_tokens,
                      engine._prefix.hit_requests, encodes[0])
    rounds = []
    try:
        for k in kernels.values():
            k.launches = 0
        regimes0 = _regimes(qm.matmul_int8)
        for r, bodies in enumerate((bodies1, None)):
            if bodies is None:
                # each follow-up re-sends a round-1 image prompt, the answer it
                # got and a new user turn
                bodies = []
                for j in range(8):
                    answer = rounds[0]["results"][j][0][-1]["text"][len(bodies1[j]["prompt"]):]
                    turn = " ".join(f"turn{j}word{i}" for i in range(40))
                    bodies.append(dict(bodies1[j], prompt=bodies1[j]["prompt"] + " " + answer
                                       + " " + turn))
            c0 = counts()
            t_start = time.perf_counter()
            results = _post_all(url, bodies)
            t_end = max(stamps[-1] for _, _, stamps in results)
            rounds.append({"bodies": bodies, "results": results,
                           "delta": [b - a for a, b in zip(c0, counts())],
                           "seconds": t_end - t_start,
                           "ttfts": sorted(st[0] - ts for _, ts, st in results)})
        launches = {n: k.launches for n, k in kernels.items()}
        deadline = time.time() + 30
        while (engine.num_active or engine._waiting is not None) and time.time() < deadline:
            time.sleep(0.05)
        with engine._page_lock:
            refs = list(engine._page_refs)
            cached = set(engine._prefix._entries.values())
            free = len(engine._free_pages)
    finally:
        llava_model.encode_images = encode_images
        server.stop()
        worker.stop()
        backend.stop()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for rd in rounds:
        _check_streams(rd["bodies"], rd["results"], new_tokens)
    (dp1, ds1, hit1, hr1, enc1), (dp2, ds2, hit2, hr2, enc2) = (rd["delta"] for rd in rounds)
    dp, ds, hits = dp1 + dp2, ds1 + ds2, hr1 + hr2
    want = {"flash": L * dp, "decode1": L * ds, "general": 0, "dense decode": 0,
            "quant": (4 * L + 1) * (dp + ds + hits)}
    held = sum(1 for p in cached if refs[p] == 1)
    log("paged", f"round 1: {len(bodies1)} requests in {dp1} prefill dispatches, {ds1} decode "
                 f"steps, {enc1} vision encodes; round 2: 8 follow-ups in {dp2} prefill "
                 f"dispatches, {hr2} prefix hits of {hit2} tokens, {ds2} decode steps, {enc2} "
                 f"vision encodes; launches {launches} (want {want}); pages at the end: "
                 f"{free} free + {held} held only by the prefix cache ({len(cached)} entries) "
                 f"of {engine.num_pages}")
    if hit2 < 8 * 5 * P or hr2 != 8 or dp2 != 0:
        raise AssertionError(f"round 2 did not reuse the pooled prefixes ({hr2} hits, "
                             f"{hit2} tokens, {dp2} full prefills)")
    if enc2 != 0 or enc1 <= 0:
        raise AssertionError(f"vision encodes: round 1 {enc1}, round 2 {enc2} (want 0)")
    if launches != want:
        raise AssertionError(f"launch counts {launches} differ from {want}")
    launches["quant_regimes"] = _quant_regimes("paged", "int8", regimes0, launches["quant"])
    if (free + held != engine.num_pages or any(r > 1 for r in refs)
            or any(refs[p] != 1 for p in cached)):
        raise AssertionError(f"page accounting: {free} free + {held} cached of "
                             f"{engine.num_pages}, refcounts {sorted(set(refs))}")
    for r, rd in enumerate(rounds, 1):
        n = len(rd["bodies"])
        log("paged", f"round {r}: TTFT p50 {np.median(rd['ttfts']) * 1e3:.1f} ms (min "
                     f"{rd['ttfts'][0] * 1e3:.1f}, max {rd['ttfts'][-1] * 1e3:.1f}); "
                     f"{n * new_tokens / rd['seconds']:.1f} tokens/s aggregate over {n} "
                     f"requests of {new_tokens} tokens in {rd['seconds']:.2f} s")
    total_s = sum(rd["seconds"] for rd in rounds)
    log("paged", f"both rounds: {(len(bodies1) + 8) * new_tokens / total_s:.1f} tokens/s "
                 f"aggregate; peak device memory {peak:.2f} GiB; card {smi}")
    return launches


# ---------------------------------------------------------------------------
# 17. speculative serving: the verify steps on the dense and the paged engine
# ---------------------------------------------------------------------------

SPEC_K = 4        # proposals a verify step: chunks of 5 tokens
SPEC_CHUNK = 4    # verify steps a dispatch
SPEC_NEW = 64     # tokens a request of phase 17
SPEC_TOL = 3e-2   # phase 4's logit bound for int8 weights (2e-2 for bf16 ones)


def _id_tokenizer(vocab_size, bos=True):
    """A ``DebugTokenizer`` that names every id ("#id") when it decodes, so a
    stream's text gives its token ids back; eos -1 (random weights give eos
    no meaning: every request runs its budget)."""
    from llava_plus_torch.data import DebugTokenizer

    class IdTokenizer(DebugTokenizer):
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(f"#{int(i)}" for i in ids
                            if not (skip_special_tokens and int(i) < self._RESERVED))

    tok = IdTokenizer(vocab_size=vocab_size)
    tok.eos_token_id = -1
    if not bos:
        tok.bos_token_id = None   # GPT-NeoX style, as MPT's tokenizer
    return tok


def _stream_ids(text, prompt):
    return [int(w[1:]) for w in text[len(prompt):].split()]


def _spec_bodies(rng, size, new_tokens):
    """Phase 6's 8 image prompts (762 fused tokens) and 8 repetitive text
    prompts, a tool's output quoted back: 24 words cycled, 100-240 words."""
    bodies = _engine_bodies(rng, size, 8, 0, new_tokens)
    for j in range(8):
        words = " ".join(f"tool{j}w{i % 24}" for i in range(100 + 20 * j))
        bodies.append({"prompt": f"observation: {words} summary:", "temperature": 0.0,
                       "max_new_tokens": new_tokens})
    return bodies


def _top2_gap(params, cfg, tok, body, tokens, cache_dtype, max_len=2048):
    """The plain step's top-2 logit gap, relative to the top logit, after
    ``body``'s prompt (and image) and ``tokens``: a fresh dense prefill and
    one decode step a token."""
    import torch
    from llava_plus_torch.data import ClipImageProcessor
    from llava_plus_torch.generate import prepare_multimodal_request
    from llava_plus_torch.mm_utils import load_image_from_base64, process_images
    from llava_plus_torch.models import llama, llava as llava_model

    images = None
    if body.get("images"):
        images = [process_images([load_image_from_base64(b) for b in body["images"]],
                                 ClipImageProcessor(), cfg)]
    batch, plan = prepare_multimodal_request(cfg, tok, [body["prompt"]], images,
                                             max_seq_len=max_len, device="cuda",
                                             prefill_bucket=256)
    n0 = int(plan.lengths[0])
    cache = llama.KVCache.create(llava_model.backbone(cfg)[1], 1, max_len, cache_dtype,
                                 device="cuda")
    seg = torch.ones(1, 1, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        logits, _ = llava_model.forward(params, cfg, batch, cache=cache, fresh_prefill=True,
                                        logits_positions=torch.tensor([n0 - 1], device="cuda"))
        for i, t in enumerate(tokens):
            logits, _ = llava_model.decode_step(
                params, cfg, torch.tensor([[t]], device="cuda"),
                torch.tensor([[n0 + i]], dtype=torch.int32, device="cuda"), seg, cache)
    top = logits[0, -1].float().topk(2).values
    return float((top[0] - top[1]) / top[0].abs())


def _compare_greedy(tag, plain, spec, gap_of, tol):
    """Per request: how many of the speculative engine's greedy tokens equal
    the plain engine's. At a divergence, the plain step's top-2 logit gap
    there, which must lie within ``tol`` (phase 4's logit bound): a near tie
    that the two paths' rounding may split, where a fault would split a
    wide margin."""
    matched = []
    for i, (a, b) in enumerate(zip(plain, spec)):
        n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        matched.append(n)
        if n < max(len(a), len(b)):
            gap = gap_of(i, a[:n])
            log("spec", f"{tag} request {i}: {n} of {len(a)} tokens equal the plain engine's; "
                        f"the plain step's top-2 logit gap there {gap:.3e} of the top logit "
                        f"(bound {tol})")
            if gap > tol:
                raise AssertionError(f"{tag} request {i} diverges from the plain engine at token "
                                     f"{n}, where the plain top-2 gap is {gap:.3e} > {tol}")
    log("spec", f"{tag}: tokens equal to the plain engine's, per request: {matched} "
                f"(of {[len(a) for a in plain]})")
    return matched


def _profile_tool():
    """``tools/profile_torch_slice.py``'s helpers, loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "profile_torch_slice", os.path.join(HERE, "tools", "profile_torch_slice.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _profiled(fn):
    """One call of ``fn`` (it ends with its fetch) under ``torch.profiler``:
    device busy ms and ms by kernel class, as the profile tool sorts them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tool = _profile_tool()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = tool.device_events(prof)
    by_class = {}
    for name, _, us in events:
        label = tool.kernel_class(name)
        by_class[label] = by_class.get(label, 0.0) + us / 1e3
    return {"device_busy_ms": sum(us for _, _, us in events) / 1e3,
            "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1]))}


def _step_breakdown(tag, engine, paged):
    """The engine's loop stopped, its 16 slots active at position 512: host
    ms of a plain step and of a verify step, each ending with its fetch
    (mean of 20 and 10 after 3), then one of each under ``torch.profiler``.
    A paged pool first gets 8 distinct pages a slot."""
    import torch
    from llava_plus_torch.tools import bench_spec

    if paged:
        c = engine.cache
        B, per = c.page_table.shape[0], 8
        table = torch.zeros_like(c.page_table)
        table[:, :per] = torch.arange(B * per, dtype=torch.int32,
                                      device=table.device).view(B, per)
        c.page_table.copy_(table)
        c.alloc.fill_(per * engine.page_size)
    with torch.inference_mode():
        plain, verify = bench_spec.step_fns(engine, 512)
        host = {"plain": bench_spec._host_ms(plain), "verify": bench_spec._host_ms(verify, 10)}
        plain, verify = bench_spec.step_fns(engine, 512)
        res = {}
        for name, fn in (("plain", plain), ("verify", verify)):
            fn()
            res[name] = dict(host_ms=host[name], **_profiled(fn))
            r = res[name]
            log("spec", f"{tag} {name} step, 16 slots at 512: host {r['host_ms']:.3f} ms, "
                        f"device busy {r['device_busy_ms']:.3f} ms, idle share "
                        f"{1 - r['device_busy_ms'] / r['host_ms']:.3f}; " + ", ".join(
                            f"{k} {v:.3f}" for k, v in r["by_class_ms"].items()))
    return res


def _sync_check(tag, engine):
    """One verify chunk (``SPEC_CHUNK`` steps and the start of its rows'
    copy) and one plain step queued under ``torch.cuda.set_sync_debug_mode
    ("error")``: neither may wait for the card."""
    import torch
    from llava_plus_torch.tools import bench_spec

    with torch.inference_mode():
        plain, verify = bench_spec.step_fns(engine, 600)
        verify(SPEC_CHUNK)
        plain()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            verify(SPEC_CHUNK, fetch=False)
            plain(fetch=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    log("spec", f"{tag}: a verify chunk of {SPEC_CHUNK} steps and a plain step queued under "
                f"set_sync_debug_mode('error') with no host sync")


def _narrow_spec():
    """Phase 4's narrow LLaMA (its permutation head: wide top-2 margins) and
    the narrow MHA MPT on the card, bf16 weights and cache (the kernels take
    bf16; in f32 only their plain versions run), dense and paged: the
    speculative engine's greedy tokens against the plain engine's on a
    repetitive and a plain prompt, budgets ending inside a verify chunk.
    Returns the verify launches of the dense decode kernel and the paged
    general kernel (ALiBi apart)."""
    import torch
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.paged_attention import paged_attention_general
    from llava_plus_torch.serve.engine import BatchedEngine, Request

    counts = {"chunk": 0, "general": 0, "general[alibi]": 0}
    for arch in ("llama", "mpt"):
        if arch == "llama":
            cfg = _narrow_cfg()
            cpu = llava_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            lm = cpu["language_model"]
            lm["embed_tokens"].mul_(2.0)
            perm = torch.randperm(cfg.text.vocab_size,
                                  generator=torch.Generator().manual_seed(1))
            lm["lm_head"] = lm["embed_tokens"][perm].T.contiguous()
            tok, tol = _id_tokenizer(cfg.text.vocab_size), 2e-2
        else:
            cfg = _narrow_mpt_cfg(False)
            cpu = llava_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            tok, tol = _id_tokenizer(cfg.mpt.vocab_size, bos=False), 2e-2
        params = _tree_to(cpu, "cuda")
        L = llava_model.backbone(cfg)[1].num_hidden_layers if arch == "llama" else cfg.mpt.n_layers
        prompts = [" ".join(f"w{i % 12}" for i in range(200)),
                   " ".join(f"token{i}" for i in range(150))]
        budgets = [23, 17]
        outs = {}
        for mode, kw in (("plain", {}), ("spec", dict(speculate=SPEC_K)),
                         ("spec paged", dict(speculate=SPEC_K, paged=True, page_size=128))):
            eng = BatchedEngine(params, cfg, tok, max_slots=4, max_seq_len=1024,
                                prefill_bucket=128, cache_dtype=torch.bfloat16, **kw)
            c0 = (decode_attention.chunk_launches, paged_attention_general.launches,
                  paged_attention_general.alibi_launches)
            try:
                texts = [eng.generate(Request(prompt=p, max_new_tokens=b))
                         for p, b in zip(prompts, budgets)]
                steps = eng.verify_steps
            finally:
                eng.stop()
            d = [b - a for a, b in zip(c0, (decode_attention.chunk_launches,
                                            paged_attention_general.launches,
                                            paged_attention_general.alibi_launches))]
            if mode != "plain":
                # at least once a layer a verify step (the GQA LLaMA's plain
                # steps over a paged pool take the general kernel too)
                want = L * steps
                got = d[0] if mode == "spec" else d[1] + d[2]
                if steps <= 0 or got < want or (mode == "spec" and got != want):
                    raise AssertionError(f"narrow {arch} {mode}: {got} verify launches for "
                                         f"{steps} verify steps of {L} layers")
                counts["chunk"] += d[0]
                counts["general"] += d[1]
                counts["general[alibi]"] += d[2]
            outs[mode] = [_stream_ids(t, "") for t in texts]
        for mode in ("spec", "spec paged"):
            _compare_greedy(
                f"narrow {arch} {mode}", outs["plain"], outs[mode],
                lambda i, toks: _top2_gap(params, cfg, tok, {"prompt": prompts[i]}, toks,
                                          torch.bfloat16, max_len=1024), tol)
        del params
    return counts


def phase_speculative(smi):
    """Phase 17: prompt-lookup speculative decoding at LLaVA-1.5-7B width,
    one fresh random tree (seed 0) quantized to int8 and fused, int8 KV.

    1. ``llava_plus_torch.tools.bench_spec``'s shape: one stream, a 160-word
       repetitive prompt and an image, 128 greedy tokens, speculation off,
       then on (k = 4, chunks of 4 steps): tokens/s, acceptance (> 1
       required) and the loop's host seconds by part.
    2. The dense engine at 16 slots behind the HTTP worker
       (``TorchBackend(..., speculate=4)``) on 16 requests (8 image, 8
       repetitive text) of 64 greedy tokens, after the plain engine on the
       same requests: TTFT p50, tokens/s, verify steps, pauses, the
       extended decode kernel's launches (one a layer a verify step), and per
       request the tokens equal to the plain engine's (at a divergence the
       plain step's top-2 gap, which must lie within phase 4's bound).
    3. The paged engine (256 pages of 128, prefix cache) with speculation on
       the same requests, then 8 prefix-hit follow-ups: the general paged
       kernel launched once a layer a verify step.
    4. On each engine, its loop stopped: a verify chunk and a plain step
       queued under ``set_sync_debug_mode("error")``, then a plain and a
       verify step at 16 slots, host ms and device busy by class.
    5. The narrow LLaMA and MPT (``_narrow_spec``)."""
    import torch
    from llava_plus_torch.data import ClipImageProcessor
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.ops.paged_attention import paged_attention_general, paged_decode1
    from llava_plus_torch.serve.model_worker import ModelWorker, TorchBackend, build_app
    from llava_plus_torch.tools import bench_spec

    cfg = LLAVA_15_7B
    L, P = cfg.text.num_hidden_layers, 128
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = bench_spec.make_params("cuda:0")
    log("spec", f"LLaVA-1.5-7B, random bf16 weights (seed 0), int8 fused, in "
                f"{time.perf_counter() - t0:.1f} s")
    out = {"flash": 0, "quant": 0, "decode1": 0}
    kernels = {"flash": flash_attention, "quant": qm.matmul_int8, "decode1": paged_decode1}

    # 1. bench_spec's shape
    runs = {}
    for mode in (0, SPEC_K):
        runs[mode] = r = bench_spec.run(mode, 128, SPEC_CHUNK, params=params)
        log("spec", f"bench_spec, speculate={mode}: {r['tokens']} tokens in {r['seconds']:.3f} s "
                    f"= {r['tok_s']:.1f} tokens/s (TTFT {r['ttft_s'] * 1e3:.1f} ms)"
                    + (f"; spec_acceptance {r['acceptance']:.3f} over {r['steps']} verify steps, "
                       f"{r['refreshes']} refreshes, {r['pauses']} pauses; spec_timers "
                       f"{ {k: round(v, 4) for k, v in r['timers'].items()} }" if mode else ""))
    if runs[SPEC_K]["acceptance"] <= 1.0 or runs[SPEC_K]["tokens"] != 128:
        raise AssertionError(f"bench_spec: acceptance {runs[SPEC_K]['acceptance']:.3f}, "
                             f"{runs[SPEC_K]['tokens']} tokens")
    out["bench"] = {m: {k: r[k] for k in ("tok_s", "acceptance", "steps")}
                    for m, r in runs.items()}

    tok = _id_tokenizer(cfg.text.vocab_size)
    bodies = _spec_bodies(np.random.default_rng(5), cfg.vision.image_size, SPEC_NEW)

    def serve(tag, bodies_rounds, **kw):
        """Serve rounds of bodies on a fresh backend over HTTP; each round's
        texts, TTFTs and seconds, the engine's counters and kernels' launch
        deltas, and the engine (stopped) for the step checks."""
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        backend = TorchBackend(params, cfg, tok, ClipImageProcessor(), device="cuda",
                               use_engine=True, max_slots=16, decode_chunk=4, kv_int8=True,
                               warmup_len=768, spec_chunk=SPEC_CHUNK, **kw)
        engine = backend.engine
        log("spec", f"{tag}: built and warmed in {time.perf_counter() - t0:.1f} s")
        worker = ModelWorker("http://127.0.0.1:9", "http://127.0.0.1:0", backend,
                             ["llava-1.5-7b-random"], limit_model_concurrency=16,
                             no_register=True, heartbeats=False)
        server = _Server(build_app(worker))
        url = f"http://127.0.0.1:{server.port}/worker_generate_stream"
        names = ("verify_steps", "spec_steps", "spec_emitted", "spec_pauses", "decode_steps",
                 "prefill_dispatches", "prefix_hit_tokens")
        c0 = {n: getattr(engine, n) for n in names}
        k0 = {n: k.launches for n, k in kernels.items()}
        k0.update(chunk=decode_attention.chunk_launches, general=paged_attention_general.launches,
                  dense=decode_attention.launches)
        rounds = []
        try:
            for bodies_r in bodies_rounds:
                if callable(bodies_r):
                    bodies_r = bodies_r(rounds)
                t_start = time.perf_counter()
                results = _post_all(url, bodies_r)
                t_end = max(st[-1] for _, _, st in results)
                _check_streams(bodies_r, results, SPEC_NEW)
                rounds.append({"bodies": bodies_r, "seconds": t_end - t_start,
                               "ttfts": sorted(st[0] - ts for _, ts, st in results),
                               "texts": [c[-1]["text"] for c, _, _ in results]})
        finally:
            server.stop()
            worker.stop()
            backend.stop()
        d = {n: getattr(engine, n) - c0[n] for n in names}
        d.update(launches={n: k.launches - k0[n] for n, k in kernels.items()},
                 chunk=decode_attention.chunk_launches - k0["chunk"],
                 general=paged_attention_general.launches - k0["general"],
                 dense=decode_attention.launches - k0["dense"])
        for r, rd in enumerate(rounds, 1):
            n = len(rd["bodies"])
            log("spec", f"{tag} round {r}: TTFT p50 {np.median(rd['ttfts']) * 1e3:.1f} ms (max "
                        f"{rd['ttfts'][-1] * 1e3:.1f}); {n * SPEC_NEW / rd['seconds']:.1f} "
                        f"tokens/s aggregate over {n} requests of {SPEC_NEW} tokens in "
                        f"{rd['seconds']:.2f} s")
        acc = d["spec_emitted"] / d["spec_steps"] if d["spec_steps"] else 0.0
        log("spec", f"{tag}: {d['verify_steps']} verify steps ({d['spec_steps']} with a live "
                    f"slot, acceptance {acc:.3f}), {d['spec_pauses']} pauses, "
                    f"{d['decode_steps']} plain steps, {d['prefill_dispatches']} prefill "
                    f"dispatches, {d['prefix_hit_tokens']} prefix-hit tokens; launches: "
                    f"decode (of them verify chunks) {d['dense']} ({d['chunk']}), paged general "
                    f"{d['general']}, {d['launches']}; card {smi}")
        for n in ("flash", "quant", "decode1"):
            out[n] += d["launches"][n]
        return rounds, d, engine

    def ids_of(rounds):
        return [_stream_ids(t, b["prompt"]) for t, b in zip(rounds[0]["texts"],
                                                            rounds[0]["bodies"])]

    def gap_of(i, toks):
        return _top2_gap(params, cfg, tok, bodies[i], toks, torch.int8)

    # 2. the dense engine: plain, then speculative
    plain_rounds, _, engine = serve("dense plain", [bodies])
    del engine
    rounds, d, engine = serve("dense spec", [bodies], speculate=SPEC_K)
    if d["verify_steps"] <= 0 or d["chunk"] != L * d["verify_steps"] or d["general"] != 0:
        raise AssertionError(f"dense spec: {d['chunk']} verify launches of the decode kernel "
                             f"for {d['verify_steps']} verify steps of {L} layers")
    plain_ids = ids_of(plain_rounds)
    out["dense_match"] = _compare_greedy("dense spec", plain_ids, ids_of(rounds), gap_of,
                                         SPEC_TOL)
    out["chunk"] = d["chunk"]
    out["dense"] = d
    _sync_check("dense spec", engine)
    out["dense_steps"] = _step_breakdown("dense", engine, paged=False)
    del engine

    # 3. the paged engine: the same requests, then 8 prefix-hit follow-ups
    def follow_ups(rounds_so_far):
        first = rounds_so_far[0]
        return [dict(bodies[j], prompt=bodies[j]["prompt"] + " "
                     + first["texts"][j][len(bodies[j]["prompt"]):] + " "
                     + " ".join(f"turn{j}word{i}" for i in range(40)))
                for j in range(8)]

    rounds, d, engine = serve("paged spec", [bodies, follow_ups], speculate=SPEC_K,
                              max_seq_len=4096, paged=True, pool_tokens=32768,
                              prefix_cache=True)
    if engine.num_pages != 256:
        raise AssertionError(f"pool of {engine.num_pages} pages, want 256")
    if d["verify_steps"] <= 0 or d["general"] != L * d["verify_steps"] or d["chunk"] != 0:
        raise AssertionError(f"paged spec: {d['general']} general launches for "
                             f"{d['verify_steps']} verify steps of {L} layers")
    if d["launches"]["decode1"] != L * d["decode_steps"]:
        raise AssertionError(f"paged spec: {d['launches']['decode1']} decode1 launches for "
                             f"{d['decode_steps']} plain steps")
    if d["prefix_hit_tokens"] < 8 * 5 * P:
        raise AssertionError(f"paged spec: {d['prefix_hit_tokens']} prefix-hit tokens")
    out["paged_match"] = _compare_greedy("paged spec (round 1)", plain_ids, ids_of(rounds),
                                         gap_of, SPEC_TOL)
    out["general"] = d["general"]
    out["paged"] = d
    _sync_check("paged spec", engine)
    out["paged_steps"] = _step_breakdown("paged", engine, paged=True)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the narrow models
    narrow = _narrow_spec()
    out["narrow"] = narrow
    log("spec", f"narrow models: verify launches {narrow}")
    return out


# ---------------------------------------------------------------------------
# 11. LLaVA-MPT-7B at full width behind the HTTP worker, dense and paged
# ---------------------------------------------------------------------------

def _init_mpt_7b(dev):
    """LLaVA-MPT-7B at full width and depth, random bf16 weights from seed 0."""
    import torch
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_MPT_7B

    t0 = time.perf_counter()
    params = llava_model.init_params(LLAVA_MPT_7B, torch.Generator(device=dev).manual_seed(0),
                                     dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log("mpt", f"random bf16 weights on {dev}: {n_params / 1e9:.3f} B parameters in "
               f"{time.perf_counter() - t0:.1f} s")
    return params


def _mpt_prompt(text):
    """One user turn in the ``conv_mpt`` template, the assistant's turn open."""
    from llava_plus_torch.conversation import conv_templates

    conv = conv_templates["mpt"].copy()
    conv.append_message(conv.roles[0], text)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def _mpt_bodies(rng, size, n_image, n_text, new_tokens):
    """``conv_mpt`` prompts: image turns of ~480 fused tokens (256 image
    slots between the start / end tokens, 200 words; one 512 bucket) and
    text turns of 60..300 words."""
    bodies = []
    for j in range(n_image):
        words = " ".join(f"img{j}word{i}" for i in range(200))
        bodies.append({"prompt": _mpt_prompt("<image>\n" + words),
                       "images": [_png_b64(rng, size)]})
    for j, n in enumerate(np.linspace(60, 300, n_text).round().astype(int)):
        bodies.append({"prompt": _mpt_prompt(" ".join(f"txt{j}word{i}" for i in range(n)))})
    for b in bodies:
        b.update(temperature=0.0, max_new_tokens=new_tokens)
    return bodies


def serve_mpt_7b(smi):
    """Phase 11: LLaVA-MPT-7B on the dense engine, then on the paged engine
    (:func:`_serve_mpt_engine`, each on fresh weights, the first freed
    before the second is made). Returns the launch counts of both."""
    return {mode: _serve_mpt_engine(smi, mode) for mode in ("dense", "paged")}


def _serve_mpt_engine(smi, mode):
    """LLaVA-MPT-7B (``LLAVA_MPT_7B``: mosaicml/mpt-7b-chat's decoder with
    ALiBi, CLIP ViT-L/14 at 224 px, a linear projector, image start / end
    tokens) at full width, random bf16 weights, behind the HTTP worker, as
    the JAX worker serves it: weights quantized in place to int8 (the four
    matrices of each layer; the tied ``wte`` stays bf16), an int8 KV cache,
    16 slots, decode chunks of 4, warmed at 512 tokens, ``conv_mpt`` prompts,
    the GPT-NeoX-style tokenizer (no BOS) at vocab 50432.

    1. the dense engine (16 slots x 2048): 8 concurrent requests of 32
       greedy tokens (4 image, 4 text);
    2. the paged engine with the prefix cache on fresh weights: an int8 pool
       of 128 pages of 128 tokens, 8 requests, then 4 multi-turn follow-ups
       (a round-1 image prompt, its answer, a new user turn) that must hit
       their pooled prefixes (3 pages each, no full prefill, no vision
       encode).

    ``mode`` is "dense" (1) or "paged" (2). Checks every chunk and token
    count, batched admission, the prefix hits, the page accounting, and every
    kernel's launch count against the engine's own counts: the ALiBi flash
    forward 32 a prefill (32 layers), the ALiBi dense decode (1) or decode1
    (2) 32 a decode step, the int8 matmul 4 x 32 a forward, no launch of a
    kernel's plain (LLaMA) variant. Returns the launch counts."""
    import torch
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_MPT_7B
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.ops.paged_attention import paged_attention_general, paged_decode1
    from llava_plus_torch.serve.model_worker import ModelWorker, TorchBackend, build_app

    cfg = LLAVA_MPT_7B
    L, new_tokens, P, size = cfg.mpt.n_layers, 32, 128, cfg.vision.image_size
    tok = DebugTokenizer(vocab_size=cfg.mpt.vocab_size)
    tok.bos_token_id = None   # GPT-NeoX style, as MPT's tokenizer
    tok.eos_token_id = -1     # random weights give eos no meaning: every request runs 32 tokens
    wrappers = (flash_attention, decode_attention, paged_decode1, paged_attention_general,
                qm.matmul_int8, qm.matmul_int4)

    def counts():
        return {f"{k.__name__}{'' if a == 'launches' else '[alibi]'}": getattr(k, a)
                for k in wrappers for a in ("launches", "alibi_launches") if hasattr(k, a)}

    encodes = [0]
    encode_images = llava_model.encode_images

    def counted_encode(*args, **kwargs):
        encodes[0] += 1
        return encode_images(*args, **kwargs)

    paged = mode == "paged"
    gc.collect()   # an earlier backend's engine threads hold it in a cycle
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gib = torch.cuda.memory_allocated() / 2 ** 30   # left by earlier phases
    t0 = time.perf_counter()
    backend = TorchBackend(_init_mpt_7b("cuda:0"), cfg, tok,
                           ClipImageProcessor(shortest_edge=size, crop_size=size),
                           device="cuda", use_engine=True, max_slots=16, decode_chunk=4,
                           quantize="int8", kv_int8=True, max_seq_len=2048, paged=paged,
                           pool_tokens=128 * P if paged else None, prefix_cache=paged,
                           warmup_len=512)
    engine = backend.engine
    log("mpt", f"{mode} engine: int8 weights, int8 KV "
               f"{f'pool of {engine.num_pages} pages x {P}' if paged else '16 x 2048'}, 16 "
               f"slots, decode chunks of 4: built and warmed in "
               f"{time.perf_counter() - t0:.1f} s (warmup {engine.warmup_s:.1f} s)")
    rng = np.random.default_rng(11)
    bodies1 = _mpt_bodies(rng, size, 4, 4, new_tokens)
    worker = ModelWorker("http://127.0.0.1:9", "http://127.0.0.1:0", backend,
                         ["llava-mpt-7b-random"], limit_model_concurrency=len(bodies1),
                         no_register=True, heartbeats=False)
    server = _Server(build_app(worker))
    url = f"http://127.0.0.1:{server.port}/worker_generate_stream"
    state = lambda: (engine.prefill_dispatches, engine.prefill_requests,  # noqa: E731
                     engine.decode_steps, engine.multi_slot_steps,
                     engine.prefix_hit_tokens,
                     engine._prefix.hit_requests if paged else 0, encodes[0])
    rounds = []
    llava_model.encode_images = counted_encode
    try:
        for w in wrappers:
            w.launches = 0
            if hasattr(w, "alibi_launches"):
                w.alibi_launches = 0
        regimes0 = _regimes(qm.matmul_int8)
        for bodies in (bodies1, None) if paged else (bodies1,):
            if bodies is None:
                bodies = []
                for j in range(4):   # the image requests, each with its answer
                    prev = rounds[0]["bodies"][j]
                    answer = rounds[0]["results"][j][0][-1]["text"][len(prev["prompt"]):]
                    turn = " ".join(f"turn{j}word{i}" for i in range(40))
                    bodies.append(dict(prev, prompt=prev["prompt"] + answer
                                       + "<|im_end|><|im_start|>user\n" + turn
                                       + "<|im_end|><|im_start|>assistant\n"))
            c0 = state()
            t_start = time.perf_counter()
            results = _post_all(url, bodies)
            t_end = max(stamps[-1] for _, _, stamps in results)
            rounds.append({"bodies": bodies, "results": results,
                           "delta": [b - a for a, b in zip(c0, state())],
                           "seconds": t_end - t_start,
                           "ttfts": sorted(st[0] - ts for _, ts, st in results)})
        launches = counts()
        deadline = time.time() + 30
        while (engine.num_active or engine._waiting is not None) and time.time() < deadline:
            time.sleep(0.05)
        if paged:
            with engine._page_lock:
                refs = list(engine._page_refs)
                cached = set(engine._prefix._entries.values())
                free = len(engine._free_pages)
    finally:
        llava_model.encode_images = encode_images
        server.stop()
        worker.stop()
        backend.stop()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for rd in rounds:
        _check_streams(rd["bodies"], rd["results"], new_tokens)
    dp, dr, ds, dm, hit_tok, hits, enc = (sum(rd["delta"][i] for rd in rounds)
                                          for i in range(7))
    want = {k: 0 for k in launches}
    want["flash_attention[alibi]"] = L * dp
    want["paged_decode1[alibi]" if paged else "decode_attention[alibi]"] = L * ds
    want["matmul_int8"] = 4 * L * (dp + ds + hits)
    log("mpt", f"{mode}: {dr} requests in {dp} prefill dispatches, {ds} decode steps "
               f"({dm} with more than one active slot), {enc} vision encodes"
               + (f", {hits} prefix hits of {hit_tok} tokens" if paged else "")
               + f"; launches {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"MPT {mode}: launch counts {launches} differ from {want}")
    launches["matmul_int8 regimes"] = _quant_regimes("mpt", "int8", regimes0,
                                                     launches["matmul_int8"])
    if rounds[0]["delta"][1] != len(bodies1) or rounds[0]["delta"][0] >= len(bodies1) \
            or dm <= 0:
        raise AssertionError(f"MPT {mode}: no batched admission or no shared decode steps")
    if paged:
        dp2, _, _, _, hit2, hr2, enc2 = rounds[1]["delta"]
        held = sum(1 for p_ in cached if refs[p_] == 1)
        log("mpt", f"paged round 2: {hr2} prefix hits of {hit2} tokens, {dp2} full "
                   f"prefills, {enc2} vision encodes; pages at the end: {free} free + "
                   f"{held} held only by the prefix cache ({len(cached)} entries) of "
                   f"{engine.num_pages}")
        if hr2 != 4 or hit2 < 4 * 3 * P or dp2 != 0 or enc2 != 0:
            raise AssertionError(f"MPT paged round 2 did not reuse the pooled prefixes "
                                 f"({hr2} hits, {hit2} tokens, {dp2} full prefills, "
                                 f"{enc2} encodes)")
        if (free + held != engine.num_pages or any(r > 1 for r in refs)
                or any(refs[p_] != 1 for p_ in cached)):
            raise AssertionError(f"MPT page accounting: {free} free + {held} cached of "
                                 f"{engine.num_pages}, refcounts {sorted(set(refs))}")
    for r, rd in enumerate(rounds, 1):
        n = len(rd["bodies"])
        log("mpt", f"{mode} round {r}: TTFT p50 {np.median(rd['ttfts']) * 1e3:.1f} ms (min "
                   f"{rd['ttfts'][0] * 1e3:.1f}, max {rd['ttfts'][-1] * 1e3:.1f}); "
                   f"{n * new_tokens / rd['seconds']:.1f} tokens/s aggregate over {n} "
                   f"requests of {new_tokens} tokens in {rd['seconds']:.2f} s")
    log("mpt", f"{mode}: peak device memory {peak:.2f} GiB ({before_gib:.2f} GiB held before "
               f"the phase); card {smi}")
    return launches


# ---------------------------------------------------------------------------
# 8-10. training: the narrow model card vs CPU, LLaVA-1.5-7B stages 1 and 2
# ---------------------------------------------------------------------------

def _fingerprint(x):
    """An integer that changes when any element of ``x`` changes: the sum
    of its bit patterns."""
    import torch

    bits = x.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                   torch.int8: torch.int8}[x.dtype])
    return int(torch.sum(bits, dtype=torch.int64))


def _fingerprints(tree):
    return [_fingerprint(x) for x in _leaves(tree)]


def _bwd_counters():
    from llava_plus_torch.ops import flash_attention as fa

    return fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq


def _reset_counts():
    from llava_plus_torch.ops import quant_matmul as qm

    for k in _bwd_counters():
        k.launches = k.alibi_launches = 0
    for k in (qm.matmul_int8, qm.matmul_int4):
        k.launches = k.backward_calls = 0
    qm.matmul_int4_native.launches = 0


def _counts(alibi=False):
    return tuple(getattr(k, "alibi_launches" if alibi else "launches") for k in _bwd_counters())


def _narrow_train_arrays(cfg, rng):
    """Two rows of 320 tokens from the port's packer: row 0 packs three
    image-text samples (segment ids 1-3), row 1 holds one sample and a
    padded tail of 115 tokens."""
    from llava_plus_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from llava_plus_torch.data.packing import pack_instances
    from llava_plus_torch.models.llava import backbone

    vocab = backbone(cfg)[1].vocab_size
    inst = []
    for n in (90, 120, 60, 200):
        ids = np.array([1, IMAGE_TOKEN_INDEX] + list(rng.integers(3, vocab, n)))
        labels = np.where(np.arange(len(ids)) < 8, IGNORE_INDEX, ids)
        size = cfg.vision.image_size
        inst.append({"input_ids": ids, "labels": labels,
                     "images": rng.normal(size=(1, size, size, 3)).astype(np.float32)})
    arrays, consumed = pack_instances(inst, rows=2, max_len=320,
                                      num_patches=cfg.num_image_tokens,
                                      image_size=cfg.vision.image_size, max_images_per_row=3)
    if consumed != 4 or arrays["segment_ids"][0].max() != 3 or arrays["segment_ids"][1].min():
        raise AssertionError("the narrow training batch is not packed and padded as planned")
    return arrays


def _batch_on(arrays, device):
    import torch
    from llava_plus_torch.models.llava import MultimodalBatch

    return MultimodalBatch(**{k: torch.from_numpy(np.asarray(v)).to(device)
                              for k, v in arrays.items()})


def _cosines(cpu_tree, cuda_tree):
    """Each leaf pair's cosine similarity, and how many leaves are all 0."""
    cos, zero = [], 0
    for a, b in zip(_leaves(cpu_tree), _leaves(cuda_tree)):
        a, b = a.double().flatten(), b.double().cpu().flatten()
        na, nb = float(a.norm()), float(b.norm())
        zero += na == 0.0 or nb == 0.0
        cos.append(float(a @ b) / max(na * nb, 1e-300))
    return cos, zero


def phase_narrow_training():
    """The narrow models' training step on the card (bf16, the flash
    forward and both backward kernels, remat) against the same weights in
    f32 on the CPU plain path, on one batch of packed and padded rows: the
    narrow LLaMA, then the narrow MPT (``_narrow_mpt_cfg``) in MHA and MQA,
    through the ALiBi kernels. For each: the loss within 2%; the gradient of
    the projector and of every language-model leaf at cosine similarity >=
    0.99 and nonzero; then one stage-2 AdamW update on both sides, after
    which every parameter agrees within bf16 rounding (2**-7 of its size)
    plus twice the step (an element whose gradient is near 0 may move the
    other way); the kernels' launch counts exact (remat runs the forward
    twice per layer), ALiBi launches counted apart. Then LoRA and QLoRA
    (``phase_narrow_lora``). Returns the ALiBi backward launches."""
    import torch
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.convert import per_layer
    from llava_plus_torch.train import step as step_lib
    from llava_plus_torch.train.optimizer import OptimizerConfig, build_optimizer

    alibi_total = {"dkv": 0, "dq": 0}
    for name, cfg in (("LLaVA (hidden 512, 4 heads over 2, 2 layers)", _narrow_cfg()),
                      ("LLaVA-MPT MHA (d_model 512, 4 heads, 2 layers)", _narrow_mpt_cfg(False)),
                      ("LLaVA-MPT MQA (d_model 512, 4 heads over 1, 2 layers)",
                       _narrow_mpt_cfg(True))):
        alibi = cfg.language_model_type == "mpt"
        L = llava_model.backbone(cfg)[1].n_layers if alibi else cfg.text.num_hidden_layers
        keys = ("language_model", "mm_projector")
        base = llava_model.init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                                       torch.bfloat16)
        trees = {"cpu": per_layer(_tree_to(base, "cpu", torch.float32)),
                 "cuda": per_layer(_tree_to(base, "cuda"))}
        arrays = _narrow_train_arrays(cfg, np.random.default_rng(3))
        opt_cfg = OptimizerConfig(learning_rate=1e-4, total_steps=10, warmup_ratio=0.0)
        loss_of = lambda p, mb, cfg=cfg: step_lib.loss_fn(p, cfg, mb, remat=True)  # noqa: E731
        grads, metrics = {}, {}
        for dev, params in trees.items():
            batch = _batch_on(arrays, dev)
            _reset_counts()
            grads[dev], metrics[dev] = step_lib.grads_and_metrics(loss_of, params, batch,
                                                                  keys=keys)
            if dev == "cuda":
                torch.cuda.synchronize()
                launched, other = _counts(alibi), _counts(not alibi)
            opt = build_optimizer(params, opt_cfg)
            opt.update(grads[dev], opt.init(params), params)
        want = (2 * L, L, L)
        loss = {d: float(m["loss"]) for d, m in metrics.items()}
        rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        cos, zero = _cosines([grads["cpu"][k] for k in keys], [grads["cuda"][k] for k in keys])
        worst = 0.0
        for a, b in zip(_leaves(trees["cpu"]), _leaves(trees["cuda"])):
            b = b.float().cpu()
            # Adam's first update moves each element by at most lr (in bf16,
            # lr and the moment ratio are rounded: < 1% more)
            excess = (a - b).abs() - (2.0 ** -7 * a.abs() + 2.02 * opt_cfg.learning_rate)
            worst = max(worst, float(excess.max()))
        log("train", f"narrow {name}, 2 rows x 320 (one packed as 3 samples, one padded): "
                     f"loss card {loss['cuda']:.5f} vs CPU {loss['cpu']:.5f} (rel {rel:.2e}, "
                     f"bound 2e-2); gradient cosine over {len(cos)} leaves: min {min(cos):.5f} "
                     f"(bound 0.99), {zero} zero; after one AdamW step every parameter within "
                     f"bound (worst excess {worst:.2e}); launches flash fwd/dkv/dq"
                     f"{'[alibi]' if alibi else ''} {launched} (want {want}), others {other}")
        if (rel > 2e-2 or min(cos) < 0.99 or zero or worst > 0 or launched != want
                or any(other)):
            raise AssertionError(f"narrow training ({name}) on the card disagrees with the CPU")
        if alibi:
            alibi_total["dkv"] += launched[1]
            alibi_total["dq"] += launched[2]
    return alibi_total


def _to_keep_ints(tree, device, dtype=None):
    """``tree`` on ``device``, its float leaves cast to ``dtype`` (if given)
    and its integer leaves (quantized weights) as they are."""
    if isinstance(tree, dict):
        return {k: _to_keep_ints(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_keep_ints(v, device, dtype) for v in tree]
    return tree.to(device, dtype if tree.is_floating_point() else None)


def phase_narrow_lora():
    """LoRA and QLoRA on the narrow LLaMA, card (bf16 activations, f32
    adapters, the flash kernels and, on a quantized base, the int8 / int4
    kernels and their backward Function) against the same base and adapters
    on the CPU (f32, plain): a bf16 base, then the same base quantized to
    int8 and to int4 (the LLaMA matrices and the head, unfused, as ``--bits``
    does). The adapters (r 16, alpha 32) have a nonzero ``b`` so that every
    leaf takes a gradient. Checks the loss within 2%, the gradient of every
    adapter leaf at cosine >= 0.99 and nonzero, that the base keeps its
    bytes, and the launch counts: per step the quantized kernel runs 7
    products a layer twice (remat) and the head once; the backward Function
    runs once for each product whose input carries a gradient (all but the
    first layer's q/k/v, whose input comes from the frozen embeddings).
    Returns the quantized kernels' forward launches and backward calls."""
    import torch
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.convert import per_layer
    from llava_plus_torch.ops import quant
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.train import lora as lora_lib
    from llava_plus_torch.train import step as step_lib

    cfg = _narrow_cfg()
    L = cfg.text.num_hidden_layers
    lcfg = lora_lib.LoraConfig(r=16, alpha=32)
    base = llava_model.init_params(cfg, torch.Generator().manual_seed(6), "cpu", torch.bfloat16)
    arrays = _narrow_train_arrays(cfg, np.random.default_rng(6))
    adapters = lora_lib.init_lora_params(base["language_model"], lcfg,
                                         torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    for ab in adapters.values():
        ab["b"].normal_(0.0, 0.02, generator=gen)
    totals = {8: [0, 0], 4: [0, 0]}
    for bits in (None, 8, 4):
        tree = copy.deepcopy(base)
        if bits:
            tree = quant.quantize_llava_params(tree, "llama", bits=bits)
        wrapper = {None: None, 8: qm.matmul_int8, 4: qm.matmul_int4}[bits]
        grads, loss = {}, {}
        for dev in ("cpu", "cuda"):
            params = per_layer(_to_keep_ints(tree, dev, torch.float32 if dev == "cpu" else None))
            layers = lora_lib.lora_per_layer(_tree_to(adapters, dev))

            def loss_of(p, mb, params=params):
                lm = lora_lib.apply_lora(params["language_model"], p["lora"], lcfg)
                return step_lib.loss_fn(dict(params, language_model=lm), cfg, mb, remat=True)

            before = _fingerprints(params["language_model"])
            _reset_counts()
            g, m = step_lib.grads_and_metrics(loss_of, {"lora": layers}, _batch_on(arrays, dev),
                                              keys=("lora",))
            grads[dev], loss[dev] = g["lora"], float(m["loss"])
            if _fingerprints(params["language_model"]) != before:
                raise AssertionError(f"LoRA (bits={bits}) changed its base on {dev}")
            if dev == "cuda":
                torch.cuda.synchronize()
                flash = _counts()
                q = (wrapper.launches, wrapper.backward_calls) if wrapper else (0, 0)
        want_q = (2 * 7 * L + 1, 7 * L + 1 - 3) if bits else (0, 0)
        rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        cos, zero = _cosines(grads["cpu"], grads["cuda"])
        tag = f"int{bits}" if bits else "bf16"
        log("train", f"narrow {'QLoRA' if bits else 'LoRA'} on a {tag} base (r 16, "
                     f"{len(cos)} adapter leaves): loss card {loss['cuda']:.5f} vs CPU "
                     f"{loss['cpu']:.5f} (rel {rel:.2e}, bound 2e-2); adapter gradient cosine "
                     f"min {min(cos):.5f} (bound 0.99), {zero} zero; base bytes unchanged; "
                     f"launches flash fwd/dkv/dq {flash} (want {(2 * L, L, L)}), quantized "
                     f"kernel forward / backward calls {q} (want {want_q})")
        if (rel > 2e-2 or min(cos) < 0.99 or zero or flash != (2 * L, L, L) or q != want_q
                or len(cos) != 2 * 7 * L):
            raise AssertionError(f"narrow LoRA (bits={bits}) on the card disagrees with the CPU")
        if bits:
            totals[bits] = [totals[bits][0] + q[0], totals[bits][1] + q[1]]
    return totals


def _write_corpus(root, n, rng, size, turns_of):
    """``n`` records with a ``size`` px PNG of noise each, under ``root``."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    records = []
    for i in range(n):
        name = f"{i}.png"
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(root, name), compress_level=1)
        records.append({"image": name, "conversations": turns_of(i)})
    path = os.path.join(root, "data.json")
    with open(path, "w") as f:
        json.dump(records, f)
    return path


def _words(rng, n):
    return " ".join(f"w{int(j)}" for j in rng.integers(0, 20000, n))


def _long_turns(rng):
    """A multi-turn image conversation of about 700 to 2200 fused tokens
    (``rng`` draws its length and words)."""
    n = int(rng.integers(90, 1600))        # about n + 610 fused tokens
    first = int(rng.integers(20, 60))
    out = [{"from": "human", "value": "<image>\n" + _words(rng, first)}]
    rest, k = n - first, 0
    while rest > 0:
        w = min(rest, int(rng.integers(40, 400)))
        out.append({"from": "gpt" if k % 2 == 0 else "human", "value": _words(rng, w)})
        rest, k = rest - w, k + 1
    if out[-1]["from"] == "human":
        out.append({"from": "gpt", "value": _words(rng, 20)})
    return out


def phase_train_stage1(smi):
    """LLaVA-1.5-7B stage 1 through the port's ``train()``: the recipe of
    ``scripts/v1_5/pretrain.sh`` (plain template, projector only, mlp2x_gelu,
    square images, batch 32, max length 2048, lr 1e-3, no weight decay,
    warmup 0.03, cosine, gradient checkpointing, bf16) on 96 synthetic
    image-caption records (3 steps), random bf16 weights from seed 0 in place
    of a checkpoint. Checks every logged loss, that the language model and
    the vision tower keep their bytes and the projector moves, the
    ``mm_projector.bin`` keys and shapes, and the launch counts."""
    import torch
    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.train import train as train_lib

    cfg, L = LLAVA_15_7B, LLAVA_15_7B.text.num_hidden_layers
    root = os.path.join(SMOKE_DIR, "stage1")
    rng = np.random.default_rng(4)
    data = _write_corpus(root, 96, rng, cfg.vision.image_size, lambda i: [
        {"from": "human", "value": "<image>\n"},
        {"from": "gpt", "value": _words(rng, int(rng.integers(10, 61)))}])
    before = {}

    def build_model(model_args, dtype, device):
        params = _init_7b(device)
        before.update({k: _fingerprints(params[k]) for k in params})
        return params, cfg, DebugTokenizer(vocab_size=cfg.text.vocab_size)

    steps = []

    def on_step(step, metrics, seconds, arrays):
        tokens = int((arrays["segment_ids"] > 0).sum())
        steps.append((metrics, seconds, tokens, arrays["tokens"].shape))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = os.path.join(root, "out")
    params, _ = train_lib.train(
        train_lib.ModelArguments(version="plain", tune_mm_mlp_adapter=True,
                                 mm_projector_type="mlp2x_gelu"),
        train_lib.DataArguments(data_path=data, image_folder=root, image_aspect_ratio="square"),
        train_lib.TrainingArguments(output_dir=out, per_device_train_batch_size=32,
                                    model_max_length=2048, learning_rate=1e-3,
                                    weight_decay=0.0, warmup_ratio=0.03,
                                    lr_scheduler_type="cosine", gradient_checkpointing=True,
                                    bf16=True, save_steps=1000, device="cuda"),
        build_model=build_model, on_step=on_step)
    torch.cuda.synchronize()
    launched = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = (3 * 2 * L, 3 * L, 3 * L)
    for i, (m, dt, tokens, shape) in enumerate(steps, 1):
        log("stage1", f"step {i}: batch {shape[0]} x {shape[1]}, {tokens} non-pad tokens, "
                      f"loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, host "
                      f"{dt * 1e3:.1f} ms, {tokens / dt:.0f} non-pad tokens/s")
    after = {k: _fingerprints(params[k]) for k in params}
    sd = torch.load(os.path.join(out, "mm_projector.bin"), weights_only=True)
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    want_shapes = {"model.mm_projector.0.weight": (4096, 1024), "model.mm_projector.0.bias": (4096,),
                   "model.mm_projector.2.weight": (4096, 4096), "model.mm_projector.2.bias": (4096,)}
    moved = sum(a != b for a, b in zip(before["mm_projector"], after["mm_projector"]))
    log("stage1", f"{len(steps)} steps; language model and vision tower bytes unchanged: "
                  f"{after['language_model'] == before['language_model']}, "
                  f"{after['vision_tower'] == before['vision_tower']}; projector leaves moved "
                  f"{moved} of {len(after['mm_projector'])}; mm_projector.bin {shapes}; "
                  f"launches flash fwd/dkv/dq {launched} (want {want}); peak device memory "
                  f"{peak:.2f} GiB; card {smi}")
    if (len(steps) != 3 or not all(np.isfinite(m["loss"]) for m, *_ in steps)
            or after["language_model"] != before["language_model"]
            or after["vision_tower"] != before["vision_tower"]
            or moved != len(after["mm_projector"]) or shapes != want_shapes
            or launched != want):
        raise AssertionError("7B stage 1 failed its checks")
    return dict(zip(("flash", "dkv", "dq"), launched))


def phase_train_stage2(smi):
    """LLaVA-1.5-7B stage 2 through ``make_train_step`` with batches from
    the port's dataset and collator (what ``train()`` runs, without its
    final HF export): the recipe of ``scripts/v1_5/finetune.sh`` (v1
    template, language model and projector trained, lr 2e-5, no weight
    decay, warmup 0.03, cosine, gradient checkpointing, bf16 parameters and
    moments), reduced for one card to batch 4 with gradient accumulation 2
    (the recipe has 16 a device on 8 cards); 3 steps on 24 synthetic
    multi-turn image records of 700 to 2048 fused tokens, some truncated at
    2048. Checks the loss, that every language-model and projector leaf
    received an update (a nonzero first moment) and every matrix moved (a
    norm weight of 1.0 cannot move by lr 2e-5 in bf16), that the vision
    tower keeps its bytes, and the launch counts."""
    import torch
    from llava_plus_torch import conversation
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.data.dataset import DataConfig, collate_batch, make_supervised_dataset
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.models.convert import per_layer
    from llava_plus_torch.train import step as step_lib
    from llava_plus_torch.train import train as train_lib
    from llava_plus_torch.train.optimizer import OptimizerConfig, build_optimizer

    cfg, L = LLAVA_15_7B, LLAVA_15_7B.text.num_hidden_layers
    B, K, n_steps = 4, 2, 3
    root = os.path.join(SMOKE_DIR, "stage2")
    rng = np.random.default_rng(5)

    data = _write_corpus(root, B * K * n_steps, rng, cfg.vision.image_size,
                         lambda i: _long_turns(rng))
    tok = DebugTokenizer(vocab_size=cfg.text.vocab_size)
    conv = conversation.conv_templates["v1"]
    ds = make_supervised_dataset(tok, DataConfig(data_path=data, image_folder=root,
                                                 conv_version=conv.version),
                                 ClipImageProcessor(shortest_edge=cfg.vision.image_size,
                                                    crop_size=cfg.vision.image_size), conv)
    fused = []
    batches = []
    for s in range(n_steps):
        micro = []
        for j in range(K):
            items = [ds[(s * K + j) * B + r] for r in range(B)]
            fused += [len(it["input_ids"]) + cfg.num_image_tokens - 1 for it in items]
            micro.append(collate_batch(items, num_patches=cfg.num_image_tokens, max_len=2048,
                                       image_size=cfg.vision.image_size,
                                       pad_token_id=tok.pad_token_id))
        batches.append(train_lib.stack_micro_batches(micro, tok.pad_token_id, 2048))

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = per_layer(_init_7b("cuda:0"))   # each layer's weights are their own leaves
    before = {k: _fingerprints(params[k]) for k in params}
    opt = build_optimizer(params, OptimizerConfig(
        learning_rate=2e-5, weight_decay=0.0, warmup_ratio=0.03, total_steps=n_steps,
        schedule="cosine"))
    state = opt.init(params)
    step_fn = step_lib.make_train_step(cfg, opt, remat=True, accum_steps=K)
    _reset_counts()
    logs = []
    for s, arrays in enumerate(batches, 1):
        batch = _batch_on(arrays, "cuda")
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        m = {k: float(v) for k, v in m.items()}
        dt = time.perf_counter() - t0
        tokens = int((arrays["segment_ids"] > 0).sum())
        logs.append(m)
        log("stage2", f"step {s}: {K} x {B} x {arrays['tokens'].shape[-1]} (rows "
                      f"{', '.join(str(int(x)) for x in (arrays['segment_ids'] > 0).sum(-1).ravel())}"
                      f" tokens), loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, host "
                      f"{dt * 1e3:.1f} ms, {tokens / dt:.0f} non-pad tokens/s")
    torch.cuda.synchronize()
    launched = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    after = {k: _fingerprints(params[k]) for k in params}
    want = (n_steps * K * 2 * L, n_steps * K * L, n_steps * K * L)
    mu_zero = sum(int(float(m.abs().max()) == 0.0) for key in ("language_model", "mm_projector")
                  for m in state["mu"][key])
    unmoved = [i for i, (a, b, x) in enumerate(zip(before["language_model"],
                                                   after["language_model"],
                                                   _leaves(params["language_model"])))
               if a == b and x.dim() == 2]
    moved_proj = sum(a != b for a, b in zip(before["mm_projector"], after["mm_projector"]))
    log("stage2", f"{n_steps} steps of {K} x {B} rows ({min(fused)}-{max(fused)} fused tokens "
                  f"a record, {sum(f > 2048 for f in fused)} truncated at 2048); leaves with a "
                  f"zero first moment {mu_zero}; language-model matrices unmoved {len(unmoved)}; "
                  f"projector leaves moved {moved_proj} of {len(after['mm_projector'])}; vision "
                  f"tower bytes unchanged {after['vision_tower'] == before['vision_tower']}; "
                  f"launches flash fwd/dkv/dq {launched} (want {want}); peak device memory "
                  f"{peak:.2f} GiB; card {smi}")
    if (not all(np.isfinite(m["loss"]) for m in logs) or mu_zero or unmoved
            or moved_proj != len(after["mm_projector"])
            or after["vision_tower"] != before["vision_tower"] or launched != want):
        raise AssertionError("7B stage 2 failed its checks")
    return dict(zip(("flash", "dkv", "dq"), launched))


class _LastStepProfile:
    """Profiles the last of ``n_steps`` steps of a ``train()`` run from its
    ``on_step`` hook: ``torch.profiler`` starts when step n - 1 has been
    reported and stops when step n has, so the window is step n's host work
    (its batch, its step, its metrics). The earlier steps' host clocks are
    taken before the profiler starts. Device busy is the sum of the device
    events, by kernel class as ``tools/profile_torch_slice.py`` sorts them."""

    def __init__(self, n_steps):
        self.n_steps, self.prof, self.result = n_steps, None, None

    def after(self, step, seconds):
        import importlib.util

        import torch
        from torch.profiler import ProfilerActivity, profile

        if step == self.n_steps - 1:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        elif step == self.n_steps and self.prof is not None:
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            # the profile tool's own helpers, loaded from its file
            spec = importlib.util.spec_from_file_location(
                "profile_torch_slice", os.path.join(HERE, "tools", "profile_torch_slice.py"))
            tool = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(tool)
            events = tool.device_events(self.prof)
            busy = sum(us for _, _, us in events) / 1e3
            by_class = {}
            for name, _, us in events:
                label = tool.kernel_class(name)
                by_class[label] = by_class.get(label, 0.0) + us / 1e3
            host = seconds * 1e3
            self.result = {"host_ms": host, "device_busy_ms": busy, "idle_share": 1 - busy / host,
                           "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1]))}

    def line(self):
        r = self.result
        parts = ", ".join(f"{k} {v:.3f}" for k, v in r["by_class_ms"].items())
        return (f"profiled step {self.n_steps}: host {r['host_ms']:.3f} ms, device busy "
                f"{r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}; {parts}")


def phase_train_mpt_stage1(smi):
    """LLaVA-MPT-7B stage 1 through the port's ``train()`` at full width
    and depth (d_model 4096, 32 layers of 32 heads, vocab 50432, CLIP-L/224,
    linear projector; random bf16 weights from seed 0): the recipe of
    ``scripts/pretrain.sh`` (plain template, projector only, batch 32, max
    length 2048, lr 1e-3, no weight decay, warmup 0.03, cosine, gradient
    checkpointing, bf16) on 96 synthetic image-caption records, 3 steps. The
    backward through the frozen language model (to the projector's output)
    runs the ALiBi flash backward kernels. Checks every loss, that the
    language model and the vision tower keep their bytes and the projector
    moves, the ``mm_projector.bin`` keys and shapes, and the launch counts:
    ALiBi flash forward 2 x 32 per step (remat), each ALiBi backward 32 per
    step, no launch of the kernels without ALiBi."""
    import torch
    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.models.configs import LLAVA_MPT_7B
    from llava_plus_torch.train import train as train_lib

    cfg, L = LLAVA_MPT_7B, LLAVA_MPT_7B.mpt.n_layers
    root = os.path.join(SMOKE_DIR, "mpt_stage1")
    rng = np.random.default_rng(7)
    data = _write_corpus(root, 96, rng, cfg.vision.image_size, lambda i: [
        {"from": "human", "value": "<image>\n"},
        {"from": "gpt", "value": _words(rng, int(rng.integers(10, 61)))}])
    before = {}

    def build_model(model_args, dtype, device):
        params = _init_mpt_7b(device)
        before.update({k: _fingerprints(params[k]) for k in params})
        tok = DebugTokenizer(vocab_size=cfg.mpt.vocab_size)
        tok.bos_token_id = None
        return params, cfg, tok

    steps, prof = [], _LastStepProfile(3)

    def on_step(step, metrics, seconds, arrays):
        tokens = int((arrays["segment_ids"] > 0).sum())
        steps.append((metrics, seconds, tokens, arrays["tokens"].shape))
        prof.after(step, seconds)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = os.path.join(root, "out")
    params, _ = train_lib.train(
        train_lib.ModelArguments(version="plain", tune_mm_mlp_adapter=True,
                                 mm_projector_type="linear", tiny_debug_arch="mpt"),
        train_lib.DataArguments(data_path=data, image_folder=root, image_aspect_ratio="square"),
        train_lib.TrainingArguments(output_dir=out, per_device_train_batch_size=32,
                                    model_max_length=2048, learning_rate=1e-3,
                                    weight_decay=0.0, warmup_ratio=0.03,
                                    lr_scheduler_type="cosine", gradient_checkpointing=True,
                                    bf16=True, save_steps=1000, device="cuda"),
        build_model=build_model, on_step=on_step)
    torch.cuda.synchronize()
    launched, plain = _counts(alibi=True), _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = (3 * 2 * L, 3 * L, 3 * L)
    for i, (m, dt, tokens, shape) in enumerate(steps, 1):
        log("mpt-stage1", f"step {i}: batch {shape[0]} x {shape[1]}, {tokens} non-pad tokens, "
                          f"loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, host "
                          f"{dt * 1e3:.1f} ms, {tokens / dt:.0f} non-pad tokens/s")
    log("mpt-stage1", prof.line())
    after = {k: _fingerprints(params[k]) for k in params}
    sd = torch.load(os.path.join(out, "mm_projector.bin"), weights_only=True)
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    want_shapes = {"model.mm_projector.0.weight": (4096, 1024),
                   "model.mm_projector.0.bias": (4096,)}
    moved = sum(a != b for a, b in zip(before["mm_projector"], after["mm_projector"]))
    log("mpt-stage1", f"{len(steps)} steps; language model and vision tower bytes unchanged: "
                      f"{after['language_model'] == before['language_model']}, "
                      f"{after['vision_tower'] == before['vision_tower']}; projector leaves moved "
                      f"{moved} of {len(after['mm_projector'])}; mm_projector.bin {shapes}; "
                      f"launches flash fwd/dkv/dq[alibi] {launched} (want {want}), without "
                      f"ALiBi {plain}; peak device memory {peak:.2f} GiB; card {smi}")
    if (len(steps) != 3 or not all(np.isfinite(m["loss"]) for m, *_ in steps)
            or after["language_model"] != before["language_model"]
            or after["vision_tower"] != before["vision_tower"]
            or moved != len(after["mm_projector"]) or shapes != want_shapes
            or launched != want or any(plain)):
        raise AssertionError("LLaVA-MPT-7B stage 1 failed its checks")
    return dict(zip(("flash", "dkv", "dq"), launched))


def phase_train_qlora(smi):
    """LLaVA-1.5-7B QLoRA through the port's ``train()``: the recipe of
    ``scripts/finetune_qlora.sh`` (``--lora-enable --bits 4``, r 128, alpha
    256, v1 template, gradient checkpointing, bf16) reduced for one card to
    batch 4 and 3 steps on 12 synthetic multi-turn image records of 700 to
    2048 fused tokens (phase 10's), random bf16 weights from seed 0 in place
    of a checkpoint. ``--bits 4`` quantizes the language model to int4 (the
    seven LLaMA matrices and the head) before the adapters are made; only
    the adapters train (the JAX package's ``optax.adamw(lr)``). Checks every
    loss, that every adapter leaf moved, that the int4 base, the vision tower
    and the projector keep their bytes, the PEFT export (448 tensors of the
    adapters' shapes) and ``non_lora_trainables.bin``, the peak memory, and
    the launch counts: per step the int4 kernel runs 7 products a layer
    twice (remat) and the head once, its backward Function once for each
    product whose input carries a gradient (all but layer 0's q/k/v)."""
    import torch
    from safetensors.torch import load_file
    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.train import lora as lora_lib
    from llava_plus_torch.train import train as train_lib

    cfg, L = LLAVA_15_7B, LLAVA_15_7B.text.num_hidden_layers
    B, n_steps, r = 4, 3, 128
    root = os.path.join(SMOKE_DIR, "qlora")
    rng = np.random.default_rng(8)
    data = _write_corpus(root, B * n_steps, rng, cfg.vision.image_size,
                         lambda i: _long_turns(rng))
    state = {}

    def build_model(model_args, dtype, device):
        params = _init_7b(device)
        state["vision_tower"] = _fingerprints(params["vision_tower"])
        state["mm_projector"] = _fingerprints(params["mm_projector"])
        return params, cfg, DebugTokenizer(vocab_size=cfg.text.vocab_size)

    def init_lora(lm, lora_cfg, generator):
        # the base the adapters are made on: int4 already
        state["lm"] = lm
        state["lm_before"] = _fingerprints(lm)
        ad = lora_lib.init_lora_params(lm, lora_cfg, generator)
        state["adapters"] = ad
        state["ad_before"] = _fingerprints(ad)
        return ad

    steps, prof = [], _LastStepProfile(n_steps)

    def on_step(step, metrics, seconds, arrays):
        tokens = int((arrays["segment_ids"] > 0).sum())
        steps.append((metrics, seconds, tokens, arrays["tokens"].shape))
        prof.after(step, seconds)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    out = os.path.join(root, "out")
    params, _ = train_lib.train(
        train_lib.ModelArguments(version="v1"),
        train_lib.DataArguments(data_path=data, image_folder=root),
        train_lib.TrainingArguments(output_dir=out, per_device_train_batch_size=B,
                                    max_steps=n_steps, model_max_length=2048,
                                    learning_rate=2e-5, gradient_checkpointing=True, bf16=True,
                                    lora_enable=True, bits=4, lora_r=r, lora_alpha=2 * r,
                                    save_steps=1000, device="cuda"),
        build_model=build_model, init_lora=init_lora, on_step=on_step)
    torch.cuda.synchronize()
    flash = _counts()
    q = (qm.matmul_int4.launches, qm.matmul_int4.backward_calls)
    other = qm.matmul_int8.launches + qm.matmul_int8.backward_calls
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (m, dt, tokens, shape) in enumerate(steps, 1):
        log("qlora", f"step {i}: batch {shape[0]} x {shape[1]}, {tokens} non-pad tokens, loss "
                     f"{m['loss']:.4f}, adapter grad_norm {m['grad_norm']:.4f}, host "
                     f"{dt * 1e3:.1f} ms, {tokens / dt:.0f} non-pad tokens/s")
    log("qlora", prof.line())
    ad_after = _fingerprints(state["adapters"])
    unmoved = sum(a == b for a, b in zip(state["ad_before"], ad_after))
    base_same = _fingerprints(state["lm"]) == state["lm_before"]
    wq = state["lm"]["layers"]["attn"]["wq"]
    int4_base = isinstance(wq, dict) and "qvalue4" in wq
    frozen = (_fingerprints(params["vision_tower"]) == state["vision_tower"]
              and _fingerprints(params["mm_projector"]) == state["mm_projector"])
    sd = load_file(os.path.join(out, "adapter_model.safetensors"))
    shapes_ok = all(v.shape[0 if k.endswith("lora_A.weight") else 1] == r for k, v in sd.items())
    extra = torch.load(os.path.join(out, "non_lora_trainables.bin"), weights_only=True)
    want_flash = (n_steps * 2 * L, n_steps * L, n_steps * L)
    want_q = (n_steps * (2 * 7 * L + 1), n_steps * (7 * L + 1 - 3))
    log("qlora", f"{len(steps)} steps; adapter leaves unmoved {unmoved} of {len(ad_after)}; "
                 f"int4 base {int4_base}, its bytes unchanged {base_same}; vision tower and "
                 f"projector bytes unchanged {frozen}; export: {len(sd)} adapter tensors "
                 f"(rank {r}: {shapes_ok}), non_lora_trainables {sorted(extra)}; launches flash "
                 f"fwd/dkv/dq {flash} (want {want_flash}); int4 kernel forward launches / "
                 f"backward calls {q} (want {want_q}), int8 {other}; peak device memory "
                 f"{peak:.2f} GiB; card {smi}")
    if (len(steps) != n_steps or not all(np.isfinite(m["loss"]) for m, *_ in steps) or unmoved
            or not int4_base or not base_same or not frozen or len(sd) != 2 * 7 * L
            or not shapes_ok or len(extra) != 4 or flash != want_flash or q != want_q
            or other):
        raise AssertionError("LLaVA-1.5-7B QLoRA failed its checks")
    return {"flash": flash[0], "dkv": flash[1], "dq": flash[2], "int4": q[0]}


# ---------------------------------------------------------------------------
# 14. the int4 measurement tools
# ---------------------------------------------------------------------------

def phase_int4_tools():
    """The port's int4 measurement tools end to end, in-process through
    their ``main(argv)`` at 16 rows: ``bench_int4_variants`` (the five
    shapes: split-half int4, native int4, int8) and ``bench_int4`` (the
    three 7B shapes: both kernels and two library baselines). Each tool
    checks every kernel against its plain version before it times it. The
    launch counts must be exact: for each shape and kernel one check, the
    warm-up calls and the timed ones."""
    import torch
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.tools import bench_int4, bench_int4_variants

    argv = ["--rows", "16"]
    per = 1 + bench_int4_variants.WARMUP + bench_int4_variants.ITERS
    n5, n3 = len(bench_int4_variants.SHAPES), len(bench_int4.SHAPES)
    _reset_counts()
    before = _regimes(qm.matmul_int4_native)
    t0 = time.perf_counter()
    rc = (bench_int4_variants.main(argv), bench_int4.main(argv))
    torch.cuda.synchronize()
    got = (qm.matmul_int4_native.launches, qm.matmul_int4.launches, qm.matmul_int8.launches)
    want = (n5 * per, (n5 + n3) * per, (n5 + n3) * per)
    regimes = tuple(b - a for a, b in zip(before, _regimes(qm.matmul_int4_native)))
    log("int4 tools", f"exit codes {rc} in {time.perf_counter() - t0:.1f} s; launches native "
                      f"int4 / int4 / int8 {got} (want {want}); native int4 by regime {regimes} "
                      f"(decode rows, prefill rows)")
    if rc != (0, 0) or got != want or sum(regimes) != got[0]:
        raise AssertionError("the int4 tools failed their checks")
    return {"int4n": got[0], "int4": got[1], "int8": got[2], "int4n regimes": regimes}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def device_times_only(root):
    """Phases 1, 2 and 15 alone, for the ``llava_plus_torch`` package under
    ``root``, with phase 3's int8, int4, decode1 and general rows also timed
    through their wrappers first: run once for each of two checkouts in one
    call (A, B, B, A) to compare their kernels on one card."""
    import collections

    sys.path.insert(0, root)
    phase_env()
    phase_build()
    stats = collections.defaultdict(dict)
    wrapper_times(stats)
    phase_device_times(stats)
    print(json.dumps({"root": root, "device_times": stats}), flush=True)
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    root = HERE
    if args and args[0] == "--device-times":
        root = os.path.abspath(args[1]) if len(args) > 1 else HERE
    if not os.path.isdir(os.path.join(root, "llava_plus_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    if args and args[0] == "--device-times":
        return device_times_only(root)
    sys.path.insert(0, HERE)
    smi = phase_env()
    phase_build()
    stats = phase_kernels()
    narrow_general = phase_narrow_model()
    narrow_mpt = phase_narrow_mpt()
    dev = "cuda:0"
    params = _init_7b(dev)
    single = phase_full_slice(smi, params, dev)
    # phase 16 exports these weights before phase 6 quantizes them in place
    ckpt = phase_checkpoint(smi, params)
    # int4 starts from fresh ones
    int8 = serve_engine(smi, params, "int8", n_image=8, n_text=8)
    del params
    int4 = serve_engine(smi, _init_7b(dev), "int4", n_image=2, n_text=2)
    paged = serve_paged_engine(smi)
    spec = phase_speculative(smi)   # phase 17, on fresh weights
    mpt = serve_mpt_7b(smi)   # phase 11, before training (the LLaMA weights are gone)
    narrow_alibi_bwd = phase_narrow_training()
    narrow_lora = phase_narrow_lora()
    stage1 = phase_train_stage1(smi)
    stage2 = phase_train_stage2(smi)
    mpt_stage1 = phase_train_mpt_stage1(smi)
    qlora = phase_train_qlora(smi)
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    tools = phase_int4_tools()
    phase_device_times(stats)

    entries = []
    paged_src = "llava_plus_torch/csrc/paged_attention.cu"
    bwd_src = "llava_plus_torch/csrc/flash_bwd.cu"
    for name, source, replaces, count in (
        ("flash_fwd", "llava_plus_torch/csrc/flash_fwd.cu", FLASH_REPLACES,
         single["flash"] + ckpt["flash"] + int8["flash"] + int4["flash"] + paged["flash"]
         + spec["flash"] + stage1["flash"] + stage2["flash"] + qlora["flash"]),
        ("flash_bwd[dkv]", bwd_src, DKV_REPLACES, stage1["dkv"] + stage2["dkv"] + qlora["dkv"]),
        ("flash_bwd[dq]", bwd_src, DQ_REPLACES, stage1["dq"] + stage2["dq"] + qlora["dq"]),
        ("decode_attention[bf16]", "llava_plus_torch/csrc/decode_attention.cu",
         DECODE_REPLACES, single["bf16"]),
        ("decode_attention[int8]", "llava_plus_torch/csrc/decode_attention.cu",
         DECODE_REPLACES, single["int8"] + ckpt["decode"] + int8["decode"] + int4["decode"]),
        ("quant_matmul[int8]", "llava_plus_torch/csrc/quant_matmul.cu", INT8_REPLACES,
         ckpt["quant"] + int8["quant"] + paged["quant"] + spec["quant"] + mpt["dense"]["matmul_int8"]
         + mpt["paged"]["matmul_int8"] + narrow_lora[8][0] + tools["int8"]),
        ("quant_matmul[int4]", "llava_plus_torch/csrc/quant_matmul.cu", INT4_REPLACES,
         int4["quant"] + narrow_lora[4][0] + qlora["int4"] + tools["int4"]),
        ("quant_matmul[int4n]", "llava_plus_torch/csrc/quant_matmul.cu", INT4N_REPLACES,
         tools["int4n"]),
        ("paged_attention[decode1]", paged_src, PAGED_DECODE1_REPLACES,
         paged["decode1"] + spec["decode1"]),
        ("paged_attention[general]", paged_src, PAGED_GENERAL_REPLACES,
         narrow_general + spec["general"] + spec["narrow"]["general"]),
        # the verify chunks (Tq = k + 1) of the speculative engines (phase 17),
        # where the JAX package runs XLA's quant_cache_attention chain
        ("decode_attention[verify]", "llava_plus_torch/csrc/decode_attention.cu",
         DECODE_REPLACES, spec["chunk"] + spec["narrow"]["chunk"]),
        ("flash_fwd[alibi]", "llava_plus_torch/csrc/flash_fwd.cu", FLASH_ALIBI_REPLACES,
         mpt["dense"]["flash_attention[alibi]"] + mpt["paged"]["flash_attention[alibi]"]
         + mpt_stage1["flash"]),
        ("flash_bwd[dkv,alibi]", bwd_src, DKV_ALIBI_REPLACES,
         narrow_alibi_bwd["dkv"] + mpt_stage1["dkv"]),
        ("flash_bwd[dq,alibi]", bwd_src, DQ_ALIBI_REPLACES,
         narrow_alibi_bwd["dq"] + mpt_stage1["dq"]),
        ("decode_attention[G>8]", "llava_plus_torch/csrc/decode_attention.cu",
         DECODE_REPLACES, narrow_mpt["wide"]),
        ("decode_attention[alibi]", "llava_plus_torch/csrc/decode_attention.cu",
         DECODE_ALIBI_REPLACES, mpt["dense"]["decode_attention[alibi]"] + narrow_mpt["decode"]),
        ("paged_attention[decode1,alibi]", paged_src, PAGED_DECODE1_ALIBI_REPLACES,
         mpt["paged"]["paged_decode1[alibi]"] + narrow_mpt["decode1"]),
        ("paged_attention[general,alibi]", paged_src, PAGED_GENERAL_ALIBI_REPLACES,
         narrow_mpt["general"] + spec["narrow"]["general[alibi]"]),
    ):
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": count, **stats[name]})
        if name == "quant_matmul[int8]":
            # the serving engines' int8 launches by regime (phases 16, 6, 7, 11)
            regimes = [ckpt["quant_regimes"], int8["quant_regimes"], paged["quant_regimes"],
                       mpt["dense"]["matmul_int8 regimes"], mpt["paged"]["matmul_int8 regimes"]]
            entries[-1].update(engine_decode_launches=sum(r[0] for r in regimes),
                               engine_prefill_launches=sum(r[1] for r in regimes))
        elif name == "quant_matmul[int4]":
            # the int4 engine's launches by regime (phase 6)
            entries[-1].update(engine_decode_launches=int4["quant_regimes"][0],
                               engine_prefill_launches=int4["quant_regimes"][1])
        elif name == "quant_matmul[int4n]":
            # the int4 tools' native launches by regime (phase 14, 16 rows)
            entries[-1].update(tools_decode_launches=tools["int4n regimes"][0],
                               tools_prefill_launches=tools["int4n regimes"][1])
        elif name == "paged_attention[general]":
            # the 7B paged engines' general launches (phases 7 and 11): 0, as
            # those phases require (MHA decode is decode1's; a suffix prefill
            # runs in 256-token buckets over the gathered pages)
            entries[-1].update(engine_7b_launches=paged["general"]
                               + mpt["paged"]["paged_attention_general"]
                               + mpt["paged"]["paged_attention_general[alibi]"],
                               engine_7b_spec_launches=spec["general"])
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "llava_plus_tpu"))
    if foreign:
        raise AssertionError(f"the port pulled in JAX or the JAX package: {foreign[:5]}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
