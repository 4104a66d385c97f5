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
   a 16-slot verify step's 80 and 128 rows; the two W8A8 kernels bit for
   bit against their plain versions (the row quantize at 768 and 3,072 rows
   of K = 4096 and 11008, bf16 and f32; the epilogue at the 7B's N), each
   through its wrapper and alone, and the W8A8 product at wqkv and w_down
   beside the weight-only int8 kernel and bf16 ``torch.matmul``; and rows at
   LLaVA-1.5-13B's shapes (``phase_13b_kernels``): the flash forward at 40
   heads (T = 768 and 2,048), the dense decode kernel at 8 and 16 slots of
   2,048 over 40 kv heads (bf16, int8), the int8 and int4 matmuls on its
   fused wqkv, wo, w_gateup, w_down and head at 1, 8, 16, 80, 768 and 3,072
   rows, and paged decode1 at 8 and 16 slots of 32 pages (40 kv heads); and
   the flash forward, dK/dV and dQ at stage 1's padded length (40 heads,
   T = 640, a padded row; phase 28's shape);
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
9. LLaVA-1.5-7B's width at 8 of its 32 layers (``STAGE_LAYERS``; phase 27
   runs a 7B at the whole depth) in stage 1 through the port's ``train()``
   with the ``scripts/v1_5/pretrain.sh`` recipe (projector only, batch 32) on 64
   synthetic image-caption records: 2 steps, frozen bytes, the
   ``mm_projector.bin`` export and the launch counts; then one more step
   eager and through ``make_train_step(..., mesh=make_mesh(1, 1, 1))`` on a
   one-rank NCCL group (every leaf a DTensor, the flash kernels through
   the mesh's local wrapper, loss, grad_norm and projector against the
   eager step's, host ms of both);
10. LLaVA-1.5-7B's width at ``STAGE_LAYERS`` layers in stage 2 through
   ``make_train_step`` with the
   ``scripts/v1_5/finetune.sh`` recipe reduced to batch 4 with gradient
   accumulation 2, on 16 synthetic multi-turn image records of 700-2048
   tokens: 2 steps, every trained leaf updated, the vision tower frozen, the
   launch counts and the peak memory;
11. (run after 7, before the training phases) LLaVA-MPT-7B at full width,
   random bf16 weights quantized to int8, int8 KV, behind the HTTP worker:
   the dense engine (8 concurrent ``conv_mpt`` requests, 4 image and 4 text,
   of 32 greedy tokens), then the paged engine with the prefix cache (128
   pages of 128; 8 requests, then 4 multi-turn follow-ups that hit their
   pooled prefixes), with TTFT p50, tokens/s, peak memory, page accounting
   and every ALiBi kernel's launch count checked;
12. LLaVA-MPT-7B stage 1 through ``train()`` at full width and depth with
   the ``scripts/pretrain.sh`` recipe (projector only, batch 32) on 64
   synthetic image-caption records: 2 steps, frozen bytes, the
   ``mm_projector.bin`` export and the ALiBi kernels' launch counts (the
   backward to the projector runs both ALiBi backward kernels);
13. LLaVA-1.5-7B QLoRA through ``train()`` with the
   ``scripts/finetune_qlora.sh`` recipe (``--lora-enable --bits 4``, r 128,
   alpha 256, remat) reduced to batch 4, 2 steps on records of 700-2048
   tokens and 8 of the 32 layers: every adapter leaf updated, the int4 base
   unchanged, the PEFT export, the peak memory and the int4 kernel's
   forward launches and backward calls;
14. the port's int4 measurement tools (``llava_plus_torch.tools.
   bench_int4_variants`` and ``bench_int4``) in-process through their
   ``main``: split-half int4, native int4 and int8 kernels at the five
   shapes of the JAX tool and at LLaVA-1.5-7B's three, each checked against
   its plain version and timed, with exact launch counts;
15. (phase 3's device times, taken last because a ``torch.profiler``
   session can leave CUPTI attached and slow the host clocks of later
   phases, and in a process of its own, on a fresh CUPTI: late in a whole
   run the profiler loses kernel events) the flash forward, dK/dV, dQ and
   dense decode rows, the int8 and int4 matmuls at every shape and row of phase 3, the native int4
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
   the share of the bound; and phase 3's 13B rows at decode rows (the int8
   and int4 matmuls at 1, 8 and 16 rows, dense decode and decode1 at 8 and
   16 slots) and at training shapes (the flash forward, dK/dV and dQ at 40
   heads, int4 on w_gateup and the head at 8,192 and 32,768 rows), the
   kernel alone;
17. (run after 7, before 11) speculative serving on fresh int8 weights of
   LLaVA-1.5-7B's width at 8 of its 32 layers (``SPEC_LAYERS``), int8 KV: ``llava_plus_torch.tools.bench_spec``'s stream (160
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
18. (run after 17, before 11) a LLaVA-Plus tool turn at LLaVA-1.5-7B
   width: random bf16 weights (seed 0) with a planted decoding chain
   (``llava_plus_torch.tools.planted``: greedy decoding after ``ASSISTANT:``
   emits one ``grounding_dino`` call in the thoughts / actions / value
   grammar), int8 fused, behind the HTTP worker on the paged engine (256
   pages, prefix cache, 16 slots), registered with the port's controller;
   the controller, the fake tool worker and the web server
   (``--llava-plus``) started as ``python -m`` processes. 8 sessions at
   once send an image turn and a follow-up of their own through
   ``/api/chat``, with speculation off, then ``speculate=4`` with the
   acceptance gate off: the prompts the worker receives (every word known
   to the tokenizer), every stream's events in the JAX package's order,
   the round texts equal to the planted reply and across passes, prefix
   hits (each follow-up's round 2 admitted on a hit, with no vision
   encode), page accounting, the controller's registry and queues, exits
   on SIGTERM and launch counts; round-1 TTFT, tool dispatch,
   round-2 TTFT and turn seconds (p50), tokens/s and ``spec_acceptance``;
19. (run after 18, before 11) the eval harness from phase 16's checkpoint
   (kept on disk until then): 4 image questions written under ``.smoke/``
   and ``python -m llava_plus_torch.eval.model_vqa_loader --model-path
   ...`` run as a user runs it, three times at once (single-stream greedy,
   ``--engine-slots 8``, ``--num_beams 3 --max-new-tokens 16``), each
   process's flash and bf16 decode launches checked against its prefills
   and steps; where an engine answer differs from the single-stream one,
   the top-2 logit gap at the first differing token within phase 4's
   bound; the 7B beam search against a cache-free oracle on the card at a
   4-token budget (a differing selection only where the oracle's closest
   margin is within twice that bound); load seconds, answers/s, seconds a beam
   answer, the beam reorder's ms a step and peak device memory;
20. (run after 6, on its int8 fused tree) the dense engine with
   ``w8a8=True`` (16 slots, int8 KV): a 4-image-prompt prefill with and
   without W8A8 alternated (CUDA events) and their first-token logits
   within a bound stated beforehand, bursts of 16 image prompts x 32
   tokens on a weight-only and on the W8A8 engine (peak memory each; the
   W8A8 kernels once a decoder product a prefill, the int8 kernel at
   decode rows only), then a plain 256-row product outside the engine,
   which must be the weight-only kernel's bit for bit;
22. (run after 19, on phase 16's checkpoint, before it is removed) the
   deployment predictor: ``Predictor.setup`` on the checkpoint, one image
   prompt streamed for 32 greedy tokens, bit for bit ``Generator.stream``'s
   on the loaded tree, with its launch counts; setup seconds, seconds to
   the first piece, tokens a second;
23. the native image library (``data/native``, built with g++ from the
   port's ``native/llava_img.cpp``) single and batched against
   ``ClipImageProcessor`` within one uint8 level, host ms an image beside
   the host CPU;
24. the narrow model's stage-2 training state placed on a one-rank NCCL
   ``make_mesh(1, 1, 1)``, saved shard by shard
   (``checkpoint.save_train_state``), restored onto fresh DTensors and into
   one process's plain trees, every leaf bit for bit; seconds and bytes;
   then (``phase_resume``) ``scripts/v1_5/finetune.sh``'s flags through
   ``train.main`` at the narrow width, 2 rows x 2 micro-batches a step,
   cut after its save at step 2 and resumed (``llava_plus_torch/tools/
   train_resume.py``'s ``cut_run``, both runs in this process): steps 3-4,
   their sample ids and the state after them bit for bit the run's that
   was never cut, the restored state bit for bit the state after step 2,
   exact flash launches;
16. (run after 5, before 6) a tree of LLaVA-1.5-7B's width at 2 of its 32
   layers (``CKPT_LAYERS``) exported as an HF checkpoint under ``.smoke/``
   (one ``model.safetensors``, 2.0 GB, with a word-level tokenizer that
   names every id) and served from disk: ``load_pretrained_model`` in this
   process, every leaf equal to the exported one bit for bit; the worker
   started as a user starts it (``python -m llava_plus_torch.serve.
   model_worker --model-path ... --load-8bit --kv-int8 --max-slots 16
   --limit-model-concurrency 16``)
   answering phase 6's burst, then requests one at a time whose greedy texts
   equal a ``TorchBackend`` built in this process by the worker's own
   factory on the loaded tree; the worker stopped by SIGTERM; one turn of
   ``python -m llava_plus_torch.serve.cli`` with its input piped (in a
   whole run, beside phase 19's runner processes). Write and
   load times, host GB/s, the worker's first served token from its start,
   TTFT p50, tokens/s and its peak device memory;
25. (run after 7, before 17) LLaVA-1.5-13B at full width and 10 of its 40
   layers (``SERVE_13B_LAYERS``), random bf16 weights: ``TorchBackend`` behind ``build_app`` with
   int4 fused weights and int8 KV at 8 slots (8 image prompts at once; the
   quantization's peak device memory held to the bf16 tree plus the int4
   tree plus 2 GiB), requests one at a time through the engine and the
   single-stream ``Generator`` on the same tree (equal ids, or a top-2 gap
   within phase 4's bound where they part), int8 weights on the dense
   engine at 16 slots and on the paged engine with the prefix cache (hits
   counted, no vision encode on a hit), each engine's decode step timed
   (host ms, device busy); then a 2-layer
   checkpoint at 13B's width served by ``python -m
   llava_plus_torch.serve.model_worker --load-4bit --kv-int8 --max-slots 8``
   registered with the port's controller (``python -m
   llava_plus_torch.serve.controller``), 8 streams to the address
   ``/get_worker_address`` gives and one through the controller's stream
   route, both processes stopped by SIGTERM with exit code 0;
26. (run after 28, before 27) LLaVA-1.5-13B trained at full width and depth
   through ``llava_plus_torch.train.train.main`` from phase 28's base
   language model, tower and ``mm_projector.bin`` (``--model-name-or-path``,
   ``--vision-tower``, ``--pretrain-mm-mlp-adapter``):
   ``scripts/v1_5/finetune_lora.sh``'s flags (LoRA r 128 on the bf16 base,
   batch 16 at max length 2048), then the same plus ``--bits 4`` on the
   same tree quantized in place (the base read from disk once, for both);
   for each, its start checked (the base's, the tower's and the stage-1
   projector's bytes), 2 steps with exact launch counts of the
   flash forward and backward kernels and the int4 kernel and its backward,
   every adapter leaf moved, the base, tower and projector bytes kept, the
   PEFT export, the peak memory under a stated bound and the last step's
   device time by class; then the trained adapters merged into the base,
   every merged weight held to this script's own f64 sum of the base (an
   int4 base dequantized here) and the adapters within f32's error bound,
   and a 768-token image prefill through the merged tree beside the lazy
   adapters (finite, exact launches, its difference logged);
27. (run after 26, before 14) LLaVA-Plus-7B (vicuna-7b-v1.3: LLaMA-7B;
   CLIP ViT-L/14 at 224 px; a linear projector) from a base checkpoint at
   full width and 2 of its 32 layers (``PLUS7B_LAYERS``: the run's disk
   and time budgets): a plain HF LLaMA directory (random bf16 weights
   with phase 18's planted chain, a word-level tokenizer with a BOS that
   knows every word of the corpora and of the tool turn) and an HF CLIP
   directory, written by the port's exporters after a check of free disk;
   ``scripts/pretrain.sh``'s flags through ``llava_plus_torch.train.train.
   main`` from them (``--vision-tower`` the directory: the trainer builds
   the tower and the projector; 2 steps of 32 image captions; the language
   model and the tower are the directories' bytes and keep them, the
   projector moves, ``mm_projector.bin``, the launches), then
   ``scripts/llava_plus/training_llava_plus_v1_3_7b.sh``'s flags (two
   datasets in two image folders: image chats and tool-use records, some
   without an image; batch 4 with accumulation 2; 2 steps and the HF
   export, alone (``--save-only-model``: the 41 GB training state would
   pass the 45 GiB a call may write); every language-model and projector
   leaf updated, the tower kept, the launches); the planted chain's margins on
   the export; the export served by the model worker's own ``main``
   (``--load-8bit``) in a child process under the port's controller with
   phase 18's fake tool worker and web server: 4 sessions of an image turn
   and a follow-up through ``/api/chat``, every turn's events and texts,
   the worker's 256 image tokens and linear projector, round 1 the greedy
   tokens of the ``Generator`` on the same export with int8 weights, the
   launches of both, every process's exit on SIGTERM; peak memory, host ms
   a step, tokens/s, write and load seconds, TTFT and turn seconds;
28. (run after 13, before 26) LLaVA-1.5-13B stage 1 from a base language
   model at full width and depth: a plain HF LLaMA directory of
   vicuna-13b-v1.5's shape (40 layers of 5,120, random bf16 weights, 26 GB)
   and an HF CLIP ViT-L/14-336 directory, written by the port's exporters
   after a check of free disk; ``scripts/v1_5/pretrain.sh``'s flags through
   ``llava_plus_torch.train.train.main`` from them (the trainer builds the
   tower and the mlp2x_gelu projector; 2 steps of 32 image captions at 336
   px, rows of 640): every loss finite, the language model and the tower
   the directories' bytes and kept, every projector leaf moved, the only
   gradients the projector's and ``grad_norm`` their norm,
   ``mm_projector.bin`` (1,024 -> 5,120 -> 5,120) bit for bit the trained
   projector, exact launches, the peak device memory under a bound stated
   beforehand, each step's host ms, tokens/s and peak and the last step's
   device time by class. Its base, tower and ``mm_projector.bin`` are
   phase 26's start.

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
of the JAX package (``llava_plus_tpu``) was imported. Each phase logs its
seconds as it ends, and a ``phase seconds`` line gathers them; the line
before the last is a JSON summary of the kernels; the last line is the
JSON result.
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
# W8A8's quantize and epilogue stand in for what XLA fuses in the JAX
# package (no Pallas kernel there)
W8A8_REPLACES = "llava_plus_tpu/ops/quant.py:146 _w8a8_matmul"

# Published peaks of one H100 SXM (dense): HBM3 bytes/s and bf16 tensor-core
# flop/s. A kernel's bound is the larger of its bytes over the first and its
# flops over the second.
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
INT8_OPS_S = 1979e12   # int8 tensor-core operations a second


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


def bound(nbytes, flops, ops_s=BF16_FLOPS_S):
    """The least time (ms) the card could take to move ``nbytes`` and do
    ``flops`` operations at ``ops_s`` (bf16 by default), and which of the
    two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / ops_s * 1e3
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
    # phases 16 and 25 write checkpoints of 2.8 and 3.9 GB under .smoke/
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
# LLaVA-1.5-13B's fused matrices and head (K x N), and the rows its engines
# give them: one decode row, 8 and 16 slots, a 16-slot verify step of 5
# tokens, one 768-token prefill and the engine's 4-prompt batch; phase 15
# times the decode rows alone
QUANT_13B_SHAPES = (("13B wqkv", 5120, 15360), ("13B wo", 5120, 5120),
                    ("13B w_gateup", 5120, 27648), ("13B w_down", 13824, 5120),
                    ("13B lm_head", 5120, 32000))
ROWS_13B = (1, 8, 16, 80, 768, 3072)
DECODE_ROWS_13B = (1, 8, 16)
# the int4 kernel at a 13B QLoRA step's rows (phase 26: 16 x 2048; 4 x 2048
# for a batch of 4) on the fused MLP matrix and the head
TRAIN_13B_SHAPES = ("13B w_gateup", "13B lm_head")
TRAIN_ROWS_13B = (8192, 32768)
# the 13B engines' slots (the int4 engine's 8, the int8 and paged engines' 16)
SLOTS_13B = (8, 16)


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


def check_quant(kind, name, K, N, gen, extra_rows=(), row_counts=None):
    """One weight, every row count (``row_counts``, else the kind's phase-3
    rows and ``extra_rows``): kernel and plain version against the f64
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
    out_dtype = (torch.float32 if name.endswith("lm_head") or kind == "int4n"
                 else torch.bfloat16)
    kw = {} if kind == "int4n" else {"out_dtype": out_dtype}
    nbytes = q.numel() + s.numel() * 4
    w16 = _dequant16(kind, q, s)
    for rows_, cut in ((INT8_ROWS, qm.INT8_CUT), (INT4_ROWS, qm.INT4_CUT),
                       (INT4N_ROWS, qm.INT4N_CUT)):
        if not {cut, cut + 1} <= set(rows_):
            raise AssertionError(f"the rows {rows_} must hold both sides of the cut {cut}")
    rows = {}
    for R in row_counts or {"int8": INT8_ROWS, "int4": INT4_ROWS,
                            "int4n": INT4N_ROWS}[kind] + extra_rows:
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
    if name in ("wqkv", "7B q/o", "13B wqkv"):
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


# W8A8 (the engine's int8 activations for prefill rows): the quantize at a
# prefill's rows and LLaVA-1.5-7B's contraction dims, the epilogue at its
# output dims, the product at wqkv and w_down
W8A8_ROWS = (768, 3072)
W8A8_K = (4096, 11008)
W8A8_N = (12288, 22016, 4096, 32000)
W8A8_PRODUCTS = (("wqkv", 4096, 12288), ("w_down", 11008, 4096))
# a row-parallel product's K on one rank of LLaMA-7B at tp = 4 (wo, w_down)
W8A8_GIVEN_K = (1024, 2816)


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def phase_w8a8_kernels():
    """The two W8A8 kernels bit for bit against their plain versions (the
    int8 rows, the row scales, the epilogue outputs), each timed through
    its wrapper and alone (the C entry point on preallocated buffers), with
    the plain version and the bound; then the whole W8A8 product (quantize,
    ``torch._int_mm`` on the K-major copy, epilogue) against its plain
    version (the int32 product in f64, exact) beside the weight-only int8
    kernel and the bf16 ``torch.matmul`` on the same weight."""
    import torch
    from llava_plus_torch.kernels import build
    from llava_plus_torch.ops import quant
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops import w8a8 as w8

    gen = torch.Generator(device="cuda").manual_seed(5)
    lib = build.lib()
    quant_rows, epi_rows, products = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        for R in W8A8_ROWS:
            for K in W8A8_K:
                x = (torch.randn(R, K, generator=gen, device="cuda")
                     * torch.rand(R, 1, generator=gen, device="cuda") * 8).to(dtype)
                x[1] = 0.0                                   # the 1e-6 floor
                xq, sc = w8.w8a8_quantize_rows(x)
                pq, ps = w8.quantize_rows_reference(x)
                same = torch.equal(xq, pq) and torch.equal(sc, ps)
                oq, os_ = torch.empty_like(xq), torch.empty_like(sc)
                ms = time_ms(lambda: w8.w8a8_quantize_rows(x))
                alone = time_ms(lambda: lib.w8a8_quantize_rows(
                    x.data_ptr(), int(dtype == torch.bfloat16), R, K, K, oq.data_ptr(),
                    os_.data_ptr(), None, _stream()))
                plain_ms = time_ms(lambda: w8.quantize_rows_reference(x))
                b = bound(R * K * (x.element_size() + 1) + 4 * R, 0)
                log("kernels", f"w8a8_quantize_rows {str(dtype)[6:]} R={R} K={K}: int8 rows and "
                               f"scales equal the plain version's {same}; {ms:.4f} ms "
                               f"(alone {alone:.4f}) vs plain {plain_ms:.4f} ms, bound "
                               f"{b['bound_ms']:.4f} ms ({b['bound_by']}) -> "
                               f"{'ok' if same else 'FAIL'}")
                if not same:
                    raise AssertionError(f"w8a8_quantize_rows {dtype} R={R} K={K} differs from "
                                         "its plain version")
                quant_rows[str(dtype)[6:], R, K] = {"max_abs_err": 0.0, "ms": ms,
                                                   "alone_ms": alone, "plain_ms": plain_ms, **b}
    # the given row amax (a row-parallel product under tensor parallelism):
    # one rank's slice of K, each row's absmax taken over the whole row
    given = {}
    for R in W8A8_ROWS:
        for K in W8A8_GIVEN_K:
            full = (torch.randn(R, 4 * K, generator=gen, device="cuda")
                    * torch.rand(R, 1, generator=gen, device="cuda") * 8).bfloat16()
            full[1] = 0.0
            x = full[:, K:2 * K].contiguous()
            amax = full.abs().amax(dim=-1)
            xq, sc = w8.w8a8_quantize_rows(x, amax)
            pq, ps = w8.quantize_rows_reference(x, amax)
            wq, ws = w8.quantize_rows_reference(full)
            same = torch.equal(xq, pq) and torch.equal(sc, ps)
            whole = torch.equal(xq, wq[:, K:2 * K]) and torch.equal(sc, ws)
            ms = time_ms(lambda: w8.w8a8_quantize_rows(x, amax))
            own = time_ms(lambda: w8.w8a8_quantize_rows(x))
            plain_ms = time_ms(lambda: w8.quantize_rows_reference(x, amax))
            b = bound(R * K * 3 + 2 * R + 4 * R, 0)
            log("kernels", f"w8a8_quantize_rows bf16 given amax R={R} K={K} (one rank's slice "
                           f"of a {4 * K} row): equal to the plain version {same}, to the whole "
                           f"row's quantization {whole}; {ms:.4f} ms (own reduction "
                           f"{own:.4f}) vs plain {plain_ms:.4f} ms, bound "
                           f"{b['bound_ms']:.4f} ms -> {'ok' if same and whole else 'FAIL'}")
            if not (same and whole):
                raise AssertionError(f"w8a8_quantize_rows with a given amax R={R} K={K} differs")
            given[R, K] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"]}
    for R in W8A8_ROWS:
        for N in W8A8_N:
            acc = torch.randint(-2 ** 22, 2 ** 22, (R, N), generator=gen, device="cuda",
                                dtype=torch.int32)
            rs = torch.rand(R, generator=gen, device="cuda") * 0.05
            cs = torch.rand(1, N, generator=gen, device="cuda") * 1e-3
            out = w8.w8a8_epilogue(acc, rs, cs, torch.bfloat16)
            same = torch.equal(out, w8.epilogue_reference(acc, rs, cs, torch.bfloat16))
            buf = torch.empty_like(out)
            ms = time_ms(lambda: w8.w8a8_epilogue(acc, rs, cs, torch.bfloat16))
            alone = time_ms(lambda: lib.w8a8_epilogue(
                acc.data_ptr(), rs.data_ptr(), cs.data_ptr(), buf.data_ptr(), 0, R, N,
                build.sm_count(acc.device), _stream()))
            plain_ms = time_ms(lambda: w8.epilogue_reference(acc, rs, cs, torch.bfloat16))
            b = bound(R * N * (4 + 2) + 4 * (R + N), 0)
            log("kernels", f"w8a8_epilogue R={R} N={N} -> bf16: equal to the plain version "
                           f"{same}; {ms:.4f} ms (alone {alone:.4f}) vs plain {plain_ms:.4f} ms, "
                           f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) -> "
                           f"{'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"w8a8_epilogue R={R} N={N} differs from its plain version")
            epi_rows[R, N] = {"max_abs_err": 0.0, "ms": ms, "alone_ms": alone,
                              "plain_ms": plain_ms, **b}
    for name, K, N in W8A8_PRODUCTS:
        w = torch.randn(K, N, generator=gen, device="cuda").mul_(0.02).bfloat16()
        qw = quant.quantize_array(w)
        q, s = qw[quant.QKEY], qw[quant.SKEY]
        qt = q.t().contiguous()
        w16 = qm.dequantize(8, q, s, torch.bfloat16)
        w64 = qm.dequantize(8, q, s, torch.float64)
        del w, qw
        for R in W8A8_ROWS:
            x = torch.randn(R, K, generator=gen, device="cuda").bfloat16()

            def plain_product():
                xq_, rs_ = w8.quantize_rows_reference(x)
                return w8.epilogue_reference(w8.int_mm_reference(xq_, q), rs_, s,
                                             torch.bfloat16)

            out = w8.w8a8_product(x, q, s, torch.bfloat16, qt)
            same = torch.equal(out, plain_product())
            truth = x.double() @ w64
            top = truth.abs().max().item()
            err = (out.double() - truth).abs().max().item() / top
            wo_err = (qm.matmul_int8(x, q, s).double() - truth).abs().max().item() / top
            del truth
            xq, _ = w8.w8a8_quantize_rows(x)
            ms = time_ms(lambda: w8.w8a8_product(x, q, s, torch.bfloat16, qt))
            mm_ms = time_ms(lambda: torch._int_mm(xq, qt.t()))
            rowmajor_ms = time_ms(lambda: torch._int_mm(xq, q), iters=5)
            plain_ms = time_ms(plain_product, iters=3, warmup=1)
            int8_ms = time_ms(lambda: qm.matmul_int8(x, q, s))
            bf16_ms = time_ms(lambda: torch.matmul(x, w16))
            b = bound(R * K * 2 + K * N + 4 * N + R * N * 2, 2 * R * K * N, INT8_OPS_S)
            log("kernels", f"w8a8 product {name} R={R} K={K} N={N}: equal to the plain version "
                           f"{same}, rel err {err:.3e} against the f64 product of the "
                           f"dequantized weight (weight-only kernel {wo_err:.3e}); {ms:.4f} ms "
                           f"({2 * R * K * N / ms / 1e9:.1f} TOP/s; _int_mm alone "
                           f"{mm_ms:.4f} ms on the K-major copy, {rowmajor_ms:.4f} ms on the "
                           f"row-major weight) vs plain {plain_ms:.4f} ms; int8_wgmma_kernel "
                           f"{int8_ms:.4f} ms, bf16 torch.matmul {bf16_ms:.4f} ms; bound "
                           f"{b['bound_ms']:.4f} ms ({b['bound_by']}) -> "
                           f"{'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"the w8a8 product {name} R={R} differs from its plain "
                                     "version")
            products[name, R] = {"ms": ms, "int_mm_ms": mm_ms, "int_mm_rowmajor_ms": rowmajor_ms,
                                 "plain_ms": plain_ms, "int8_wgmma_ms": int8_ms,
                                 "bf16_matmul_ms": bf16_ms, "rel_err": err, **b}
    head_q = quant_rows["bfloat16", 768, 4096]
    head_e = epi_rows[768, 12288]
    extra = {f"{name}_r{R}_{k}": v for (name, R), row in products.items()
             for k, v in row.items() if k != "bound_by"}
    return {
        "w8a8_quantize_rows": dict(head_q, shape="bf16 R=768 K=4096", library_ms=None,
                                   r3072_k11008_ms=quant_rows["bfloat16", 3072, 11008]["ms"],
                                   **{f"given_amax_r{R}_k{K}_{k}": v
                                      for (R, K), row in given.items() for k, v in row.items()}),
        "w8a8_epilogue": dict(head_e, shape="R=768 N=12288 -> bf16", library_ms=None,
                              r3072_n12288_ms=epi_rows[3072, 12288]["ms"], **extra),
    }


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
    stats = {"flash_fwd": flash,
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
            **phase_paged_kernels(gen, rng),
            **phase_w8a8_kernels()}
    # the rows at LLaVA-1.5-13B's shapes, their errors in each line's largest
    for name, row in phase_13b_kernels().items():
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], row["max_abs_err"])
        stats[name]["13b"] = row["13b"]
    return stats


def _row(r):
    """A phase-3 row for the kernels line: [ms, bound ms, library ms,
    yardstick ms], None where the row has none."""
    return [None if r.get(k) is None else round(r[k], 5)
            for k in ("ms", "bound_ms", "library_ms", "yardstick_ms")]


def phase_13b_kernels():
    """Phase 3's rows at LLaVA-1.5-13B's shapes (40 heads of 128, hidden
    5,120, FFN 13,824), on a generator of their own: the flash forward at
    B = 2, H = 40, T = 768 and 2,048 (library: sdpa); the dK/dV and dQ
    kernels at B = 2, H = 40, T = 2,048 (library: sdpa's backward); the int4
    matmul on w_gateup and the head at TRAIN_ROWS_13B; the dense decode kernel
    at 8 and 16 slots of 2,048, bf16 (library: sdpa) and int8; the int8 and
    int4 matmuls on the fused matrices and the head at ROWS_13B (beside the
    bf16 yardstick; wqkv at 16 rows also the library's weight-only
    product); paged decode1 at 8 and 16 slots of 32 pages of 128 over an
    int8 pool; the flash forward, dK/dV and dQ at stage 1's padded length
    (B = 2, H = 40, T = STAGE1_13B_T, phase 28's rows; a padded row in
    each). Each row against its plain version and the f64 truth by
    phase 3's criterion, launched twice, bit for bit. Returns, per kernel
    line, its largest error and its rows (:func:`_row`) under "13b"."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13)
    rng = np.random.default_rng(13)
    rows = {}
    flash = {T: check_flash("13B MHA", B=2, T=T, H=40, Hkv=40, pad_tail=100, gen=gen)
             for T in (768, 2048)}
    rows["flash_fwd"] = {f"T={T}": r for T, r in flash.items()}
    for tag in ("bf16", "int8"):
        rows[f"decode_attention[{tag}]"] = {
            f"B={B} S=2048": check_decode(tag, B=B, S=2048, H=40, Hkv=40, gen=gen, rng=rng)
            for B in SLOTS_13B}
    for kind in ("int8", "int4"):
        rows[f"quant_matmul[{kind}]"] = {
            f"{name} R={R}": r for name, K, N in QUANT_13B_SHAPES
            for R, r in check_quant(kind, name, K, N, gen, row_counts=ROWS_13B).items()}
    rows["paged_attention[decode1]"] = {
        f"B={B} pages/slot=32": check_paged("13B int8", 40, 1, True, gen, rng, B=B, H=40,
                                            pages_per_slot=32)
        for B in SLOTS_13B}
    # phase 26's training shapes, on a generator of their own (every row
    # above keeps its inputs): both backward kernels at B 2, H 40, T 2,048,
    # causal; the int4 kernel at a QLoRA step's rows
    gen_train = torch.Generator(device="cuda").manual_seed(15)
    dkv, dq = check_flash_bwd("13B MHA", B=2, T=2048, H=40, Hkv=40, gen=gen_train)
    rows["flash_bwd[dkv]"], rows["flash_bwd[dq]"] = {"B=2 T=2048": dkv}, {"B=2 T=2048": dq}
    for name, K, N in QUANT_13B_SHAPES:
        if name in TRAIN_13B_SHAPES:
            rows["quant_matmul[int4]"].update(
                {f"{name} R={R}": r for R, r in check_quant(
                    "int4", name, K, N, gen_train, row_counts=TRAIN_ROWS_13B).items()})
    # phase 28's shape: stage 1's rows of an image and a caption, padded to
    # STAGE1_13B_T (not a multiple of the kernels' 128-row tiles), on a
    # generator of their own
    gen_stage1 = torch.Generator(device="cuda").manual_seed(28)
    T = STAGE1_13B_T
    rows["flash_fwd"][f"T={T}"] = check_flash("13B stage 1", B=2, T=T, H=40, Hkv=40,
                                              pad_tail=50, gen=gen_stage1)
    dkv, dq = check_flash_bwd("13B stage 1", B=2, T=T, H=40, Hkv=40, gen=gen_stage1)
    rows["flash_bwd[dkv]"][f"B=2 T={T}"], rows["flash_bwd[dq]"][f"B=2 T={T}"] = dkv, dq
    return {name: {"max_abs_err": max(r["max_abs_err"] for r in per.values()),
                   "13b": {k: _row(r) for k, r in per.items()}}
            for name, per in rows.items()}


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
    _device_times_13b(stats)


def _device_times_13b(stats):
    """Phase 3's 13B rows at decode rows, each kernel alone (its own device
    time, taken twice), from seeds of their own: the int8 and int4 matmuls
    on the five matrices at DECODE_ROWS_13B, the dense decode kernel at 8
    and 16 slots of 2,048 (bf16, int8) and paged decode1 at 8 and 16 slots of
    32 pages (int8). Adds [device ms, bound ms] by row under "13b_alone"."""
    import torch
    from llava_plus_torch.ops import paged_attention as pa
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention

    gen = torch.Generator(device="cuda").manual_seed(14)
    rng = np.random.default_rng(14)

    def alone(line, row, call, names, b):
        ms = (device_ms(call, names) + device_ms(call, names)) / 2
        log("device", f"{line} {row}: kernel {ms:.4f} ms device, {b['bound_ms'] / ms:.1%} of "
                      f"the bound ({b['bound_ms']:.4f} ms, {b['bound_by']})")
        stats[line].setdefault("13b_alone", {})[row] = [round(ms, 5), round(b["bound_ms"], 5)]

    for kind, wrapper, names in (("int8", qm.matmul_int8, INT8_KERNEL),
                                 ("int4", qm.matmul_int4, INT4_KERNEL)):
        for name, K, N in QUANT_13B_SHAPES:
            q, s = _quantize(kind, torch.randn(K, N, generator=gen, device="cuda").mul_(0.02)
                             .bfloat16())
            out_dtype = torch.float32 if name.endswith("lm_head") else torch.bfloat16
            for R in DECODE_ROWS_13B:
                x = torch.randn(R, K, generator=gen, device="cuda").bfloat16()
                out_bytes = R * N * (4 if out_dtype == torch.float32 else 2)
                alone(f"quant_matmul[{kind}]", f"{name} R={R}",
                      lambda: wrapper(x, q, s, out_dtype=out_dtype), names,
                      bound(q.numel() + 4 * s.numel() + 2 * R * K + out_bytes, 2 * R * K * N))
            del q, s
    for tag in ("bf16", "int8"):
        for B in SLOTS_13B:
            q, kc, vc, seg, q_pos, ks, vs, fills = _decode_inputs(tag, B, 2048, 40, 40, gen, rng)
            _, b = _decode_bound(fills, B, 40, 40, 2048, kc.element_size(), ks is not None)
            alone(f"decode_attention[{tag}]", f"B={B} S=2048",
                  lambda: decode_attention(q, kc, vc, seg, q_pos, ks, vs), DECODE_KERNEL, b)
            del q, kc, vc, seg, q_pos, ks, vs
    for B in SLOTS_13B:
        (q, pool, scale, page_ids, lens, ck, cv, vals), lengths, valid = _paged_inputs(
            40, 1, True, gen, rng, B, 40, 128, 32)
        _, b = _paged_bound(lengths, valid, B, 40, 40, 1, 128, True, pool.element_size())
        alone("paged_attention[decode1]", f"B={B} pages/slot=32",
              lambda: pa.paged_decode_attention(q, pool, page_ids, lens, scale, ck, cv, vals),
              DECODE1_KERNEL, b)
        del q, pool, scale, page_ids, lens, ck, cv, vals
    _device_times_13b_train(stats)


def _device_times_13b_train(stats):
    """Phase 3's 13B training rows alone, from a seed of their own, each
    alternated with its library call or yardstick: the flash forward at
    B = 2, H = 40, T = STAGE1_13B_T, 768 and 2,048 (sdpa), dK/dV and dQ at
    T = STAGE1_13B_T and 2,048 (sdpa's backward), the int4 matmul on w_gateup and the head at
    TRAIN_ROWS_13B (bf16 ``torch.matmul``). Adds [device ms, bound ms,
    library or yardstick device ms] by row under "13b_alone"."""
    import torch
    import torch.nn.functional as F
    from llava_plus_torch.ops import flash_attention as fa
    from llava_plus_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(16)
    dev, D, B, H = "cuda", 128, 2, 40
    scale = D ** -0.5

    def add(line, row, ms, b, lib_ms, what):
        log("device", f"{line} {row}: kernel {ms:.4f} ms device, {what} {lib_ms:.4f} ms "
                      f"device, x{ms / lib_ms:.2f} of it, {b['bound_ms'] / ms:.1%} of the bound "
                      f"({b['bound_ms']:.4f} ms, {b['bound_by']})")
        stats[line].setdefault("13b_alone", {})[row] = [round(ms, 5), round(b["bound_ms"], 5),
                                                        round(lib_ms, 5)]

    for T in (768, 2048, STAGE1_13B_T):
        q, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        seg = torch.ones(B, T, dtype=torch.int32, device=dev)
        seg[-1, T - 100:] = 0
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms, lib_ms = _alternated(
            lambda: fa.flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg),
            FWD_KERNEL, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        b = bound(2 * 4 * B * T * H * D + 4 * B * H * T + 2 * 4 * B * T,
                  4 * H * D * _causal_pairs(seg, True))
        add("flash_fwd", f"13B B=2 T={T}", ms, b, lib_ms, "sdpa")
        del q, k, v, qt, kt, vt
    kw = dict(causal=True, sm_scale=scale, alibi_slopes=None)
    for T in (2048, STAGE1_13B_T):
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
                       for _ in range(4))
        seg = torch.ones(B, T, dtype=torch.int32, device=dev)
        seg[0, T - 100:] = 0
        seg[1, T // 2:] = 2
        out, lse = fa._launch(q, k, v, seg, seg, True, scale, None)
        delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        g_lib = do.transpose(1, 2).contiguous()
        pairs = _causal_pairs(seg, True)
        # q, k, v and dO read; lse, delta and the segment ids
        nbytes = 4 * 2 * B * T * H * D + 2 * 4 * B * H * T + 2 * 4 * B * T
        for line, fn, names, flops, out_bytes in (
                ("flash_bwd[dkv]", fa.flash_bwd_dkv, DKV_KERNEL, 8 * D * H * pairs,
                 2 * 2 * B * T * H * D),
                ("flash_bwd[dq]", fa.flash_bwd_dq, DQ_KERNEL, 6 * D * H * pairs,
                 2 * B * T * H * D)):
            ms, lib_ms = _alternated(
                lambda: fn(q, k, v, do, seg, seg, lse, delta, **kw), names,
                lambda: torch.autograd.grad(o_lib, (qt, kt, vt), g_lib, retain_graph=True))
            add(line, f"13B B=2 T={T}", ms, bound(nbytes + out_bytes, flops), lib_ms,
                "sdpa backward (dq, dk, dv)")
        del q, k, v, do, out, lse, delta, qt, kt, vt, o_lib, g_lib
    for name, K, N in QUANT_13B_SHAPES:
        if name not in TRAIN_13B_SHAPES:
            continue
        q4, s4 = _quantize("int4", torch.randn(K, N, generator=gen, device=dev).mul_(0.02)
                           .bfloat16())
        w16 = qm.dequantize(4, q4, s4, torch.bfloat16)
        out_dtype = torch.float32 if name.endswith("lm_head") else torch.bfloat16
        for R in TRAIN_ROWS_13B:
            x = torch.randn(R, K, generator=gen, device=dev).bfloat16()
            ms, yard_ms = _alternated(lambda: qm.matmul_int4(x, q4, s4, out_dtype=out_dtype),
                                      INT4_KERNEL, lambda: torch.matmul(x, w16))
            out_bytes = R * N * (4 if out_dtype == torch.float32 else 2)
            add("quant_matmul[int4]", f"{name} R={R}", ms,
                bound(q4.numel() + 4 * s4.numel() + 2 * R * K + out_bytes, 2 * R * K * N),
                yard_ms, "yardstick (bf16 matmul)")
            del x
        del q4, s4, w16


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

    def __init__(self, app, port=None):
        import asyncio

        from aiohttp import web

        self.port = port or _free_port()
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


def _init_llava(dev, cfg=None):
    """A LLaVA tree of ``cfg`` (LLaVA-1.5-7B by default) at its full width and
    depth, random bf16 weights from seed 0."""
    import torch
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_15_7B

    cfg = cfg or LLAVA_15_7B
    t0 = time.perf_counter()
    params = llava_model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log("init", f"random bf16 weights on {dev}: {n_params / 1e9:.3f} B parameters "
                f"({cfg.text.num_hidden_layers} layers of {cfg.hidden_size}) in "
                f"{time.perf_counter() - t0:.1f} s")
    return params


def _tree_bytes(tree):
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


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
# the depth of phase 16's checkpoint, at LLaVA-1.5-7B's width: 2 of its 32
# layers, 2.0 GB of safetensors (the whole model's 14.1 GB spent most of
# phases 16, 19 and 22 in writes and loads); phases 19 and 22 answer from it
CKPT_LAYERS = 2
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


def _wait_registered(ctrl, name, proc, t_start, deadline_s=600):
    """Seconds from ``t_start`` until the worker process ``proc`` lists
    ``name`` at the controller ``ctrl``; raises if it exits first or takes
    longer than ``deadline_s``."""
    import requests

    while name not in requests.post(ctrl + "/list_models", timeout=5).json()["models"]:
        if proc.poll() is not None:
            raise AssertionError(f"the worker exited with {proc.returncode} before registering")
        if time.perf_counter() - t_start > deadline_s:
            raise AssertionError(f"the worker did not register within {deadline_s} s")
        time.sleep(0.25)
    return time.perf_counter() - t_start


def _tail(path, n=3000):
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def _llava_7b(layers):
    """LLaVA-1.5-7B at ``layers`` of its 32 layers."""
    import dataclasses

    from llava_plus_torch.models.configs import LLAVA_15_7B

    return dataclasses.replace(LLAVA_15_7B, text=dataclasses.replace(
        LLAVA_15_7B.text, num_hidden_layers=layers))


def _ckpt_cfg():
    """Phase 16's checkpoint: LLaVA-1.5-7B at CKPT_LAYERS layers."""
    return _llava_7b(CKPT_LAYERS)


def export_checkpoint(params, cfg=None, name=CKPT_NAME):
    """The tree of ``cfg`` (phase 16's, :func:`_ckpt_cfg`, by default)
    written under ``.smoke/<name>`` as an HF checkpoint (one
    ``model.safetensors`` and the word-level tokenizer): (path, bytes of
    safetensors, seconds)."""
    from llava_plus_torch.train.checkpoint import export_hf_llava

    cfg = cfg or _ckpt_cfg()
    path = os.path.join(SMOKE_DIR, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(SMOKE_DIR, exist_ok=True)
    t0 = time.perf_counter()
    export_hf_llava(params, cfg, path, _word_tokenizer(cfg.text.vocab_size))
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
                 if f.endswith(".safetensors"))
    return path, nbytes, write_s


def phase_checkpoint(smi, params, cfg=None, device="cuda", keep=False):
    """A tree of LLaVA-1.5-7B's width at CKPT_LAYERS of its layers (``cfg``,
    :func:`_ckpt_cfg` by default) written as an HF checkpoint with the
    port's exporter, then served from disk:

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
       must answer (:func:`_start_cli`, :func:`_finish_cli`).

    ``keep`` leaves the checkpoint on disk (phases 19 and 22 answer from it)
    and the CLI's turn to the caller (``main`` runs it beside phase 19's
    runner processes, which load the same checkpoint).
    Returns this process's launch counts (flash, int8 decode, int8 matmul)."""
    import signal

    import requests
    import torch
    from llava_plus_torch.models.builder import load_pretrained_model
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.serve import model_worker as mw

    cfg = cfg or _ckpt_cfg()
    L, V = cfg.text.num_hidden_layers, cfg.text.vocab_size
    os.makedirs(SMOKE_DIR, exist_ok=True)
    disk = shutil.disk_usage(SMOKE_DIR)
    log("ckpt", f"free disk under {SMOKE_DIR}: {disk.free / 1e9:.1f} GB of "
                f"{disk.total / 1e9:.1f}")

    # the checkpoint, written once -------------------------------------------
    path, nbytes, write_s = export_checkpoint(params, cfg)
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

    # 4. the chat CLI (with ``keep``, the caller runs it beside phase 19) -----
    if not keep:
        _finish_cli(smi, _start_cli(path, cfg, device))
        shutil.rmtree(path, ignore_errors=True)
    return launches


def _start_cli(path, cfg=None, device="cuda"):
    """Phase 16's chat turn, started: ``python -m llava_plus_torch.serve.cli``
    on the checkpoint at ``path`` with a random image and one question piped
    in, its output to files under ``.smoke/``. :func:`_finish_cli` waits for
    it and checks the answer."""
    from PIL import Image

    cfg = cfg or _ckpt_cfg()
    png = os.path.join(SMOKE_DIR, "image.png")
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, size=(cfg.vision.image_size,) * 2 + (3,), dtype=np.uint8)).save(png)
    outs = [open(os.path.join(SMOKE_DIR, f"cli.{n}"), "w+") for n in ("out", "err")]
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "llava_plus_torch.serve.cli", "--model-path",
                             path, "--image-file", png, "--temperature", "0",
                             "--max-new-tokens", "16", "--device", device],
                            stdin=subprocess.PIPE, stdout=outs[0], stderr=outs[1], text=True,
                            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE))
    proc.stdin.write("w5 w17 w99 w7\n")
    proc.stdin.close()
    ended = {}

    def watch():
        proc.wait()
        ended["t"] = time.perf_counter()

    threading.Thread(target=watch, daemon=True).start()
    return proc, outs, t0, ended


def _finish_cli(smi, started, beside=None):
    """Waits for :func:`_start_cli`'s turn (killed after 600 s) and checks
    that it exited 0 with an answer; logs its seconds from its start to its
    end, the checkpoint's load included, as the CLI's own only when nothing
    else ran (``beside`` names what shared the card and the host with it)."""
    proc, outs, t0, ended = started
    try:
        code = proc.wait(600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
        raise AssertionError("the CLI did not answer within 600 s")
    cli_s = ended.get("t", time.perf_counter()) - t0
    for f in outs:
        f.seek(0)
    out, err = (f.read() for f in outs)
    for f in outs:
        f.close()
    # stdout: "USER: ASSISTANT: <answer>\nUSER: exit..."
    answer = out.partition("ASSISTANT: ")[2].partition("\n")[0].strip()
    if code != 0 or not answer:
        raise AssertionError(f"the CLI failed (exit {code}): {out[-1500:]}{err[-1500:]}")
    took = (f"taken beside {beside}, so not the CLI's own latency" if beside
            else "load included")
    log("ckpt", f"cli: one turn in {cli_s:.1f} s ({took}), answer of "
                f"{len(answer.split())} words: {answer[:60]!r}; card {smi}")


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


def serve_engine(smi, params, quantize, n_image, n_text, *, cfg=None, max_slots=16,
                 name="llava-1.5-7b-random", step_times=False):
    """``TorchBackend(use_engine=True)`` on ``params`` of ``cfg``
    (LLaVA-1.5-7B by default) with fused ``quantize`` weights (quantized in
    place: the caller's tree is the quantized one after) and an int8 KV
    cache, ``max_slots`` slots, decode chunks of 4, warmed at 768 tokens;
    every request sent at once. Checks every chunk, each request's full
    token count, batched admission, decode steps shared by several slots,
    and every kernel's launch count against the engine's own counts of
    prefill dispatches and decode steps. With ``step_times`` it then times
    the decode step at every slot (:func:`_decode_step_times`). Returns the
    launch counts, with the bytes of the quantized tree and the build's
    peak device memory."""
    import torch
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.serve.model_worker import ModelWorker, TorchBackend, build_app

    cfg = cfg or LLAVA_15_7B
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
                           use_engine=True, max_slots=max_slots, decode_chunk=4,
                           quantize=quantize, kv_int8=True, max_seq_len=2048, warmup_len=768)
    del params  # quantized in place into the backend's tree
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    engine = backend.engine
    tree_bytes = _tree_bytes(engine.params)
    log("engine", f"{name}: {quantize} weights, fused ({tree_bytes / 2 ** 30:.2f} GiB); int8 "
                  f"KV, {max_slots} slots x 2048, decode chunks of 4: built and warmed in "
                  f"{build_s:.1f} s (warmup {engine.warmup_s:.1f} s); peak device memory of "
                  f"the build {build_peak / 2 ** 30:.2f} GiB; card {smi}")
    bodies = _engine_bodies(np.random.default_rng(1), cfg.vision.image_size, n_image, n_text,
                            new_tokens)
    worker = ModelWorker("http://127.0.0.1:9", "http://127.0.0.1:0", backend, [name],
                         limit_model_concurrency=len(bodies), no_register=True,
                         heartbeats=False)
    server = _Server(build_app(worker))
    url = f"http://127.0.0.1:{server.port}/worker_generate_stream"
    torch.cuda.reset_peak_memory_stats()
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
    peak = torch.cuda.max_memory_allocated()
    _check_streams(bodies, results, new_tokens)
    want = {"flash": L * dp, "decode": L * ds, "quant": (4 * L + 1) * (dp + ds)}
    log("engine", f"{name} {quantize}: {len(bodies)} requests in {dp} prefill dispatches, "
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
    log("engine", f"{name} {quantize}: TTFT p50 {np.median(ttfts) * 1e3:.1f} ms (min "
                  f"{ttfts[0] * 1e3:.1f}, max {ttfts[-1] * 1e3:.1f}); {rate:.1f} tokens/s "
                  f"aggregate in {t_end - t_start:.2f} s, per request {np.mean(per):.1f} "
                  f"tokens/s after the first, over {len(bodies)} concurrent requests of "
                  f"{new_tokens} tokens "
                  f"({n_image} image, {n_text} text); peak device memory {peak / 2 ** 30:.2f} "
                  f"GiB; card {smi}")
    launches.update(tree_bytes=tree_bytes, build_peak=build_peak)
    if step_times:
        _decode_step_times(f"{name} {quantize}", engine, smi)
    return launches


def _decode_step_times(tag, engine, smi, fill=800):
    """The decode step of a stopped engine with every slot active at
    ``fill`` (a paged pool: each slot its own pages up to there): host ms a
    step (chunks of 4 steps, each ending with its tokens' fetch, as the
    engine's loop runs them; mean of 5 after 2) and device busy a step from
    ``torch.profiler`` over a chunk of 4. (CUDA events cannot take the
    card's time of a step here: a 13B step launches more kernels than the
    launch queue holds, so on an H100 80GB HBM3 at 700 W a step queued
    behind a ``torch.cuda._sleep`` of 0.25 s was never queued whole when
    the sleep ended.)"""
    import torch

    B = engine.max_slots
    fill = min(fill, engine.max_seq_len - 16)
    args = (np.full(B, fill, np.int32), np.ones(B, bool), np.zeros(B, np.float32),
            np.ones(B, np.float32), np.zeros(B, np.int64), False)
    if engine.paged:
        for slot in range(B):
            engine._attach_pages(slot, engine._alloc_pages(fill // engine.page_size + 1))

    def chunk():
        return engine._issue("decode", *args, 4).tolist()

    with torch.inference_mode():
        for _ in range(2):
            chunk()
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            chunk()
            host.append((time.perf_counter() - t0) * 1e3 / 4)
        busy = _profiled(chunk)["device_busy_ms"] / 4
    host_ms = float(np.mean(host))
    log("steps", f"{tag}: decode step, {B} slots at {fill}: host {host_ms:.3f} ms (min "
                 f"{min(host):.3f}); device busy (torch.profiler) {busy:.3f} ms, idle share "
                 f"{1 - busy / host_ms:.3f}; card {smi}")


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


# ---------------------------------------------------------------------------
# 20. W8A8 serving on phase 6's int8 tree
# ---------------------------------------------------------------------------

# The bound on the first-token logits of the W8A8 engine against the
# weight-only engine's, as the largest |difference| over the largest |logit|.
# On the CPU (random bf16 weights, int8 fused, 4 prompts of 512 tokens) the
# LLaMA at the 7B's width (hidden 4096, MLP 11008, 32 heads) gave 0.060 at 2
# layers and 0.095 at 4; 0.25 leaves room for 32. (A first bound of 0.1, from
# the same model 512 wide, 0.022-0.031 at 2-32 layers, was exceeded on the
# card at 0.1208: the width, not the depth, sets the error.) Rows whose
# weight-only top-2 gap exceeds twice the largest difference must keep
# their argmax.
W8A8_LOGIT_TOL = 0.25
W8A8_PROMPTS = 16
W8A8_NEW = 32


def _w8a8_prompts(rng, size, n):
    """``n`` image prompts of 762 fused tokens (T = 768 a prompt) with
    preprocessed pixels."""
    return [("<image>\n" + " ".join(f"w{j}x{i}" for i in range(184)),
             rng.normal(size=(1, size, size, 3)).astype(np.float32)) for j in range(n)]


def _w8a8_burst(engine, prompts):
    """Every prompt submitted at once, 32 greedy tokens each; returns the
    engine's (prefill dispatches, decode steps) over the burst and its
    seconds."""
    from llava_plus_torch.serve.engine import Request

    e0 = (engine.prefill_dispatches, engine.decode_steps)
    t0 = time.perf_counter()
    reqs = [engine.submit(Request(prompt=p, images=img, max_new_tokens=W8A8_NEW,
                                  temperature=0.0)) for p, img in prompts]
    texts = [engine.drain(r) for r in reqs]
    dt = time.perf_counter() - t0
    if not all(texts):
        raise AssertionError("a W8A8 burst request came back empty")
    return engine.prefill_dispatches - e0[0], engine.decode_steps - e0[1], dt


def phase_w8a8_serving(smi, params):
    """The dense engine with ``w8a8=True`` on phase 6's int8 fused 7B tree
    (16 slots, int8 KV): the prefill of 4 image prompts with and without
    W8A8, alternated on the same engine (CUDA-event ms), their first-token
    logits against each other, a burst of 16 image prompts x 32 tokens on a
    weight-only engine and on the W8A8 engine (peak device memory each;
    the W8A8 launches once a decoder product a prefill, the int8 kernel at
    decode rows only), then a plain 256-row product in this thread, which
    must be the weight-only kernel's, bit for bit."""
    import torch
    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.generate import prepare_multimodal_request
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops import quant
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops import w8a8 as w8
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.serve.engine import BatchedEngine

    cfg, L = LLAVA_15_7B, LLAVA_15_7B.text.num_hidden_layers
    tok = DebugTokenizer(vocab_size=cfg.text.vocab_size)
    tok.eos_token_id = -1   # every request runs its 32 tokens
    prompts = _w8a8_prompts(np.random.default_rng(20), cfg.vision.image_size, W8A8_PROMPTS)
    kw = dict(max_slots=16, max_seq_len=2048, decode_chunk=4, cache_dtype=torch.int8)
    kernels = (w8.w8a8_quantize_rows, w8.w8a8_epilogue, w8.w8a8_int_mm)

    # the weight-only engine's burst and peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = BatchedEngine(params, cfg, tok, **kw)
    try:
        n0 = [k.launches for k in kernels]
        wo = _w8a8_burst(engine, prompts)
        if [k.launches for k in kernels] != n0:
            raise AssertionError("the weight-only engine launched a W8A8 kernel")
    finally:
        engine.stop()
    torch.cuda.synchronize()
    peak_wo = torch.cuda.max_memory_allocated() / 2 ** 30
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = BatchedEngine(params, cfg, tok, w8a8=True, **kw)   # adds the K-major copies
    copies = sum(w[quant.QTKEY].numel() for w in _quantized(params["language_model"]["layers"])
                 if quant.QTKEY in w) / 2 ** 30
    log("w8a8", f"engine built in {time.perf_counter() - t0:.1f} s; K-major int8 copies of the "
                f"decoder matrices: {copies:.2f} GiB")
    try:
        # a 4-prompt prefill with and without W8A8 on the same engine and tree
        batch, _ = prepare_multimodal_request(
            cfg, tok, [p for p, _ in prompts[:4]], [img for _, img in prompts[:4]],
            max_seq_len=2048, device="cuda", prefill_bucket=engine.prefill_bucket)
        T = int(batch.tokens.shape[1])

        def prefill(on):
            cache = engine._make_cache(batch=4, seq_len=T, force_dense=True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with quant.w8a8_scope(on):
                start.record()
                logits = engine._prefill(batch, cache)
                end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end), logits.float()

        prefill(False)
        prefill(True)
        times = {False: [], True: []}
        logits = {}
        for on in (False, True, True, False, False, True, True, False):
            before = ([k.launches for k in kernels], qm.matmul_int8.prefill_launches)
            ms, logits[on] = prefill(on)
            times[on].append(ms)
            got = ([k.launches - b for k, b in zip(kernels, before[0])],
                   qm.matmul_int8.prefill_launches - before[1])
            want = ([4 * L] * 3, 0) if on else ([0] * 3, 4 * L)
            if got != want:
                raise AssertionError(f"W8A8 {on}: the prefill launched {got}, want {want}")
        a, b = logits[True], logits[False]
        rel = float((a - b).abs().max() / b.abs().max())
        top2 = b.topk(2, dim=-1).values
        wide = (top2[:, 0] - top2[:, 1]) > 2 * float((a - b).abs().max())
        agree = (a.argmax(-1) == b.argmax(-1))
        log("w8a8", f"4-prompt prefill (T = {T}, {4 * T} rows): weight-only "
                    f"{np.mean(times[False]):.2f} ms, W8A8 {np.mean(times[True]):.2f} ms "
                    f"(CUDA events, mean of 4 each, alternated: {times}); first-token logits "
                    f"largest |diff| / largest |logit| {rel:.4f} (bound {W8A8_LOGIT_TOL}), "
                    f"equal argmax {int(agree.sum())} of 4, rows with a top-2 gap past twice "
                    f"the largest diff {int(wide.sum())} (all must agree); card {smi}")
        if rel > W8A8_LOGIT_TOL or not bool(agree[wide].all()):
            raise AssertionError("W8A8 first-token logits left their bound")

        # the burst
        flash_attention.launches = decode_attention.launches = 0
        n0 = [k.launches for k in kernels]
        r0 = _regimes(qm.matmul_int8)
        dp, ds, dt = _w8a8_burst(engine, prompts)
        launches = dict(zip(("quantize", "epilogue", "int_mm"),
                            (k.launches - n for k, n in zip(kernels, n0))))
        regimes = tuple(b - a for a, b in zip(r0, _regimes(qm.matmul_int8)))
        launches.update(flash=flash_attention.launches, decode=decode_attention.launches)
        want = dict(quantize=4 * L * dp, epilogue=4 * L * dp, int_mm=4 * L * dp, flash=L * dp,
                    decode=L * ds)
        log("w8a8", f"burst of {len(prompts)} image prompts x {W8A8_NEW} tokens: {dp} prefill "
                    f"dispatches, {ds} decode steps in {dt:.2f} s (weight-only engine: "
                    f"{wo[0]} dispatches, {wo[1]} steps in {wo[2]:.2f} s); launches {launches} "
                    f"(want {want}); int8 kernel at decode rows {regimes[0]} (want "
                    f"{(4 * L + 1) * ds + dp}: decode steps and each prefill's head), at "
                    f"prefill rows {regimes[1]} (want 0)")
        if launches != want or regimes != ((4 * L + 1) * ds + dp, 0):
            raise AssertionError("the W8A8 engine's launch counts are off")
    finally:
        engine.stop()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del engine
    for w in _quantized(params["language_model"]["layers"]):
        w.pop(quant.QTKEY, None)
    gc.collect()
    torch.cuda.empty_cache()
    log("w8a8", f"peak device memory: W8A8 engine {peak:.2f} GiB, weight-only engine "
                f"{peak_wo:.2f} GiB; card {smi}")
    # the engine's W8A8 did not leak into this thread
    wqkv = {k: v[0] for k, v in params["language_model"]["layers"]["attn"]["wqkv"].items()}
    x = torch.randn(256, wqkv[quant.QKEY].shape[0], device="cuda").bfloat16()
    n0 = w8.w8a8_quantize_rows.launches
    same = torch.equal(quant.matmul(x, wqkv), qm.matmul_int8(x, wqkv[quant.QKEY],
                                                             wqkv[quant.SKEY]))
    log("w8a8", f"a plain 256-row product after the engine: the weight-only kernel's bits "
                f"{same}, W8A8 launches {w8.w8a8_quantize_rows.launches - n0}")
    if not same or w8.w8a8_quantize_rows.launches != n0:
        raise AssertionError("the engine's W8A8 reached a product outside it")
    return launches


TP_PROMPTS = 8   # phase 21's image prompts (762 fused tokens each)
TP_NEW = 32      # greedy tokens a request
TP_BUDGET_S = 45.0


def _tp_run(engine, prompts, cfg, tok):
    """The engine's first-token logits of ``prompts`` (one prefill op over
    all of them) and, submitted at once through its queue, their greedy
    streams as token ids; the seconds of the burst."""
    import torch
    from llava_plus_torch.generate import multimodal_arrays
    from llava_plus_torch.serve.engine import Request

    arrays, plan = multimodal_arrays(cfg, tok, [p for p, _ in prompts],
                                     [img for _, img in prompts],
                                     max_seq_len=engine.max_seq_len,
                                     prefill_bucket=engine.prefill_bucket)
    n = len(prompts)
    _, _, logits = engine._issue("prefill", next(engine._pids), list(engine._caches.keys()),
                                 arrays, [0.0] * n, [1.0] * n, [0] * n,
                                 (np.asarray(plan.lengths) - 1).tolist())
    logits = logits.float().cpu()
    t0 = time.perf_counter()
    reqs = [engine.submit(Request(prompt=p, images=img, max_new_tokens=TP_NEW, temperature=0.0))
            for p, img in prompts]
    ids = [_stream_ids(" " + engine.drain(r), "") for r in reqs]
    torch.cuda.synchronize()
    return logits, ids, time.perf_counter() - t0


def phase_tp_serving(smi, params):
    """Phase 21: tensor-parallel serving's one-rank path on phase 6's int8
    fused 7B tree. A dense engine (16 slots, int8 KV) serves 8 image prompts
    x 32 greedy tokens; then, on a one-rank NCCL group, the same engine with
    ``mesh=make_mesh(1, 1, 1)`` (its tree the caller's plain tensors, every
    device call an op of the step driver, the serving group active in each
    forward) serves them again. The first-token logits and the greedy
    tokens must equal the plain engine's bit for bit, and the flash, decode
    and int8 kernels must have run under the mesh. A one-rank group moves
    no bytes between cards; tp = 2 and 4 are ``tools/bench_tp.py``'s, on
    four cards."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.parallel.mesh import make_mesh
    from llava_plus_torch.serve.engine import BatchedEngine

    t_phase = time.perf_counter()
    cfg, L = LLAVA_15_7B, LLAVA_15_7B.text.num_hidden_layers
    tok = _id_tokenizer(cfg.text.vocab_size)
    prompts = _w8a8_prompts(np.random.default_rng(21), cfg.vision.image_size, TP_PROMPTS)
    kw = dict(max_slots=16, max_seq_len=2048, decode_chunk=4, cache_dtype=torch.int8)

    engine = BatchedEngine(params, cfg, tok, **kw)
    try:
        plain_logits, plain_ids, plain_s = _tp_run(engine, prompts, cfg, tok)
    finally:
        engine.stop()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        engine = BatchedEngine(params, cfg, tok, mesh=make_mesh(1, 1, 1), **kw)
        try:
            plain_tree = all(type(x) is torch.Tensor and not isinstance(x, DTensor)
                             for x in _leaves(engine.params))
            flash_attention.launches = decode_attention.launches = 0
            qm.matmul_int8.launches = 0
            r0 = _regimes(qm.matmul_int8)
            steps0, dispatch0 = engine.decode_steps, engine.prefill_dispatches
            tp_logits, tp_ids, tp_s = _tp_run(engine, prompts, cfg, tok)
            launches = {"flash": flash_attention.launches, "decode": decode_attention.launches,
                        "int8": qm.matmul_int8.launches}
            regimes = tuple(b - a for a, b in zip(r0, _regimes(qm.matmul_int8)))
            steps = engine.decode_steps - steps0
            dispatches = engine.prefill_dispatches - dispatch0
            ops = engine._driver.sent
        finally:
            engine.stop()
        del engine
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    same_logits = torch.equal(tp_logits, plain_logits)
    same_ids = tp_ids == plain_ids and all(len(i) == TP_NEW for i in tp_ids)
    # one prefill op (8 rows) and the burst's dispatches, each L flash launches
    want_flash = L * (1 + dispatches)
    elapsed = time.perf_counter() - t_phase
    log("tp", f"one-rank mesh engine (1, 1, 1) on NCCL vs the plain engine, {TP_PROMPTS} image "
              f"prompts x {TP_NEW} tokens, 16 slots, int8 weights and KV: first-token logits "
              f"bit-identical {same_logits} (largest |diff| "
              f"{float((tp_logits - plain_logits).abs().max()):.3e}), greedy token ids equal "
              f"{same_ids}; the tree plain local tensors {plain_tree}; launches under the mesh "
              f"{launches} (flash want {want_flash}; decode {L} x {steps} steps = {L * steps}; "
              f"int8 at decode rows {regimes[0]}, at prefill rows {regimes[1]}); burst "
              f"{tp_s:.2f} s under the mesh vs {plain_s:.2f} s plain; {ops} ops issued (a "
              f"one-rank group broadcasts none); phase {elapsed:.1f} s (budget {TP_BUDGET_S:.0f} "
              f"s); card {smi}")
    if not (same_logits and same_ids and plain_tree) or launches["flash"] != want_flash \
            or launches["decode"] != L * steps or launches["int8"] <= 0 or ops != 0:
        raise AssertionError("the one-rank mesh engine differs from the plain engine")
    if elapsed > TP_BUDGET_S:
        raise AssertionError(f"phase 21 took {elapsed:.1f} s, past its {TP_BUDGET_S:.0f} s")
    return launches


def _quantized(tree):
    """The quantized leaves (dicts) of a tree."""
    from llava_plus_torch.ops import quant

    if quant.is_quantized(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _quantized(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _quantized(v)


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


def serve_paged_engine(smi, params=None, cfg=None, name="llava-1.5-7b-random",
                       step_times=False):
    """The paged engine at full width behind the HTTP worker, as the JAX
    worker's ``--paged`` serves: fresh random weights of ``cfg`` (LLaVA-1.5-7B
    by default; seed 0) quantized to int8 and fused, or ``params`` so
    quantized already, an int8 KV pool of 256 pages of 128 tokens (the
    memory a dense 16 x 2048 cache would take, shared by 16 slots that may
    each reach 4096 tokens), the prefix cache on, decode chunks of 4, warmed
    at 768 tokens. Round 1: 16 concurrent requests of 32 greedy tokens (8
    image, 7 text, one of 3,000 tokens). Round 2: 8 follow-ups, each a round-1
    image prompt, its answer and a new user turn of 40 words, as the
    LLaVA-Plus loop re-sends its history. Checks every chunk and token
    count, the prefix hits (at least 5 pages of each follow-up), that round
    2 runs no vision encode, every kernel's launch count against the
    engine's counts, and that every page is free or held only by the prefix
    cache at the end. With ``step_times`` it then times the decode step at
    every slot (:func:`_decode_step_times`). Returns the launch counts of
    both rounds."""
    import torch
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.ops.paged_attention import paged_attention_general, paged_decode1
    from llava_plus_torch.serve.model_worker import ModelWorker, TorchBackend, build_app

    cfg = cfg or LLAVA_15_7B
    L, new_tokens, P = cfg.text.num_hidden_layers, 32, 128
    tok = DebugTokenizer(vocab_size=cfg.text.vocab_size)
    tok.eos_token_id = -1  # random weights give eos no meaning: every request runs 32 tokens
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = TorchBackend(_init_llava("cuda:0", cfg) if params is None else params, cfg, tok,
                           ClipImageProcessor(), device="cuda", use_engine=True, max_slots=16,
                           decode_chunk=4, quantize="int8" if params is None else None,
                           kv_int8=True, max_seq_len=4096, paged=True, pool_tokens=32768,
                           prefix_cache=True, warmup_len=768)
    del params
    engine = backend.engine
    if engine.num_pages != 256:
        raise AssertionError(f"pool of {engine.num_pages} pages, want 256")
    log("paged", f"{name}: int8 weights, fused; int8 KV pool of {engine.num_pages} pages x "
                 f"{P} tokens, 16 slots up to 4096 tokens, prefix cache on, decode chunks of "
                 f"4: built and warmed in {time.perf_counter() - t0:.1f} s (warmup "
                 f"{engine.warmup_s:.1f} s)")
    encodes = [0]
    encode_images = llava_model.encode_images

    def counted_encode(*args, **kwargs):
        encodes[0] += 1
        return encode_images(*args, **kwargs)

    llava_model.encode_images = counted_encode
    rng = np.random.default_rng(2)
    bodies1 = _paged_bodies(rng, cfg.vision.image_size, new_tokens)
    worker = ModelWorker("http://127.0.0.1:9", "http://127.0.0.1:0", backend, [name],
                         limit_model_concurrency=len(bodies1), no_register=True,
                         heartbeats=False)
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
    log("paged", f"{name}: both rounds: {(len(bodies1) + 8) * new_tokens / total_s:.1f} tokens/s "
                 f"aggregate; peak device memory {peak:.2f} GiB; card {smi}")
    if step_times:
        _decode_step_times(f"{name} paged int8", engine, smi)
    return launches


# ---------------------------------------------------------------------------
# 25. LLaVA-1.5-13B served: the engines in this process, the worker under the
#     controller
# ---------------------------------------------------------------------------

NAME_13B = "llava-v1.5-13b-random"
# phase 25's depth: LLaVA-1.5-13B's width at SERVE_13B_LAYERS of its 40
# layers (the run's time budget; phases 28 and 26 run the 13B at its whole
# depth, and phase 3 checks every kernel at its shapes)
SERVE_13B_LAYERS = 10
# the depth of the 13B-width checkpoint the worker process serves: 2 of its
# 40 layers, 2.6 GB of safetensors
WORKER_13B_LAYERS = 2
SINGLE_13B_NEW = 24   # greedy tokens of each request sent one at a time
SINGLE_TOL = 2e-2     # phase 4's logit bound


def phase_serve_13b(smi):
    """Phase 25: LLaVA-1.5-13B (layers of 5,120, 40 heads, FFN 13,824) at
    full width and SERVE_13B_LAYERS of its 40 layers on random bf16 weights
    (seed 0), served as the
    JAX package serves its second configuration (``bench.py``'s
    ``llava-1.5-13b-int4``: int4 weights, int8 KV, batch 8):

    1. ``TorchBackend(quantize="int4", kv_int8=True, max_slots=8)`` behind
       ``build_app`` (:func:`serve_engine`): 8 image prompts of 768 fused
       tokens x 32 greedy tokens sent at once; the build's peak device
       memory held to the bf16 tree plus the int4 tree plus 2 GiB (the
       quantization runs a layer at a time); then requests one at a time
       through the engine and the single-stream ``Generator`` on the same
       int4 tree (:func:`_single_13b`);
    2. fresh weights quantized to int8 on the dense engine at 16 slots (8
       image, 8 text requests), then the paged engine with the prefix cache
       on the same int8 tree (:func:`serve_paged_engine`: 16 requests, 8
       follow-ups that hit their prefixes and run no vision encode);
    3. a 13B-width checkpoint served by ``model_worker --load-4bit
       --kv-int8`` as a process registered with the port's controller
       (:func:`_serve_13b_worker`).

    Each engine's decode step is timed at every slot (host ms, device
    busy). Returns the launch counts of the
    engines in this process, each checked against the engine's own counts."""
    import dataclasses

    import torch
    from llava_plus_torch.models.configs import LLAVA_15_13B

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(LLAVA_15_13B, text=dataclasses.replace(
        LLAVA_15_13B.text, num_hidden_layers=SERVE_13B_LAYERS))
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = _init_llava("cuda:0", cfg)
    bf16 = _tree_bytes(params)
    int4 = serve_engine(smi, params, "int4", n_image=8, n_text=0, cfg=cfg, max_slots=8,
                        name=NAME_13B, step_times=True)
    build, limit = int4["build_peak"] - base, bf16 + int4["tree_bytes"] + 2 * 2 ** 30
    log("13b", f"int4 build: peak device memory {build / 2 ** 30:.2f} GiB over the "
               f"{base / 2 ** 30:.2f} GiB held before; bf16 tree {bf16 / 2 ** 30:.2f} GiB, int4 "
               f"tree {int4['tree_bytes'] / 2 ** 30:.2f} GiB, bound (bf16 + int4 + 2 GiB) "
               f"{limit / 2 ** 30:.2f} GiB; card {smi}")
    if build > limit:
        raise AssertionError(f"the int4 build's peak {build / 2 ** 30:.2f} GiB exceeds "
                             f"{limit / 2 ** 30:.2f} GiB")
    single = _single_13b(smi, params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = _init_llava("cuda:0", cfg)
    int8 = serve_engine(smi, params, "int8", n_image=8, n_text=8, cfg=cfg, max_slots=16,
                        name=NAME_13B, step_times=True)
    paged = serve_paged_engine(smi, params, cfg, name=NAME_13B, step_times=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _serve_13b_worker(smi)
    log("13b", f"phase 25: {time.perf_counter() - t_phase:.1f} s; card {smi}")
    return {"flash": int4["flash"] + single["flash"] + int8["flash"] + paged["flash"],
            "decode": int4["decode"] + single["decode"] + int8["decode"],
            "int4": int4["quant"] + single["quant"], "int8": int8["quant"] + paged["quant"],
            "decode1": paged["decode1"],
            "int4_regimes": [a + b for a, b in zip(int4["quant_regimes"],
                                                   single["quant_regimes"])],
            "int8_regimes": [a + b for a, b in zip(int8["quant_regimes"],
                                                   paged["quant_regimes"])]}


def _single_13b(smi, params, cfg):
    """Phase 6's 2 image and 2 text prompts, 24 greedy tokens each, sent one
    at a time to ``TorchBackend(use_engine=True)`` (8 slots) and to
    ``TorchBackend(use_engine=False)`` (the single-stream ``Generator``) on
    the same quantized tree, both with int8 KV: equal token ids, or, at the
    first token that differs, the plain step's top-2 logit gap within
    SINGLE_TOL (one request at a time gives both sides one row, but the
    engine's prefill bucket and its 8-slot decode split their sums
    otherwise). Launches checked against the engine's prefill dispatches
    and decode steps and the Generator's one prefill and 23 steps a
    request."""
    import torch
    from llava_plus_torch.data import ClipImageProcessor
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.serve.model_worker import TorchBackend

    L, n = cfg.text.num_hidden_layers, SINGLE_13B_NEW
    tok = _id_tokenizer(cfg.text.vocab_size)
    bodies = _engine_bodies(np.random.default_rng(5), cfg.vision.image_size, 2, 2, n)
    kw = dict(device="cuda", kv_int8=True, max_seq_len=2048)
    engine_b = TorchBackend(params, cfg, tok, ClipImageProcessor(), use_engine=True,
                            max_slots=8, **kw)
    plain_b = TorchBackend(params, cfg, tok, ClipImageProcessor(), use_engine=False, **kw)
    engine = engine_b.engine
    flash_attention.launches = decode_attention.launches = qm.matmul_int4.launches = 0
    regimes0 = _regimes(qm.matmul_int4)
    e0 = (engine.prefill_dispatches, engine.decode_steps)
    try:
        streams = []
        for body in bodies:
            a = _stream_ids(list(engine_b.generate_stream(body))[-1], body["prompt"])
            b = _stream_ids(list(plain_b.generate_stream(body))[-1], body["prompt"])
            streams.append((a, b, list(plain_b.generator._last_output_ids)))
        launches = {"flash": flash_attention.launches, "decode": decode_attention.launches,
                    "quant": qm.matmul_int4.launches}
        dp, ds = (b - a for a, b in zip(e0, (engine.prefill_dispatches, engine.decode_steps)))
    finally:
        engine_b.stop()
        plain_b.stop()
    r = len(bodies)
    want = {"flash": L * (dp + r), "decode": L * (ds + r * (n - 1)),
            "quant": (4 * L + 1) * (dp + ds + r * n)}
    if launches != want:
        raise AssertionError(f"13b one at a time: launches {launches}, want {want}")
    launches["quant_regimes"] = _quant_regimes("13b", "int4", regimes0, launches["quant"])
    equal = 0
    for i, (body, (a, b, exact)) in enumerate(zip(bodies, streams)):
        if len(exact) != n:
            raise AssertionError(f"13b request {i}: the Generator gave {len(exact)} tokens")
        k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
        if k is None:
            equal += 1
            continue
        # the k-th shown id's place among the Generator's ids (the tokenizer
        # does not show the reserved ids)
        shown = [j for j, t in enumerate(exact) if t >= tok._RESERVED]
        cut = shown[k] if k < len(shown) else len(exact)
        gap = _top2_gap(params, cfg, tok, body, exact[:cut], torch.int8)
        log("13b", f"request {i}: the engine's ids leave the Generator's at token {cut}; the "
                   f"plain step's top-2 logit gap there {gap:.3e} of the top logit (bound "
                   f"{SINGLE_TOL})")
        if gap > SINGLE_TOL:
            raise AssertionError(f"13b request {i}: the engine diverges at token {cut}, where "
                                 f"the top-2 gap is {gap:.3e} > {SINGLE_TOL}")
    log("13b", f"{r} requests one at a time: the engine's greedy ids equal the Generator's in "
               f"{equal} of {r}; launches {launches} (want {want}); card {smi}")
    return launches


def _serve_13b_worker(smi):
    """LLaVA-1.5-13B's width at WORKER_13B_LAYERS layers (random bf16,
    seed 0) written by the port's exporter under ``.smoke/`` and loaded
    back here (the config LLaVA-1.5-13B's but for the depth, every leaf bit
    for bit); the port's controller and ``python -m
    llava_plus_torch.serve.model_worker --model-path ... --load-4bit
    --kv-int8 --max-slots 8 --controller-address ...`` started as users
    start them. The worker must register; a client finds it through the
    controller's ``/get_worker_address`` by the model's name and sends 8
    requests at once (6 image, 2 text; 32 greedy tokens each), then one
    through the controller's own stream route; every stream whole. The
    worker and the controller must exit 0 on SIGTERM. Prints export and
    load seconds, the worker's registration and first served token counted
    from its start, TTFT p50, tokens/s and its peak device memory."""
    import dataclasses
    import signal

    import requests
    import torch
    from llava_plus_torch.models.builder import load_pretrained_model
    from llava_plus_torch.models.configs import LLAVA_15_13B
    from llava_plus_torch.serve.protocol import iter_chunks_requests

    full = LLAVA_15_13B
    cfg = dataclasses.replace(full, text=dataclasses.replace(
        full.text, num_hidden_layers=WORKER_13B_LAYERS))
    params = _init_llava("cuda:0", cfg)
    path, nbytes, write_s = export_checkpoint(params, cfg, NAME_13B)
    t0 = time.perf_counter()
    tok, loaded, lcfg, _, ctx = load_pretrained_model(path)
    load_s = time.perf_counter() - t0
    if lcfg != cfg or dataclasses.replace(lcfg, text=dataclasses.replace(
            lcfg.text, num_hidden_layers=full.text.num_hidden_layers)) != full:
        raise AssertionError(f"the 13B checkpoint loads as {lcfg}")
    got, want = dict(_named_leaves(loaded)), dict(_named_leaves(params))
    if sorted(got) != sorted(want) or any(
            a.dtype != want[k].dtype or not torch.equal(a.to(want[k].device), want[k])
            for k, a in got.items()):
        raise AssertionError("the 13B checkpoint's leaves differ from the exported tree's")
    log("13b", f"checkpoint at 13B's width, {WORKER_13B_LAYERS} of its 40 layers: "
               f"{nbytes / 1e9:.2f} GB of safetensors written in {write_s:.1f} s, loaded in "
               f"{load_s:.1f} s; config.json reads back as LLaVA-1.5-13B's (hidden "
               f"{lcfg.text.hidden_size}, {lcfg.text.num_attention_heads} heads, FFN "
               f"{lcfg.text.intermediate_size}) at {lcfg.text.num_hidden_layers} layers, "
               f"{len(got)} leaves bit for bit; card {smi}")
    del got, want, loaded, params
    gc.collect()
    torch.cuda.empty_cache()

    root = os.path.join(SMOKE_DIR, "worker13b")
    os.makedirs(root, exist_ok=True)
    ctrl_port, port = _free_port(), _free_port()
    ctrl, url = f"http://127.0.0.1:{ctrl_port}", f"http://127.0.0.1:{port}"
    procs = _start_processes(root, {"controller": [
        "llava_plus_torch.serve.controller", "--host", "127.0.0.1", "--port", str(ctrl_port)]},
        {"controller": ctrl + "/list_models"})
    argv = ["--model-path", path, "--load-4bit", "--kv-int8", "--max-slots", "8",
            "--limit-model-concurrency", "8", "--controller-address", ctrl,
            "--worker-address", url, "--host", "127.0.0.1", "--port", str(port),
            "--device", "cuda"]
    worker_log = os.path.join(root, "worker.out")
    bodies = _in_vocab(_engine_bodies(np.random.default_rng(3), cfg.vision.image_size, 6, 2,
                                      32), cfg.text.vocab_size)
    code = None
    try:
        with open(worker_log, "w") as logf:
            t_start = time.perf_counter()
            proc = subprocess.Popen([sys.executable, "-m", "llava_plus_torch.serve.model_worker",
                                     *argv], cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
                                    stdout=logf, stderr=subprocess.STDOUT)
        try:
            registered_s = _wait_registered(ctrl, NAME_13B, proc, t_start)
            address = requests.post(ctrl + "/get_worker_address", json={"model": NAME_13B},
                                    timeout=5).json()["address"]
            if address != url:
                raise AssertionError(f"the controller gave {address!r} for {NAME_13B}, the "
                                     f"worker is at {url}")
            _wait_status(address, proc, 120)
            t_burst = time.perf_counter()
            results = _post_all(address + "/worker_generate_stream", bodies)
            _check_streams(bodies, results, 32)
            first = min(st[0] for _, _, st in results)
            t_end = max(st[-1] for _, _, st in results)
            ttfts = sorted(st[0] - t_send for _, t_send, st in results)
            body = dict(bodies[0], model=NAME_13B)
            r = requests.post(ctrl + "/worker_generate_stream", json=body, stream=True,
                              timeout=600)
            _check_streams([body], [(list(iter_chunks_requests(r)), None, None)], 32)
            metrics = requests.post(address + "/worker_metrics", timeout=30).json()
            log("13b", f"worker (--load-4bit --kv-int8 --max-slots 8): registered with the "
                       f"controller {registered_s:.1f} s after its start, found through "
                       f"/get_worker_address; {len(bodies)} streams at once, every stream "
                       f"whole: first served token {first - t_start:.1f} s after the process "
                       f"started, TTFT p50 {np.median(ttfts) * 1e3:.1f} ms (max "
                       f"{ttfts[-1] * 1e3:.1f}), {len(bodies) * 32 / (t_end - t_burst):.1f} "
                       f"tokens/s aggregate; one more through the controller's stream route, "
                       f"whole; peak device memory {metrics['device_peak_gib']:.2f} GiB, "
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
    finally:
        codes = _stop_processes(procs)
    if code != 0 or codes != {"controller": 0}:
        print(_tail(worker_log), file=sys.stderr, flush=True)
        raise AssertionError(f"exit codes: worker {code}, {codes}")
    log("13b", "worker and controller stopped by SIGTERM, exit codes 0")
    shutil.rmtree(path, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# 17. speculative serving: the verify steps on the dense and the paged engine
# ---------------------------------------------------------------------------

SPEC_K = 4        # proposals a verify step: chunks of 5 tokens
SPEC_CHUNK = 4    # verify steps a dispatch
SPEC_NEW = 64     # tokens a request of phase 17
SPEC_TOL = 3e-2   # phase 4's logit bound for int8 weights (2e-2 for bf16 ones)
# phase 17's depth: LLaVA-1.5-7B's width at SPEC_LAYERS of its 32 layers (the
# run's time budget; phases 5-7 serve the 7B at the whole depth)
SPEC_LAYERS = 8


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
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.ops.paged_attention import paged_attention_general, paged_decode1
    from llava_plus_torch.serve.model_worker import ModelWorker, TorchBackend, build_app
    from llava_plus_torch.tools import bench_spec

    cfg = _llava_7b(SPEC_LAYERS)
    L, P = cfg.text.num_hidden_layers, 128
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = bench_spec.make_params("cuda:0", cfg)
    log("spec", f"LLaVA-1.5-7B's width at {L} layers, random bf16 weights (seed 0), int8 "
                f"fused, in {time.perf_counter() - t0:.1f} s")
    out = {"flash": 0, "quant": 0, "decode1": 0}
    kernels = {"flash": flash_attention, "quant": qm.matmul_int8, "decode1": paged_decode1}

    # 1. bench_spec's shape
    runs = {}
    for mode in (0, SPEC_K):
        runs[mode] = r = bench_spec.run(mode, 128, SPEC_CHUNK, params=params, cfg=cfg)
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
# 18. a LLaVA-Plus tool turn: controller, tool worker and web server
# ---------------------------------------------------------------------------

PLUS_MODEL = "llava-plus-7b-planted"
PLUS_SESSIONS = 8
PLUS_EVENTS = ["text", "prog", "status", "tool", "text", "image"]   # JAX's order
# a session's two turns: the first the same in every session, the second its own
# from its 4th page on and long enough for round 1 to publish a 5th, which
# holds the end of the image's span (a hit must cover it) and round 2 reuses
PLUS_TURNS = ("find the cat", "session {j}: what else in this picture should I look at next?")
# kernels line entry -> phase 18's count
PLUS_KERNELS = {"flash_fwd": "flash", "quant_matmul[int8]": "quant",
                "paged_attention[decode1]": "decode1", "paged_attention[general]": "general"}


def _written_gb():
    from llava_plus_torch.tools.common import written_gb

    return written_gb()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plus_processes(root):
    """The control plane as users start it, each ``python -m`` on a free
    port with its output in ``root``: the controller, the fake tool worker
    registering ``grounding_dino`` and the web server with ``--llava-plus``.
    The tool worker beats at its default interval (15 s, inside the
    controller's 30 s expiry)."""
    os.makedirs(root, exist_ok=True)
    ports = {name: _free_port() for name in ("controller", "tool", "web")}
    ctrl = f"http://127.0.0.1:{ports['controller']}"
    commands = {
        "controller": ["llava_plus_torch.serve.controller", "--host", "127.0.0.1",
                       "--port", str(ports["controller"])],
        "tool": ["llava_plus_torch.serve.tool_workers.fake_tool_worker", "--host", "127.0.0.1",
                 "--port", str(ports["tool"]), "--controller-address", ctrl,
                 "--worker-address", f"http://127.0.0.1:{ports['tool']}",
                 "--model-names", "grounding_dino"],
        "web": ["llava_plus_torch.serve.web_server", "--host", "127.0.0.1",
                "--port", str(ports["web"]), "--controller-url", ctrl, "--llava-plus"],
    }
    probes = {"controller": ctrl + "/list_models",
              "tool": f"http://127.0.0.1:{ports['tool']}/worker_get_status",
              "web": f"http://127.0.0.1:{ports['web']}/api/models"}
    procs = _start_processes(root, commands, probes)
    return procs, ctrl, f"http://127.0.0.1:{ports['web']}"


def _start_processes(root, commands, probes):
    """Each ``python -m`` command of ``commands`` (by name) started in turn,
    its output in ``root``, each answering a POST to its ``probes`` URL
    within 60 s before the next starts: {name: (process, log path)}."""
    import requests

    env = dict(os.environ, PYTHONPATH=HERE)
    procs = {}
    try:
        for name, cmd in commands.items():
            log_path = os.path.join(root, f"{name}.out")
            with open(log_path, "w") as out:   # the child keeps its own descriptor
                procs[name] = (subprocess.Popen([sys.executable, "-m", *cmd], cwd=root, env=env,
                                                stdout=out, stderr=subprocess.STDOUT), log_path)
            deadline = time.time() + 60
            while True:
                try:
                    requests.post(probes[name], timeout=5)
                    break
                except requests.ConnectionError:
                    if procs[name][0].poll() is not None or time.time() > deadline:
                        raise AssertionError(f"{name} did not start: {_tail(log_path)}")
                    time.sleep(0.1)
    except BaseException:
        _stop_processes(procs)   # a process that did start is not left behind
        raise
    return procs


def _stop_processes(procs):
    """SIGTERM each process; every one must exit with 0 within 30 s."""
    import signal

    codes = {}
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    for name, (proc, _) in procs.items():
        try:
            codes[name] = proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
            codes[name] = "killed"
    return codes


def _plus_session(web, j, image, results, model=PLUS_MODEL):
    """One session with ``model``: an image turn, then a follow-up that
    carries it as history; per turn, (send time, [(arrival time, chunk)])."""
    import requests
    from llava_plus_torch.serve.protocol import iter_chunks_requests

    turns, history = [], []
    for text in (t.format(j=j) for t in PLUS_TURNS):
        body = {"model": model, "text": text, "history": history, "image": image,
                "temperature": 0.0, "max_new_tokens": 64, "session_id": f"s{j}"}
        t_send = time.perf_counter()
        resp = requests.post(web + "/api/chat", json=body, stream=True, timeout=600)
        chunks = [(time.perf_counter(), c) for c in iter_chunks_requests(resp)]
        turns.append((t_send, chunks))
        texts = [c["text"] for _, c in chunks if "text" in c]
        # the browser's history keeps the first turn's image marker with it
        history = [["<image>\n" + text, texts[-1] if texts else ""]]
    results[j] = turns


def _plus_prompts(reply, image, tool_response, sessions=PLUS_SESSIONS, model=PLUS_MODEL):
    """Every prompt the web server sends ``model`` for the turns of
    ``sessions`` sessions, as the port's orchestrator builds them:
    ``stream_turn`` on the web server's template and history, with the model
    answering ``reply`` and the tool ``tool_response`` (no process or card
    involved)."""
    from llava_plus_torch.conversation import conv_templates
    from llava_plus_torch.serve.orchestrator import ToolOrchestrator

    prompts = []

    def stream_model(model_name, prompt, images_b64=None, **gen_params):
        prompts.append(prompt)
        yield reply.strip()

    orch = ToolOrchestrator("")
    orch.stream_model, orch.call_tool = stream_model, lambda *args: tool_response
    for j in range(sessions):
        history = []
        for text in (t.format(j=j) for t in PLUS_TURNS):
            conv = conv_templates["v1"].copy()
            for u, a in history:
                conv.append_message(conv.roles[0], u)
                conv.append_message(conv.roles[1], a)
            for _ in orch.stream_turn(conv, model, text, image=image):
                pass
            history = [["<image>\n" + text, reply.strip()]]
    return prompts


def _plus_turn(t_send, chunks, reply, tool_want, size, n_tokens):
    """A turn's checks (events in JAX's order, round 1 and round 2 the
    planted reply, the tool's folded response, an annotated PNG at the
    image's size) and its times."""
    from PIL import Image

    kinds = [next(iter(c)) for _, c in chunks]
    merged = [k for i, k in enumerate(kinds) if i == 0 or k != "text" or kinds[i - 1] != "text"]
    if merged != PLUS_EVENTS:
        raise AssertionError(f"events {merged}, want {PLUS_EVENTS}: {chunks[-1][1]}")
    i_prog, i_status, i_tool, i_image = (kinds.index(k) for k in ("prog", "status", "tool",
                                                                   "image"))
    r1 = [c["text"] for _, c in chunks[:i_prog]][-1]
    r2 = [c["text"] for _, c in chunks[i_tool + 1:i_image]][-1]
    prog, tool = chunks[i_prog][1]["prog"], chunks[i_tool][1]["tool"]
    if not (r1 == prog == r2 == reply.strip()):
        raise AssertionError(f"round texts differ from the planted reply: {r1!r} / {r2!r}")
    if tool != {"api_name": "grounding_dino", "response": tool_want}:
        raise AssertionError(f"tool event {tool}, want {tool_want}")
    png = Image.open(io.BytesIO(base64.b64decode(chunks[i_image][1]["image"])))
    if png.format != "PNG" or png.size != size:
        raise AssertionError(f"annotated image {png.format} {png.size}, want PNG {size}")
    r1_times = [t for t, c in chunks[:i_prog] if "text" in c]
    r2_times = [t for t, c in chunks[i_tool + 1:i_image] if "text" in c]
    return {"r1": r1, "r2": r2, "r1_ttft": chunks[0][0] - t_send,
            # the stream's pace after its first token, ms a token
            "r1_tok": (r1_times[-1] - r1_times[0]) / (n_tokens - 1),
            "r2_tok": (r2_times[-1] - r2_times[0]) / (n_tokens - 1),
            "dispatch": chunks[i_tool][0] - chunks[i_status][0],
            "r2_ttft": chunks[i_tool + 1][0] - chunks[i_tool][0],
            "turn": chunks[-1][0] - t_send, "end": chunks[-1][0]}


def phase_plus_turn(smi, profile=False):
    """Phase 18: a full LLaVA-Plus tool turn at LLaVA-1.5-7B width. Random
    bf16 weights (seed 0) with a planted decoding chain
    (``llava_plus_torch.tools.planted``: after ``ASSISTANT:`` greedy decoding
    emits one ``grounding_dino`` call in the thoughts / actions / value
    grammar, then ``</s>``), quantized to int8 and fused. The controller, the
    fake tool worker and the web server run as ``python -m`` processes; the
    model worker runs here on the paged engine (int8 KV pool of 256 pages,
    prefix cache, 16 slots) registered with that controller. 8 sessions at
    once send an image turn ("find the cat", temperature 0, the same in
    every session) and a follow-up of their own carrying it as history
    (:data:`PLUS_TURNS`) through ``/api/chat``: each turn is two model
    rounds around a tool dispatch. The tokenizer knows
    every word of the 32 prompts (from the orchestrator's own dry run), and
    the worker must receive exactly those prompts. Passes on fresh
    backends: speculation off, then ``speculate=4`` with the engine's
    acceptance gate off (the gate pauses on round 1, whose text repeats
    nothing, and the pause outlasts the pass, hiding the rounds that quote
    it). Checks every stream's events and texts, the speculative texts
    against the plain ones, prefix reuse (every session's follow-up round 2
    admitted on a hit of its round 1's pages, so with no vision encode), page
    accounting, the controller's registry and queues, the processes' exits
    on SIGTERM and the kernels' launch counts. ``profile`` adds a third
    pass, plain, under ``torch.profiler``: that pass's device busy, idle
    share and device time by kernel class."""
    import requests
    import torch
    from llava_plus_torch.data import ClipImageProcessor
    from llava_plus_torch.mm_utils import process_images
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.ops.paged_attention import paged_attention_general, paged_decode1
    from llava_plus_torch.ops.quant import quantize_llava_params
    from llava_plus_torch.serve.model_worker import ModelWorker, TorchBackend, build_app
    from llava_plus_torch.serve.orchestrator import fold_tool_response, ToolSession
    from llava_plus_torch.serve.tool_workers.fake_tool_worker import _canned
    from llava_plus_torch.tools import planted
    from llava_plus_torch.utils.demo_assets import demo_image, demo_image_b64

    cfg, device = LLAVA_15_7B, "cuda"
    L, size = cfg.text.num_hidden_layers, cfg.vision.image_size
    processor = ClipImageProcessor(shortest_edge=size, crop_size=size)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = llava_model.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    reply = planted.canned_reply()
    image = demo_image("cat")
    prompts = _plus_prompts(reply, image, _canned("grounding_dino", image))
    tok = planted.tool_tokenizer(cfg.text.vocab_size, reply, prompts)
    unknown = {w for p in prompts for w in planted.unknown_words(tok, p)}
    if unknown:
        raise AssertionError(f"prompt words the tokenizer does not know: {sorted(unknown)}")
    ids = planted.chain_ids(tok, reply)
    planted.plant_chain(params, ids)
    params = quantize_llava_params(params, cfg.language_model_type, bits=8, fuse=True)
    with torch.inference_mode():   # the first prompt is turn 1's round 1
        gaps = planted.chain_gaps(params, cfg, tok, prompts[0],
                                  process_images([image], processor, cfg), ids,
                                  device)
    log("plus", f"LLaVA-1.5-7B, random bf16 weights (seed 0) with a planted chain of "
                f"{len(ids) - 1} steps, int8 fused, in {time.perf_counter() - t0:.1f} s; along "
                f"the chain after the round-1 prompt: argmax the planted word at "
                f"{sum(a for a, _ in gaps)} of {len(gaps)} steps, smallest top-2 logit gap "
                f"{min(g for _, g in gaps):.2f}; {len(prompts)} prompts, "
                f"{len(set(prompts))} distinct, every word known")
    if not all(a for a, _ in gaps):
        raise AssertionError(f"the planted chain does not hold on the int8 weights: {gaps}")
    tool_want = fold_tool_response("grounding_dino", _canned("grounding_dino", image),
                                   ToolSession())[0]
    image_b64 = demo_image_b64("cat")

    received, suffix_admits = [], [0]

    def recording(generate_stream):
        def generate(params):
            received.append(params["prompt"])
            return generate_stream(params)
        return generate

    kernels = {"flash": flash_attention, "decode1": paged_decode1,
               "general": paged_attention_general, "quant": qm.matmul_int8}
    counters = ("prefill_dispatches", "decode_steps", "prefix_hit_tokens", "verify_steps",
                "spec_steps", "spec_slot_steps", "spec_emitted", "spec_pauses")
    procs, ctrl, web = _plus_processes(os.path.join(SMOKE_DIR, "plus"))
    worker = server = backend = None
    passes, totals = {}, {n: 0 for n in kernels}
    regimes = [0, 0]
    try:
        mport = _free_port()
        modes = [("plain", 0), ("spec, gate off", 4)] + [("plain, profiled", 0)] * profile
        for mode, speculate in modes:
            gc.collect()
            t0 = time.perf_counter()
            backend = TorchBackend(params, cfg, tok, processor, device=device,
                                   use_engine=True, max_slots=16, decode_chunk=4, kv_int8=True,
                                   max_seq_len=2048, paged=True, pool_tokens=256 * 128,
                                   prefix_cache=True, warmup_len=768, speculate=speculate,
                                   spec_chunk=SPEC_CHUNK)
            engine = backend.engine
            engine.spec_min_accept = 0.0
            insert_suffix = engine._insert_suffix

            def counted_suffix(*args, insert_suffix=insert_suffix):
                out = insert_suffix(*args)   # raises while the pool is short: retried later
                suffix_admits[0] += 1
                return out

            # a prefix hit is admitted with a suffix prefill only: no vision encode
            engine._insert_suffix = counted_suffix
            log("plus", f"{mode}: paged engine ({engine.num_pages} pages of 128, int8 KV, "
                        f"prefix cache, 16 slots, speculate={speculate}) built and warmed in "
                        f"{time.perf_counter() - t0:.1f} s")
            if worker is None:
                # registers with the controller (and beats every 15 s) as
                # `python -m llava_plus_torch.serve.model_worker` does
                worker = ModelWorker(ctrl, f"http://127.0.0.1:{mport}", backend, [PLUS_MODEL],
                                     limit_model_concurrency=16)
                server = _Server(build_app(worker), port=mport)
            backend.generate_stream = recording(backend.generate_stream)
            worker.backend = backend
            models = requests.post(ctrl + "/list_models", timeout=30).json()["models"]
            if sorted(models) != ["grounding_dino", PLUS_MODEL]:
                raise AssertionError(f"the controller lists {models}")
            for k in kernels.values():
                k.launches = 0
            regimes0 = _regimes(qm.matmul_int8)
            c0 = {n: getattr(engine, n) for n in counters}
            worker.metrics = {}     # the worker's own TTFT and rate, this pass only
            suffix_admits[0] = 0
            received.clear()
            results = [None] * PLUS_SESSIONS

            def traffic():
                threads = [threading.Thread(target=_plus_session,
                                            args=(web, j, image_b64, results))
                           for j in range(PLUS_SESSIONS)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(600)

            t_start = time.perf_counter()
            prof = _profiled(traffic) if mode.endswith("profiled") else traffic()
            launches = {n: k.launches for n, k in kernels.items()}
            d = {n: getattr(engine, n) - c0[n] for n in counters}
            served = worker.get_metrics()
            got_regimes = [b - a for a, b in zip(regimes0, _regimes(qm.matmul_int8))]
            if any(r is None for r in results):
                raise AssertionError(f"{mode}: a session did not complete")
            if sorted(received) != sorted(prompts):
                raise AssertionError(f"{mode}: the worker received other prompts than the dry "
                                     f"run's: {sorted(set(received) - set(prompts))}")
            turns = [[_plus_turn(t_send, chunks, reply, tool_want, image.size, len(ids) - 2)
                      for t_send, chunks in r] for r in results]
            t_end = max(t["end"] for r in turns for t in r)
            deadline = time.time() + 30
            while (engine.num_active or engine._waiting is not None) and time.time() < deadline:
                time.sleep(0.05)
            with engine._page_lock:
                refs = list(engine._page_refs)
                cached = set(engine._prefix._entries.values())
                free = len(engine._free_pages)
            held = sum(1 for p in cached if refs[p] == 1)
            for _ in range(100):
                status = requests.post(ctrl + "/worker_get_status", timeout=30).json()
                if status["queue_length"] == 0:
                    break
                time.sleep(0.1)
            backend.stop()
            rounds = 4 * PLUS_SESSIONS
            model_requests = rounds          # every round sends the image
            tokens = rounds * (len(ids) - 2)
            p = {"turns": turns, "seconds": t_end - t_start, "tokens": tokens,
                 "launches": launches, "counters": d, "suffix_admits": suffix_admits[0],
                 "regimes": got_regimes}
            passes[mode] = p
            ttft = lambda k, i: np.median([r[i][k] for r in turns]) * 1e3
            log("plus", f"{mode}: {PLUS_SESSIONS} sessions x 2 turns x 2 rounds in "
                        f"{p['seconds']:.2f} s: {tokens} tokens, "
                        f"{tokens / p['seconds']:.1f} tokens/s aggregate; p50 over sessions, "
                        + "; ".join(f"turn {i + 1}: round-1 TTFT {ttft('r1_ttft', i):.1f} ms, "
                                    f"then {ttft('r1_tok', i):.1f} ms a token, tool dispatch "
                                    f"{ttft('dispatch', i):.1f} ms, round-2 TTFT "
                                    f"{ttft('r2_ttft', i):.1f} ms, then {ttft('r2_tok', i):.1f} ms "
                                    f"a token, turn {ttft('turn', i) / 1e3:.3f} s"
                                    for i in range(2)))
            log("plus", f"{mode}: at the worker (from its receipt of a request), TTFT mean "
                        f"{served['mean_ttft_s'] * 1e3:.1f} ms over {served['requests']} "
                        f"requests, {served['decode_tok_s']:.1f} tokens/s a request after its "
                        f"first; {d['prefill_dispatches']} prefill dispatches, "
                        f"{d['decode_steps']} decode steps, {d['verify_steps']} verify steps "
                        f"({d['spec_steps']} live, spec_acceptance "
                        f"{d['spec_emitted'] / max(d['spec_steps'], 1):.3f} summed over the "
                        f"slots, {d['spec_emitted'] / max(d['spec_slot_steps'], 1):.3f} a slot, "
                        f"{d['spec_pauses']} pauses), prefix hits {d['prefix_hit_tokens']} "
                        f"tokens: {suffix_admits[0]} of {model_requests} image requests "
                        f"admitted on a hit (no vision encode); launches "
                        f"{launches}, int8 by regime {got_regimes}; pages at the end {free} "
                        f"free + {held} held only by the prefix cache of {engine.num_pages}; "
                        f"controller queue {status['queue_length']}")
            if prof:
                log("plus", f"{mode}: device busy {prof['device_busy_ms']:.1f} ms of the pass's "
                            f"{p['seconds'] * 1e3:.1f}, idle share "
                            f"{1 - prof['device_busy_ms'] / (p['seconds'] * 1e3):.3f}; "
                            + ", ".join(f"{k} {v:.1f}" for k, v in prof["by_class_ms"].items()))
            want = {"flash": L * d["prefill_dispatches"], "decode1": L * d["decode_steps"],
                    "general": L * d["verify_steps"]}
            if {k: launches[k] for k in want} != want:
                raise AssertionError(f"{mode}: launches {launches}, want {want}")
            # with the gate off every decode step may be a verify step
            if (launches["flash"] <= 0 or (speculate == 0 and launches["decode1"] <= 0)
                    or min(got_regimes) <= 0
                    or sum(got_regimes) != launches["quant"]
                    or (launches["general"] > 0) != (speculate > 0)):
                raise AssertionError(f"{mode}: a kernel of the path did not run: {launches}, "
                                     f"int8 by regime {got_regimes}")
            # every session's follow-up round 2 reuses its round 1's pages
            if d["prefix_hit_tokens"] <= 0 or suffix_admits[0] < PLUS_SESSIONS:
                raise AssertionError(f"{mode}: prefix reuse {d['prefix_hit_tokens']} hit "
                                     f"tokens, {suffix_admits[0]} requests admitted on a hit, "
                                     f"want at least {PLUS_SESSIONS}")
            if (free + held != engine.num_pages or any(r > 1 for r in refs)
                    or any(refs[q] != 1 for q in cached)):
                raise AssertionError(f"{mode}: page accounting: {free} free + {held} cached of "
                                     f"{engine.num_pages}, refcounts {sorted(set(refs))}")
            if status["queue_length"] != 0 or sorted(status["model_names"]) != sorted(models):
                raise AssertionError(f"{mode}: controller status {status}")
            if mode != "plain":
                same = [[(t["r1"], t["r2"]) for t in r] for r in turns]
                plain = [[(t["r1"], t["r2"]) for t in r] for r in passes["plain"]["turns"]]
                if same != plain:
                    raise AssertionError(f"{mode}: texts differ from the plain pass's")
            for n in kernels:
                totals[n] += launches[n]
            regimes = [a + b for a, b in zip(regimes, got_regimes)]
            del engine, backend
            backend = None
    finally:
        if server is not None:
            server.stop()
        if worker is not None:
            worker.stop()
        if backend is not None:
            backend.stop()
        codes = _stop_processes(procs)
    if any(c != 0 for c in codes.values()):
        raise AssertionError(f"exit codes on SIGTERM {codes}: "
                             + " | ".join(_tail(path, 800) for _, path in procs.values()))
    plain = passes["plain"]
    for mode in ("spec, gate off",):
        p, c = passes[mode], passes[mode]["counters"]
        log("plus", f"{mode}: spec_acceptance {c['spec_emitted'] / max(c['spec_steps'], 1):.3f} "
                    f"({c['spec_emitted'] / max(c['spec_slot_steps'], 1):.3f} a slot); "
                    f"{p['tokens'] / p['seconds']:.1f} tokens/s against the plain pass's "
                    f"{plain['tokens'] / plain['seconds']:.1f} "
                    f"(x{plain['seconds'] / p['seconds']:.3f}); texts equal the plain pass's")
    log("plus", f"processes stopped by SIGTERM, exit codes {codes}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; card {smi}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    totals["quant_regimes"] = tuple(regimes)
    return totals


# ---------------------------------------------------------------------------
# 19. the eval harness at 7B, from phase 16's checkpoint
# ---------------------------------------------------------------------------

EVAL_QUESTIONS = 4
EVAL_RUNS = (("greedy", ["--max-new-tokens", "32"]),
             ("engine", ["--engine-slots", "8", "--max-new-tokens", "32"]),
             ("beam", ["--num_beams", "3", "--max-new-tokens", "16"]))
EVAL_ORACLE_TOKENS = 4   # the cache-free beam oracle's budget


def _eval_child():
    """In a child process (``python3 -c "import chip_smoke;
    chip_smoke._eval_child()" RUNNER ARGS...``): run
    ``llava_plus_torch.eval.RUNNER`` as ``python -m`` runs it, with the
    session's load and the answers timed apart, and print one line
    ``EVAL_CHILD {json}``: the flash and dense decode launches (from 0 in
    this process), load and answer seconds, the engine's prefill dispatches
    and decode steps, peak device memory and any module of JAX loaded."""
    import runpy

    import torch
    from llava_plus_torch.eval import common
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention

    marks = {}
    init = common.EvalSession.__init__

    def timed(self, *args, **kw):
        t0 = time.perf_counter()
        init(self, *args, **kw)
        torch.cuda.synchronize()
        marks.update(load_s=time.perf_counter() - t0, ready=time.perf_counter(), session=self)

    common.EvalSession.__init__ = timed
    flash_attention.launches = decode_attention.launches = 0
    module = "llava_plus_torch.eval." + sys.argv[1]
    sys.argv = [module] + sys.argv[2:]
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    engine = marks["session"].engine
    print("EVAL_CHILD " + json.dumps({
        "flash": flash_attention.launches, "decode": decode_attention.launches,
        "chunk": decode_attention.chunk_launches, "wide": decode_attention.wide_launches,
        "load_s": marks["load_s"], "answer_s": time.perf_counter() - marks["ready"],
        "prefill_dispatches": engine.prefill_dispatches if engine else 0,
        "decode_steps": engine.decode_steps if engine else 0,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "foreign": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib", "llava_plus_tpu"))}),
          flush=True)


def _word_ids(text):
    """The ids of a word-level answer ("w17 w9 ..."; ``<unk>``, id 0, is
    never printed)."""
    return [int(w[1:]) for w in text.split()]


def _beam_oracle(params, cfg, tok, prompt, pixels, nb, n_new):
    """Cache-free beam search on the card: every step a full forward
    (``llava.forward``, no cache, the flash kernel over the whole sequence)
    of each live beam's prompt + tokens, the port's expansion rules (the top
    ``nb`` of each live beam, finished beams carried, a stable sort).
    Returns the ids, the (tokens, parents) each step selects, and each
    step's closest margin: the smallest gap between neighbours among its
    first ``nb + 1`` candidates (which decides the selected set and its
    order) over the step's largest top logit."""
    import torch
    from llava_plus_torch.data.multimodal import pad_images, plan_multimodal_batch
    from llava_plus_torch.mm_utils import tokenizer_image_token
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.llava import MultimodalBatch

    eos = tok.eos_token_id
    prompt_ids = list(tokenizer_image_token(prompt, tok))
    hw = (cfg.vision.image_size, cfg.vision.image_size, 3)
    images = torch.from_numpy(pad_images([pixels], 1, hw)).cuda()

    def step_logits(ids):
        plan = plan_multimodal_batch([np.asarray(ids, np.int64)],
                                     num_patches=cfg.num_image_tokens, max_len=2048,
                                     max_images=1, pad_to_multiple=128)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).cuda()

        batch = MultimodalBatch(tokens=dev(plan.tokens), positions=dev(plan.positions),
                                segment_ids=dev(plan.segment_ids), images=images,
                                image_pos=dev(plan.image_pos))
        last = torch.tensor([int(plan.lengths[0]) - 1], device="cuda")
        with torch.inference_mode():
            logits, _ = llava_model.forward(params, cfg, batch, logits_positions=last)
        return logits[0, -1].float()

    beams, steps, margins = [(0.0, [], False)], [], []
    for _ in range(n_new):
        cands, top = [], 0.0   # (score, ids, done, parent, token)
        for b, (score, ids, done) in enumerate(beams):
            if done:
                cands.append((score, ids, True, b, 0))
                continue
            logits = step_logits(prompt_ids + ids)
            top = max(top, float(logits.max().abs()))
            lp = torch.log_softmax(logits, dim=-1)
            vals, idx = torch.sort(lp, descending=True, stable=True)
            for v, i in zip(vals[:nb + 1].tolist(), idx[:nb + 1].tolist()):
                cands.append((score + v, ids + [i], i == eos, b, i))
        cands.sort(key=lambda c: -c[0])
        margins.append(min(cands[k][0] - cands[k + 1][0] for k in range(nb)) / top)
        steps.append(([c[4] for c in cands[:nb]], [c[3] for c in cands[:nb]]))
        beams = [c[:3] for c in cands[:nb]]
        if all(d for _, _, d in beams):
            break
    finished = [(s / len(i), i) for s, i, d in beams if d]
    if finished:
        return max(finished, key=lambda f: f[0])[1][:-1], steps, margins
    return max(beams, key=lambda b: b[0])[1], steps, margins


def phase_eval(smi, path=None):
    """Phase 19: the eval harness at LLaVA-1.5-7B width (CKPT_LAYERS layers),
    from phase 16's checkpoint on disk (random bf16 weights, seed 0, a word-level tokenizer
    that names every id and whose EOS lies past the logits, so every answer
    runs its budget).

    1. 4 image questions (12 words each) and their 336-px images written
       under ``.smoke/eval``;
    2. ``python -m llava_plus_torch.eval.model_vqa_loader --model-path ...``
       as a user runs it, three times at once (each in its own process, with
       the load and the answers timed apart: :func:`_eval_child`; the three
       share the card and the host, so their seconds are not one run's
       alone): single-stream
       greedy (32 tokens), ``--engine-slots 8`` (the dense engine, bf16 KV)
       and ``--num_beams 3 --max-new-tokens 16``; every answer file whole,
       each run's flash and dense decode launches exactly what its
       prefills and steps make, nothing of JAX loaded;
    3. the checkpoint loaded here: where an engine answer differs from the
       single-stream one, the plain step's top-2 logit gap at the first
       differing token, which must lie within phase 4's bound (2e-2; the
       greedy ids recomputed here by ``Generator.generate`` must equal the
       runner's); the beam search at a 4-token budget on 2 questions
       against a cache-free oracle on the card: each step's selected
       tokens and parents equal, or, from the first step that differs,
       that step's closest margin between candidates within twice that
       bound (a beam's score is a sum of log-probs);
    4. the beam reorder (:func:`llava_plus_torch.generate.reorder_beams`)
       timed at the beam run's shapes (3 rows of 2,048 slots, 16 slots
       moved, every row from another) beside a whole-cache gather.

    Prints load seconds, answers/s (greedy, engine), seconds an answer
    (beams), the reorder's ms a step and peak device memory, each with the
    card's name and power limit. Returns the launches of the three runs."""
    import torch
    from PIL import Image
    from llava_plus_torch.eval.model_vqa_loader import build_prompt
    from llava_plus_torch.generate import Generator, reorder_beams
    from llava_plus_torch.mm_utils import process_images
    from llava_plus_torch.models import llama
    from llava_plus_torch.models.builder import load_pretrained_model
    from llava_plus_torch.models.convert import tree_map

    t_phase = time.perf_counter()
    cfg, tol = _ckpt_cfg(), 2e-2
    L, V = cfg.text.num_hidden_layers, cfg.text.vocab_size
    path = path or os.path.join(SMOKE_DIR, CKPT_NAME)
    root = os.path.join(SMOKE_DIR, "eval")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.default_rng(19)
    questions = []
    for j in range(EVAL_QUESTIONS):
        size = (cfg.vision.image_size,) * 2 + (3,)
        Image.fromarray(rng.integers(0, 256, size=size, dtype=np.uint8)).save(
            os.path.join(root, "images", f"{j}.png"))
        words = " ".join(f"w{1 + (j * 7919 + i * 104729) % (V - 1)}" for i in range(12))
        questions.append({"question_id": j, "image": f"{j}.png", "text": words})
    with open(os.path.join(root, "questions.jsonl"), "w") as f:
        f.write("\n".join(json.dumps(q) for q in questions) + "\n")

    # 2. the runner as users run it: the three runs started together, each
    # in its own process (their loads, the most of a run, overlap) -----------
    runs, children = {}, {}
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    for tag, extra in EVAL_RUNS:
        answers = os.path.join(root, f"answers-{tag}.jsonl")
        argv = ["model_vqa_loader", "--model-path", path, "--image-folder",
                os.path.join(root, "images"), "--question-file",
                os.path.join(root, "questions.jsonl"), "--answers-file", answers, *extra]
        out_path = os.path.join(root, f"runner-{tag}.out")
        with open(out_path, "w") as out:   # the child keeps its own descriptor
            children[tag] = (subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke; chip_smoke._eval_child()", *argv],
                cwd=HERE, env=env, stdout=out, stderr=subprocess.STDOUT), out_path)
    for tag, extra in EVAL_RUNS:
        proc, out_path = children[tag]
        try:
            code = proc.wait(600)
        except subprocess.TimeoutExpired:
            for p, _ in children.values():
                p.kill()
            raise AssertionError(f"eval {tag}: the runner did not end within 600 s")
        wall = time.perf_counter() - t0
        answers = os.path.join(root, f"answers-{tag}.jsonl")
        with open(out_path, errors="replace") as f:
            output = f.read()
        line = next((ln for ln in output.splitlines() if ln.startswith("EVAL_CHILD ")), None)
        if code != 0 or line is None:
            for p, _ in children.values():
                p.kill()
            raise AssertionError(f"eval {tag}: the runner failed (exit {code}): "
                                 f"{output[-4500:]}")
        r = json.loads(line[len("EVAL_CHILD "):])
        rows = [json.loads(x) for x in open(answers)]
        if [row["question_id"] for row in rows] != list(range(EVAL_QUESTIONS)):
            raise AssertionError(f"eval {tag}: the answers file lists {len(rows)} answers")
        r["texts"] = [row["text"] for row in rows]
        n_new = int(extra[-1])
        lengths = [len(_word_ids(t)) for t in r["texts"]]
        n = EVAL_QUESTIONS
        if tag == "engine":
            want = (L * r["prefill_dispatches"], L * r["decode_steps"])
        else:   # one prefill an answer, then n_new - 1 decode steps
            want = (L * n, L * n * (n_new - 1))
        if (r["flash"], r["decode"]) != want or r["chunk"] or r["wide"] or r["foreign"]:
            raise AssertionError(f"eval {tag}: launches flash {r['flash']}, decode {r['decode']} "
                                 f"(want {want}), chunk {r['chunk']}, wide {r['wide']}; "
                                 f"foreign modules {r['foreign'][:5]}")
        if tag != "beam" and min(lengths) < n_new - 1:
            raise AssertionError(f"eval {tag}: answers of {lengths} words, want {n_new}")
        runs[tag] = r
        rate = (f"{n / r['answer_s']:.3f} answers/s" if tag != "beam"
                else f"{r['answer_s'] / n:.3f} s an answer")
        log("eval", f"{tag}: {' '.join(extra)}: {n} answers of {lengths} words in "
                    f"{r['answer_s']:.2f} s ({rate}), load {r['load_s']:.1f} s, process "
                    f"ended {wall:.1f} s after the three started; launches flash "
                    f"{r['flash']}, decode[bf16] {r['decode']}"
                    + (f" ({r['prefill_dispatches']} prefill dispatches, {r['decode_steps']} "
                       f"decode steps)" if tag == "engine" else "")
                    + f"; peak device memory {r['peak_gib']:.2f} GiB; card {smi}")

    # 3. the answers held here ------------------------------------------------
    t0 = time.perf_counter()
    tok, params, lcfg, proc, ctx = load_pretrained_model(path)
    params = tree_map(lambda x: x.cuda(), params)
    torch.cuda.synchronize()
    log("eval", f"checkpoint loaded here and moved to the card in {time.perf_counter() - t0:.1f} s")
    gen = Generator(params, lcfg, tok, proc, device="cuda", max_seq_len=ctx)
    prompts = [build_prompt(q["text"], "llava_v1") for q in questions]

    def pixels(j):
        img = Image.open(os.path.join(root, "images", f"{j}.png")).convert("RGB")
        return process_images([img], proc, lcfg)

    greedy, engine = runs["greedy"]["texts"], runs["engine"]["texts"]
    differ = [j for j in range(EVAL_QUESTIONS) if greedy[j] != engine[j]]
    for j in differ:
        ids = gen.generate(prompts[j], pixels(j), max_new_tokens=32, temperature=0.0,
                           stop_strings=["</s>"]).output_ids
        if tok.decode(ids, skip_special_tokens=True).strip() != greedy[j]:
            raise AssertionError(f"eval: question {j}: Generator.generate here differs from "
                                 f"the runner's single-stream answer")
        shown = [i for i, t in enumerate(ids) if t != 0]
        e = _word_ids(engine[j])
        k = next((m for m, (a, b) in enumerate(zip([ids[i] for i in shown], e)) if a != b),
                 min(len(shown), len(e)))
        cut = shown[k] if k < len(shown) else len(ids)
        with open(os.path.join(root, "images", f"{j}.png"), "rb") as f:
            body = {"prompt": prompts[j], "images": [base64.b64encode(f.read()).decode()]}
        gap = _top2_gap(params, lcfg, tok, body, ids[:cut], torch.bfloat16)
        log("eval", f"question {j}: the engine's answer leaves the single-stream one at token "
                    f"{cut}; the plain step's top-2 logit gap there {gap:.3e} of the top logit "
                    f"(bound {tol})")
        if gap > tol:
            raise AssertionError(f"eval: question {j}: the engine diverges at token {cut}, where "
                                 f"the top-2 gap is {gap:.3e} > {tol}")
    log("eval", f"engine answers equal to the single-stream ones: "
                f"{EVAL_QUESTIONS - len(differ)} of {EVAL_QUESTIONS}")

    for j in range(2):
        got = gen.beam_search(prompts[j], pixels(j), num_beams=3,
                              max_new_tokens=EVAL_ORACLE_TOKENS).output_ids
        want, steps, margins = _beam_oracle(params, lcfg, tok, prompts[j], pixels(j), 3,
                                            EVAL_ORACLE_TOKENS)
        # the first step whose selection (tokens and parents) differs
        s = next((t for t, (a, b) in enumerate(zip(gen._last_beam_steps, steps)) if a != b),
                 None)
        differ = ("equal" if s is None else f"differ at step {s} (tokens, parents: "
                  f"{gen._last_beam_steps[s]} here, {steps[s]} in the oracle)")
        log("eval", f"question {j}: 3 beams x {EVAL_ORACLE_TOKENS} tokens {got}, cache-free "
                    f"oracle {want}; selections {differ}; closest margins "
                    f"{', '.join(f'{m:.2e}' for m in margins)} of the top logit (bound {2 * tol})")
        if s is None and got != want:
            raise AssertionError(f"eval: question {j}: equal selections gave other ids")
        if s is not None and margins[s] > 2 * tol:
            raise AssertionError(f"eval: question {j}: beam selection differs from the "
                                 f"cache-free oracle's at step {s}, margin {margins[s]:.3e} "
                                 f"> {2 * tol}")

    # 4. the reorder a beam step makes ------------------------------------------
    n0 = gen._last_prompt_len
    cache = llama.KVCache.create(lcfg.text, 3, ctx, torch.bfloat16, device="cuda")
    ms = time_ms(lambda: reorder_beams(cache, [1, 2, 0], n0, n0 + 16))
    ms_all = time_ms(lambda: reorder_beams(cache, [1, 2, 0], 0, ctx))
    moved = 2 * L * 3 * 16 * cfg.text.num_key_value_heads * cfg.text.head_dim * 2
    log("eval", f"beam reorder: {ms:.4f} ms a step for slots [{n0}, {n0 + 16}) of 3 rows "
                f"({moved / 1e6:.1f} MB of k and v moved), the whole {ctx}-slot cache "
                f"{ms_all:.3f} ms; card {smi}")
    del cache, gen, params
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    log("eval", f"phase 19: {time.perf_counter() - t_phase:.1f} s; card {smi}")
    return {"flash": sum(r["flash"] for r in runs.values()),
            "decode": sum(r["decode"] for r in runs.values())}


# ---------------------------------------------------------------------------
# 22. the deployment predictor, from phase 16's checkpoint
# ---------------------------------------------------------------------------

PREDICT_TOKENS = 32


def phase_predictor(smi, path=None, device="cuda"):
    """Phase 22: ``llava_plus_torch.predict.Predictor`` as a deployment runs
    it: ``setup`` on phase 16's checkpoint (the port's loader, the tree
    moved to the card), then one image prompt streamed for 32 tokens at
    ``temperature=0``. Its tokens must be, bit for bit, what
    ``Generator.stream`` gives on the predictor's loaded tree for the same
    prompt and image; its flash and decode launches must be one prefill's
    and 31 decode steps'. Load seconds, seconds to the first piece and
    tokens a second (after the first piece)."""
    import torch
    from PIL import Image
    from llava_plus_torch.generate import Generator
    from llava_plus_torch.mm_utils import process_images
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.predict import Predictor
    from llava_plus_torch.serve.cli import load_image

    path = path or os.path.join(SMOKE_DIR, CKPT_NAME)
    rng = np.random.default_rng(22)
    image = os.path.join(SMOKE_DIR, "predict.png")
    Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)).save(image)
    prompt = "What is unusual about this image? Describe it in detail."
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pred = Predictor(device=device)
    pred.setup(path)
    sync()
    load_s = time.perf_counter() - t0
    L = pred.cfg.text.num_hidden_layers
    flash_attention.launches = decode_attention.launches = 0
    pieces, first = [], None
    t0 = time.perf_counter()
    for piece in pred.predict(image, prompt, temperature=0, max_tokens=PREDICT_TOKENS):
        if first is None:
            first = time.perf_counter() - t0
        pieces.append(piece)
    total = time.perf_counter() - t0
    launched = {"flash": flash_attention.launches, "decode": decode_attention.launches}
    ids = list(pred.generator._last_output_ids)

    gen = Generator(pred.generator.params, pred.cfg, pred.tokenizer, pred.image_processor,
                    device=device, max_seq_len=pred.generator.max_seq_len)
    text, stop = pred.prompt(prompt)
    images = process_images([load_image(image)], pred.image_processor, pred.cfg)
    streamed = list(gen.stream(text, images=images, max_new_tokens=PREDICT_TOKENS,
                               temperature=0.0, stop_strings=[stop]))
    want = list(gen._last_output_ids)
    rate = (len(ids) - 1) / (total - first) if len(ids) > 1 else 0.0
    log("predict", f"Predictor.setup {load_s:.1f} s; {len(ids)} tokens in {len(pieces)} "
                   f"pieces, first piece {first:.3f} s, {rate:.2f} tokens/s after it "
                   f"({total:.2f} s in all); prompt {pred.generator._last_prompt_len} fused "
                   f"tokens; flash +{launched['flash']} (want {L}), decode "
                   f"+{launched['decode']} (want {(PREDICT_TOKENS - 1) * L}); the same "
                   f"tokens as Generator.stream: {ids == want}; card {smi}")
    if (ids != want or len(ids) != PREDICT_TOKENS or "".join(pieces) != streamed[-1]
            or launched != {"flash": L, "decode": (PREDICT_TOKENS - 1) * L}):
        raise AssertionError(f"the predictor's stream differs from Generator.stream's: "
                             f"{ids} vs {want}, launches {launched}")
    del pred, gen
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    os.remove(image)
    return {**launched, "load_s": load_s, "first_s": first, "tok_s": rate}


# ---------------------------------------------------------------------------
# 23. the native image library against the image processor
# ---------------------------------------------------------------------------

NATIVE_LEVEL = 1.01 / 255 / 0.258   # one uint8 level in normalized units


def _host_cpu():
    """The host CPU's model name (``lscpu``, else ``/proc/cpuinfo``, else
    the machine type) and the cores this process may use."""
    import platform

    model = None
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                      if ln.strip().startswith("Model name")), None)
    except (OSError, subprocess.SubprocessError):
        pass
    if model is None:
        try:
            with open("/proc/cpuinfo") as f:
                model = next((ln.split(":", 1)[1].strip() for ln in f
                              if ln.startswith("model name")), None)
        except OSError:
            pass
    return (f"{model or 'model not named'} ({platform.machine()}), "
            f"nproc {len(os.sched_getaffinity(0))}")


def phase_native(smi):
    """Phase 23: ``llava_plus_torch.data.native`` (built here with g++ from
    the port's ``native/llava_img.cpp``) on the smoke's kind of images (the
    7B tower's 336 px squares, a 480 x 640 photo-sized frame, a tall and a
    large one), single and batched, against the port's
    ``ClipImageProcessor`` (PIL) within one uint8 level in normalized
    units; the batch bit for bit the single calls; the pad to square bit
    for bit ``mm_utils.expand2square``. Host ms an image for each path, with
    the host CPU beside them."""
    from PIL import Image
    from llava_plus_torch import mm_utils
    from llava_plus_torch.data import native
    from llava_plus_torch.data.image_processing import ClipImageProcessor

    t0 = time.perf_counter()
    lib = native.load_library()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(23)
    proc = ClipImageProcessor()
    singles = [rng.integers(0, 256, s + (3,), dtype=np.uint8)
               for s in [(336, 336), (480, 640), (640, 360), (1024, 768)]]
    worst = 0.0
    for a in singles:
        worst = max(worst, float(np.abs(proc(Image.fromarray(a))
                                        - native.clip_preprocess(a)).max()))
    bg = tuple(int(x * 255) for x in proc.image_mean)
    squares_equal = all(
        np.array_equal(native.expand2square(a, bg),
                       np.asarray(mm_utils.expand2square(Image.fromarray(a), bg)))
        for a in singles)
    batch = rng.integers(0, 256, (8, 480, 640, 3), dtype=np.uint8)
    got = native.clip_preprocess_batch(batch)
    batch_equal = all(np.array_equal(got[i], native.clip_preprocess(batch[i]))
                      for i in range(len(batch)))
    worst_batch = max(float(np.abs(proc(Image.fromarray(x)) - y).max())
                      for x, y in zip(batch, got))

    def per_image_ms(fn, n, reps=3):
        best = float("inf")
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t)
        return best * 1e3 / n

    pil_ms = per_image_ms(lambda: [proc(Image.fromarray(x)) for x in batch], len(batch))
    single_ms = per_image_ms(lambda: [native.clip_preprocess(x) for x in batch], len(batch))
    batch_ms = per_image_ms(lambda: native.clip_preprocess_batch(batch), len(batch))
    cpu = _host_cpu()
    log("native", f"{os.path.basename(lib._name)} built and loaded in {build_s:.2f} s (OpenMP "
                  f"{'on' if native.openmp() else 'off: the compiler has no OpenMP runtime'}); largest "
                  f"|native - ClipImageProcessor| {max(worst, worst_batch):.5f} (one level "
                  f"{NATIVE_LEVEL:.5f}); batch bit for bit the single calls {batch_equal}; "
                  f"expand2square bit for bit {squares_equal}; 480 x 640 -> 336 host ms an "
                  f"image: PIL {pil_ms:.2f}, native single {single_ms:.2f}, native batch of 8 "
                  f"{batch_ms:.2f}; host {cpu}")
    if max(worst, worst_batch) > NATIVE_LEVEL or not batch_equal or not squares_equal:
        raise AssertionError("the native library disagrees with the image processor")
    return {"pil_ms": pil_ms, "single_ms": single_ms, "batch_ms": batch_ms, "cpu": cpu,
            "openmp": native.openmp()}


# ---------------------------------------------------------------------------
# 24. the training state saved shard by shard, and restored
# ---------------------------------------------------------------------------

def phase_sharded_save(smi, device="cuda"):
    """Phase 24: the narrow LLaMA's stage-2 training state (phase 4's
    width: bf16 parameters, AdamW moments of the language model and the
    projector) placed
    on a one-rank NCCL ``make_mesh(1, 1, 1)`` and written by
    ``checkpoint.save_train_state`` (each rank its own shards,
    ``torch.distributed.checkpoint``), then restored into freshly placed
    trees on the mesh and, after the process group is gone, into plain
    trees on the host as one process holds them: every leaf bit for bit.
    Seconds and bytes written. (A 7B state, ~70 GB with f32 moments, does
    not fit the run's time; a one-rank mesh moves no bytes between ranks:
    the multi-rank writes are the CPU tests', tests/test_torch_mesh.py.)"""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from llava_plus_torch.models import llava
    from llava_plus_torch.models.convert import per_layer, tree_map
    from llava_plus_torch.parallel.mesh import make_mesh
    from llava_plus_torch.train import checkpoint
    from llava_plus_torch.train import step as step_lib
    from llava_plus_torch.train.optimizer import OptimizerConfig, build_optimizer, tree_leaves

    cfg = _narrow_cfg()
    base = llava.init_params(cfg, torch.Generator().manual_seed(24), "cpu", torch.bfloat16)
    root = os.path.join(SMOKE_DIR, "sharded")
    shutil.rmtree(root, ignore_errors=True)

    def moments_like(tree):
        return {"count": 0, **{m: {k: [torch.zeros_like(x) for x in tree_leaves(tree[k])]
                                   for k in trained} for m in ("mu", "nu")}}

    def local(x):
        return (x.to_local() if isinstance(x, DTensor) else x).cpu()

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, 1)
        params = per_layer(step_lib.place_params(tree_map(lambda x: x.to(device), base),
                                                 mesh, cfg))
        state = build_optimizer(params, OptimizerConfig()).init(params)
        trained = list(state["mu"])
        g = torch.Generator(device=device).manual_seed(24)
        for m in ("mu", "nu"):
            for leaves in state[m].values():
                for x in leaves:
                    x.to_local().normal_(generator=g)
        state["count"] = 3
        leaves = [x for x in _leaves({"p": params, "mu": state["mu"], "nu": state["nu"]})]
        payload = sum(x.numel() * x.element_size() for x in leaves)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save_train_state(root, 3, params, state, cfg)
        save_s = time.perf_counter() - t0
        files = os.listdir(os.path.join(path, checkpoint.SHARDED_DIR))
        written = sum(os.path.getsize(os.path.join(path, checkpoint.SHARDED_DIR, f))
                      for f in files)
        fresh = per_layer(step_lib.place_params(tree_map(
            lambda x: x.to(device),
            llava.init_params(cfg, torch.Generator().manual_seed(99), "cpu", torch.bfloat16)),
            mesh, cfg))
        t0 = time.perf_counter()
        on_mesh, at = checkpoint.restore_train_state(path, fresh, moments_like(fresh))
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        got_mesh = [local(x) for x in _leaves({"p": on_mesh["params"],
                                               "mu": on_mesh["opt_state"]["mu"],
                                               "nu": on_mesh["opt_state"]["nu"]})]
        want = [local(x) for x in leaves]
        dtensors = all(isinstance(x, DTensor) for x in _leaves(on_mesh["params"]))
        count_mesh = on_mesh["opt_state"]["count"]
        del on_mesh, fresh, params, state, leaves
    finally:
        dist.destroy_process_group()
    plain = per_layer(tree_map(torch.zeros_like, base))
    t0 = time.perf_counter()
    on_host, at_host = checkpoint.restore_train_state(path, plain, moments_like(plain))
    host_s = time.perf_counter() - t0
    got_host = list(_leaves({"p": on_host["params"], "mu": on_host["opt_state"]["mu"],
                             "nu": on_host["opt_state"]["nu"]}))
    same_mesh = len(got_mesh) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got_mesh, want))
    same_host = len(got_host) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got_host, want))
    shutil.rmtree(root, ignore_errors=True)
    log("save", f"narrow stage-2 state, {len(want)} leaves, {payload / 2 ** 20:.1f} MiB: sharded "
                f"save on a one-rank NCCL mesh {save_s:.2f} s, {written / 2 ** 20:.1f} MiB "
                f"written in {len(files)} files ({written / max(save_s, 1e-9) / 2 ** 30:.2f} "
                f"GiB/s); restored onto fresh DTensors {mesh_s:.2f} s (bit for bit "
                f"{same_mesh}, all DTensors {dtensors}), into plain host trees without a "
                f"process group {host_s:.2f} s (bit for bit {same_host}); step {at} / "
                f"{at_host}, count {count_mesh} / {on_host['opt_state']['count']}; card {smi}")
    if (not (same_mesh and same_host and dtensors) or at != 3 or at_host != 3
            or count_mesh != 3 or on_host["opt_state"]["count"] != 3
            or not payload <= written < 1.1 * payload):
        raise AssertionError("the sharded save did not restore the state it wrote")
    return {"save_s": save_s, "bytes": written, "mesh_s": mesh_s, "host_s": host_s}


RESUME_ROWS, RESUME_ACCUM = 2, 2   # phase 24's cut run: 4 rows a step


def phase_resume(smi, device="cuda"):
    """Phase 24, second part: ``scripts/v1_5/finetune.sh``'s flags through
    ``train.main`` at the narrow width (phase 4's LLaMA; its 2-layer tower
    at 28 px written as an HF directory; a random stage-1
    ``mm_projector.bin``; the base built in memory by
    ``train_13b_mesh.in_memory_base``), ``RESUME_ROWS`` rows x
    ``RESUME_ACCUM`` micro-batches a step, ``--save-steps 2 --max-steps 4``:
    run A trains steps 1-4 and saves ``checkpoint-2`` on the way, run B
    restores it and trains steps 3-4, both cut at step 4 before its save
    (``train_resume.cut_run``; both in this process). Holds B to A
    (``train_resume.pair_checks``: steps 3-4 bit for bit in loss,
    ``grad_norm``, non-pad tokens and sample ids, the restored state and
    the state after step 4 by digest) and each run's flash launches to 2L /
    L / L a micro-batch."""
    from pathlib import Path

    import torch
    from llava_plus_torch.data.debug_tokenizer import DebugTokenizer
    from llava_plus_torch.models import clip_vit
    from llava_plus_torch.tools import common
    from llava_plus_torch.tools import train_13b_mesh as mesh_tool
    from llava_plus_torch.tools import train_resume

    cfg = _narrow_cfg()
    L = cfg.text.num_hidden_layers
    root = os.path.join(SMOKE_DIR, "resume")
    shutil.rmtree(root, ignore_errors=True)
    per_step = RESUME_ROWS * RESUME_ACCUM
    data = mesh_tool.write_corpus(Path(root) / "data", per_step * train_resume.STEPS,
                                  cfg.vision.image_size, tiny=True)
    proj = mesh_tool.write_projector(Path(root) / "mm_projector.bin", cfg)
    common.write_tower(os.path.join(root, "tower"), clip_vit.init_params(
        cfg.vision, torch.Generator().manual_seed(1), "cpu", torch.float32), cfg.vision)
    argv, _ = common.script_argv(
        train_resume.SCRIPT, model_name_or_path=mesh_tool.BASE_NAME, data_path=data,
        image_folder=data.parent, vision_tower=os.path.join(root, "tower"),
        pretrain_mm_mlp_adapter=proj, output_dir=os.path.join(root, "out"),
        per_device_train_batch_size=RESUME_ROWS, gradient_accumulation_steps=RESUME_ACCUM,
        save_steps=train_resume.SAVE_STEPS, max_steps=train_resume.STEPS,
        model_max_length=cfg.max_sequence_length, device=device)
    build_model = mesh_tool.in_memory_base(cfg.text, DebugTokenizer(vocab_size=cfg.text.vocab_size))
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else device
    w0 = _written_gb()
    a = train_resume.cut_run(argv, build_model, torch.device(dev))
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    b = train_resume.cut_run(argv, build_model, torch.device(dev))
    written = _written_gb() - w0
    shutil.rmtree(root, ignore_errors=True)
    checks = train_resume.pair_checks(a, b)

    def want(n_steps):
        micro = n_steps * RESUME_ACCUM
        return {"fwd": 2 * L * micro, "dkv": L * micro, "dq": L * micro}

    late = [str(s) for s in range(train_resume.SAVE_STEPS + 1, train_resume.STEPS + 1)]
    checks["launches"] = (a["launches"] == want(train_resume.STEPS)
                          and b["launches"] == want(len(late)))
    checks["under_1_gb"] = written < 1.0
    log("resume", f"finetune.sh's flags through train.main at the narrow width, "
                  f"{RESUME_ROWS} x {RESUME_ACCUM} rows a step: A steps 1-4 (checkpoint-2 "
                  f"{a['save']['bytes'] / 2 ** 20:.1f} MiB in {a['save']['seconds']:.2f} s), "
                  f"B restored it in {b['restore']['seconds']:.2f} s (load "
                  f"{b['restore']['load_s']:.2f}, copy {b['restore']['copy_s']:.2f}) and ran "
                  f"steps 3-4; losses A {[round(s['loss'], 6) for s in a['steps'].values()]}, "
                  f"B {[round(s['loss'], 6) for s in b['steps'].values()]}; sample ids of step "
                  f"3 {b['steps'][late[0]]['sample_ids'] if late[0] in b['steps'] else None}; "
                  f"launches A {a['launches']}, B {b['launches']}; {written:.3f} GB written; "
                  f"checks {checks}; card {smi}")
    if not all(checks.values()):
        raise AssertionError(f"the resumed run is not the run that was never cut: {checks}")
    return {k: a["launches"][v] + b["launches"][v]
            for k, v in (("flash", "fwd"), ("dkv", "dkv"), ("dq", "dq"))}


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


TRAIN_STEPS = 2   # steps of each training phase (9, 10, 12, 13, 26, 27, 28)
# phase 13's depth: LLaVA-1.5-7B's width at 8 of its 32 layers (its recipe,
# QLoRA r 128, runs at a whole model's depth in phase 26, at 13B)
QLORA_LAYERS = 8
# phases 9 and 10's depth: LLaVA-1.5-7B's width at STAGE_LAYERS of its 32
# layers (phase 27 runs a 7B stage 1 and a 7B stage 2 at the whole depth,
# from a base checkpoint through the trainer's main())
STAGE_LAYERS = 8


def phase_train_stage1(smi):
    """LLaVA-1.5-7B's width at STAGE_LAYERS layers in stage 1 through the
    port's ``train()``: the recipe of
    ``scripts/v1_5/pretrain.sh`` (plain template, projector only, mlp2x_gelu,
    square images, batch 32, max length 2048, lr 1e-3, no weight decay,
    warmup 0.03, cosine, gradient checkpointing, bf16) on 64 synthetic
    image-caption records (2 steps), random bf16 weights from seed 0 in place
    of a checkpoint. Checks every logged loss, that the language model and
    the vision tower keep their bytes and the projector moves, the
    ``mm_projector.bin`` keys and shapes, and the launch counts."""
    import torch
    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.train import train as train_lib

    cfg = _llava_7b(STAGE_LAYERS)
    L = cfg.text.num_hidden_layers
    root = os.path.join(SMOKE_DIR, "stage1")
    rng = np.random.default_rng(4)
    data = _write_corpus(root, 32 * TRAIN_STEPS, rng, cfg.vision.image_size, lambda i: [
        {"from": "human", "value": "<image>\n"},
        {"from": "gpt", "value": _words(rng, int(rng.integers(10, 61)))}])
    before = {}

    def build_model(model_args, dtype, device, seed):
        params = _init_llava(device, cfg)
        before.update({k: _fingerprints(params[k]) for k in params})
        return params, cfg, DebugTokenizer(vocab_size=cfg.text.vocab_size)

    steps = []

    last = {}

    def on_step(step, metrics, seconds, arrays):
        tokens = int((arrays["segment_ids"] > 0).sum())
        steps.append((metrics, seconds, tokens, arrays["tokens"].shape))
        last["arrays"] = arrays

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
    want = (TRAIN_STEPS * 2 * L, TRAIN_STEPS * L, TRAIN_STEPS * L)
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
    if (len(steps) != TRAIN_STEPS or not all(np.isfinite(m["loss"]) for m, *_ in steps)
            or after["language_model"] != before["language_model"]
            or after["vision_tower"] != before["vision_tower"]
            or moved != len(after["mm_projector"]) or shapes != want_shapes
            or launched != want):
        raise AssertionError("7B stage 1 failed its checks")
    mesh = _stage1_mesh_step(smi, params, cfg, last["arrays"])
    return {k: n + mesh[k] for k, n in zip(("flash", "dkv", "dq"), launched)}


# the mesh step's bounds against the eager step (bf16, one rank): the loss
# and grad_norm within rtol 1e-3; the projector's elements within 2 lr of
# the eager step's (Adam moves an element by about lr, in the direction of
# its gradient's sign, which the summation order decides near 0) and at
# least 99.9% of them bit for bit
MESH_RTOL = 1e-3
MESH_SAME_SHARE = 0.999


def _stage1_mesh_step(smi, params, cfg, arrays):
    """One more stage-1 step on phase 9's trained 7B tree and its last
    batch, first eager, then (the projector and the optimizer state as
    before it) through ``make_train_step(..., mesh=make_mesh(1, 1, 1))`` on
    a one-rank NCCL process group: every leaf a DTensor, the flash kernels
    run through the mesh's local wrapper, the loss, grad_norm and the
    updated projector held to the eager step's, the host ms of both. A
    one-rank mesh moves no bytes between ranks: the multi-rank collectives
    are the CPU tests' (tests/test_torch_mesh.py, 8 gloo ranks)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from llava_plus_torch.models.convert import per_layer, tree_map
    from llava_plus_torch.ops.attention import attention
    from llava_plus_torch.ops.quant import matmul
    from llava_plus_torch.parallel.mesh import make_mesh
    from llava_plus_torch.train import step as step_lib
    from llava_plus_torch.train.optimizer import OptimizerConfig, build_optimizer

    L, lr = cfg.text.num_hidden_layers, 1e-3
    opt_cfg = OptimizerConfig(learning_rate=lr, warmup_ratio=0.0, schedule="constant",
                              total_steps=10, train_language_model=False)
    batch = _batch_on(arrays, "cuda")
    saved = tree_map(lambda x: x.clone(), params["mm_projector"])

    def one_step(tree, b, mesh=None):
        p = per_layer(tree)
        opt = build_optimizer(p, opt_cfg)
        state = opt.init(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step_lib.make_train_step(cfg, opt, remat=True, mesh=mesh)(p, state, b)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        return m, (time.perf_counter() - t0) * 1e3

    m_e, ms_e = one_step(params, batch)
    proj_e = list(_leaves(tree_map(lambda x: x.clone(), params["mm_projector"])))
    tree_map(lambda p, s: p.copy_(s), params["mm_projector"], saved)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, 1)
        placed = step_lib.place_params(params, mesh, cfg)
        dtensors = all(isinstance(x, DTensor) for x in _leaves(placed))
        _reset_counts()
        calls = attention.mesh_calls
        products = (matmul.column_calls, matmul.row_calls)
        m_m, ms_m = one_step(placed, step_lib.place_batch(batch, mesh), mesh)
        launched = _counts()
        calls = attention.mesh_calls - calls
        products = (matmul.column_calls - products[0], matmul.row_calls - products[1])
        proj_m = [x.full_tensor() for x in _leaves(placed["mm_projector"])]
        del placed
    finally:
        dist.destroy_process_group()
    before = list(_leaves(saved))
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(proj_m, proj_e))
    same = (sum(int((a == b).sum()) for a, b in zip(proj_m, proj_e))
            / sum(a.numel() for a in proj_e))
    moved = sum(not torch.equal(a, b) for a, b in zip(proj_m, before))
    want = (2 * L, L, L)
    # the forward's 5 column (wq, wk, wv, w_gate, w_up) and 2 row (wo,
    # w_down) products a layer, and remat's recompute of the layer up to the
    # last tensor its backward saved: its 5 column products and wo (the
    # non-reentrant checkpoint stops before w_down, whose output nothing saves)
    want_products = (2 * 5 * L, 2 * L + L)
    log("stage1", f"mesh step (dp, fsdp, tp) = (1, 1, 1), one NCCL rank (a one-rank mesh moves "
                  f"no bytes between ranks; the CPU tests hold the multi-rank collectives): "
                  f"every leaf a DTensor {dtensors}; attention through the mesh's local "
                  f"wrapper {calls} times (want {2 * L}), flash fwd/dkv/dq {launched} (want "
                  f"{want}); local products column/row {products} (want {want_products}); loss {m_m['loss']:.6f} vs eager {m_e['loss']:.6f}, grad_norm "
                  f"{m_m['grad_norm']:.6f} vs {m_e['grad_norm']:.6f}; projector largest |diff| "
                  f"{diff:.3e} (bound {2 * lr}), bit-identical share {same:.6f} (at least "
                  f"{MESH_SAME_SHARE}), leaves moved {moved} of {len(before)}; host "
                  f"{ms_m:.1f} ms vs eager {ms_e:.1f} ms; card {smi}")
    if (not dtensors or calls != 2 * L or launched != want or products != want_products
            or abs(m_m["loss"] - m_e["loss"]) > MESH_RTOL * abs(m_e["loss"])
            or abs(m_m["grad_norm"] - m_e["grad_norm"]) > MESH_RTOL * abs(m_e["grad_norm"])
            or diff > 2 * lr or same < MESH_SAME_SHARE or moved != len(before)):
        raise AssertionError("the mesh step differs from the eager step")
    return dict(zip(("flash", "dkv", "dq"), launched), column=products[0], row=products[1],
                host_ms=ms_m, eager_host_ms=ms_e)


def phase_train_stage2(smi):
    """LLaVA-1.5-7B's width at STAGE_LAYERS layers in stage 2 through
    ``make_train_step`` with batches from
    the port's dataset and collator (what ``train()`` runs, without its
    final HF export): the recipe of ``scripts/v1_5/finetune.sh`` (v1
    template, language model and projector trained, lr 2e-5, no weight
    decay, warmup 0.03, cosine, gradient checkpointing, bf16 parameters and
    moments), reduced for one card to batch 4 with gradient accumulation 2
    (the recipe has 16 a device on 8 cards); 2 steps on 16 synthetic
    multi-turn image records of 700 to 2048 fused tokens, some truncated at
    2048. Checks the loss, that every language-model and projector leaf
    received an update (a nonzero first moment) and every matrix moved (a
    norm weight of 1.0 cannot move by lr 2e-5 in bf16), that the vision
    tower keeps its bytes, and the launch counts."""
    import torch
    from llava_plus_torch import conversation
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.data.dataset import DataConfig, collate_batch, make_supervised_dataset
    from llava_plus_torch.models.convert import per_layer
    from llava_plus_torch.train import step as step_lib
    from llava_plus_torch.train import train as train_lib
    from llava_plus_torch.train.optimizer import OptimizerConfig, build_optimizer

    cfg = _llava_7b(STAGE_LAYERS)
    L = cfg.text.num_hidden_layers
    B, K, n_steps = 4, 2, TRAIN_STEPS
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
    params = per_layer(_init_llava("cuda:0", cfg))   # each layer's weights are their own leaves
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
    events, by kernel class as ``tools/profile_torch_slice.py`` sorts them.
    Only the device is traced: a 13B step's host operators took 22-26 s to
    read back, and no number here comes from them."""

    def __init__(self, n_steps):
        self.n_steps, self.prof, self.result = n_steps, None, None

    def after(self, step, seconds):
        import importlib.util

        import torch
        from torch.profiler import ProfilerActivity, profile

        if step == self.n_steps - 1:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        elif step == self.n_steps and self.prof is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
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
                           "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
                           "read_s": time.perf_counter() - t0}

    def line(self):
        r = self.result
        parts = ", ".join(f"{k} {v:.3f}" for k, v in r["by_class_ms"].items())
        return (f"profiled step {self.n_steps}: host {r['host_ms']:.3f} ms, device busy "
                f"{r['device_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}; {parts} (the "
                f"profile read in {r['read_s']:.1f} s)")


def phase_train_mpt_stage1(smi):
    """LLaVA-MPT-7B stage 1 through the port's ``train()`` at full width
    and depth (d_model 4096, 32 layers of 32 heads, vocab 50432, CLIP-L/224,
    linear projector; random bf16 weights from seed 0): the recipe of
    ``scripts/pretrain.sh`` (plain template, projector only, batch 32, max
    length 2048, lr 1e-3, no weight decay, warmup 0.03, cosine, gradient
    checkpointing, bf16) on 64 synthetic image-caption records, 2 steps. The
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
    data = _write_corpus(root, 32 * TRAIN_STEPS, rng, cfg.vision.image_size, lambda i: [
        {"from": "human", "value": "<image>\n"},
        {"from": "gpt", "value": _words(rng, int(rng.integers(10, 61)))}])
    before = {}

    def build_model(model_args, dtype, device, seed):
        params = _init_mpt_7b(device)
        before.update({k: _fingerprints(params[k]) for k in params})
        tok = DebugTokenizer(vocab_size=cfg.mpt.vocab_size)
        tok.bos_token_id = None
        return params, cfg, tok

    steps, prof = [], _LastStepProfile(TRAIN_STEPS)

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
    want = (TRAIN_STEPS * 2 * L, TRAIN_STEPS * L, TRAIN_STEPS * L)
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
    if (len(steps) != TRAIN_STEPS or not all(np.isfinite(m["loss"]) for m, *_ in steps)
            or after["language_model"] != before["language_model"]
            or after["vision_tower"] != before["vision_tower"]
            or moved != len(after["mm_projector"]) or shapes != want_shapes
            or launched != want or any(plain)):
        raise AssertionError("LLaVA-MPT-7B stage 1 failed its checks")
    return dict(zip(("flash", "dkv", "dq"), launched))


def _qlora_cfg():
    """Phase 13's model: LLaVA-1.5-7B at QLORA_LAYERS layers."""
    return _llava_7b(QLORA_LAYERS)


def phase_train_qlora(smi):
    """LLaVA-1.5-7B QLoRA through the port's ``train()``: the recipe of
    ``scripts/finetune_qlora.sh`` (``--lora-enable --bits 4``, r 128, alpha
    256, v1 template, gradient checkpointing, bf16) reduced for one card to
    batch 4 and 2 steps on 8 synthetic multi-turn image records of 700 to
    2048 fused tokens (phase 10's), random bf16 weights from seed 0 in place
    of a checkpoint, 7B's width at QLORA_LAYERS of its 32 layers (phase 26
    runs the recipe at a whole model's depth). ``--bits 4`` quantizes the language model to int4 (the
    seven LLaMA matrices and the head) before the adapters are made; only
    the adapters train (the JAX package's ``optax.adamw(lr)``). Checks every
    loss, that every adapter leaf moved, that the int4 base, the vision tower
    and the projector keep their bytes, the PEFT export (2 x 7 tensors a
    layer of the adapters' shapes) and ``non_lora_trainables.bin``, the peak memory, and
    the launch counts: per step the int4 kernel runs 7 products a layer
    twice (remat) and the head once, its backward Function once for each
    product whose input carries a gradient (all but layer 0's q/k/v)."""
    import torch
    from safetensors.torch import load_file
    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.train import lora as lora_lib
    from llava_plus_torch.train import train as train_lib

    cfg = _qlora_cfg()
    L = cfg.text.num_hidden_layers
    B, n_steps, r = 4, TRAIN_STEPS, 128
    root = os.path.join(SMOKE_DIR, "qlora")
    rng = np.random.default_rng(8)
    data = _write_corpus(root, B * n_steps, rng, cfg.vision.image_size,
                         lambda i: _long_turns(rng))
    state = {}

    def build_model(model_args, dtype, device, seed):
        params = _init_llava(device, cfg)
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
    log("qlora", f"{len(steps)} steps at {L} layers; adapter leaves unmoved {unmoved} of {len(ad_after)}; "
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
        raise AssertionError(f"LLaVA-1.5-7B QLoRA ({L} layers) failed its checks")
    return {"flash": flash[0], "dkv": flash[1], "dq": flash[2], "int4": q[0]}


# ---------------------------------------------------------------------------
# 26. LLaVA-1.5-13B LoRA and QLoRA
# ---------------------------------------------------------------------------

# scripts/v1_5/finetune_lora.sh at 13B: per-device batch 16 at max length
# 2048, LoRA r 128 / alpha 256, lr 2e-4 (the projector's 2e-5, warmup 0.03
# and cosine given as the script gives them; the JAX LoRA step ignores them)
TRAIN_13B_BATCH = 16
TRAIN_13B_LEN = 2048
TRAIN_13B_RANK = 128
TRAIN_13B_LR = 2e-4
# r-128 adapters on LLaVA-1.5-13B's seven targets: 40 * 128 * (11 * 5120 +
# 3 * 13824) parameters, 14 stacked leaves
ADAPTERS_13B = 500_695_040
# the peak device memory each recipe is held under (GiB of the card's 79.6),
# from the arithmetic in PERF.md's prediction for phase 26: base, f32 adapters with
# their gradients and AdamW moments, 40 remat checkpoints of 16 x 2048 x
# 5120 bf16, f32 logits / log-softmax / their gradient, one layer's
# recompute and the int4 backward's dequantized matrix
TRAIN_13B_PEAK_GIB = {"lora": 72.0, "qlora": 58.0}
# the merge check (check_merged_weights): every merged target against this
# script's own sum, the base (an int4 base dequantized here from its nibbles
# and block scales) plus a @ b * scaling in f64. The port's merge sums in f32
# and rounds to bf16, so each merged weight must be the bf16 rounding of a
# value within f32's error bound of the f64 sum: (r + 2) * 2**-24 * (|W| +
# scaling * |a| @ |b|), the bound of an r-term product and one addition.
# Each matrix's footprint (its share of weights that the adapters move off
# the base in bf16) must be at least MERGE_FOOTPRINT, or the check could
# not tell a merge from the base.
MERGE_FOOTPRINT = 0.1
# a 768-token image prefill (576 image slots + BOS + newline + 190 words)
# through the merged tree and through the base with the adapters attached
# lazily, logged against MERGE_TOL (phase 25's bound for two routes to one
# function), which a bf16 merge of a random 40-layer 13B does not meet
MERGE_WORDS = 190
MERGE_TOL = 2e-2


def phase_train_13b(smi, start):
    """Phase 26: LLaVA-1.5-13B (40 layers of 5,120, 40 heads, FFN 13,824,
    vocab 32,000) at full width and depth, trained through the port's
    ``train.main`` from phase 28's ``start``: B13 (``--model-name-or-path``),
    V336 (``--vision-tower``) and stage 1's ``mm_projector.bin``
    (``--pretrain-mm-mlp-adapter``), by two recipes:

    A. ``scripts/v1_5/finetune_lora.sh``'s flags at 13B (``--lora-enable``,
       r 128, alpha 256, lr 2e-4, v1 template, pad aspect, modality-grouped
       batches, gradient checkpointing, bf16, batch 16 at max length 2048);
    B. the same plus ``--bits 4``, which quantizes the same tree in place
       (the seven matrices and the head, a layer at a time) before the
       adapters are made.

    B13 is read from disk once, for both: the first recipe's
    ``build_model`` is the trainer's own; the second's is the trainer's own
    too, its loader handing back the first read's language model (already
    on the card), so that the tower is built from V336 and the projector
    loaded from the file again. Each run's start is checked: the language
    model B13's bytes, the tower V336's, the projector the file's bit for
    bit. Each runs TRAIN_STEPS steps on 32 synthetic multi-turn image
    records of 700 to 2048 fused tokens (:func:`_train_13b_recipe` checks
    each), then merges its trained adapters into its base
    (:func:`_merge_check_13b`). B13 and V336 are removed at the end.
    Returns the launches of the phase by kernel."""
    import torch
    from llava_plus_torch.models import builder
    from llava_plus_torch.models.configs import LLAVA_15_13B
    from llava_plus_torch.train import train as train_lib

    t_phase = time.perf_counter()
    cfg = LLAVA_15_13B
    root = os.path.join(SMOKE_DIR, "train_13b")
    rng = np.random.default_rng(26)
    data = _write_corpus(root, TRAIN_13B_BATCH * TRAIN_STEPS, rng, cfg.vision.image_size,
                         lambda i: _long_turns(rng))
    projector = torch.load(start["projector"], weights_only=True)
    kept, starts = {}, []

    def build_model(model_args, dtype, device, seed):
        """The trainer's ``build_model``; B13 read by the first call only."""
        load = builder.load_pretrained_model

        def reading(path, dtype, device):
            t0 = time.perf_counter()
            got = load(path, dtype=dtype, device=device)
            kept.update(tok=got[0], cfg=got[2], read_s=time.perf_counter() - t0)
            return got

        def again(path, dtype, device):
            # the first read's language model, on the card (a text-only tree)
            return (kept["tok"], {"language_model": kept.pop("lm"), "vision_tower": {},
                                  "mm_projector": {}}, kept["cfg"], None, None)

        builder.load_pretrained_model = again if "lm" in kept else reading
        t0 = time.perf_counter()
        try:
            params, got_cfg, tok = train_lib.build_model(model_args, dtype, device, seed)
        finally:
            builder.load_pretrained_model = load
        torch.cuda.synchronize()
        kept["lm"] = params["language_model"]
        starts.append({
            "build_s": time.perf_counter() - t0, "read_s": kept.pop("read_s", None),
            "base": _named_prints(params["language_model"]) == start["base_prints"],
            "tower": _named_prints(params["vision_tower"]) == start["tower_prints"],
            "projector": _projector_matches(projector, params["mm_projector"]),
            "frozen": {k: _fingerprints(params[k]) for k in ("vision_tower", "mm_projector")}})
        return params, got_cfg, tok

    totals = {}
    for tag, bits in (("lora", None), ("qlora", 4)):
        for k, v in _train_13b_recipe(smi, tag, cfg, bits, data, root, start, build_model,
                                      starts).items():
            totals[k] = totals.get(k, 0) + v
    kept.clear()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(start["root"], ignore_errors=True)
    log("train-13b", f"phase 26: {time.perf_counter() - t_phase:.1f} s; launches {totals}; "
                     f"B13 and V336 removed; card {smi}")
    return totals


def _train_13b_recipe(smi, tag, cfg, bits, data, root, start, build_model, starts):
    """One recipe of phase 26 through ``train.main`` with
    ``finetune_lora.sh``'s flags (``bits`` None: LoRA on the bf16 base; 4:
    QLoRA, ``--bits 4``, the tree quantized in place), from ``start``
    through ``build_model`` (which appends the start's checks to
    ``starts``). Checks the start (the language model B13's bytes, the
    tower V336's, the projector stage 1's file bit for bit), every loss is
    finite, that every adapter leaf moved and the adapters hold
    ADAPTERS_13B parameters, that the base keeps its bytes (bf16, or int4
    as quantized) and the vision tower and projector theirs, the PEFT export
    (2 x 7 x 40 tensors of rank 128, as many parameters) and
    ``non_lora_trainables.bin``, the peak device memory under
    TRAIN_13B_PEAK_GIB, and the launch counts: per step the flash forward 2
    x 40 (remat), dK/dV and dQ 40 each; with int4 its kernel 7 products a
    layer twice and the head once, its backward Function once for each
    product whose input carries a gradient (all but layer 0's q/k/v, fed by
    the frozen embeddings and projector); no int8 launch, and no int4
    launch on the bf16 base. Logs each step's host ms, non-pad tokens/s and
    peak memory, and the last step's device time by class. Then the merge
    (:func:`_merge_check_13b`). Returns the recipe's launches by kernel."""
    import math

    import torch
    from safetensors import safe_open
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.train import lora as lora_lib
    from llava_plus_torch.train import train as train_lib

    L, D = cfg.text.num_hidden_layers, cfg.hidden_size
    F = cfg.text.intermediate_size
    n_steps, r = TRAIN_STEPS, TRAIN_13B_RANK
    state = {}

    def init_lora(lm, lora_cfg, generator):
        # the base the adapters are made on (int4 already with --bits 4)
        state["lm"], state["lm_before"] = lm, _fingerprints(lm)
        ad = lora_lib.init_lora_params(lm, lora_cfg, generator)
        state["adapters"], state["ad_before"] = ad, _fingerprints(ad)
        return ad

    steps, prof = [], _LastStepProfile(n_steps)

    def on_step(step, metrics, seconds, arrays):
        tokens = int((arrays["segment_ids"] > 0).sum())
        # the peak since the last step's report (the first: since the run
        # began, the base's build, quantization and adapters included)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        steps.append((metrics, seconds, tokens, arrays["tokens"].shape, peak))
        prof.after(step, seconds)
        state["t_steps"] = time.perf_counter()

    out = os.path.join(root, f"out_{tag}")
    flags = dict(model_name_or_path=start["base"], vision_tower=start["tower"],
                 pretrain_mm_mlp_adapter=start["projector"], data_path=data, image_folder=root,
                 output_dir=out, max_steps=n_steps, device="cuda")
    argv, env = _script_argv(LORA_13B_SCRIPT, **flags, **({"bits": bits} if bits else {}))
    want_recipe = {"per-device-train-batch-size": TRAIN_13B_BATCH,
                   "model-max-length": TRAIN_13B_LEN, "lora-r": r, "lora-alpha": 2 * r,
                   "learning-rate": TRAIN_13B_LR, "version": "v1", "image-aspect-ratio": "pad",
                   "group-by-modality-length": "true"}
    recipe = {k: type(v)(argv[argv.index(f"--{k}") + 1]) for k, v in want_recipe.items()}
    if env or recipe != want_recipe:
        raise AssertionError(f"{LORA_13B_SCRIPT} no longer gives phase 26's recipe: {recipe}, "
                             f"{env}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    params, got_cfg = train_lib.main(argv, build_model=build_model, init_lora=init_lora,
                                     on_step=on_step)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    seconds = t_end - t0
    began = starts[-1]
    peak = max([p for *_, p in steps] + [torch.cuda.max_memory_allocated()]) / 2 ** 30
    flash = _counts()
    q = (qm.matmul_int4.launches, qm.matmul_int4.backward_calls)
    other = qm.matmul_int8.launches + qm.matmul_int8.backward_calls
    name = "QLoRA int4" if bits else "LoRA bf16"
    read = (f"B13 read from disk in {began['read_s']:.1f} s" if began["read_s"] is not None
            else "B13 as the first recipe read it")
    log("train-13b", f"{name} through main() ({LORA_13B_SCRIPT}'s flags"
                     f"{' --bits 4' if bits else ''}): the start built in "
                     f"{began['build_s']:.1f} s ({read}, the tower from V336, the projector "
                     f"from stage 1's file); its language model B13's bytes {began['base']}, "
                     f"its tower V336's {began['tower']}, its projector the file's bit for bit "
                     f"{began['projector']}; {got_cfg.num_image_tokens} image tokens at "
                     f"{got_cfg.vision.image_size} px, a {got_cfg.mm_projector_type} projector")
    for i, (m, dt, tokens, shape, p) in enumerate(steps, 1):
        log("train-13b", f"{name} step {i}: batch {shape[0]} x {shape[1]}, {tokens} non-pad "
                         f"tokens, loss {m['loss']:.4f}, adapter grad_norm {m['grad_norm']:.4f}, "
                         f"host {dt * 1e3:.1f} ms, {tokens / dt:.0f} non-pad tokens/s, peak "
                         f"device memory {p / 2 ** 30:.2f} GiB")
    log("train-13b", f"{name} {prof.line()}")
    ad = state.pop("adapters")
    ad_after = _fingerprints(ad)
    unmoved = sum(a == b for a, b in zip(state["ad_before"], ad_after))
    n_adapter = sum(x.numel() for x in _leaves(ad))
    base_same = _fingerprints(state["lm"]) == state["lm_before"]
    wq = state.pop("lm")["layers"]["attn"]["wq"]
    kind = ("int4" if isinstance(wq, dict) and "qvalue4" in wq else
            "bf16" if torch.is_tensor(wq) and wq.dtype == torch.bfloat16 else "other")
    kept = {k: _fingerprints(params[k]) == v for k, v in began["frozen"].items()}
    with safe_open(os.path.join(out, "adapter_model.safetensors"), "pt") as f:
        shapes = {k: f.get_slice(k).get_shape() for k in f.keys()}
    shapes_ok = all(v[0 if k.endswith("lora_A.weight") else 1] == r for k, v in shapes.items())
    n_export = sum(math.prod(v) for v in shapes.values())
    n_sd = len(shapes)
    extra = torch.load(os.path.join(out, "non_lora_trainables.bin"), weights_only=True)
    want_flash = (n_steps * 2 * L, n_steps * L, n_steps * L)
    want_q = (n_steps * (2 * 7 * L + 1), n_steps * (7 * L + 1 - 3)) if bits else (0, 0)
    limit = TRAIN_13B_PEAK_GIB[tag]
    log("train-13b", f"{name}: {len(steps)} steps in {seconds:.1f} s (with the start, the "
                     f"{'quantization, ' if bits else ''}data and the profile; the export "
                     f"{t_end - state['t_steps']:.1f} s of them); "
                     f"adapters {n_adapter:,} parameters (want {ADAPTERS_13B:,}), leaves unmoved "
                     f"{unmoved} of {len(ad_after)}; base {kind}, its bytes unchanged "
                     f"{base_same}; vision tower / projector bytes unchanged {kept}; export: "
                     f"{n_sd} adapter tensors (rank {r}: {shapes_ok}), {n_export:,} parameters, "
                     f"non_lora_trainables {sorted(extra)} (stage 1's projector bit for bit "
                     f"{_projector_matches(extra, params['mm_projector'])}); launches flash "
                     f"fwd/dkv/dq {flash} (want {want_flash}); int4 kernel forward launches / "
                     f"backward calls {q} (want {want_q}), int8 {other}; peak device memory "
                     f"{peak:.2f} GiB (bound {limit:.1f}); card {smi}")
    if (not (began["base"] and began["tower"] and began["projector"])
            or got_cfg.vision != cfg.vision or got_cfg.mm_projector_type != cfg.mm_projector_type
            or len(steps) != n_steps or not all(np.isfinite(m["loss"]) for m, *_ in steps)
            or unmoved or n_adapter != ADAPTERS_13B or L * r * (11 * D + 3 * F) != ADAPTERS_13B
            or kind != ("int4" if bits else "bf16") or not base_same or not all(kept.values())
            or n_sd != 2 * 7 * L or not shapes_ok or n_export != ADAPTERS_13B
            or len(extra) != 4 or not _projector_matches(extra, params["mm_projector"])
            or flash != want_flash or q != want_q or other or peak > limit):
        raise AssertionError(f"LLaVA-1.5-13B {name} failed its checks")
    merged = _merge_check_13b(smi, name, params, got_cfg, ad,
                              lora_lib.LoraConfig(r=r, alpha=2 * r), bits)
    return {"flash": flash[0] + merged["flash"], "dkv": flash[1], "dq": flash[2],
            "int4": q[0] + merged["int4"], "int4_backward": q[1]}


def _int4_values(w):
    """An int4 leaf (``{"qvalue4": int8 [in/2, out], "scale": f32 [in/32,
    out]}``) as its [in, out] values in f64: two signed nibbles a byte in
    split-half order (the low nibbles are rows 0-15 of each 32-row block,
    the high ones rows 16-31), times the block's scale."""
    import torch

    p = w["qvalue4"].to(torch.int16)
    half, n = p.shape
    lo, hi = ((((p >> s) & 15) ^ 8) - 8 for s in (0, 4))
    q = torch.cat([lo.reshape(half // 16, 16, n), hi.reshape(half // 16, 16, n)], dim=1)
    return (q.double() * w["scale"].double()[:, None, :]).reshape(2 * half, n)


def _bf16_order(x):
    """bf16 values as integers in their order, one apart for neighbours
    (both zeros 0)."""
    import torch

    v = x.view(torch.int16).to(torch.int32)
    return torch.where(v < 0, -(v & 0x7FFF), v)


def check_merged_weights(merged_layers, base_layers, adapters, scaling):
    """Holds each merged target of ``merged_layers`` (a per-layer tree's
    layers) against this script's own f64 sum of ``base_layers``' weight (a
    bf16 matrix, or an int4 leaf dequantized by :func:`_int4_values` and
    rounded to bf16, as the merge dequantizes it) and ``a @ b * scaling``
    from the stacked ``adapters``: a bf16 matrix of the base's shape whose
    every weight lies between the bf16 roundings of that sum less and plus
    f32's error bound (an f32 sum rounds to bf16 within them, rounding
    being monotonic), and a footprint of at least MERGE_FOOTPRINT. Raises
    AssertionError naming the first matrix that fails; returns the largest
    share of a matrix's weights that differ from the f64 sum's own bf16
    rounding (those within the bound of a rounding boundary) and the
    smallest footprint."""
    import torch

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    worst, smallest = 0.0, 1.0
    with torch.no_grad():
        for i, (m_lay, b_lay) in enumerate(zip(merged_layers, base_layers, strict=True)):
            for joined, ab in adapters.items():
                path = joined.split("/")[1:]   # below "layers"
                w, got = at(b_lay, path), at(m_lay, path)
                base = (_int4_values(w).to(torch.bfloat16) if isinstance(w, dict)
                        else w.to(torch.bfloat16))
                a, b = ab["a"][i].double(), ab["b"][i].double()
                total = base.double() + (a @ b) * scaling
                bound = ((a.shape[-1] + 2) * 2.0 ** -24
                         * (base.double().abs() + (a.abs() @ b.abs()) * scaling))
                want = total.to(torch.bfloat16)
                where = f"layer {i} {joined}"
                if not (torch.is_tensor(got) and got.dtype == torch.bfloat16
                        and got.shape == want.shape):
                    raise AssertionError(f"the merged {where} is not a bf16 matrix of "
                                         f"{tuple(want.shape)}")
                o = _bf16_order(got)
                outside = int(((o < _bf16_order((total - bound).to(torch.bfloat16)))
                               | (o > _bf16_order((total + bound).to(torch.bfloat16)))).sum())
                share = float((got != want).double().mean())
                footprint = float((want != base).double().mean())
                worst, smallest = max(worst, share), min(smallest, footprint)
                if outside:
                    raise AssertionError(f"the merged {where} is not the base plus its "
                                         f"adapters: {outside} weights outside f32's bound")
                if footprint < MERGE_FOOTPRINT:
                    raise AssertionError(f"the adapters move {footprint:.2e} of {where}'s "
                                         f"weights, under {MERGE_FOOTPRINT}: the check "
                                         "cannot tell a merge from the base")
    return worst, smallest


def _merge_check_13b(smi, name, params, cfg, adapters, lora_cfg, bits):
    """The trained adapters merged into the base for good
    (``merge_lora_into_base`` over the per-layer tree, so the merge's f32
    transients are one layer's; an int4 base dequantized to bf16), each
    merged target held by :func:`check_merged_weights` against this
    script's own f64 sum. Then one 768-token image prefill through the
    merged tree and through the base with the same adapters attached lazily
    (``apply_lora``): finite logits and exact launches (the flash forward
    once a layer a prefill; the int4 kernel 7 a layer and the head through
    the lazy tree, the head alone through the merged one), the largest
    difference logged against MERGE_TOL with the positions whose greedy
    pick parts. Returns the launches."""
    import torch
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.generate import prepare_multimodal_request
    from llava_plus_torch.mm_utils import load_image_from_base64, process_images
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.convert import per_layer
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.train import lora as lora_lib

    L = cfg.text.num_hidden_layers
    rng = np.random.default_rng(27)
    tok = DebugTokenizer(vocab_size=cfg.text.vocab_size)
    prompt = "<image>\n" + " ".join(f"merge{i}" for i in range(MERGE_WORDS))
    image = load_image_from_base64(_png_b64(rng, cfg.vision.image_size))
    proc = ClipImageProcessor(shortest_edge=cfg.vision.image_size,
                              crop_size=cfg.vision.image_size)
    batch, plan = prepare_multimodal_request(
        cfg, tok, [prompt], [process_images([image], proc, cfg)],
        max_seq_len=TRAIN_13B_LEN, device="cuda", prefill_bucket=256)
    n = int(plan.lengths[0])
    if n != 768 or batch.tokens.shape[1] != 768:
        raise AssertionError(f"the merge check's prompt is {n} fused tokens, not 768")
    pl = per_layer(params)
    flash_attention.launches = qm.matmul_int4.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        merged = lora_lib.merge_lora_into_base(pl, adapters, lora_cfg)
        torch.cuda.synchronize()
        t_merge = time.perf_counter()
        apart, footprint = check_merged_weights(
            merged["language_model"]["layers"], pl["language_model"]["layers"], adapters,
            lora_cfg.scaling)
        torch.cuda.synchronize()
        t_check = time.perf_counter()
        got = llava_model.forward(merged, cfg, batch)[0][0].float()
        del merged
        lazy = dict(pl, language_model=lora_lib.apply_lora(pl["language_model"], adapters,
                                                           lora_cfg))
        want = llava_model.forward(lazy, cfg, batch)[0][0].float()
        del lazy
    torch.cuda.synchronize()
    launches = (flash_attention.launches, qm.matmul_int4.launches)
    merge_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del pl
    top = float(want.abs().max())
    err = float((got - want).abs().max()) / top
    finite = bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    parted = got.argmax(-1) != want.argmax(-1)
    # two prefills: merged, then lazy
    want_launches = (2 * L, 7 * L + 2 if bits else 0)
    log("train-13b", f"{name} merged into its base ({'int4 dequantized to ' if bits else ''}"
                     f"bf16) in {t_merge - t0:.1f} s; every merged target against the f64 "
                     f"sum ({t_check - t_merge:.1f} s): every weight within f32's bound, at "
                     f"most {apart:.2e} of a matrix apart from the f64 sum's bf16 rounding; "
                     f"the adapters move at least "
                     f"{footprint:.3f} of each matrix (bound {MERGE_FOOTPRINT}); 768-token "
                     f"image prefill, merged vs lazy (not gated): max |diff| {err:.3e} of the "
                     f"top logit {top:.3f} ({MERGE_TOL}: {err <= MERGE_TOL}), greedy picks "
                     f"equal at {n - int(parted.sum())} of {n} positions; finite {finite}; "
                     f"launches flash / int4 {launches} (want {want_launches}); peak device "
                     f"memory {merge_peak:.2f} GiB; card {smi}")
    if not finite or launches != want_launches:
        raise AssertionError(f"LLaVA-1.5-13B {name}: the merged tree's prefill failed")
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash": launches[0], "int4": launches[1]}


# ---------------------------------------------------------------------------
# 27. LLaVA-Plus-7B from a base checkpoint: stage 1, the tool-use tuning,
#     its export and a served tool turn
# ---------------------------------------------------------------------------

PLUS7B_MODEL = "llava-plus-v1.3-7b-planted"
PLUS7B_SESSIONS = 4
# the recipe's 16 rows a device on 8 cards, cut for one card to 4 rows with
# gradient accumulation 2 (as phase 10 cuts finetune.sh)
PLUS7B_BATCH, PLUS7B_ACCUM = 4, 2
PLUS7B_WORDS = 3000      # the corpora draw their words from w0 .. w2999
# phase 27's depth: LLaMA-7B's width at PLUS7B_LAYERS of its 32 layers (the
# run's 45 GiB of writes: B, the export and phase 28's 26 GB base; phase 28
# trains and phase 26 tunes a base at a whole model's depth, at 13B)
PLUS7B_LAYERS = 2
PLUS7B_TOOLS = ("grounding_dino", "sam", "easyocr", "blip2")
STAGE1_SCRIPT = "pretrain.sh"
PLUS_SCRIPT = "llava_plus/training_llava_plus_v1_3_7b.sh"


def _script_argv(name, **flags):
    """(argv, env) of the launcher ``name``: ``common.script_argv``."""
    from llava_plus_torch.tools.common import script_argv

    return script_argv(name, **flags)


def _plus_corpus(root, rng, n_chat, n_tool, size):
    """The LLaVA-Plus recipe's two datasets in two image folders, under
    ``root``: ``chat.json``, shaped as ``llava_150k.json`` (an image and 1-3
    question / answer pairs; images in ``coco/``), and ``plus.json``, shaped
    as ``llava_plus_v1_117k.json`` (a request; a reply that calls a tool,
    its ``thoughts`` / ``actions`` / ``value`` fields apart, as the dataset
    merges them into the grammar of ``serialize_tool_turn``; the tool's
    output in the next human turn, as the orchestrator folds it; the final
    answer; every third record without an image; images in ``hiertext/``).
    Returns (the ``--data-path``, the ``--image-folder``)."""
    from PIL import Image

    def words(n):
        return " ".join(f"w{int(j)}" for j in rng.integers(0, PLUS7B_WORDS, n))

    def image(folder, name):
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(root, folder, name), compress_level=1)
        return name

    chat = []
    for i in range(n_chat):
        turns = []
        for k in range(int(rng.integers(1, 4))):
            q = words(int(rng.integers(6, 20))) + "?"
            turns += [{"from": "human", "value": ("<image>\n" if k == 0 else "") + q},
                      {"from": "gpt", "value": words(int(rng.integers(20, 90))) + "."}]
        chat.append({"id": f"chat{i}", "image": image("coco", f"c{i}.png"),
                     "conversations": turns})
    plus = []
    for i in range(n_tool):
        tool = PLUS7B_TOOLS[i % len(PLUS7B_TOOLS)]
        request = words(int(rng.integers(4, 12))) + "?"
        box = [round(float(x), 1) for x in rng.integers(0, 10, 4) / 10]
        output = {"boxes": [box], "logits": [round(float(rng.integers(1, 10)) / 10, 1)],
                  "phrases": [f"w{int(rng.integers(0, PLUS7B_WORDS))}"]}
        rec = {"id": f"plus{i}", "conversations": [
            {"from": "human", "value": ("<image>\n" if i % 3 else "") + request},
            {"from": "gpt", "thoughts": words(int(rng.integers(5, 15))) + ".",
             "actions": [{"API_name": tool, "API_params": {"caption": words(2)}}],
             "value": words(int(rng.integers(5, 15))) + "."},
            {"from": "human", "value": f"{tool} model outputs: {output}\n\nPlease summarize "
                                       f"the model outputs and answer my first question: "
                                       f"{request}"},
            {"from": "gpt", "thoughts": words(int(rng.integers(5, 15))) + ".", "actions": [],
             "value": words(int(rng.integers(20, 90))) + "."}]}
        if i % 3:
            rec["image"] = image("hiertext", f"h{i}.png")
        plus.append(rec)
    paths = []
    for name, records in (("chat.json", chat), ("plus.json", plus)):
        paths.append(os.path.join(root, name))
        with open(paths[-1], "w") as f:
            json.dump(records, f)
    return ",".join(paths), ",".join(os.path.join(root, d) for d in ("coco", "hiertext"))


def _dataset_texts(data_path, image_folder, version, size):
    """Every text that the trainer's dataset gives its tokenizer for these
    records under the ``version`` template: the port's own preprocessing,
    run here with a tokenizer that records what it is given."""
    from llava_plus_torch import conversation
    from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
    from llava_plus_torch.data.dataset import DataConfig, make_supervised_dataset

    texts = []

    class Recording(DebugTokenizer):
        def __call__(self, text):
            texts.append(text)
            return super().__call__(text)

    conv = conversation.conv_templates[version]
    ds = make_supervised_dataset(
        Recording(), DataConfig(data_path=data_path, image_folder=image_folder,
                                conv_version=conv.version),
        ClipImageProcessor(shortest_edge=size, crop_size=size), conv)
    for i in range(len(ds)):
        ds[i]
    return texts


def _write_base(path, lm, text_cfg, tokenizer=None):
    """A plain HF LLaMA directory (``model.safetensors``, ``config.json``,
    the tokenizer if one is given; without one the loaders take their
    ``DebugTokenizer``), as a base model is published: (bytes, seconds)."""
    from llava_plus_torch.tools.common import save_safetensors
    from llava_plus_torch.train import checkpoint

    t0 = time.perf_counter()
    os.makedirs(path, exist_ok=True)
    save_safetensors(checkpoint.llama_state_dict_from_params(lm, text_cfg),
                     os.path.join(path, "model.safetensors"), {"format": "pt"})
    config = dict(checkpoint._llama_hf_config(text_cfg), architectures=["LlamaForCausalLM"],
                  model_type="llama", torch_dtype="bfloat16")
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    if tokenizer is not None:
        tokenizer.save_pretrained(path)
    return os.path.getsize(os.path.join(path, "model.safetensors")), time.perf_counter() - t0


def _write_tower(path, tower, vision_cfg):
    """An HF ``CLIPVisionModel`` directory: ``common.write_tower``."""
    from llava_plus_torch.tools.common import write_tower

    return write_tower(path, tower, vision_cfg)


def _layer_leaves(tree):
    """(path, leaf) of a tree, each layer of a stacked ``layers`` leaf
    ([L, ...], not a list's item) apart, as the trainer holds and updates
    them."""
    import re

    for name, x in _named_leaves(tree):
        if re.search(r"/layers/(?!\d)", name):
            for i in range(x.shape[0]):
                yield f"{name}[{i}]", x[i]
        else:
            yield name, x


def _named_prints(tree):
    return {name: _fingerprint(x) for name, x in _layer_leaves(tree)}


class _TrainRecord:
    """The ``build_model`` and ``on_step`` hooks of one ``main()`` run: the
    trainer's own builder, the fingerprints of what it built, and each
    step's metrics, host seconds, batch shape, non-pad tokens and wall
    clock."""

    def __init__(self, profile=False):
        self.before, self.steps, self.matrices, self.bos = {}, [], set(), None
        # the last step's device time by class (the device traced alone)
        self.prof = _LastStepProfile(TRAIN_STEPS) if profile else None
        # on the card, each step's peak device memory since the last report
        # (the first: since the run began, its load included), in GiB
        self.peaks = []

    def build_model(self, model_args, dtype, device, seed):
        from llava_plus_torch.train import train as train_lib

        params, cfg, tok = train_lib.build_model(model_args, dtype, device, seed)
        self.before = {k: _named_prints(v) for k, v in params.items()}
        self.matrices = {name for name, x in _layer_leaves(params["language_model"])
                         if x.dim() == 2}
        # the trainer's label masking counts on a BOS, as LLaMA's tokenizer gives
        self.bos = tok("w1").input_ids[0] == tok.bos_token_id
        return params, cfg, tok

    def on_step(self, step, metrics, seconds, arrays):
        tokens = int((arrays["segment_ids"] > 0).sum())
        self.steps.append((metrics, seconds, tokens, arrays["tokens"].shape, time.time()))
        import torch

        if torch.cuda.is_available():
            self.peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            torch.cuda.reset_peak_memory_stats()
        if self.prof is not None:
            self.prof.after(step, seconds)

    def peak_gib(self):
        """The run's peak device memory in GiB (0 off the card)."""
        import torch

        if not torch.cuda.is_available():
            return 0.0
        return max(self.peaks + [torch.cuda.max_memory_allocated() / 2 ** 30])

    def lines(self, tag):
        for i, (m, dt, tokens, shape, _) in enumerate(self.steps, 1):
            peak = "" if not self.peaks else f", peak device memory {self.peaks[i - 1]:.2f} GiB"
            log(tag, f"step {i}: batch {' x '.join(str(d) for d in shape)}, {tokens} non-pad "
                     f"tokens, loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, host "
                     f"{dt * 1e3:.1f} ms, {tokens / dt:.0f} non-pad tokens/s{peak}")


def _trained(rec):
    """Every step of a ``main()`` run taken, with a finite loss over a
    nonzero count of targets, from a tokenizer that gives a BOS."""
    return (rec.bos and len(rec.steps) == TRAIN_STEPS
            and all(np.isfinite(m["loss"]) and m["tokens"] > 0 for m, *_ in rec.steps))


def _worker_child():
    """In a child process (``python3 -c "import chip_smoke;
    chip_smoke._worker_child()" FLAGS...``): the model worker's own
    ``main(FLAGS)``, as ``python -m llava_plus_torch.serve.model_worker``
    runs it, with its backend's build timed; when the worker stops
    (SIGTERM), one line ``WORKER_CHILD {json}``: the build's seconds, the
    served config's image tokens an image and projector type, the engine's
    prefill dispatches and decode steps and the kernels' launches after
    the build (its warmup not counted), peak device memory and any module
    of JAX loaded. The process first imports the tokenizer's library and
    makes the card's context, then waits until the path in
    ``WORKER_CHILD_AFTER`` exists (the caller writes it when the checkpoint
    is whole) before ``main``."""
    import torch
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.serve import model_worker

    kernels = {"flash": flash_attention, "decode": decode_attention, "quant": qm.matmul_int8}
    marks = {}
    load_backend = model_worker.load_backend

    def timed(*args, **kw):
        t0 = time.perf_counter()
        backend, names = load_backend(*args, **kw)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        engine = backend.engine
        marks.update(build_s=time.perf_counter() - t0, backend=backend,
                     engine0=(engine.prefill_dispatches, engine.decode_steps))
        return backend, names

    model_worker.load_backend = timed
    # started ahead of its checkpoint: the tokenizer's library imported and
    # the card's context made, then wait for the file that says the
    # checkpoint is whole
    import transformers  # noqa: F401

    after, argv = os.environ["WORKER_CHILD_AFTER"], sys.argv[1:]
    if "--device" in argv and argv[argv.index("--device") + 1].startswith("cuda"):
        torch.zeros(1, device=argv[argv.index("--device") + 1])
    deadline = time.time() + 1800
    while not os.path.exists(after):
        if time.time() > deadline:
            raise SystemExit(f"{after} did not appear within 1800 s")
        time.sleep(0.2)
    model_worker.main(argv)
    cuda = torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    backend = marks["backend"]
    engine = backend.engine
    print("WORKER_CHILD " + json.dumps({
        "build_s": marks["build_s"], "image_tokens": backend.cfg.num_image_tokens,
        "projector": backend.cfg.mm_projector_type,
        "layers": backend.cfg.text.num_hidden_layers,
        "prefill_dispatches": engine.prefill_dispatches - marks["engine0"][0],
        "decode_steps": engine.decode_steps - marks["engine0"][1],
        **{n: k.launches for n, k in kernels.items()},
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0,
        "foreign": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib", "llava_plus_tpu"))}),
          flush=True)


def phase_plus_7b(smi, cfg=None, device="cuda"):
    """Phase 27: LLaVA-Plus-7B (vicuna-7b-v1.3, CLIP ViT-L/14 at 224 px,
    a linear projector) trained from a base language model and served, at
    LLaMA-7B's width and PLUS7B_LAYERS of its 32 layers by default.

    a. B, a plain HF LLaMA directory (random bf16 weights from seed 0,
       the planted decoding chain of phase 18 applied, a word-level
       tokenizer that knows every word of both corpora and of the tool
       turn, with a BOS as LLaMA's), and V, an HF CLIP ViT-L/14-224
       directory (seed 1), written by the port's own exporters; free disk
       checked first.
    b. ``scripts/pretrain.sh`` through ``train.main`` from B with
       ``--vision-tower V`` (the trainer builds the tower and the
       projector): 2 steps of 32 image-caption records; the language model
       and the tower keep their bytes (and are B's and V's), the projector
       moves, ``mm_projector.bin``'s keys and shapes, the launches.
    c. ``scripts/llava_plus/training_llava_plus_v1_3_7b.sh`` through
       ``train.main`` from B and V (a fresh linear projector; the language
       model and the projector trained; two datasets in two folders:
       :func:`_plus_corpus`), its batch cut to PLUS7B_BATCH rows with
       gradient accumulation PLUS7B_ACCUM, 2 steps, then the trainer's own
       HF export, its only save (``--save-only-model``: the card's machine
       ends a call that writes 45 GiB, and at the whole depth the training
       state is 41 GB):
       finite losses, every language-model and projector leaf with a
       nonzero first moment (the trainer's optimizer state, kept through a
       wrapper of its ``build_optimizer``) and every matrix moved, the
       tower's bytes kept, the launches, the last step's device time by
       class; then B and V are removed.
    d. the export served by the model worker (``--load-8bit``) in a child
       process registered with the port's controller, with phase 18's fake
       tool worker and web server (all started before b, the worker's
       process waiting for the export): PLUS7B_SESSIONS sessions at once each
       send phase 18's image turn and a follow-up through ``/api/chat``;
       every turn's events, the planted call dispatched and both rounds'
       texts; the worker's 256 image tokens and linear projector; round 1's
       text the greedy tokens of the port's ``Generator`` on the same export
       with int8 weights (built by the worker's own factory, in this
       process); the planted chain's margins on the export, bf16 and int8;
       the launches on both sides; every process's exit on SIGTERM.

    Prints peak memory, host ms a step and non-pad tokens/s of b and c, the
    write and load seconds of B, V, the state and the export, the worker's
    build seconds, round-1 and round-2 TTFT and turn seconds, the chain's
    margins. Returns the launches by kernel."""
    import dataclasses
    import signal

    import torch
    from llava_plus_torch.mm_utils import process_images
    from llava_plus_torch.models import clip_vit, llama
    from llava_plus_torch.models.builder import load_pretrained_model
    from llava_plus_torch.models.configs import CLIP_VIT_L_224
    from llava_plus_torch.models.convert import tree_map
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.ops.decode_attention import decode_attention
    from llava_plus_torch.ops.flash_attention import flash_attention
    from llava_plus_torch.serve import model_worker
    from llava_plus_torch.serve.orchestrator import fold_tool_response, ToolSession
    from llava_plus_torch.serve.tool_workers.fake_tool_worker import _canned
    from llava_plus_torch.tools import planted
    from llava_plus_torch.train import train as train_lib
    from llava_plus_torch.utils.demo_assets import demo_image, demo_image_b64

    # vicuna-7b-v1.3 is LLaMA-7B (LLaVA-1.5-7B's language model); the tower
    # is CLIP ViT-L/14 at 224 px
    cfg = cfg or dataclasses.replace(_llava_7b(PLUS7B_LAYERS), vision=CLIP_VIT_L_224,
                                     mm_projector_type="linear")
    text_cfg, L, size = cfg.text, cfg.text.num_hidden_layers, cfg.vision.image_size
    cuda = torch.device(device).type == "cuda"
    root = os.path.join(SMOKE_DIR, "plus7b")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    base, tower_dir = os.path.join(root, "vicuna-7b-v1.3"), os.path.join(root, "clip-vit-l-14")
    t_phase = time.perf_counter()

    # -- a. the inputs ------------------------------------------------------
    n_lm = sum(x.numel() for x in _leaves(llama.init_params(text_cfg, None, "meta")))
    n_tower = sum(x.numel() for x in _leaves(clip_vit.init_params(cfg.vision, None, "meta")))
    n_proj = cfg.mm_hidden_size * cfg.hidden_size + cfg.hidden_size
    lm_b, tower_b, proj_b = 2 * n_lm, 2 * n_tower, 2 * n_proj
    # on disk at once: B, V and the export; the export is the run's only
    # save (--save-only-model: the training state, parameters
    # and AdamW's two moments, would be three times the export, 41 GB at the
    # whole depth, past what the card's machine lets a call write)
    export_b = lm_b + tower_b + proj_b
    need = lm_b + tower_b + export_b + 2 ** 30
    free = shutil.disk_usage(root).free
    log("plus7b", f"disk: {free / 1e9:.1f} GB free under {root}, {need / 1e9:.1f} GB needed "
                  f"(B {lm_b / 1e9:.2f}, V {tower_b / 1e9:.2f}, the export "
                  f"{export_b / 1e9:.2f} GB; {_written_gb():.1f} GB passed to write() by "
                  f"this process so far)")
    if free < need:
        raise AssertionError(f"{free / 1e9:.1f} GB free on disk, phase 27 needs "
                             f"{need / 1e9:.1f}")
    rng = np.random.default_rng(27)
    stage1_data = _write_corpus(os.path.join(root, "captions"), 32 * TRAIN_STEPS, rng, 256,
                                lambda i: [{"from": "human", "value": "<image>\n"},
                                           {"from": "gpt", "value": " ".join(
                                               f"w{int(j)}" for j in rng.integers(
                                                   0, PLUS7B_WORDS, int(rng.integers(8, 40))))}])
    n_records = PLUS7B_BATCH * PLUS7B_ACCUM * TRAIN_STEPS
    data_path, folders = _plus_corpus(os.path.join(root, "plus"), rng, n_records // 2,
                                      n_records - n_records // 2, 256)
    reply = planted.canned_reply()
    image = demo_image("cat")
    tool_response = _canned("grounding_dino", image)
    prompts = _plus_prompts(reply, image, tool_response, sessions=PLUS7B_SESSIONS,
                            model=PLUS7B_MODEL)
    texts = (_dataset_texts(stage1_data, os.path.dirname(stage1_data), "plain", size)
             + _dataset_texts(data_path, folders, "v1", size) + prompts)
    tok = planted.tool_tokenizer(text_cfg.vocab_size, reply, texts, bos=True)
    unknown = {w for t in texts for w in planted.unknown_words(tok, t)}
    if unknown:
        raise AssertionError(f"words the tokenizer does not know: {sorted(unknown)[:20]}")
    ids = planted.chain_ids(tok, reply)
    lm = llama.init_params(text_cfg, torch.Generator(device=device).manual_seed(0), device)
    planted.plant_chain({"language_model": lm}, ids)
    b_prints = _named_prints(lm)
    b_bytes, b_write = _write_base(base, lm, text_cfg, tok)
    del lm
    tower = clip_vit.init_params(cfg.vision, torch.Generator(device=device).manual_seed(1),
                                 device)
    v_prints = _named_prints(tower)
    v_bytes, v_write = _write_tower(tower_dir, tower, cfg.vision)
    del tower
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log("plus7b", f"B: a plain LLaMA of 7B's width ({L} layers of {text_cfg.hidden_size}, FFN "
                  f"{text_cfg.intermediate_size}, vocab {text_cfg.vocab_size}), random bf16 "
                  f"weights with the planted chain of {len(ids) - 1} steps, "
                  f"{b_bytes / 1e9:.2f} GB written in {b_write:.1f} s, with a tokenizer of "
                  f"{len(tok)} words that knows all {len(texts)} texts of the corpora and the "
                  f"tool turn; V: CLIP ViT-L/14-{size}, {v_bytes / 1e9:.2f} GB in "
                  f"{v_write:.1f} s")

    # -- the serving side, started before the training: the controller, the
    # fake tool worker, the web server and the model worker's process, which
    # imports its modules and takes the card while the training runs, then
    # waits for the export (so that its start is off the phase's path)
    out2 = os.path.join(root, "tuned")
    export = os.path.join(out2, "hf_export")
    serve_root = os.path.join(root, "serve")
    ready = os.path.join(serve_root, "export-ready")
    procs, ctrl, web = _plus_processes(serve_root)
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    worker_log = os.path.join(serve_root, "worker.out")
    flags = ["--model-path", export, "--model-name", PLUS7B_MODEL, "--load-8bit",
             "--controller-address", ctrl, "--worker-address", url, "--host", "127.0.0.1",
             "--port", str(port), "--device", device]
    with open(worker_log, "w") as logf:
        worker = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke._worker_child()", *flags],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE, WORKER_CHILD_AFTER=ready),
            stdout=logf, stderr=subprocess.STDOUT)
    try:
        # -- b. stage 1 ---------------------------------------------------------
        out1 = os.path.join(root, "stage1")
        argv, _ = _script_argv(STAGE1_SCRIPT, model_name_or_path=base, data_path=stage1_data,
                               image_folder=os.path.dirname(stage1_data), vision_tower=tower_dir,
                               output_dir=out1, max_steps=TRAIN_STEPS, device=device)
        rec = _TrainRecord()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        params, got_cfg = train_lib.main(argv, build_model=rec.build_model, on_step=rec.on_step)
        stage1_s = time.perf_counter() - t0
        launched = _counts()
        peak1 = rec.peak_gib()
        after = {k: _named_prints(v) for k, v in params.items()}
        sd = torch.load(os.path.join(out1, "mm_projector.bin"), weights_only=True)
        shapes = {k: tuple(v.shape) for k, v in sd.items()}
        H, M = cfg.hidden_size, cfg.mm_hidden_size
        want_shapes = {"model.mm_projector.0.weight": (H, M), "model.mm_projector.0.bias": (H,),
                       "model.mm_projector.2.weight": (H, H), "model.mm_projector.2.bias": (H,)}
        moved = sum(after["mm_projector"][k] != v for k, v in rec.before["mm_projector"].items())
        want = (TRAIN_STEPS * 2 * L, TRAIN_STEPS * L, TRAIN_STEPS * L)
        rec.lines("plus7b stage1")
        log("plus7b", f"stage 1 ({STAGE1_SCRIPT}'s flags, --vision-tower V) through main() in "
                      f"{stage1_s:.1f} s: the trainer built {got_cfg.num_image_tokens} image tokens "
                      f"at {got_cfg.vision.image_size} px, select layer "
                      f"{got_cfg.vision.select_layer}, a {got_cfg.mm_projector_type} projector "
                      f"{M} -> {H}; its language model B's bytes "
                      f"{rec.before['language_model'] == b_prints}, its tower V's "
                      f"{rec.before['vision_tower'] == v_prints}; after "
                      f"{len(rec.steps)} steps both unchanged "
                      f"{after['language_model'] == b_prints and after['vision_tower'] == v_prints}, "
                      f"projector leaves moved {moved} of {len(after['mm_projector'])}; "
                      f"mm_projector.bin {shapes}; launches flash fwd/dkv/dq {launched} (want "
                      f"{want}); peak device memory {peak1:.2f} GiB; card {smi}")
        if (not _trained(rec) or got_cfg.vision != cfg.vision
                or got_cfg.mm_projector_type != "mlp2x_gelu"
                or rec.before["language_model"] != b_prints or rec.before["vision_tower"] != v_prints
                or after["language_model"] != b_prints or after["vision_tower"] != v_prints
                or moved != len(after["mm_projector"]) or shapes != want_shapes
                or (cuda and launched != want)):
            raise AssertionError("phase 27: stage 1 from the base checkpoint failed its checks")
        del params, after, sd
        totals = dict(zip(("flash", "dkv", "dq"), launched))

        # -- c. the LLaVA-Plus tuning ----------------------------------------------
        argv, env = _script_argv(PLUS_SCRIPT, model_name_or_path=base, data_path=data_path,
                                 image_folder=folders, vision_tower=tower_dir, output_dir=out2,
                                 per_device_train_batch_size=PLUS7B_BATCH,
                                 gradient_accumulation_steps=PLUS7B_ACCUM, max_steps=TRAIN_STEPS,
                                 save_only_model="true", device=device)
        if env:
            raise AssertionError(f"{PLUS_SCRIPT} exports {env}, which this phase does not set")
        rec = _TrainRecord(profile=cuda)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        build_optimizer, states = train_lib.build_optimizer, []

        def keeping_state(*args, **kwargs):
            """The trainer's optimizer, its state kept here (updated in place)."""
            opt = build_optimizer(*args, **kwargs)
            init = opt.init
            opt.init = lambda params: states.append(init(params)) or states[-1]
            return opt

        train_lib.build_optimizer = keeping_state
        try:
            params, got_cfg = train_lib.main(argv, build_model=rec.build_model, on_step=rec.on_step)
        finally:
            train_lib.build_optimizer = build_optimizer
        stage2_s = time.perf_counter() - t0
        launched = _counts()
        peak2 = rec.peak_gib()
        after = {k: _named_prints(v) for k, v in params.items()}
        mu = [m for key in ("language_model", "mm_projector") for m in states[0]["mu"][key]]
        mu_zero, n_mu = sum(int(not bool(m.any())) for m in mu), len(mu)
        del params, states, mu
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        # the export's end on the wall clock: its config, written after its
        # safetensors
        export_s = os.path.getmtime(os.path.join(export, "config.json")) - rec.steps[-1][4]
        export_bytes = os.path.getsize(os.path.join(export, "model.safetensors"))
        saved = sorted(os.listdir(out2))
        shutil.rmtree(base)
        shutil.rmtree(tower_dir)
        unmoved = [k for k, v in rec.before["language_model"].items()
                   if after["language_model"][k] == v and k in rec.matrices]
        moved_proj = sum(after["mm_projector"][k] != v
                         for k, v in rec.before["mm_projector"].items())
        want = (TRAIN_STEPS * PLUS7B_ACCUM * 2 * L, TRAIN_STEPS * PLUS7B_ACCUM * L,
                TRAIN_STEPS * PLUS7B_ACCUM * L)
        rec.lines("plus7b tuning")
        if rec.prof is not None:
            log("plus7b tuning", rec.prof.line())
        log("plus7b", f"LLaVA-Plus tuning ({PLUS_SCRIPT}'s flags; --per-device-train-batch-size "
                      f"{PLUS7B_BATCH} --gradient-accumulation-steps {PLUS7B_ACCUM} for the recipe's "
                      f"16 a device on 8 cards) through main() in {stage2_s:.1f} s: the trainer "
                      f"built a {got_cfg.mm_projector_type} projector over V "
                      f"({got_cfg.num_image_tokens} image tokens), its tower V's bytes "
                      f"{rec.before['vision_tower'] == v_prints}, kept "
                      f"{after['vision_tower'] == v_prints}; "
                      f"leaves with a zero first moment {mu_zero} of {n_mu}; language-model "
                      f"matrices unmoved {len(unmoved)}; projector leaves moved {moved_proj} of "
                      f"{len(after['mm_projector'])}; launches flash fwd/dkv/dq {launched} (want "
                      f"{want}); peak device memory {peak2:.2f} GiB; the export "
                      f"({export_bytes / 1e9:.2f} GB) written in {export_s:.1f} s, {saved} in the "
                      f"output directory; card {smi}")
        if (not _trained(rec) or got_cfg.vision != cfg.vision or got_cfg.mm_projector_type != "linear"
                or rec.before["vision_tower"] != v_prints or after["vision_tower"] != v_prints
                or mu_zero or unmoved or moved_proj != len(after["mm_projector"])
                or saved != ["hf_export"]
                or (cuda and launched != want)):
            raise AssertionError("phase 27: the LLaVA-Plus tuning failed its checks")
        totals = {k: totals[k] + n for k, n in zip(("flash", "dkv", "dq"), launched)}

    except BaseException:
        worker.kill()
        worker.wait(30)
        _stop_processes(procs)
        raise
    with open(ready, "w"):
        t_ready = time.perf_counter()

    # -- d. the export served: a tool turn ------------------------------------
    with open(os.path.join(export, "config.json")) as f:
        exported = json.load(f)
    if (exported["mm_projector_type"] != "linear"
            or exported["mm_vision_config"]["image_size"] != size):
        raise AssertionError(f"the export's config names {exported['mm_projector_type']} at "
                             f"{exported['mm_vision_config']['image_size']} px")
    code, child = None, None
    try:
        # meanwhile, here: the export loaded, the chain's margins, the
        # Generator on the same export with the worker's int8 weights
        t0 = time.perf_counter()
        loaded = load_pretrained_model(export)
        load_s = time.perf_counter() - t0
        g_tok, g_params, g_cfg, processor, _ = loaded
        g_params = tree_map(lambda x: x.to(device), g_params)
        images = process_images([image], processor, g_cfg)
        with torch.inference_mode():
            gaps_bf16 = planted.chain_gaps(g_params, g_cfg, g_tok, prompts[0], images, ids,
                                           device)
        backend = model_worker.backend_for(
            model_worker.parse_args(["--model-path", export, "--load-8bit", "--no-engine",
                                     "--device", device]),
            (g_tok, g_params, g_cfg, processor, loaded[4]))
        del loaded, g_params
        gen = backend.generator
        with torch.inference_mode():
            gaps_int8 = planted.chain_gaps(gen.params, g_cfg, g_tok, prompts[0], images, ids,
                                           device)
        flash_attention.launches = decode_attention.launches = qm.matmul_int8.launches = 0
        g_text = ""
        for g_text in gen.stream(prompts[0], images, max_new_tokens=64, temperature=0.0):
            pass
        g_ids = list(gen._last_output_ids)
        n = len(g_ids)
        g_launches = {"flash": flash_attention.launches, "decode": decode_attention.launches,
                      "quant": qm.matmul_int8.launches}
        g_want = {"flash": L, "decode": L * n, "quant": (4 * L + 1) * (n + 1)}
        backend.stop()
        del backend, gen
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        log("plus7b", f"the export loaded here in {load_s:.1f} s: along the chain after the "
                      f"round-1 prompt, bf16: argmax the planted word at "
                      f"{sum(a for a, _ in gaps_bf16)} of {len(gaps_bf16)} steps, top-2 gaps "
                      f"min {min(g for _, g in gaps_bf16):.3f} median "
                      f"{float(np.median([g for _, g in gaps_bf16])):.3f}; int8: "
                      f"{sum(a for a, _ in gaps_int8)} of {len(gaps_int8)}, min "
                      f"{min(g for _, g in gaps_int8):.3f} median "
                      f"{float(np.median([g for _, g in gaps_int8])):.3f}; the Generator "
                      f"(int8, the worker's factory) gave {n} tokens, launches {g_launches} "
                      f"(want {g_want})")
        if g_ids != ids[1:-1] or (cuda and g_launches != g_want):
            raise AssertionError(f"phase 27: the Generator on the export gave {g_ids}, want the "
                                 f"planted chain {ids[1:-1]}; launches {g_launches}")
        registered_s = _wait_registered(ctrl, PLUS7B_MODEL, worker, t_ready)
        _wait_status(url, worker, 120)
        image_b64 = demo_image_b64("cat")
        results = [None] * PLUS7B_SESSIONS
        threads = [threading.Thread(target=_plus_session, args=(web, j, image_b64, results),
                                    kwargs={"model": PLUS7B_MODEL})
                   for j in range(PLUS7B_SESSIONS)]
        t_burst = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        burst_s = time.perf_counter() - t_burst
        if any(r is None for r in results):
            raise AssertionError("phase 27: a session did not complete")
        tool_want = fold_tool_response("grounding_dino", tool_response, ToolSession())[0]
        turns = [[_plus_turn(t_send, chunks, reply, tool_want, image.size, len(ids) - 2)
                  for t_send, chunks in r] for r in results]
        if any(t["r1"] != g_text.strip() for r in turns for t in r):
            raise AssertionError("phase 27: the worker's round 1 differs from the Generator's")
        p50 = lambda k, i: float(np.median([r[i][k] for r in turns]))
        log("plus7b", f"worker (--load-8bit, dense engine; its process started with the "
                      f"training) registered {registered_s:.1f} s after the export was ready; "
                      f"{PLUS7B_SESSIONS} sessions x 2 turns x 2 rounds in "
                      f"{burst_s:.2f} s, p50 over sessions: "
                      + "; ".join(f"turn {i + 1}: round-1 TTFT {p50('r1_ttft', i) * 1e3:.1f} ms, "
                                  f"tool dispatch {p50('dispatch', i) * 1e3:.1f} ms, round-2 "
                                  f"TTFT {p50('r2_ttft', i) * 1e3:.1f} ms, turn "
                                  f"{p50('turn', i):.3f} s" for i in range(2))
                      + "; every round-1 text the Generator's greedy tokens")
    finally:
        if worker is not None:
            if worker.poll() is None:
                worker.send_signal(signal.SIGTERM)
            try:
                code = worker.wait(60)
            except subprocess.TimeoutExpired:
                worker.kill()
                worker.wait(30)
        codes = _stop_processes(procs)
        with open(worker_log) as f:
            child = next((json.loads(line[len("WORKER_CHILD "):]) for line in f
                          if line.startswith("WORKER_CHILD ")), None)
    if code != 0 or child is None or any(c != 0 for c in codes.values()):
        print(_tail(worker_log), file=sys.stderr, flush=True)
        raise AssertionError(f"phase 27: exit codes on SIGTERM: worker {code}, {codes}")
    dp, ds = child["prefill_dispatches"], child["decode_steps"]
    w_launches = {k: child[k] for k in ("flash", "decode", "quant")}
    w_want = {"flash": L * dp, "decode": L * ds, "quant": (4 * L + 1) * (dp + ds)}
    log("plus7b", f"the worker process: built in {child['build_s']:.1f} s (load, int8, warmup), "
                  f"{child['image_tokens']} image tokens an image, a {child['projector']} "
                  f"projector, {child['layers']} layers; {dp} prefill dispatches, {ds} decode "
                  f"steps, launches {w_launches} (want {w_want}); peak device memory "
                  f"{child['peak_gib']:.2f} GiB; JAX modules {child['foreign']}; every process "
                  f"stopped by SIGTERM with exit code 0")
    if (child["image_tokens"] != cfg.num_image_tokens or child["projector"] != "linear"
            or child["layers"] != L or child["foreign"]
            or (cuda and (w_launches != w_want or min(w_launches.values()) <= 0))):
        raise AssertionError(f"phase 27: the worker served {child}")
    shutil.rmtree(root, ignore_errors=True)
    log("plus7b", f"phase 27 in {time.perf_counter() - t_phase:.1f} s; card {smi}")
    totals.update(decode=g_launches["decode"] + w_launches["decode"],
                  quant=g_launches["quant"] + w_launches["quant"])
    totals["flash"] += g_launches["flash"] + w_launches["flash"]
    return totals


# ---------------------------------------------------------------------------
# 28. LLaVA-1.5-13B stage 1 from a base language model
# ---------------------------------------------------------------------------

# LLaVA-1.5-13B's recipes, run from phase 28's base and tower: stage 1, then
# LoRA and QLoRA (phase 26) over its mm_projector.bin
PRETRAIN_13B_SCRIPT = "v1_5/pretrain.sh"
LORA_13B_SCRIPT = "v1_5/finetune_lora.sh"
# stage 1's rows at 336 px: 576 image tokens, BOS, a newline and a caption of
# 10-60 words (590-640 fused tokens), padded to a multiple of 64
STAGE1_13B_T = 640
# the peak device memory phase 28 is held under (GiB of the card's 79.6),
# written before its first run: the bf16 base 24.25 and tower 0.57, 40 remat
# checkpoints of 32 x 640 x 5,120 bf16 (7.8), the f32 logits' copies (~7.3)
# and one layer's recompute
STAGE1_13B_PEAK_GIB = 48.0


def _host_peak_gb():
    from llava_plus_torch.tools.common import host_peak_gb

    return host_peak_gb()


def _projector_matches(sd, proj):
    """A projector state dict (``mm_projector.bin``, or the projector in
    ``non_lora_trainables.bin``) holds the projector tree ``proj``'s values
    bit for bit: every ``model.mm_projector.<2i>`` weight the transpose of
    layer i's ``w`` and its bias ``b``, whatever the file's float type."""
    import torch

    layers = proj["layers"]
    if len(sd) != 2 * len(layers):
        return False
    for i, lay in enumerate(layers):
        for name, x in (("weight", lay["w"].T), ("bias", lay["b"])):
            got = sd.get(f"model.mm_projector.{2 * i}.{name}")
            if got is None or not torch.equal(got.float(), x.float().cpu()):
                return False
    return True


def phase_pretrain_13b(smi, cfg=None, device="cuda"):
    """Phase 28: ``scripts/v1_5/pretrain.sh`` at LLaVA-1.5-13B (40 layers of
    5,120, 40 heads, FFN 13,824, vocab 32,000; CLIP ViT-L/14 at 336 px; an
    mlp2x_gelu projector) from a base language model, at full width and
    depth.

    a. B13, a plain HF LLaMA directory of vicuna-13b-v1.5's shape (random
       bf16 weights from seed 0, 26 GB; no tokenizer files, so the loaders
       take their ``DebugTokenizer``, which gives a BOS), and V336, an HF
       CLIP ViT-L/14-336 directory (seed 1), written by the port's exporters
       after a check of free disk (B13, V336 and phase 26's two adapter
       exports lie on disk at once): each write's bytes and seconds, the
       host's peak resident memory.
    b. The script's flags through ``train.main`` with
       ``--model-name-or-path B13 --vision-tower V336``: the trainer loads
       B13, builds the tower and a fresh projector; 2 steps of 32 image
       captions at 336 px (rows of STAGE1_13B_T). Checks: every loss
       finite; the language model and the tower are B13's and V336's bytes
       and keep them, and none of their leaves holds or takes a gradient;
       every projector leaf moved; each step differentiates the projector
       alone and its ``grad_norm`` is those gradients' norm (the trainer's
       ``grads_and_metrics`` observed); ``mm_projector.bin`` has
       mlp2x_gelu's keys and shapes and holds the trained projector bit for
       bit, and reads back through the ``--pretrain-mm-mlp-adapter`` path
       in bf16 and f32; the launches exact (flash forward 2 x 40 a step,
       remat; dK/dV and dQ 40; no int8 or int4); the peak device memory under
       STAGE1_13B_PEAK_GIB. Logs each step's host ms, non-pad tokens/s and
       peak, and the last step's device time by class.

    Returns the launches by kernel and, under "start", what phase 26 starts
    from: B13's and V336's paths and fingerprints, ``mm_projector.bin``'s
    path and the directory that holds them (removed by phase 26)."""
    import torch
    from llava_plus_torch.models import clip_vit, hf_import, llama
    from llava_plus_torch.models.configs import LLAVA_15_13B
    from llava_plus_torch.ops import quant_matmul as qm
    from llava_plus_torch.train import optimizer as opt_lib
    from llava_plus_torch.train import step as step_lib
    from llava_plus_torch.train import train as train_lib

    cfg = cfg or LLAVA_15_13B
    text_cfg, L, size = cfg.text, cfg.text.num_hidden_layers, cfg.vision.image_size
    D, F = cfg.hidden_size, text_cfg.intermediate_size
    cuda = torch.device(device).type == "cuda"
    root = os.path.join(SMOKE_DIR, "pretrain_13b")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    base = os.path.join(root, "vicuna-13b-v1.5")
    tower_dir = os.path.join(root, "clip-vit-large-patch14-336")
    t_phase = time.perf_counter()

    # -- a. the inputs ------------------------------------------------------
    n_lm = sum(x.numel() for x in _leaves(llama.init_params(text_cfg, None, "meta")))
    n_tower = sum(x.numel() for x in _leaves(clip_vit.init_params(cfg.vision, None, "meta")))
    lm_b, tower_b = 2 * n_lm, 2 * n_tower
    # phase 26's two PEFT exports (r-128 adapters in f32) are written while
    # B13 and V336 are still on disk
    adapters_b = 2 * 4 * L * TRAIN_13B_RANK * (11 * D + 3 * F)
    need = lm_b + tower_b + adapters_b + 2 ** 30
    free = shutil.disk_usage(root).free
    log("pretrain13b", f"disk: {free / 1e9:.1f} GB free under {root}, {need / 1e9:.1f} GB needed "
                       f"(B13 {lm_b / 1e9:.2f}, V336 {tower_b / 1e9:.2f}, phase 26's adapter "
                       f"exports {adapters_b / 1e9:.2f} GB; {_written_gb():.1f} GB passed to "
                       f"write() by this process so far)")
    if free < need:
        raise AssertionError(f"{free / 1e9:.1f} GB free on disk, phases 28 and 26 need "
                             f"{need / 1e9:.1f}")
    rng = np.random.default_rng(28)
    data = _write_corpus(os.path.join(root, "captions"), 32 * TRAIN_STEPS, rng, size,
                         lambda i: [{"from": "human", "value": "<image>\n"},
                                    {"from": "gpt", "value": _words(rng, int(rng.integers(10, 61)))}])
    lm = llama.init_params(text_cfg, torch.Generator(device=device).manual_seed(0), device)
    b_prints = _named_prints(lm)
    b_bytes, b_write = _write_base(base, lm, text_cfg)
    del lm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    b_host = _host_peak_gb()
    tower = clip_vit.init_params(cfg.vision, torch.Generator(device=device).manual_seed(1),
                                 device)
    v_prints = _named_prints(tower)
    v_bytes, v_write = _write_tower(tower_dir, tower, cfg.vision)
    del tower
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log("pretrain13b", f"B13: a plain LLaMA ({L} layers of {D}, {text_cfg.num_attention_heads} "
                       f"heads, FFN {F}, vocab {text_cfg.vocab_size}), random bf16 weights, "
                       f"{b_bytes / 1e9:.2f} GB written in {b_write:.1f} s "
                       f"({b_bytes / 1e9 / b_write:.2f} GB/s; this process's peak resident "
                       f"memory {b_host:.1f} GB after it); V336: CLIP ViT-L/14-{size}, "
                       f"{v_bytes / 1e9:.2f} GB in {v_write:.1f} s; {_written_gb():.1f} GB passed "
                       f"to write() by this process so far")

    # -- b. stage 1 through main() ------------------------------------------------
    out = os.path.join(root, "stage1")
    argv, env = _script_argv(PRETRAIN_13B_SCRIPT, model_name_or_path=base, data_path=data,
                             image_folder=os.path.dirname(data), vision_tower=tower_dir,
                             output_dir=out, max_steps=TRAIN_STEPS, device=device)
    if env:
        raise AssertionError(f"{PRETRAIN_13B_SCRIPT} exports {env}, which this phase does not set")
    rec = _TrainRecord(profile=cuda)
    grads_and_metrics, seen = step_lib.grads_and_metrics, []

    def observed(loss_of, params, batch, accum_steps=1, keys=("language_model", "mm_projector")):
        """The trainer's own gradients, observed: the subtrees a step
        differentiates and their norm (the optimizer's ``global_norm``)."""
        grads, metrics = grads_and_metrics(loss_of, params, batch, accum_steps, keys)
        seen.append((tuple(keys), float(opt_lib.global_norm(
            [g for k in keys for g in opt_lib.tree_leaves(grads[k])]))))
        return grads, metrics

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    step_lib.grads_and_metrics = observed
    try:
        params, got_cfg = train_lib.main(argv, build_model=rec.build_model, on_step=rec.on_step)
    finally:
        step_lib.grads_and_metrics = grads_and_metrics
    if cuda:
        torch.cuda.synchronize()
    stage1_s = time.perf_counter() - t0
    load_host = _host_peak_gb()
    launched = _counts()
    quant = (qm.matmul_int8.launches + qm.matmul_int8.backward_calls
             + qm.matmul_int4.launches + qm.matmul_int4.backward_calls)
    peak = rec.peak_gib()
    after = {k: _named_prints(v) for k, v in params.items()}
    moved = sum(after["mm_projector"][k] != v for k, v in rec.before["mm_projector"].items())
    taking = sum(x.requires_grad or x.grad is not None
                 for key in ("language_model", "vision_tower") for x in _leaves(params[key]))
    sd = torch.load(os.path.join(out, "mm_projector.bin"), weights_only=True)
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    M = cfg.mm_hidden_size
    want_shapes = {"model.mm_projector.0.weight": (D, M), "model.mm_projector.0.bias": (D,),
                   "model.mm_projector.2.weight": (D, D), "model.mm_projector.2.bias": (D,)}
    exact = (_projector_matches(sd, params["mm_projector"])
             and {v.dtype for v in sd.values()} == {torch.float32})
    # the file read back as --pretrain-mm-mlp-adapter reads it (the key
    # prefix stripped), in bf16 and in f32
    reread = {}
    for dt in (torch.bfloat16, torch.float32):
        back = hf_import.projector_params_from_state_dict(
            {k.replace("model.mm_projector.", ""): v for k, v in sd.items()}, "mlp2x_gelu", dt)
        reread[str(dt)[6:]] = all(
            torch.equal(b.cpu(), t.to(dt).cpu())
            for b, t in zip(_leaves(back), _leaves(params["mm_projector"])))
    grads_ok = (len(seen) == TRAIN_STEPS
                and all(keys == ("mm_projector",) and norm == m["grad_norm"]
                        for (keys, norm), (m, *_) in zip(seen, rec.steps)))
    shapes_t = {tuple(shape) for _, _, _, shape, _ in rec.steps}
    want = (TRAIN_STEPS * 2 * L, TRAIN_STEPS * L, TRAIN_STEPS * L)
    rec.lines("pretrain13b stage1")
    if rec.prof is not None:
        log("pretrain13b stage1", rec.prof.line())
    log("pretrain13b", f"stage 1 ({PRETRAIN_13B_SCRIPT}'s flags, --model-name-or-path B13 "
                       f"--vision-tower V336) through main() in {stage1_s:.1f} s (B13's load "
                       f"included; this process's peak resident memory {load_host:.1f} GB after "
                       f"it): the trainer built {got_cfg.num_image_tokens} image tokens at "
                       f"{got_cfg.vision.image_size} px, select layer "
                       f"{got_cfg.vision.select_layer}, a {got_cfg.mm_projector_type} projector "
                       f"{M} -> {D} -> {D}; batches {sorted(shapes_t)}; its language model B13's "
                       f"bytes {rec.before['language_model'] == b_prints}, its tower V336's "
                       f"{rec.before['vision_tower'] == v_prints}; after {len(rec.steps)} steps "
                       f"both unchanged "
                       f"{after['language_model'] == b_prints and after['vision_tower'] == v_prints}"
                       f", their leaves holding or taking a gradient {taking}; projector leaves "
                       f"moved {moved} of {len(after['mm_projector'])}; each step differentiated "
                       f"{sorted({k for keys, _ in seen for k in keys})} and its grad_norm is "
                       f"their norm {grads_ok}; mm_projector.bin {shapes}, the trained "
                       f"projector bit for bit {exact}, read back as --pretrain-mm-mlp-adapter "
                       f"{reread}; launches flash fwd/dkv/dq {launched} (want {want}), int8 / "
                       f"int4 {quant}; peak device memory {peak:.2f} GiB (bound "
                       f"{STAGE1_13B_PEAK_GIB:.1f}); card {smi}")
    if (not _trained(rec) or got_cfg.vision != cfg.vision
            or got_cfg.mm_projector_type != "mlp2x_gelu" or got_cfg.text != text_cfg
            or rec.before["language_model"] != b_prints or rec.before["vision_tower"] != v_prints
            or after["language_model"] != b_prints or after["vision_tower"] != v_prints
            or taking or moved != len(after["mm_projector"]) or not grads_ok
            or shapes != want_shapes or not exact or not all(reread.values())
            or (cuda and (launched != want or quant or peak > STAGE1_13B_PEAK_GIB
                          or shapes_t != {(32, STAGE1_13B_T)}))):
        raise AssertionError("phase 28: LLaVA-1.5-13B stage 1 from the base failed its checks")
    del params, after, sd
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log("pretrain13b", f"phase 28 in {time.perf_counter() - t_phase:.1f} s; card {smi}")
    return {**dict(zip(("flash", "dkv", "dq"), launched)),
            "start": {"root": root, "base": base, "tower": tower_dir,
                      "projector": os.path.join(out, "mm_projector.bin"),
                      "base_prints": b_prints, "tower_prints": v_prints}}


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


def _device_times_child():
    """Phase 15 in a process of its own (``python3 -c "import chip_smoke;
    chip_smoke._device_times_child()" OUT``), so that its profiler sessions
    start on a fresh CUPTI: late in a whole run the profiler loses kernel
    events (once every flash forward event of six sessions in a row, after
    sdpa had read 4x short). Writes the rows it adds to ``stats`` to OUT as
    JSON."""
    import collections

    stats = collections.defaultdict(dict)
    phase_device_times(stats)
    with open(sys.argv[1], "w") as f:
        json.dump(stats, f)


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


# the kernels LLaVA-1.5-13B's engines run (phase 25), by their key there
S13_KERNELS = {"flash_fwd": "flash", "decode_attention[int8]": "decode",
               "quant_matmul[int8]": "int8", "quant_matmul[int4]": "int4",
               "paged_attention[decode1]": "decode1"}


# the kernels LLaVA-1.5-13B's training runs (phase 26), by their key there
T13_KERNELS = {"flash_fwd": "flash", "flash_bwd[dkv]": "dkv", "flash_bwd[dq]": "dq",
               "quant_matmul[int4]": "int4"}
# the kernels LLaVA-1.5-13B's stage 1 from a base runs (phase 28)
T13S_KERNELS = {"flash_fwd": "flash", "flash_bwd[dkv]": "dkv", "flash_bwd[dq]": "dq"}
# kernels line entry -> phase 27's count (LLaVA-Plus-7B from a base checkpoint)
P27_KERNELS = {"flash_fwd": "flash", "flash_bwd[dkv]": "dkv", "flash_bwd[dq]": "dq",
               "decode_attention[bf16]": "decode", "quant_matmul[int8]": "quant"}


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
    seconds = {}

    def timed(phase, fn, *args, **kwargs):
        """``fn``'s result; its seconds go to the phase-seconds line (and
        are logged as it ends, so a run cut short still shows them)."""
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        seconds[phase] = round(time.perf_counter() - t0, 1)
        log("time", f"phase {phase}: {seconds[phase]:.1f} s ({_written_gb():.1f} GB passed "
                    "to write() by this process so far)")
        return result

    smi = timed("1", phase_env)
    timed("2", phase_build)
    stats = timed("3", phase_kernels)
    narrow_general = timed("4", phase_narrow_model)
    narrow_mpt = timed("4 mpt", phase_narrow_mpt)
    dev = "cuda:0"
    params = _init_llava(dev)
    single = timed("5", phase_full_slice, smi, params, dev)
    # phase 16 exports a tree of 7B's width at CKPT_LAYERS layers; phases 19
    # and 22 answer from its checkpoint
    ckpt = timed("16", phase_checkpoint, smi, _init_llava(dev, _ckpt_cfg()), keep=True)
    # int4 starts from fresh weights
    int8 = timed("6", serve_engine, smi, params, "int8", n_image=8, n_text=8)
    w8a8 = timed("20", phase_w8a8_serving, smi, params)   # on phase 6's int8 tree
    tp1 = timed("21", phase_tp_serving, smi, params)      # on the same tree
    del params
    int4 = timed("6 int4", serve_engine, smi, _init_llava(dev), "int4", n_image=2, n_text=2)
    paged = timed("7", serve_paged_engine, smi)
    s13 = timed("25 13b", phase_serve_13b, smi)   # LLaVA-1.5-13B, fresh weights
    spec = timed("17", phase_speculative, smi)   # on fresh weights
    plus = timed("18", phase_plus_turn, smi)     # on fresh weights
    # phase 16's chat turn runs beside phase 19's three runner processes,
    # which saves its ~44 s alone on a slow host (the run's 900 s budget
    # needs it); its seconds are then logged as taken beside them
    cli = _start_cli(os.path.join(SMOKE_DIR, CKPT_NAME))
    try:
        evals = timed("19", phase_eval, smi)     # from phase 16's checkpoint
        timed("16 cli", _finish_cli, smi, cli, "phase 19's three runner processes")
    finally:
        if cli[0].poll() is None:
            cli[0].kill()
            cli[0].wait(30)
    predictor = timed("22", phase_predictor, smi)   # from phase 16's checkpoint
    shutil.rmtree(os.path.join(SMOKE_DIR, CKPT_NAME), ignore_errors=True)
    timed("23", phase_native, smi)
    timed("24", phase_sharded_save, smi)
    resume = timed("24 resume", phase_resume, smi)   # cut after a save and resumed
    mpt = timed("11", serve_mpt_7b, smi)   # before training (the LLaMA weights are gone)
    narrow_alibi_bwd = timed("8", phase_narrow_training)
    narrow_lora = timed("8 lora", phase_narrow_lora)
    stage1 = timed("9", phase_train_stage1, smi)
    stage2 = timed("10", phase_train_stage2, smi)
    mpt_stage1 = timed("12", phase_train_mpt_stage1, smi)
    qlora = timed("13", phase_train_qlora, smi)
    # LLaVA-1.5-13B from a base: stage 1, then LoRA and QLoRA over its projector
    pre13 = timed("28", phase_pretrain_13b, smi)
    train13 = timed("26", phase_train_13b, smi, pre13["start"])
    plus7b = timed("27", phase_plus_7b, smi)      # LLaVA-Plus-7B from a base checkpoint
    tools = timed("14", phase_int4_tools)

    def device_times():
        """Phase 15, last and in a fresh process."""
        gc.collect()
        torch.cuda.empty_cache()
        os.makedirs(SMOKE_DIR, exist_ok=True)
        out = os.path.join(SMOKE_DIR, "device_times.json")
        subprocess.run([sys.executable, "-c",
                        "import chip_smoke; chip_smoke._device_times_child()", out],
                       cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), check=True,
                       timeout=900)
        with open(out) as f:
            for name, row in json.load(f).items():
                stats.setdefault(name, {}).update(row)

    timed("15", device_times)
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)

    entries = []
    paged_src = "llava_plus_torch/csrc/paged_attention.cu"
    bwd_src = "llava_plus_torch/csrc/flash_bwd.cu"
    for name, source, replaces, count in (
        ("flash_fwd", "llava_plus_torch/csrc/flash_fwd.cu", FLASH_REPLACES,
         single["flash"] + ckpt["flash"] + int8["flash"] + tp1["flash"] + int4["flash"]
         + paged["flash"] + s13["flash"]
         + spec["flash"] + plus["flash"] + evals["flash"] + predictor["flash"]
         + stage1["flash"] + stage2["flash"] + qlora["flash"] + pre13["flash"]
         + train13["flash"] + plus7b["flash"] + resume["flash"]),
        ("flash_bwd[dkv]", bwd_src, DKV_REPLACES,
         stage1["dkv"] + stage2["dkv"] + qlora["dkv"] + pre13["dkv"] + train13["dkv"]
         + plus7b["dkv"] + resume["dkv"]),
        ("flash_bwd[dq]", bwd_src, DQ_REPLACES,
         stage1["dq"] + stage2["dq"] + qlora["dq"] + pre13["dq"] + train13["dq"]
         + plus7b["dq"] + resume["dq"]),
        ("decode_attention[bf16]", "llava_plus_torch/csrc/decode_attention.cu",
         DECODE_REPLACES, single["bf16"] + evals["decode"] + predictor["decode"]
         + plus7b["decode"]),
        ("decode_attention[int8]", "llava_plus_torch/csrc/decode_attention.cu",
         DECODE_REPLACES, single["int8"] + ckpt["decode"] + int8["decode"] + tp1["decode"]
         + int4["decode"] + s13["decode"]),
        ("quant_matmul[int8]", "llava_plus_torch/csrc/quant_matmul.cu", INT8_REPLACES,
         ckpt["quant"] + int8["quant"] + tp1["int8"] + paged["quant"] + spec["quant"]
         + plus["quant"] + s13["int8"]
         + mpt["dense"]["matmul_int8"]
         + mpt["paged"]["matmul_int8"] + narrow_lora[8][0] + tools["int8"] + plus7b["quant"]),
        ("quant_matmul[int4]", "llava_plus_torch/csrc/quant_matmul.cu", INT4_REPLACES,
         int4["quant"] + narrow_lora[4][0] + qlora["int4"] + tools["int4"] + s13["int4"]
         + train13["int4"]),
        ("quant_matmul[int4n]", "llava_plus_torch/csrc/quant_matmul.cu", INT4N_REPLACES,
         tools["int4n"]),
        ("paged_attention[decode1]", paged_src, PAGED_DECODE1_REPLACES,
         paged["decode1"] + spec["decode1"] + plus["decode1"] + s13["decode1"]),
        ("paged_attention[general]", paged_src, PAGED_GENERAL_REPLACES,
         narrow_general + spec["general"] + plus["general"] + spec["narrow"]["general"]),
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
        # the W8A8 engine's prefills (phase 20)
        ("w8a8_quantize_rows", "llava_plus_torch/csrc/w8a8.cu", W8A8_REPLACES,
         w8a8["quantize"]),
        ("w8a8_epilogue", "llava_plus_torch/csrc/w8a8.cu", W8A8_REPLACES, w8a8["epilogue"]),
    ):
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": count, **stats[name]})
        if name in S13_KERNELS:
            # of which LLaVA-1.5-13B's engines (phase 25)
            entries[-1]["launches_13b"] = s13[S13_KERNELS[name]]
        if name in T13_KERNELS:
            # of which LLaVA-1.5-13B's LoRA and QLoRA training (phase 26)
            entries[-1]["train_13b_launches"] = train13[T13_KERNELS[name]]
        if name in T13S_KERNELS:
            # of which LLaVA-1.5-13B's stage 1 from a base (phase 28)
            entries[-1]["train_13b_stage1_launches"] = pre13[T13S_KERNELS[name]]
        if name in P27_KERNELS:
            # of which LLaVA-Plus-7B's training from a base checkpoint and
            # its served tool turn (phase 27)
            entries[-1]["plus_7b_launches"] = plus7b[P27_KERNELS[name]]
        if name in PLUS_KERNELS:
            # of which the LLaVA-Plus tool turns (phase 18)
            entries[-1]["tool_turn_launches"] = plus[PLUS_KERNELS[name]]
        if name == "w8a8_epilogue":
            # the int8 products between them (torch._int_mm, phase 20)
            entries[-1]["int_mm_launches"] = w8a8["int_mm"]
        if name in ("flash_fwd", "decode_attention[bf16]"):
            # of which the eval runs (phase 19) and the predictor (phase 22)
            key = "flash" if name == "flash_fwd" else "decode"
            entries[-1].update(eval_launches=evals[key], predictor_launches=predictor[key])
        if name == "quant_matmul[int8]":
            # the serving engines' int8 launches by regime (phases 16, 6, 7, 11)
            regimes = [ckpt["quant_regimes"], int8["quant_regimes"], paged["quant_regimes"],
                       plus["quant_regimes"], mpt["dense"]["matmul_int8 regimes"],
                       mpt["paged"]["matmul_int8 regimes"], s13["int8_regimes"]]
            entries[-1].update(engine_decode_launches=sum(r[0] for r in regimes),
                               engine_prefill_launches=sum(r[1] for r in regimes))
        elif name == "quant_matmul[int4]":
            # the int4 engines' launches by regime (phases 6 and 25)
            entries[-1].update(
                engine_decode_launches=int4["quant_regimes"][0] + s13["int4_regimes"][0],
                engine_prefill_launches=int4["quant_regimes"][1] + s13["int4_regimes"][1])
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
                               engine_7b_spec_launches=spec["general"] + plus["general"])
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "llava_plus_tpu"))
    if foreign:
        raise AssertionError(f"the port pulled in JAX or the JAX package: {foreign[:5]}")
    print("phase seconds " + json.dumps(seconds), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
