"""Where the time of the PyTorch port's 7B serving slice goes, on one CUDA card.

Builds LLaVA-1.5-7B (``llava_plus_torch``) at full width and depth with
random bf16 weights (``torch.Generator`` seed 0, as ``chip_smoke.py`` does)
and a ``Generator`` with ``max_seq_len`` 2048, then, for a bf16 and an int8
KV cache:

  prefill  the 768-token image request (CLIP encode, projector, splice,
           LLaMA prefill into a fresh cache): host clock over three warm
           calls, then one call under ``torch.profiler``;
  decode   single-token steps after that prefill, each ending with the
           token fetched to the host as ``Generator.stream`` does: host
           clock over ``--steps`` steps, then ``--steps`` more under
           ``torch.profiler``.

Every host clock is taken before the first profiler session.

With ``--engine`` it profiles the continuous-batching engine's path instead,
as ``chip_smoke.py`` phase 6 serves it: the weights quantized in place to
``--quantize`` (int8 or int4, fused), an int8 KV cache, 16 slots of 2048:

  prefill  one batched prefill of 4 image requests (768 tokens each) with
           the first-token fetch (``BatchedEngine._prepare``);
  decode   chunks of 4 batched steps with all 16 slots active (8 image and
           8 text prompts inserted from such prefills), each chunk ending
           with its tokens fetched to the host, as the engine loop does.

``--engine --paged`` profiles the same on the paged engine, as
``chip_smoke.py`` phase 7 serves it: an int8 KV pool of 256 pages of 128
tokens (``pool_tokens`` 32768), slots of up to 4096 tokens, the prefills'
stripes inserted into pool pages.

``--engine --mpt [--paged]`` profiles LLaVA-MPT-7B instead, as
``chip_smoke.py`` phase 11 serves it: the ALiBi kernels, int8 weights (its
four matrices a layer), image prompts of 200 words (~460 fused tokens with
its 256 image slots, one 512 bucket), slots of 2048, a paged pool of 128
pages of 128 tokens.

For each it prints the host-clock ms per call or step, the device busy ms
(the sum of the device time of every kernel, copy and memset in the trace,
per call or step), the idle share (1 - busy / host), the device time by
class of kernel, and the kernels with the most device time. The full
``key_averages`` tables go to ``--out``. The last line is one JSON object
with the numbers printed.

``--train --stage 1|2`` profiles one 7B training step as ``chip_smoke.py``
phases 9 and 10 run it (gradient checkpointing, bf16 weights and moments):
stage 1 trains the projector on 32 rows of ~600 fused tokens (an image and
a 10-60 word caption), stage 2 the language model and the projector on 2
micro-batches of 4 rows of 700-2048 fused tokens. It times the gradients
(forward, recompute, backward) and the AdamW update apart: host clock over
two steps after a warm-up step, then one step under ``torch.profiler``.

Usage: python tools/profile_torch_slice.py [--steps 16] [--out profile_out]
       python tools/profile_torch_slice.py --engine [--quantize int8|int4] [--paged] [--mpt]
       python tools/profile_torch_slice.py --train [--stage 1|2]
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

CLASSES = (
    ("paged_attention (kernel)", ("paged_decode1_kernel", "paged_general_kernel")),
    ("flash_fwd (kernel)", ("flash_fwd_kernel",)),
    ("flash_bwd (kernel)", ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
    ("decode_attention (kernel)", ("decode_kernel",)),
    ("quant_matmul (kernel)", ("int8_stream_kernel", "int8_wgmma_kernel", "int4_stream_kernel",
                               "int4_wgmma_kernel", "int4n_stream_kernel", "int4n_wgmma_kernel")),
    ("GEMM/GEMV (cuBLAS)", ("gemm", "gemv", "cutlass", "nvjet", "xmma", "splitk")),
    ("copies and casts", ("copy", "memcpy", "memset")),
    ("reductions", ("reduce",)),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other elementwise"


def device_events(prof):
    """(name, calls, self device µs) of every device-side event."""
    out = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            out.append((e.key, e.count, e.self_device_time_total))
    return out


def summarize(tag, prof, host_ms, per, out_dir, top=12):
    """Print and return the breakdown of one profiled phase, ``per`` calls."""
    events = device_events(prof)
    busy_ms = sum(us for _, _, us in events) / 1e3 / per
    by_class = collections.Counter()
    for name, _, us in events:
        by_class[kernel_class(name)] += us / 1e3 / per
    print(f"[{tag}] host {host_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / host_ms:.3f} (per {'step' if per > 1 else 'call'})")
    for label, ms in by_class.most_common():
        print(f"[{tag}]   {label}: {ms:.3f} ms ({ms / busy_ms:.1%})")
    for name, calls, us in sorted(events, key=lambda x: -x[2])[:top]:
        print(f"[{tag}]     {us / 1e3 / per:8.3f} ms  {calls // per:5d} calls  {name[:90]}")
    with open(os.path.join(out_dir, f"{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    return {"host_ms": host_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / host_ms,
            "by_class_ms": dict(by_class.most_common())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--engine", action="store_true",
                    help="profile the batching engine with quantized weights")
    ap.add_argument("--quantize", default="int8", choices=("int8", "int4"))
    ap.add_argument("--paged", action="store_true",
                    help="with --engine: the paged engine (256 pages of 128 tokens)")
    ap.add_argument("--mpt", action="store_true",
                    help="with --engine: LLaVA-MPT-7B (the ALiBi kernels)")
    ap.add_argument("--train", action="store_true", help="profile a 7B training step")
    ap.add_argument("--stage", type=int, default=1, choices=(1, 2))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    if args.engine:
        return profile_engine(args)
    if args.train:
        return profile_train(args)

    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.generate import Generator, sample_token
    from llava_plus_torch.models import llama, llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_15_7B

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    cfg, dev = LLAVA_15_7B, "cuda:0"
    params = llava_model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tok = DebugTokenizer(vocab_size=cfg.text.vocab_size)
    size = cfg.vision.image_size
    image = np.random.default_rng(0).standard_normal((1, size, size, 3)).astype(np.float32)
    prompt = "<image>\n" + " ".join(f"word{i}" for i in range(184))
    result = {"card": smi, "steps": args.steps}
    runs = {}
    for cache_dtype in (torch.bfloat16, torch.int8):
        gen = Generator(params, cfg, tok, device=dev, max_seq_len=2048,
                        cache_dtype=cache_dtype)
        batch, plan = gen.prepare_batch([prompt], [image])
        runs["int8" if cache_dtype == torch.int8 else "bf16"] = (
            gen, batch, int(plan.lengths[0]))

    def prefill(gen, batch):
        cache = llama.KVCache.create(cfg.text, 1, gen.max_seq_len, gen.cache_dtype,
                                     device=dev)
        logits = gen._prefill(cache, batch)
        token = sample_token(logits, None, 0.0, 1.0)[:, None]
        int(token[0, 0])
        return cache, token

    def decode(gen, cache, token, pos, n):
        for i in range(n):
            token = gen._decode_n(cache, token, pos + i, 1, None, 0.0, 1.0)
            int(token[0, 0])

    # Host clocks first: once a profiler session has run, CUPTI may stay
    # attached and slow every later launch.
    host = {}
    with torch.inference_mode():
        for kv, (gen, batch, prompt_len) in runs.items():
            for _ in range(3):                      # warm-up: allocator, cuBLAS, kernels
                cache, token = prefill(gen, batch)
                decode(gen, cache, token, prompt_len, 4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                prefill(gen, batch)
            prefill_ms = (time.perf_counter() - t0) / 3 * 1e3
            cache, token = prefill(gen, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(gen, cache, token, prompt_len, args.steps)
            host[kv] = (prefill_ms, (time.perf_counter() - t0) / args.steps * 1e3)

        for kv, (gen, batch, prompt_len) in runs.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prefill(gen, batch)
                torch.cuda.synchronize()
            pre = summarize(f"prefill-{kv}", prof, host[kv][0], 1, args.out)
            cache, token = prefill(gen, batch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                decode(gen, cache, token, prompt_len, args.steps)
                torch.cuda.synchronize()
            dec = summarize(f"decode-{kv}", prof, host[kv][1], args.steps, args.out)
            result[kv] = {"prompt_len": prompt_len, "prefill": pre, "decode": dec}

        # the decode host clock again, now after the profiler sessions
        gen, batch, prompt_len = runs["bf16"]
        cache, token = prefill(gen, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(gen, cache, token, prompt_len, args.steps)
        after = (time.perf_counter() - t0) / args.steps * 1e3
        print(f"[decode-bf16] host {after:.3f} ms per step after profiling "
              f"(before: {host['bf16'][1]:.3f} ms)")
        result["bf16"]["decode"]["host_ms_after_profiler"] = after

    print(json.dumps(result))
    return 0


def profile_engine(args):
    from llava_plus_torch.data import DebugTokenizer
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_15_7B, LLAVA_MPT_7B
    from llava_plus_torch.ops.quant import quantize_llava_params
    from llava_plus_torch.serve.engine import BatchedEngine, Request

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    cfg, dev, B, chunk = LLAVA_MPT_7B if args.mpt else LLAVA_15_7B, "cuda:0", 16, 4
    params = llava_model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = quantize_llava_params(params, cfg.language_model_type,
                                   bits=8 if args.quantize == "int8" else 4, fuse=True)
    tok = DebugTokenizer(vocab_size=llava_model.backbone(cfg)[1].vocab_size)
    tok.eos_token_id = -1  # random weights: every prefill fills its slot
    if args.mpt:
        tok.bos_token_id = None  # GPT-NeoX style, as MPT's tokenizer
    S = 4096 if args.paged and not args.mpt else 2048
    engine = BatchedEngine(params, cfg, tok, max_slots=B, max_seq_len=S,
                           decode_chunk=chunk, cache_dtype=torch.int8, paged=args.paged,
                           pool_tokens=(16384 if args.mpt else 32768) if args.paged else None)
    tag = f"{'mpt-' if args.mpt else ''}{args.quantize}{'-paged' if args.paged else ''}"
    words = 200 if args.mpt else 184
    size = cfg.vision.image_size
    rng = np.random.default_rng(0)

    def image_reqs(tag):
        return [Request(prompt="<image>\n" + " ".join(f"{tag}{j}w{i}" for i in range(words)),
                        images=rng.standard_normal((1, size, size, 3)).astype(np.float32),
                        max_new_tokens=64) for j in range(4)]

    def text_reqs(tag):
        return [Request(prompt=" ".join(f"{tag}{j}w{i}" for i in range(60 + 80 * j)),
                        max_new_tokens=64) for j in range(4)]

    result = {"card": smi, "model": "llava-mpt-7b" if args.mpt else "llava-1.5-7b",
              "quantize": args.quantize, "paged": args.paged, "slots": B, "chunk": chunk}
    with torch.inference_mode():
        for _ in range(2):                          # warm-up: kernels, allocator, cuBLAS
            engine._prepare(image_reqs("warm"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3):
            engine._prepare(image_reqs(f"p{i}"))
        prefill_ms = (time.perf_counter() - t0) / 3 * 1e3
        # fill the 16 slots' caches (the loop thread sees no occupant and idles)
        positions = []
        for k, reqs in enumerate([image_reqs("a"), image_reqs("b"), text_reqs("c"),
                                  text_reqs("d")]):
            for j, prep in enumerate(engine._prepare(reqs)):
                if args.paged:
                    engine._insert_paged(prep.cache1, prep.row, 4 * k + j,
                                         engine._alloc_pages(prep.needed_pages), prep.first_id)
                else:
                    engine._insert(prep.cache1, prep.row, 4 * k + j, prep.first_id)
                positions.append(prep.prompt_len)
        dev_t = lambda a: torch.tensor(a, device=dev)
        pos = dev_t(positions).to(torch.int32)
        active = torch.ones(B, dtype=torch.bool, device=dev)
        temps, tops = torch.zeros(B, device=dev), torch.ones(B, device=dev)
        seeds = torch.zeros(B, dtype=torch.int64, device=dev)

        def decode(n_chunks):
            nonlocal pos
            for _ in range(n_chunks):
                toks, engine.tokens = engine._decode_n(pos, active, temps, tops, seeds,
                                                       False, chunk)
                toks.tolist()
                pos = pos + chunk

        n = max(args.steps // chunk, 1)
        decode(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(n)
        step_ms = (time.perf_counter() - t0) / (n * chunk) * 1e3
        print(f"mean fill at the profiled steps: {float(pos.float().mean()):.0f} of {S}")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine._prepare(image_reqs("q"))
            torch.cuda.synchronize()
        result["prefill"] = summarize(f"engine-prefill-{tag}", prof, prefill_ms, 1, args.out)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            decode(n)
            torch.cuda.synchronize()
        result["decode"] = summarize(f"engine-decode-{tag}", prof, step_ms, n * chunk,
                                     args.out)
    engine.stop()
    print(json.dumps(result))
    return 0


def _train_arrays(cfg, rng, rows, lo, hi):
    """Collated arrays of ``rows`` image records of ``lo``-``hi`` text
    tokens each (random ids), labels on the text, padded to a multiple of
    64, as the dataset's collator gives them."""
    from llava_plus_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from llava_plus_torch.data.multimodal import pad_images, plan_multimodal_batch

    ids, labels = [], []
    for _ in range(rows):
        text = rng.integers(3, cfg.text.vocab_size, int(rng.integers(lo, hi + 1)))
        x = np.concatenate([[1, IMAGE_TOKEN_INDEX], text])
        ids.append(x)
        labels.append(np.where(np.arange(len(x)) < 2, IGNORE_INDEX, x))
    plan = plan_multimodal_batch(ids, labels, num_patches=cfg.num_image_tokens,
                                 max_len=2048, pad_to_multiple=64)
    size = cfg.vision.image_size
    images = [rng.standard_normal((1, size, size, 3)).astype(np.float32) for _ in ids]
    return {"tokens": plan.tokens, "positions": plan.positions,
            "segment_ids": plan.segment_ids, "image_pos": plan.image_pos,
            "labels": plan.labels, "images": pad_images(images, 1, (size, size, 3))}


def profile_train(args):
    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.models.configs import LLAVA_15_7B
    from llava_plus_torch.models.convert import per_layer
    from llava_plus_torch.models.llava import MultimodalBatch
    from llava_plus_torch.train import step as step_lib
    from llava_plus_torch.train.optimizer import OptimizerConfig, build_optimizer
    from llava_plus_torch.train.train import stack_micro_batches

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    cfg, dev = LLAVA_15_7B, "cuda:0"
    rng = np.random.default_rng(args.stage)
    if args.stage == 1:
        K, arrays = 1, _train_arrays(cfg, rng, 32, 12, 62)
        opt_cfg = OptimizerConfig(learning_rate=1e-3, total_steps=100,
                                  train_language_model=False)
    else:
        K = 2
        arrays = stack_micro_batches([_train_arrays(cfg, rng, 4, 90, 1500) for _ in range(K)],
                                     0, 2048)
        opt_cfg = OptimizerConfig(learning_rate=2e-5, total_steps=100)
    batch = MultimodalBatch(**{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})
    tokens = int((arrays["segment_ids"] > 0).sum())
    params = per_layer(llava_model.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                               dev))
    opt = build_optimizer(params, opt_cfg)
    state = opt.init(params)
    keys = tuple(k for k in opt.trained_keys if k != "vision_tower")
    if "mm_projector" not in keys:
        keys += ("mm_projector",)
    tag = f"train-stage{args.stage}"

    def grads():
        g, m = step_lib.grads_and_metrics(
            lambda p, mb: step_lib.loss_fn(p, cfg, mb, remat=True), params, batch, K, keys)
        float(m["loss"])
        return g

    def update(g):
        opt.update(g, state, params)
        torch.cuda.synchronize()

    update(grads())                                 # warm-up: allocator, cuBLAS, kernels
    torch.cuda.synchronize()
    host_g, host_u = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        g = grads()
        host_g.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        update(g)
        host_u.append(time.perf_counter() - t0)
        del g
    grads_ms, update_ms = np.mean(host_g) * 1e3, np.mean(host_u) * 1e3
    print(f"[{tag}] {K} x {batch.tokens.shape[-2]} x {batch.tokens.shape[-1]} rows, {tokens} "
          f"non-pad tokens: host {grads_ms + update_ms:.1f} ms a step (gradients "
          f"{grads_ms:.1f}, AdamW {update_ms:.1f}), {tokens / (grads_ms + update_ms) * 1e3:.0f} "
          f"non-pad tokens/s; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    result = {"card": smi, "stage": args.stage, "non_pad_tokens": tokens,
              "host_step_ms": grads_ms + update_ms,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g = grads()
        torch.cuda.synchronize()
    result["gradients"] = summarize(f"{tag}-gradients", prof, grads_ms, 1, args.out)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        update(g)
    result["optimizer"] = summarize(f"{tag}-optimizer", prof, update_ms, 1, args.out)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
