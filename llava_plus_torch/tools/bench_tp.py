"""Tensor-parallel serving of the port over the cards of one host.

    torchrun --standalone --nproc-per-node 4 -m llava_plus_torch.tools.bench_tp [--out FILE]

Every rank makes the same random weights (seed 0) on its card and quantizes
them whole (int8, fused); each engine cuts its rank's shard. For each
configuration, tp = 1, 2 and 4 on ranks [0, tp), the other ranks waiting:

  llama-dense   LLaVA-1.5-7B, int8 weights, int8 KV, a dense engine of 16
                slots (2048 tokens each)
  llama-paged   the same over a paged pool (128-token pages, the prefix
                cache on)
  mpt-dense     LLaVA-MPT-7B (ALiBi: each rank's slice of the slopes), int8
                weights, int8 KV, dense; tp = 1 and 4

it prints one JSON line a (configuration, tp) with:

- ``logit_rel_diff``: the first-token logits of 4 image prompts (one prefill
  op) against tp = 1's, largest |diff| over the largest |logit|;
- ``greedy_equal``: of each prompt's 32 greedy tokens, those equal to
  tp = 1's up to the first difference, and ``near_tie_gaps``: tp = 1's top-2
  logit gap (relative to the top logit) at each difference, which must lie
  within ``TIE`` (chip_smoke phase 4's bound for int8 weights): rounding may
  split a near tie, a fault splits a wide margin;
- a burst of 16 image prompts x 32 tokens submitted at once: TTFT p50 and
  the aggregate tokens/s;
- with the loop idle and all 16 slots active at position 800: host ms per
  decode step (chunks of 4 ending with their fetch, as the engine's loop
  runs them) and the bytes each rank sends into the all-reduces and the
  vocab gather a decode step;
- the peak device memory of each rank, and each rank's host ms a step of
  queueing those decode chunks (``issue_ms_per_step_by_rank``: a rank that
  queues slower holds the others at the next all-reduce).

``--device-busy`` runs, in place of all that, rank 0's device time of a
chunk of 4 such steps under ``torch.profiler`` (the sum of its kernels'
device time a step, NCCL's kernels apart, since they include the wait for
the other ranks; and the host ops that took most of a step): a pass of its own, because CUPTI stays attached after a
profiler session and would slow every later host clock of the process. (A
decode step launches more kernels than the launch queue holds, so CUDA
events around steps queued behind a sleeping kernel time the host.)

Numbers come from this run on this host's cards; ``describe_device`` gives
their name and power limit. Launched without torchrun (one process) it runs
tp = 1 only; ``--device cpu --tiny`` runs the same flow on the narrow test
configs over gloo.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from llava_plus_torch.data import DebugTokenizer
from llava_plus_torch.generate import multimodal_arrays
from llava_plus_torch.models import llama
from llava_plus_torch.models import llava as llava_model
from llava_plus_torch.models.configs import (
    LLAVA_15_7B, LLAVA_MPT_7B, tiny_llava_config, tiny_llava_mpt_config,
)
from llava_plus_torch.ops.quant import quantize_llava_params
from llava_plus_torch.parallel import tp as tp_lib
from llava_plus_torch.parallel.mesh import make_mesh
from llava_plus_torch.serve.engine import BatchedEngine, Request
from llava_plus_torch.tools import common

TIE = 3e-2          # chip_smoke phase 4's logit bound for int8 weights
NEW = 32            # greedy tokens a request
BURST = 16          # requests of the burst
FILL = 800          # the slots' position in the step measurement


class BenchEngine(BatchedEngine):
    """The engine with one more op (a slot's page table) and, on every
    rank, the host ms a step of queueing each decode chunk that runs all 16
    slots at FILL (the step measurement's chunks; no fetch inside)."""

    issue_ms: list

    def _op_attach(self, slot: int, pages):
        self._attach_pages(slot, pages)

    def _op_decode(self, positions, active, *args):
        t0 = time.perf_counter()
        out = super()._op_decode(positions, active, *args)
        if active.all() and positions.max() == min(FILL, self.max_seq_len - 16):
            self.issue_ms = getattr(self, "issue_ms", [])
            self.issue_ms.append((time.perf_counter() - t0) * 1e3 / args[-1])
        return out


class IdTokenizer(DebugTokenizer):
    """Names every id ("#id"), so a stream's text gives its ids back; eos -1
    (random weights: every request runs its budget)."""

    def __init__(self, vocab_size, bos=True):
        super().__init__(vocab_size=vocab_size)
        self.eos_token_id = -1
        if not bos:
            self.bos_token_id = None

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"#{int(i)}" for i in ids)


def _ids(text):
    return [int(w[1:]) for w in text.split()]


def make_params(cfg, device):
    """Random bf16 weights from seed 0 on ``device`` (every rank makes the
    same), the language model quantized whole to int8 and fused."""
    params = llava_model.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    return quantize_llava_params(params, cfg.language_model_type, bits=8, fuse=True)


def prompts(cfg, n, seed, words=184):
    """``n`` image prompts (762 fused tokens at LLaVA-1.5's 576 patches)
    with random pixels."""
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    text = "<image>\n" if cfg.language_model_type == "llama" else "<im_start><image><im_end>\n"
    return [(text + " ".join(f"w{j}x{i}" for i in range(words)),
             rng.standard_normal((1, size, size, 3)).astype(np.float32)) for j in range(n)]


def top2_gap(params, cfg, tok, prompt, tokens, device, max_len):
    """tp = 1's top-2 logit gap, relative to the top logit, after ``prompt``
    and ``tokens``: a fresh dense prefill (int8 KV) and a decode step a
    token on the whole tree."""
    from llava_plus_torch.generate import batch_to_device

    arrays, plan = multimodal_arrays(cfg, tok, [prompt[0]], [prompt[1]], max_seq_len=max_len,
                                     prefill_bucket=256)
    n0 = int(plan.lengths[0])
    cache = llama.KVCache.create(llava_model.backbone(cfg)[1], 1, max_len, torch.int8,
                                 device=device)
    seg = torch.ones(1, 1, dtype=torch.int32, device=device)
    with torch.inference_mode():
        logits, _ = llava_model.forward(params, cfg, batch_to_device(arrays, device),
                                        cache=cache, fresh_prefill=True,
                                        logits_positions=torch.tensor([n0 - 1], device=device))
        for i, t in enumerate(tokens):
            logits, _ = llava_model.decode_step(
                params, cfg, torch.tensor([[t]], device=device),
                torch.tensor([[n0 + i]], dtype=torch.int32, device=device), seg, cache)
    top = logits[0, -1].float().topk(2).values
    return float((top[0] - top[1]) / top[0].abs())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(engine, cfg, tok, probe, burst, counted) -> dict:
    """Rank 0's measurements on a serving engine (its followers replaying)."""
    dev = engine.device
    out = {}
    # first-token logits of the probe prompts, and their greedy streams
    arrays, plan = multimodal_arrays(cfg, tok, [p for p, _ in probe], [i for _, i in probe],
                                     max_seq_len=engine.max_seq_len,
                                     prefill_bucket=engine.prefill_bucket)
    n = len(probe)
    _, _, logits = engine._issue("prefill", next(engine._pids), list(engine._caches.keys()),
                                 arrays, [0.0] * n, [1.0] * n, [0] * n,
                                 (np.asarray(plan.lengths) - 1).tolist())
    out["logits"] = logits.float().cpu()
    reqs = [engine.submit(Request(prompt=p, images=i, max_new_tokens=NEW, temperature=0.0))
            for p, i in probe]
    out["streams"] = [_ids(engine.drain(r)) for r in reqs]
    # the burst
    _sync(dev)
    t0 = time.perf_counter()
    reqs = [engine.submit(Request(prompt=p, images=i, max_new_tokens=NEW, temperature=0.0))
            for p, i in burst]
    texts = [engine.drain(r) for r in reqs]
    dt = time.perf_counter() - t0
    out["burst_tokens"] = sum(len(_ids(t)) for t in texts)
    out["tokens_per_s"] = out["burst_tokens"] / dt
    out["ttft_p50_s"] = float(np.median([r.ttft for r in reqs]))
    out["burst_s"] = dt
    # decode steps with the loop idle
    step = full_slots(engine)
    for _ in range(2):
        step(4)
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(4)
        host.append((time.perf_counter() - t0) * 1e3 / 4)
    out["host_ms_per_step"] = float(np.mean(host))
    counted["bytes"] = 0
    step(1)
    out["collective_bytes_per_step"] = counted["bytes"]
    return out


def full_slots(engine):
    """With the loop idle, every slot active at FILL (a paged pool: each slot
    its own pages up to there, so the steps read distinct memory): a
    function that runs a decode chunk of n steps and fetches its tokens."""
    B, fill = engine.max_slots, min(FILL, engine.max_seq_len - 16)
    args = (np.full(B, fill, np.int32), np.ones(B, bool), np.zeros(B, np.float32),
            np.ones(B, np.float32), np.zeros(B, np.int64), False)
    if engine.paged:
        per = fill // engine.page_size + 1
        for slot in range(B):
            engine._issue("attach", slot, engine._alloc_pages(per))
    return lambda n: engine._issue("decode", *args, n).tolist()


def device_busy(engine) -> dict:
    """Rank 0's device ms a decode step (16 slots at FILL) from a profiled
    chunk of 4: its kernels' sum, and NCCL's kernels apart."""
    from torch.profiler import ProfilerActivity, profile

    if engine.device.type != "cuda":
        return {"device_busy_ms_per_step": "not measured", "nccl_ms_per_step": "not measured"}
    step = full_slots(engine)
    for _ in range(2):
        step(4)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(4)
        _sync(engine.device)
    busy = nccl = 0.0
    host = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            if "nccl" in e.key.lower():
                nccl += e.self_device_time_total / 1e3 / 4
            else:
                busy += e.self_device_time_total / 1e3 / 4
        elif e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total / 1e3 / 4, e.count // 4, e.key))
    # the host ops that took most of a profiled step (self CPU ms, calls)
    top = {k: [round(ms, 3), n] for ms, n, k in sorted(host, reverse=True)[:12]}
    return {"device_busy_ms_per_step": busy, "nccl_ms_per_step": nccl, "host_top_ms": top}


def count_collectives(counted):
    """Wrap the serving group's collectives to add up the bytes each rank
    sends into them."""
    from llava_plus_torch.models import mpt

    reduce, gather = tp_lib.reduce_partial, tp_lib.gather_vocab

    def reduce_counted(x):
        if tp_lib.tp_size() > 1:
            counted["bytes"] += x.numel() * x.element_size()
        return reduce(x)

    def gather_counted(x):
        if tp_lib.tp_size() > 1:
            counted["bytes"] += x.numel() * x.element_size()
        return gather(x)

    # ops/quant.py and ops/w8a8.py reach it through the module
    tp_lib.reduce_partial = reduce_counted
    for mod in (llama, mpt):
        mod.gather_vocab = gather_counted


def compare(ref, res, gap_of):
    """tp's first-token logits and greedy streams against tp = 1's."""
    a, b = res.pop("logits"), ref["logits"]
    streams = res.pop("streams")
    equal, gaps = [], []
    for i, (x, y) in enumerate(zip(ref["streams"], streams)):
        k = next((j for j, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y)))
        equal.append(k)
        if k < len(x):
            gaps.append(gap_of(i, x[:k]))
    return {"logit_rel_diff": float((a - b).abs().max() / b.abs().max()),
            "greedy_equal": equal, "of": [len(x) for x in ref["streams"]],
            "near_tie_gaps": gaps, "ties_within_bound": all(g <= TIE for g in gaps)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="the narrow test configs (with --device cpu, a dry run)")
    parser.add_argument("--device-busy", action="store_true",
                        help="only rank 0's profiled device time a decode step")
    parser.add_argument("--out", default=None, help="write the results as JSON here")
    args = parser.parse_args(argv)
    cuda = args.device == "cuda"
    if "RANK" not in os.environ:
        os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                          MASTER_PORT=str(29500 + os.getpid() % 1000))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("bench_tp: no CUDA device (pass --device cpu --tiny for a dry run)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if cuda else "gloo", timeout=tp_lib.DATA_TIMEOUT)
    # the waiting ranks wait on a gloo group with a long timeout
    idle = dist.new_group(backend="gloo", timeout=datetime.timedelta(hours=1))
    dev = torch.device(f"cuda:{torch.cuda.current_device()}" if cuda else "cpu")
    if cuda and rank == 0:
        from llava_plus_torch.kernels import build

        build.lib()   # built once, before the other ranks load it
    dist.barrier(group=idle)
    card = common.describe_device(str(dev))
    counted = {"bytes": 0}
    count_collectives(counted)
    tps = [t for t in (1, 2, 4) if t <= world]
    # tp = world over the (1, 1, tp) mesh, fewer ranks over a serving group
    # made here by every rank
    meshes = {t: make_mesh(1, 1, world, device_type=dev.type) if t == world
              else tp_lib.make_group(range(t)) for t in tps if t > 1}
    llama_cfg = LLAVA_15_7B
    if args.tiny:   # MHA, so that 4 ranks split the kv heads
        llama_cfg = tiny_llava_config()
        llama_cfg = dataclasses.replace(llama_cfg, text=dataclasses.replace(
            llama_cfg.text, num_key_value_heads=4))
    mpt_cfg = tiny_llava_mpt_config() if args.tiny else LLAVA_MPT_7B
    S = 128 if args.tiny else 2048
    configs = [("llama-dense", llama_cfg, False, tps), ("llama-paged", llama_cfg, True, tps),
               ("mpt-dense", mpt_cfg, False, [t for t in (1, 4) if t <= world])]
    results, params, made = [], None, None
    for name, cfg, paged, sizes in configs:
        t0 = time.perf_counter()
        if made is not cfg:   # the two LLaMA configurations share one tree
            params = None
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            params, made = make_params(cfg, dev), cfg
        tok = IdTokenizer(llava_model.backbone(cfg)[1].vocab_size,
                          bos=cfg.language_model_type == "llama")
        words = 8 if args.tiny else 184
        probe = prompts(cfg, 4, 1, words)
        burst = prompts(cfg, BURST, 2, words)
        kw = dict(max_slots=16, max_seq_len=S, decode_chunk=4, cache_dtype=torch.int8,
                  prefill_bucket=32 if args.tiny else 256)
        if paged:
            kw.update(paged=True, page_size=32 if args.tiny else 128)
        if rank == 0:
            print(f"[bench_tp] {name}: weights made and quantized in "
                  f"{time.perf_counter() - t0:.1f} s; card {card}", flush=True)
        ref, gaps = None, {}

        def gap_of(i, tokens):
            key = (i, len(tokens))
            if key not in gaps:
                gaps[key] = top2_gap(params, cfg, tok, probe[i], tokens, dev, S)
            return gaps[key]

        for t in sizes:
            peak, row, issue = None, None, None
            if rank < t:
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(dev)
                eng = BenchEngine(params, cfg, tok, mesh=meshes.get(t), **kw)
                if rank == 0:
                    res = device_busy(eng) if args.device_busy else measure(
                        eng, cfg, tok, probe, burst, counted)
                    eng.stop()
                else:
                    eng.follow()
                issue = float(np.median(eng.issue_ms)) if getattr(eng, "issue_ms", None) else None
                del eng
                if dev.type == "cuda":
                    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if rank == 0 and not args.device_busy:
                    if t == 1:
                        ref = {"logits": res["logits"], "streams": res["streams"]}
                    res = {**compare(ref, res, gap_of), **res}
                if rank == 0:
                    row = {"config": name, "tp": t, "card": card, **res}
            peaks = [None] * world
            dist.all_gather_object(peaks, (peak, issue if rank < t else None), group=idle)
            if rank == 0:
                row["peak_gib_per_card"] = [p for p, _ in peaks[:t]]
                row["issue_ms_per_step_by_rank"] = [i for _, i in peaks[:t]]
                print(json.dumps(row), flush=True)
                results.append(row)
    if rank == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    dist.barrier(group=idle)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
