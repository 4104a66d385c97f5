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

``--train`` measures tensor-parallel training instead: LLaVA-1.5-7B stage
2 (random bf16 weights from seed 0, language model and projector trained,
lr 2e-5, cosine, remat, bf16 moments; chip_smoke phase 10's recipe) on
synthetic image records of 700 to 2048 fused tokens, 4 rows a rank x 2
micro-batches (the same global batch on every mesh), over the (dp, fsdp,
tp) meshes (1, n, 1), (1, n/2, 2) and (1, 1, n) of the n ranks;
``--bits 8`` / ``4`` runs QLoRA over an int8 / int4 base instead (the
trainer's ``--lora-enable --bits``; several values run one after the
other). For each mesh it prints one JSON line with each step's loss and
grad_norm (and their relative difference from the first mesh's), the host
ms of the steps after the first, the peak device memory of each rank and
the column / row product counts a rank. Then, every mesh built again and
stepped twice, the second step profiled: each rank's device ms and kernel
launches by class (GEMM, flash attention, NCCL, other), its library GEMM
FLOPs (the profiler's count on local tensors, :func:`local_gemm_flops`:
forward, remat recompute and backward, every product of the step; the
quantized kernels are not counted) and aten op calls, and rank 0's
costliest host ops. That pass runs after every host clock, since CUPTI
stays attached after a profiler session; ``--passes host`` or
``--passes profile`` runs one pass alone. The tool runs against whichever ``llava_plus_torch`` the path
holds: ``PYTHONPATH=<other tree> torchrun ... <this file> --train``
measures another tree's package the same way.

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


# ---------------------------------------------------------------------------
# --train: tensor-parallel training steps
# ---------------------------------------------------------------------------

ROWS_A_RANK = 4     # chip_smoke phase 10's batch a card
ACCUM = 2           # its micro-batches a step
TRAIN_STEPS = 3     # steps a mesh: the first warms up, the others are timed


def train_batches(cfg, rows: int, steps: int, max_len: int, seed: int = 5):
    """``steps`` batches of ``ACCUM`` x ``rows`` synthetic image records
    (stacked [ACCUM, rows, ...]): an image of noise and random text whose
    fused length is drawn from about 700 to 2200 tokens (cut at
    ``max_len``; at the tiny configs, from a fifth of ``max_len`` up), the
    first 40 tokens masked out of the loss. Every rank draws the same."""
    from llava_plus_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from llava_plus_torch.data.dataset import collate_batch
    from llava_plus_torch.train.train import stack_micro_batches

    rng = np.random.default_rng(seed)
    size, P = cfg.vision.image_size, cfg.num_image_tokens
    V = llava_model.backbone(cfg)[1].vocab_size
    lo, hi = (125, 1600) if max_len >= 2048 else (max_len // 5, max_len)
    out = []
    for _ in range(steps):
        micro = []
        for _ in range(ACCUM):
            items = []
            for _ in range(rows):
                n = int(rng.integers(lo, hi))
                ids = np.concatenate([[1, IMAGE_TOKEN_INDEX], rng.integers(3, V, n)])
                labels = ids.copy()
                labels[:min(40, n)] = IGNORE_INDEX
                items.append({"input_ids": ids, "labels": labels, "images": rng.standard_normal(
                    (1, size, size, 3)).astype(np.float32)})
            micro.append(collate_batch(items, num_patches=P, max_len=max_len, image_size=size))
        out.append(stack_micro_batches(micro, 0, max_len))
    return out


def product_counts():
    from llava_plus_torch.ops.quant import matmul

    return {k: getattr(matmul, f"{k}_calls", None) for k in ("column", "row")}


def _stepper(cfg, shape, dev, bits: int, steps: int):
    """(mesh, step) of one mesh: ``step(batch)`` runs one training step on
    the placed batch and returns its metrics. ``bits`` 16: stage 2 (the
    language model and projector trained, AdamW, lr 2e-5, cosine); 8 or 4:
    QLoRA as the trainer runs it (``--lora-enable --bits``: the language
    model quantized unfused, adapters r = 128, alpha 256 on LLaMA's
    matrices, replicated; lr 2e-4)."""
    from llava_plus_torch.models.convert import per_layer, tree_map
    from llava_plus_torch.train import lora as lora_lib
    from llava_plus_torch.train import step as step_lib
    from llava_plus_torch.train.optimizer import OptimizerConfig, build_optimizer
    from llava_plus_torch.train.train import _lora_step_fn

    mesh = make_mesh(*shape, device_type=dev.type)
    params = llava_model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if bits == 16:
        placed = per_layer(step_lib.place_params(params, mesh, cfg))
        opt = build_optimizer(placed, OptimizerConfig(
            learning_rate=2e-5, weight_decay=0.0, warmup_ratio=0.03, total_steps=steps,
            schedule="cosine"))
        state = [placed, opt.init(placed)]
        fn = step_lib.make_train_step(cfg, opt, remat=True, accum_steps=ACCUM, mesh=mesh)

        def step(batch):
            state[0], state[1], m = fn(state[0], state[1], batch)
            return m
    else:
        from torch.distributed.tensor import Replicate, distribute_tensor

        lora_cfg = lora_lib.LoraConfig()
        params = quantize_llava_params(params, "llama", bits=bits)
        adapters = lora_lib.init_lora_params(params["language_model"], lora_cfg,
                                             torch.Generator(device=dev).manual_seed(1))
        placed = per_layer(step_lib.place_params(params, mesh, cfg))
        adapters = tree_map(lambda x: distribute_tensor(x, mesh, [Replicate()] * mesh.ndim),
                            adapters)
        step = _lora_step_fn(placed, cfg, lora_cfg, lora_lib.lora_per_layer(adapters), 2e-4,
                             True, ACCUM, mesh)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return mesh, step


def _placed_batch(arrays, mesh, dev):
    from llava_plus_torch.models.llava import MultimodalBatch
    from llava_plus_torch.train import step as step_lib

    batch = MultimodalBatch(**{k: torch.from_numpy(np.asarray(v)).to(dev)
                               for k, v in arrays.items()})
    return step_lib.place_batch(batch, mesh, ACCUM)


def _metrics(m) -> dict:
    return {k: float(m[k]) for k in ("loss", "grad_norm", "tokens")}


GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def local_gemm_flops(events) -> float:
    """The FLOPs of the library GEMMs that ran on this rank's local tensors
    (the profiler's count, 2 x M x K x N an ``aten::mm``). A product of
    DTensors records its event with the global shapes and runs the local
    op beneath it, so only GEMM events with no GEMM event beneath them
    count: the same mechanism reads a package whose mesh products are
    DTensor ops and one whose products run on local shards. The quantized
    kernels (a ctypes call, no aten op) are not counted."""
    def gemm_below(e):
        return any(c.name in GEMM_OPS or gemm_below(c) for c in e.cpu_children)

    return float(sum(e.flops for e in events if e.name in GEMM_OPS and not gemm_below(e)))


def train_mesh(cfg, shape, dev, batches, idle, world, bits) -> dict:
    """One mesh's steps: losses, host ms, peak memory, products."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    mesh, step = _stepper(cfg, shape, dev, bits, len(batches))
    counts0 = product_counts()
    metrics, host = [], []
    for i, arrays in enumerate(batches):
        batch = _placed_batch(arrays, mesh, dev)
        _sync(dev)
        t0 = time.perf_counter()
        m = _metrics(step(batch))
        _sync(dev)
        if i == 0:
            counts = {k: (None if v is None else v - counts0[k])
                      for k, v in product_counts().items()}
        else:
            host.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else None
    per_rank = [None] * world
    dist.all_gather_object(per_rank, (peak, counts), group=idle)
    del step
    return {"bits": bits, "mesh": list(shape), "steps": metrics, "host_ms_per_step": host,
            "host_ms_mean": float(np.mean(host)) if host else None,
            "peak_gib_per_card": [p for p, _ in per_rank],
            "product_calls_per_rank_first_step": [c for _, c in per_rank]}


def profile_mesh(cfg, shape, dev, batches, idle, world, bits) -> dict:
    """One step that warms the mesh up, then one profiled step: each rank's
    device ms and kernel launches by class (on the card), its library GEMM
    FLOPs (:func:`local_gemm_flops`: forward, remat recompute and backward)
    and aten op calls, rank 0's host ops that took most of the step, and
    both steps' metrics."""
    from torch.profiler import ProfilerActivity, profile

    mesh, step = _stepper(cfg, shape, dev, bits, 2)
    metrics = [_metrics(step(_placed_batch(batches[0], mesh, dev)))]
    _sync(dev)
    batch = _placed_batch(batches[1], mesh, dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts, record_shapes=True, with_flops=True) as prof:
        metrics.append(_metrics(step(batch)))
        _sync(dev)
    by_class = common.device_ms_by_class(prof)
    events = prof.events()
    mine = {"device_ms": by_class["ms"] if dev.type == "cuda" else "not measured",
            "launches": by_class["launches"] if dev.type == "cuda" else "not measured",
            "gemm_tflop": local_gemm_flops(events) / 1e12,
            "aten_op_calls": sum(e.name.startswith("aten::") for e in events)}
    if dist.get_rank() == 0:
        top = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                     key=lambda e: -e.self_cpu_time_total)[:12]
        mine["top_host_ops"] = [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in top]
    per_rank = [None] * world
    dist.all_gather_object(per_rank, mine, group=idle)
    del step
    return {"bits": bits, "mesh": list(shape), "steps": metrics,
            "device_ms_by_class_per_rank": [r["device_ms"] for r in per_rank],
            "launches_by_class_per_rank": [r["launches"] for r in per_rank],
            "gemm_tflop_per_rank": [r["gemm_tflop"] for r in per_rank],
            "aten_op_calls_per_rank": [r["aten_op_calls"] for r in per_rank],
            "rank0_top_host_ops_ms": per_rank[0]["top_host_ops"]}


def train_main(args, rank, world, dev, idle, card):
    """``--train``: for each ``--bits``, every mesh's steps, then every
    mesh's profiled step (the ``--passes`` named)."""
    cfg = tiny_llava_config() if args.tiny else LLAVA_15_7B
    if args.tiny:   # MHA, so that 4 ranks split the kv heads
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_key_value_heads=4))
    max_len = 96 if args.tiny else 2048
    batches = train_batches(cfg, ROWS_A_RANK * world, TRAIN_STEPS, max_len)
    shapes = [(1, world // t, t) for t in (1, 2, 4) if t <= world and world % t == 0]
    passes = [fn for name, fn in (("host", train_mesh), ("profile", profile_mesh))
              if name in args.passes]
    results = []
    for bits in args.bits:
        for measure_mesh in passes:
            first = None
            for shape in shapes:
                t0 = time.perf_counter()
                row = measure_mesh(cfg, shape, dev, batches, idle, world, bits)
                first = first or row["steps"]
                if rank == 0:
                    row["rel_diff_vs_first_mesh"] = [
                        {k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")}
                        for a, b in zip(row["steps"], first)]
                    row.update(card=card, seconds=time.perf_counter() - t0)
                    print(json.dumps(row), flush=True)
                results.append(row)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="the narrow test configs (with --device cpu, a dry run)")
    parser.add_argument("--device-busy", action="store_true",
                        help="only rank 0's profiled device time a decode step")
    parser.add_argument("--train", action="store_true",
                        help="tensor-parallel training steps in place of serving")
    parser.add_argument("--bits", type=int, nargs="+", choices=(16, 8, 4), default=[16],
                        help="--train: 16 trains stage 2, 8 and 4 QLoRA over a quantized base")
    parser.add_argument("--passes", nargs="+", choices=("host", "profile"),
                        default=["host", "profile"],
                        help="--train: the host-clock steps, the profiled step, or both")
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
    if args.train:
        results = train_main(args, rank, world, dev, idle, card)
        if rank == 0 and args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        dist.barrier(group=idle)
        dist.destroy_process_group()
        return
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
