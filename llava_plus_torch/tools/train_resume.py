"""LLaVA-1.5 stage 2 (``scripts/v1_5/finetune.sh``) cut after a save and
resumed by a fresh process, through the trainer's own entry point, against
the same run never cut.

    python -m llava_plus_torch.tools.train_resume [--out FILE]   # point 1: one card
    python -m llava_plus_torch.tools.train_resume --point 2 [--out FILE]   # four cards
    python -m llava_plus_torch.tools.train_resume --device cpu --tiny   # both, on the host

Point 1 is LLaVA-1.5-7B at full width and depth on one card: 32 layers,
width 4,096, FFN 11,008, CLIP-L/336 and an mlp2x_gelu projector. The
recipe's 16 rows a device are cut to ``ROWS_1`` rows a micro-batch with
gradient accumulation over ``ACCUM_1`` making up the 16 rows of a step,
under ``train_13b_mesh.bound``. Point 2 is LLaVA-1.5-13B stage 2 as
``train_13b_mesh.py`` runs it, under ``torchrun`` at (1, 4, 1) with 16 rows
a rank, cut to ``LAYERS_2`` of its 40 layers so that its state fits the
write budget; each rank writes its own shards (``torch.distributed.
checkpoint``). ``--tiny`` runs the tiny test config instead (point 2 over 4
gloo ranks on the host).

This process writes, under ``--work``, a corpus of image records of about
700 to 2,048 fused tokens and a random stage-1 ``mm_projector.bin``
(``--tiny``: also a tiny CLIP tower directory), and refuses to start when
the training state would pass ``WRITE_BUDGET_GB`` with what it has
written.
Then two fresh processes (``torchrun`` launches for point 2) run
``train.main`` with ``finetune.sh``'s flags (the port's launcher), the
inputs named by this run, ``--save-steps 2 --max-steps 4``, and the base
language model built in memory on the card by the ``build_model`` hook of
``train_13b_mesh.in_memory_base``:

- A trains steps 1-4 and writes ``checkpoint-2``'s whole training state
  (parameters, AdamW's two moments, the count) on the way;
- B finds ``checkpoint-2`` through ``checkpoint.latest_checkpoint``,
  restores it and trains steps 3-4.

Each is cut at step 4 by its ``on_step`` hook raising :class:`Cut`, before
the step's save and the final export: only that exception counts as the
planned cut. Each records every step's loss, ``grad_norm``, non-pad tokens,
host ms and sample ids (the trainer's ``on_data`` hook), a digest of its
trained leaves and their moments (a rank's local shards) after steps 2 and
4 and, for B, of the state it restored; the save's and the restore's
seconds and bytes; its peak device and host memory; the flash launches;
the GB it passed to ``write()``. A's first rank also has the allocator
record step 2 on the card and reports what made its peak
(:func:`peak_parts`). Before the save, A checks the state's
bytes and what the run has written against the budget.

One JSON line a process (rank), then one with the checks: B's restored
state equal to A's after step 2; B's steps 3-4 equal to A's bit for bit in
loss, ``grad_norm``, non-pad tokens and sample ids, and so are the digests
after step 4; the flash forward, dK/dV and dQ launched 2L / L / L times a
micro-batch; every peak under the bound; the run's writes under the
budget. A failed check exits non-zero. The tool runs on the card unless
``--device cpu`` asks for the host; without a CUDA device it exits. It
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from llava_plus_torch.models.configs import LLAVA_15_7B, LlavaConfig
from llava_plus_torch.tools import common
from llava_plus_torch.tools import train_13b_mesh as mesh_tool

SCRIPT = "v1_5/finetune.sh"
STEPS, SAVE_STEPS = 4, 2
ROWS_1, ACCUM_1 = 4, 4          # point 1: 16 rows a step on one card
ROWS_2, WORLD_2 = 16, 4         # point 2: 16 rows a rank, (1, 4, 1)
LAYERS_2 = 10                   # point 2: 13B at 10 of its 40 layers
WRITE_BUDGET_GB = 45 * 2 ** 30 / 1e9   # a call on the card's machine ends past 45 GiB
PROCESS_TIMEOUT_S = 1500               # A or B (a torchrun of it), each
DIGEST_CHUNK = 1 << 24
HISTORY_ENTRIES = 1 << 21               # allocator events kept for the peak's parts


class Cut(Exception):
    """The planned cut: raised by the ``on_step`` hook at the last step."""


def point_config(point: int, tiny: bool) -> LlavaConfig:
    if tiny:
        return mesh_tool.run_config(True)
    return LLAVA_15_7B if point == 1 else mesh_tool.run_config(False, LAYERS_2)


def point_shape(point: int, tiny: bool):
    """(rows a micro-batch a rank, accumulation, ranks)."""
    if point == 1:
        return (2, 2, 1) if tiny else (ROWS_1, ACCUM_1, 1)
    return (2 if tiny else ROWS_2), 1, WORLD_2


def state_gb(cfg: LlavaConfig) -> float:
    """GB of the whole training state: the trained leaves (the language
    model and the projector) with AdamW's two moments in their dtype, and
    the frozen tower, in bf16."""
    st = mesh_tool.state_bytes(cfg, None)
    return (3 * (st["language_model"] + st["mm_projector"]) + st["vision_tower"]) / 1e9


# ---------------------------------------------------------------------------
# A process of the run (A or B; a rank of it for point 2)
# ---------------------------------------------------------------------------

def peak_parts(trace, base_bytes: int, top: int = 24) -> dict:
    """What made the highest point of an allocator trace (one device's
    ``torch.cuda.memory._snapshot()["device_traces"]``, recorded with
    Python stacks from ``base_bytes`` allocated on): the blocks allocated
    in the trace and live at its peak, grouped by size and by the innermost
    frames that allocated them (the port's innermost frame -> the
    innermost frame, when that is another's), the largest groups first.
    A block is live from its ``alloc`` to its ``free_requested``, as the
    allocator's count of allocated bytes has it."""
    now = peak = peak_at = 0
    for i, e in enumerate(trace):
        if e["action"] in ("alloc", "free_requested"):
            now += e["size"] if e["action"] == "alloc" else -e["size"]
            if now > peak:
                peak, peak_at = now, i + 1
    live = {}
    for e in trace[:peak_at]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested":
            live.pop(e["addr"], None)

    def where(frames):
        frames = [f for f in frames if f["filename"].endswith(".py")]
        ours = next((f for f in frames if "llava_plus_torch" in f["filename"]), None)
        names = [f"{f['filename'].rsplit('llava_plus_torch/', 1)[-1].rsplit('-packages/', 1)[-1]}"
                 f":{f['line']} {f['name']}"
                 for f in ([ours] if ours else []) + ([frames[0]] if frames else [])]
        return " -> ".join(dict.fromkeys(names)) or "(no Python frame)"

    groups = {}
    for e in live.values():
        g = groups.setdefault((where(e.get("frames", [])), e["size"]), [0, 0])
        g[0] += 1
        g[1] += e["size"]
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][1])
    return {"base_gib": base_bytes / 2 ** 30, "peak_gib": (base_bytes + peak) / 2 ** 30,
            "in_trace_gib": peak / 2 ** 30, "events": len(trace),
            "live_in_trace_gib": sum(e["size"] for e in live.values()) / 2 ** 30,
            "groups": [{"where": w, "block_mib": size / 2 ** 20, "count": n, "gib": b / 2 ** 30}
                       for (w, size), (n, b) in ranked[:top]],
            "rest_gib": sum(b for _, (_, b) in ranked[top:]) / 2 ** 30}


def digest(leaves) -> str:
    """A digest of the leaves' bits (a DTensor's local shard): per leaf the
    sum of its 16- or 32-bit words and their sum weighted by position,
    chunk by chunk on the leaves' device, hashed in order."""
    from torch.distributed.tensor import DTensor

    sums = []
    for x in leaves:
        x = (x.to_local() if isinstance(x, DTensor) else x).detach().contiguous().view(-1)
        words = x.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                        8: torch.int64}[x.element_size()])
        s0 = torch.zeros((), dtype=torch.int64, device=x.device)
        s1 = torch.zeros((), dtype=torch.int64, device=x.device)
        for c, at in enumerate(range(0, words.numel(), DIGEST_CHUNK)):
            w = words[at:at + DIGEST_CHUNK].to(torch.int64)
            pos = torch.arange(1, w.numel() + 1, dtype=torch.int64, device=x.device)
            s0 += w.sum()
            s1 += (w * pos).sum() * (c + 1)
        sums += [s0, s1]
    values = torch.stack(sums).tolist() if sums else []
    return hashlib.sha256(json.dumps(values).encode()).hexdigest()


def state_digest(params, opt_state) -> dict:
    """The optimizer's count and digests of the trained leaves and of
    their two moments."""
    from llava_plus_torch.train.optimizer import tree_leaves

    keys = list(opt_state["mu"])
    return {"count": opt_state["count"],
            "params": digest([x for k in keys for x in tree_leaves(params[k])]),
            "mu": digest([x for k in keys for x in tree_leaves(opt_state["mu"][k])]),
            "nu": digest([x for k in keys for x in tree_leaves(opt_state["nu"][k])])}


class Watch:
    """What a process observes while ``train.main`` runs: the steps (from
    ``on_step`` / ``on_data``), the digests after the optimizer's updates
    2 and 4 (``train.build_optimizer`` wrapped), the save (seconds, bytes,
    host memory; the budget checked before it) and the restore (seconds,
    its digest), ``checkpoint``'s two functions wrapped. With
    ``breakdown`` (on the card) the allocator records step 2 and
    :func:`peak_parts` reads its peak."""

    def __init__(self, dev, state_gb_total: float, written_before_gb: float,
                 breakdown: bool = False):
        self.dev, self.state_gb, self.before = dev, state_gb_total, written_before_gb
        self.steps, self.ids, self.digests = {}, {}, {}
        self.save = self.restore = self.peak_parts = None
        self.breakdown = breakdown and dev.type == "cuda"

    def _peak(self, reset=False):
        return mesh_tool._peak_gib(self.dev, reset)

    def on_data(self, step, epoch, ids):
        self.ids[step] = {"epoch": epoch, "sample_ids": ids}

    def on_step(self, step, metrics, seconds, arrays):
        self.steps[step] = {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                            "non_pad_tokens": int((arrays["segment_ids"] > 0).sum()),
                            "shape": list(arrays["tokens"].shape), "host_ms": seconds * 1e3,
                            "peak_gib": self._peak(reset=True), **self.ids[step]}
        if self.breakdown and step == SAVE_STEPS - 1:
            torch.cuda.synchronize(self.dev)
            self.base = torch.cuda.memory_allocated(self.dev)
            torch.cuda.memory._record_memory_history(stacks="python",
                                                     max_entries=HISTORY_ENTRIES)
        elif self.breakdown and step == SAVE_STEPS:
            trace = torch.cuda.memory._snapshot()["device_traces"][self.dev.index]
            torch.cuda.memory._record_memory_history(enabled=None)
            self.peak_parts = {"step": step, **peak_parts(trace, self.base)}
        if step == STEPS:
            raise Cut(f"cut at step {step}")

    def __enter__(self):
        from llava_plus_torch.train import checkpoint
        from llava_plus_torch.train import train as train_lib

        self.modules = (checkpoint, train_lib)
        self.real = (checkpoint.save_train_state, checkpoint.restore_train_state,
                     train_lib.build_optimizer)
        real_save, real_restore, real_build = self.real

        def save(ckpt_dir, step, params, opt_state=None, cfg=None, position=None):
            written = common.written_gb()
            if self.before + written + self.state_gb > WRITE_BUDGET_GB:
                raise RuntimeError(f"the save of {self.state_gb:.2f} GB after "
                                   f"{self.before + written:.2f} GB written would pass the "
                                   f"{WRITE_BUDGET_GB:.2f} GB budget")
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            t0 = time.perf_counter()
            path = real_save(ckpt_dir, step, params, opt_state, cfg, position)
            seconds = time.perf_counter() - t0
            files = [p for p in path.rglob("*") if p.is_file()]
            nbytes = sum(p.stat().st_size for p in files
                         if p.name not in ("meta.json", "config.json"))
            self.save = {"step": step, "seconds": seconds, "bytes": nbytes,
                         "gb_per_s": nbytes / 1e9 / seconds,
                         "written_gb": common.written_gb() - written,
                         "files": len(files), "position": position,
                         "host_peak_rss_gb_after": common.host_peak_gb()}
            return path

        def restore(path, params_like, opt_state_like=None, timings=None):
            timings = {} if timings is None else timings
            t0 = time.perf_counter()
            state, step = real_restore(path, params_like, opt_state_like, timings)
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            self.restore = {"checkpoint": Path(path).name, "step": step,
                            "seconds": time.perf_counter() - t0, **timings,
                            "position": json.loads((Path(path) / "meta.json").read_text()),
                            "host_peak_rss_gb_after": common.host_peak_gb(),
                            "digest": state_digest(state["params"], state["opt_state"])}
            return state, step

        def build(params, cfg):
            opt = real_build(params, cfg)
            update = opt.update

            def update_and_digest(grads, state, params):
                state = update(grads, state, params)
                if state["count"] in (SAVE_STEPS, STEPS):
                    self.digests[state["count"]] = state_digest(params, state)
                return state

            opt.update = update_and_digest
            return opt

        checkpoint.save_train_state, checkpoint.restore_train_state = save, restore
        train_lib.build_optimizer = build
        return self

    def __exit__(self, *exc):
        checkpoint, train_lib = self.modules
        checkpoint.save_train_state, checkpoint.restore_train_state, train_lib.build_optimizer = (
            self.real)


def cut_run(argv, build_model, dev, state_gb_total: float = 0.0,
            written_before_gb: float = 0.0, breakdown: bool = False) -> dict:
    """``train.main(argv)`` with the ``build_model`` hook until the planned
    cut, observed by a :class:`Watch`, the flash launch counts set to 0
    before it; this process's record of the run (with ``breakdown``, the
    parts of step 2's peak)."""
    from llava_plus_torch.ops import flash_attention as fa
    from llava_plus_torch.train import train as train_lib

    cuda = dev.type == "cuda"
    for k in (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq):
        k.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    w0, t0 = common.written_gb(), time.perf_counter()
    cut = None
    with Watch(dev, state_gb_total, written_before_gb, breakdown) as watch:
        try:
            train_lib.main(argv, build_model=build_model, on_step=watch.on_step,
                           on_data=watch.on_data)
        except Cut as e:
            cut = str(e)
    if cuda:
        torch.cuda.synchronize(dev)
    peaks = [s["peak_gib"] for s in watch.steps.values()]
    first = min(watch.steps) if watch.steps else None
    return {"cut": cut, "steps": {str(k): v for k, v in sorted(watch.steps.items())},
            "first_step_host_ms": watch.steps[first]["host_ms"] if first else None,
            "host_ms_after_first": [s["host_ms"] for k, s in sorted(watch.steps.items())
                                    if k != first],
            "digests": {str(k): v for k, v in watch.digests.items()},
            "save": watch.save, "restore": watch.restore, "peak_parts": watch.peak_parts,
            "launches": dict(zip(("fwd", "dkv", "dq"), mesh_tool._flash_counts())),
            "peak_gib": max(peaks) if cuda and peaks else None,
            "host_peak_rss_gb": common.host_peak_gb(), "written_gb": common.written_gb(),
            "written_gb_train": common.written_gb() - w0, "seconds": time.perf_counter() - t0}


def pair_checks(a: dict, b: dict) -> dict:
    """A's and B's records (of one rank) against each other: both cut at
    step 4, A saved ``checkpoint-2`` and B restored it (and saved nothing),
    B's restored state equal to A's after step 2, B's steps 3-4 equal to
    A's bit for bit (loss, ``grad_norm``, non-pad tokens, sample ids and
    epoch), and the digests after step 4 equal."""
    keys = ("loss", "grad_norm", "non_pad_tokens", "sample_ids", "epoch")
    late = [str(s) for s in range(SAVE_STEPS + 1, STEPS + 1)]
    restored = (b["restore"] or {}).get("digest")
    return {
        "cut_at_step_4": all(r["cut"] is not None and list(r["steps"])[-1:] == [str(STEPS)]
                             for r in (a, b)),
        "a_saved_checkpoint_2": a["save"] is not None and a["save"]["step"] == SAVE_STEPS,
        "b_restored_checkpoint_2": (b["restore"] is not None and b["save"] is None
                                    and b["restore"]["checkpoint"] == f"checkpoint-{SAVE_STEPS}"),
        "b_trained_steps_3_4": list(b["steps"]) == late,
        "restored_equals_a_after_step_2": (restored is not None
                                           and restored == a["digests"].get(str(SAVE_STEPS))),
        "steps_3_4_bit_for_bit": all(
            s in a["steps"] and s in b["steps"]
            and all(a["steps"][s][k] == b["steps"][s][k] for k in keys) for s in late),
        "digests_after_step_4_equal": (str(STEPS) in a["digests"]
                                       and a["digests"][str(STEPS)] == b["digests"].get(str(STEPS))),
        "losses_finite": all(math.isfinite(s["loss"]) for r in (a, b)
                             for s in r["steps"].values()),
    }


def run_role(args) -> None:
    """A or B (a rank of it): :func:`cut_run` on this point's recipe;
    writes this process's record to ``<work>/<role>-<rank>.json``."""
    import torch.distributed as dist

    from llava_plus_torch.data.debug_tokenizer import DebugTokenizer

    cuda = args.device == "cuda"
    rank, world = int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        if rank == 0:
            from llava_plus_torch.kernels import build

            build.lib()   # built once, before the other ranks load it
    mesh = None
    if world > 1:
        from llava_plus_torch.parallel.mesh import make_mesh

        dist.init_process_group("nccl" if cuda else "gloo")
        mesh = make_mesh(1, world, 1, device_type="cuda" if cuda else "cpu")
        dist.barrier()
    dev = torch.device(f"cuda:{torch.cuda.current_device()}" if cuda else "cpu")
    cfg = point_config(args.point, args.tiny)
    rows, accum, _ = point_shape(args.point, args.tiny)
    T = cfg.max_sequence_length if args.tiny else 2048
    b = mesh_tool.bound(cfg, rows, T, mesh, accum)
    work = Path(args.work).resolve()
    data, proj = work / "data" / "data.json", work / "mm_projector.bin"
    tower = (work / "tower") if args.tiny else "openai/clip-vit-large-patch14-336"
    flags = dict(model_name_or_path=mesh_tool.BASE_NAME, data_path=data,
                 image_folder=data.parent, vision_tower=tower, pretrain_mm_mlp_adapter=proj,
                 output_dir=work / "out", per_device_train_batch_size=rows * world,
                 gradient_accumulation_steps=accum, save_steps=SAVE_STEPS, max_steps=STEPS,
                 device=args.device)
    if world > 1:
        flags["fsdp_axis"] = world
    if args.tiny:
        flags["model_max_length"] = T
    argv, _ = common.script_argv(SCRIPT, **flags)
    build_model = mesh_tool.in_memory_base(cfg.text, DebugTokenizer(vocab_size=cfg.text.vocab_size))
    record = {
        "role": args.role, "rank": rank, "point": args.point, "card": args.card,
        "config": {"layers": cfg.text.num_hidden_layers, "hidden": cfg.hidden_size,
                   "ffn": cfg.text.intermediate_size, "heads": cfg.text.num_attention_heads,
                   "tiny": args.tiny},
        "argv": argv, "rows": rows, "accum": accum, "world": world,
        **cut_run(argv, build_model, dev, args.state_gb, args.written_before,
                  breakdown=args.role == "A" and rank == 0),
        "bound_gib": b["total"] / 2 ** 30,
        "bound_parts_gib": {k: v / 2 ** 30 for k, v in b.items()},
    }
    (work / f"{args.role}-{rank}.json").write_text(json.dumps(record))
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()
    if record["cut"] is None:
        raise SystemExit(f"train_resume: process {args.role} was not cut at step {STEPS}")


# ---------------------------------------------------------------------------
# The run: inputs, the two processes, the checks
# ---------------------------------------------------------------------------

def checks(cfg: LlavaConfig, lines_a, lines_b, written_gb: float, cuda: bool) -> dict:
    """The run's checks: :func:`pair_checks` on every rank, the run's
    writes under the budget and, on the card, the flash launches (2L / L /
    L a micro-batch) and every peak under its bound."""
    L, accum = cfg.text.num_hidden_layers, lines_a[0]["accum"]
    pairs = [pair_checks(a, b) for a, b in zip(lines_a, lines_b)]
    out = {k: all(p[k] for p in pairs) for k in pairs[0]}
    out["writes_under_budget"] = written_gb <= WRITE_BUDGET_GB
    if cuda:
        def launches(n_steps):
            return {"fwd": 2 * L * accum * n_steps, "dkv": L * accum * n_steps,
                    "dq": L * accum * n_steps}

        out["flash_launches"] = (all(a["launches"] == launches(STEPS) for a in lines_a)
                                 and all(b["launches"] == launches(STEPS - SAVE_STEPS)
                                         for b in lines_b))
        out["peaks_under_bound"] = all(r["peak_gib"] <= r["bound_gib"]
                                       for r in lines_a + lines_b)
    return out


def _launch(args, role: str, world: int, written_before: float, state: float):
    cmd = [sys.executable, "-m", "llava_plus_torch.tools.train_resume"]
    if world > 1:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(world), "-m", "llava_plus_torch.tools.train_resume"]
    cmd += ["--role", role, "--point", str(args.point), "--device", args.device,
            "--work", str(args.work), "--card", args.card,
            "--written-before", repr(written_before), "--state-gb", repr(state)]
    if args.tiny:
        cmd.append("--tiny")
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, timeout=PROCESS_TIMEOUT_S,
                   env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                       filter(None, [str(Path(__file__).resolve().parents[2]),
                                     os.environ.get("PYTHONPATH")]))))
    return time.perf_counter() - t0


def run_point(args) -> list:
    """Point ``args.point``: the inputs, A, B and the checks; prints one
    line a process and the checks' line, and returns them."""
    cuda = args.device == "cuda"
    cfg = point_config(args.point, args.tiny)
    rows, accum, world = point_shape(args.point, args.tiny)
    work = Path(args.work).resolve()
    shutil.rmtree(work, ignore_errors=True)
    w0, t0 = common.written_gb(), time.perf_counter()
    data = mesh_tool.write_corpus(work / "data", rows * accum * world * STEPS,
                                  cfg.vision.image_size, args.tiny)
    mesh_tool.write_projector(work / "mm_projector.bin", cfg)
    if args.tiny:
        from llava_plus_torch.models import clip_vit

        common.write_tower(work / "tower", clip_vit.init_params(
            cfg.vision, torch.Generator().manual_seed(1), "cpu", torch.float32), cfg.vision)
    inputs_s, written_inputs = time.perf_counter() - t0, common.written_gb() - w0
    state = state_gb(cfg)
    if common.written_gb() + state > WRITE_BUDGET_GB:
        raise SystemExit(f"train_resume: a state of {state:.2f} GB after "
                         f"{common.written_gb():.2f} GB written would pass the "
                         f"{WRITE_BUDGET_GB:.2f} GB budget")
    a_s = _launch(args, "A", world, common.written_gb(), state)
    lines_a = [json.loads((work / f"A-{r}.json").read_text()) for r in range(world)]
    written = common.written_gb() + sum(r["written_gb"] for r in lines_a)
    b_s = _launch(args, "B", world, written, state)
    lines_b = [json.loads((work / f"B-{r}.json").read_text()) for r in range(world)]
    written += sum(r["written_gb"] for r in lines_b)
    for r in lines_a + lines_b:
        print(json.dumps(r), flush=True)
    got = checks(cfg, lines_a, lines_b, written, cuda)
    line = {"point": args.point, "card": args.card, "tiny": args.tiny,
            "config": lines_a[0]["config"], "recipe": SCRIPT,
            "rows_a_step": rows * accum * world, "micro_batch_rows_a_rank": rows,
            "accumulation": accum, "ranks": world, "corpus_records": len(json.loads(
                data.read_text())), "state_gb": state, "inputs_s": inputs_s,
            "inputs_written_gb": written_inputs, "process_a_s": a_s, "process_b_s": b_s,
            "written_gb_run": written, "write_budget_gb": WRITE_BUDGET_GB,
            "checks": got, "ok": all(got.values())}
    print(json.dumps(line), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return lines_a + lines_b + [line]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--point", type=int, choices=(1, 2), default=None,
                        help="1: 7B on one card; 2: 13B at 10 of 40 layers over four (default: "
                             "1, or both with --tiny)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="the tiny test config (with --device cpu, a dry run on the host)")
    parser.add_argument("--work", default=".smoke/train_resume",
                        help="the corpus, the projector and the output (removed at the end)")
    parser.add_argument("--out", default=None, help="also write the lines here")
    # a process of the run (set by the run itself)
    parser.add_argument("--role", choices=("A", "B"), default=None, help=argparse.SUPPRESS)
    parser.add_argument("--card", default="", help=argparse.SUPPRESS)
    parser.add_argument("--written-before", type=float, default=0.0, help=argparse.SUPPRESS)
    parser.add_argument("--state-gb", type=float, default=0.0, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_resume: no CUDA device (pass --device cpu --tiny for a dry run)")
    if args.role is not None:
        return run_role(args)
    args.card = common.describe_device("cuda:0" if args.device == "cuda" else args.device)
    points = [args.point] if args.point else ([1, 2] if args.tiny else [1])
    ok = True
    for p in points:
        lines = run_point(argparse.Namespace(**{**vars(args), "point": p}))
        ok &= lines[-1]["ok"]
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.writelines(json.dumps(line) + "\n" for line in lines)
    if not ok:
        raise SystemExit("train_resume: a check failed (the \"checks\" of a point's last line)")


if __name__ == "__main__":
    main()
