"""LLaVA-1.5-13B stage 2 (``scripts/v1_5/finetune.sh``) over an fsdp mesh
of the cards of one host, through the trainer's own entry point.

    torchrun --standalone --nproc-per-node 4 -m llava_plus_torch.tools.train_13b_mesh \
        [--out FILE]
    torchrun --standalone --nproc-per-node 1 -m llava_plus_torch.tools.train_13b_mesh \
        --layers 10                       # one card, 13B's width at 10 of 40 layers
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m llava_plus_torch.tools.train_13b_mesh --device cpu --tiny   # a dry run, gloo

Rank 0 writes, under ``--work``: a corpus of image records of about 700 to
2,048 fused tokens (noise images; a one-turn question and a long answer,
the prompt masked by the v1 template) and a random stage-1
``mm_projector.bin`` at 1,024 -> 5,120 -> 5,120, as
``checkpoint.export_mm_projector_bin`` writes it (``--tiny``: also a tiny
CLIP tower directory, since the recipe's tower name would give CLIP-L).
Before the steps it holds the flash forward, dK/dV and dQ kernels at a
rank's own shape (``--rows`` rows of 2,048, 40 heads of 128, padded rows of
the corpus's lengths) against their plain versions and an f64 truth, by
``chip_smoke.py`` phase 3's criterion ``max(2.5 x plain error, 2e-3)``, a
second launch bit for bit the first.

Then every rank runs ``train.main`` with ``finetune.sh``'s flags (the
port's launcher, read from ``llava_plus_torch/scripts/``), the base, data,
projector and output named by this run, ``--per-device-train-batch-size``
the GLOBAL batch (``--rows`` a rank; ``place_batch`` shards it),
``--fsdp-axis`` the world size, ``--max-steps 3`` and ``--save-only-model
true``. The base language model (vicuna-13b-v1.5's shape, random from seed
0) is built in memory on each rank's card by the ``build_model`` hook, the
trainer's own ``build_model`` with the builder's loader handing it back:
the tower is then the recipe's (its name: random from seed 0, with the
builder's warning) and the projector the file's. A base read from disk
would cost the call 26 GB of its 45 GiB of writes beside the 26.7 GB
export; the read itself is checked elsewhere (``chip_smoke.py`` phase 28).
``place_params`` keeps each rank's shards.

Rank 0 prints one JSON line a rank: each step's loss, ``grad_norm``,
non-pad tokens, host ms and non-pad tokens/s; the peak device memory of
the run and of each step against :func:`bound`, reckoned before the steps;
the host's peak resident memory; the flash launches of the run; the last
step profiled (device ms by class: GEMM, flash, NCCL, other; launches by
kernel; device busy with and without NCCL, and the idle share each way);
the GB passed to ``write()``; rank 0's line also the export's gather and
write (seconds, bytes), the kernel checks and the run's checks:

- every loss finite;
- step 1 against the same seed-0 tree on one card (rank 0's; the batch
  cut into ``REF_ROWS`` rows at a time, each chunk's loss scaled by its
  share of the batch's valid tokens): the loss within ``LOSS_RTOL``, the
  f32 norm of every trained gradient within ``GRAD_RTOL``, the projector's
  gradient within ``PROJ_GRAD_RTOL`` (relative Frobenius);
- step 1's update of the projector, gathered, against the port's AdamW
  applied on one card to the same gathered gradient: the parameters within
  ``PARAM_ULPS`` bf16 steps and both moments within ``MOMENT_ULPS`` (the
  group's clipping norm is summed shard by shard over the mesh and may
  round one step apart), and some parameter moved;
- the HF export read back by ``builder.load_pretrained_model`` equal, bit
  for bit, to the tree ``train.main`` returns, gathered;
- every rank's peak under :func:`bound`; each flash kernel launched 2L /
  L / L times a step (remat) on every rank.

A failed check exits non-zero on every rank. The script runs on the cards
unless ``--device cpu`` asks for the host; without a CUDA device it exits.
It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import gc
import json
import math
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from llava_plus_torch.models import llama
from llava_plus_torch.models.configs import LLAVA_15_13B, LlavaConfig, tiny_llava_config
from llava_plus_torch.tools import common

SCRIPT = "v1_5/finetune.sh"
BASE_NAME = "vicuna-13b-v1.5"   # the base's name; its weights are built in memory
STEPS = 3
ROWS_A_RANK = 16                # the reference's rows a GPU
REF_ROWS = 8                    # rows a chunk of the one-card backward
LOSS_RTOL = 1e-5                # step 1's loss against the one-card forward
GRAD_RTOL = 1e-3                # the f32 norm of every trained gradient
PROJ_GRAD_RTOL = 1e-2           # the projector's gradient, relative Frobenius
PARAM_ULPS = 1                  # the projector after the update: bf16 steps apart
MOMENT_ULPS = 4                 # its two moments
HBM_BYTES_S = 3.35e12           # H100 SXM: HBM3 bytes/s
BF16_FLOPS_S = 989e12           # H100 SXM: dense bf16 FLOP/s
HEAD_DIM = 128


# ---------------------------------------------------------------------------
# The recipe and its inputs
# ---------------------------------------------------------------------------

def run_config(tiny: bool, layers=None) -> LlavaConfig:
    """LLaVA-1.5-13B (``layers`` of its 40, when given), or the tiny test
    config with 4 kv heads (so that 4 ranks could split them)."""
    if tiny:
        cfg = tiny_llava_config()
        return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_key_value_heads=4))
    cfg = LLAVA_15_13B
    if layers:
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                                num_hidden_layers=layers))
    return cfg


def write_corpus(root: Path, n: int, size: int, tiny: bool, seed: int = 25) -> Path:
    """``n`` image records under ``root``: a PNG of noise and one turn, a
    question of 5-15 words and an answer long enough for about 700 to 2,048
    fused tokens at 576 image tokens (``tiny``: 10 to 60 words). Returns
    the ``data.json`` path."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)

    def words(k):
        return " ".join(f"w{int(j)}" for j in rng.integers(0, 20000, k))

    lo, hi = (10, 60) if tiny else (60, 1420)
    records = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            root / f"{i}.png", compress_level=1)
        records.append({"id": str(i), "image": f"{i}.png", "conversations": [
            {"from": "human", "value": "<image>\n" + words(int(rng.integers(5, 16))) + "?"},
            {"from": "gpt", "value": words(int(rng.integers(lo, hi))) + "."}]})
    path = root / "data.json"
    path.write_text(json.dumps(records))
    return path


def write_projector(path: Path, cfg: LlavaConfig, seed: int = 1) -> Path:
    """A random stage-1 ``mm_projector.bin`` of ``cfg``'s projector (tower
    width -> language model width), as the stage-1 save writes it."""
    from llava_plus_torch.models import projector
    from llava_plus_torch.train import checkpoint

    proj = projector.init_params(cfg.mm_projector_type, cfg.mm_hidden_size, cfg.hidden_size,
                                 torch.Generator().manual_seed(seed), "cpu", torch.float32)
    return checkpoint.export_mm_projector_bin({"mm_projector": proj}, path)


def in_memory_base(text_cfg, tokenizer):
    """A ``build_model`` hook: the trainer's own ``build_model`` with the
    builder's loader handing back a plain language model of ``text_cfg``,
    random from seed 0 on the training device (the tree a plain LLaMA
    checkpoint loads as), so that the tower and the projector come from the
    recipe's flags as they would from a base on disk."""
    from llava_plus_torch.models import builder
    from llava_plus_torch.train import train as train_lib

    def load(path, *args, dtype="bfloat16", device="cpu", **kw):
        lm = llama.init_params(text_cfg, torch.Generator(device=device).manual_seed(0), device,
                               dtype)
        return (tokenizer, {"language_model": lm, "vision_tower": {}, "mm_projector": {}},
                LlavaConfig(text=text_cfg, mm_projector_type="identity"), None, None)

    def build_model(model_args, dtype, device, seed=42):
        real = builder.load_pretrained_model
        builder.load_pretrained_model = load
        try:
            return train_lib.build_model(model_args, dtype, device, seed)
        finally:
            builder.load_pretrained_model = real

    return build_model


# ---------------------------------------------------------------------------
# The bound, reckoned before the steps
# ---------------------------------------------------------------------------

def state_bytes(cfg: LlavaConfig, mesh) -> dict:
    """This rank's bytes of the bf16 tree by subtree (``language_model``,
    ``mm_projector``, ``vision_tower``): the local shards that
    ``train/step.place_params`` gives it over ``mesh`` (the whole tree
    without one), placed as meta tensors (no memory, no communication)."""
    from torch.distributed.tensor import DTensor

    from llava_plus_torch.models import llava as llava_model
    from llava_plus_torch.train import step as step_lib
    from llava_plus_torch.train.optimizer import tree_leaves

    tree = llava_model.init_params(cfg, None, "meta")
    if mesh is not None:
        tree = step_lib.place_params(tree, mesh, cfg)
    return {k: sum((x.to_local() if isinstance(x, DTensor) else x).numel() * x.element_size()
                   for x in tree_leaves(v)) for k, v in tree.items()}


def bound(cfg: LlavaConfig, rows: int, T: int, mesh, accum: int = 1) -> dict:
    """The most device memory a rank's step may take at ``rows`` rows of
    ``T`` a micro-batch, ``accum`` micro-batches a step (bytes, by part),
    in bf16:

    - ``kept``: the trained leaves (the language model and the projector)
      three times (parameter and AdamW's two moments, in the parameters'
      dtype in the bf16 recipes) and the frozen tower, all as
      :func:`state_bytes` gives them;
    - ``grads``: the trained leaves' gradients, held from the layers'
      backward to the update;
    - ``saved``: each layer's input, kept for the remat backward;
    - ``head``: at the head's backward, before any layer's gradient
      exists, the f32 log-softmax the loss keeps, the f32 gradient that
      ``nll_loss``'s backward gives it and the one that log-softmax's
      backward makes of the two (three f32 [rows, T, V]), and the final
      norm's f32 input and product and its bf16 output, kept for its
      backward (a memory trace of the step at 13B's width shows these);
    - ``layer``: one layer's recompute and its gradients, counted as 3 F-
      and 8 D-wide bf16 activations, twice;
    - ``gathered``: a layer's weights gathered whole and its weight
      gradients before the reduce-scatter, and the whole tower.

    ``total`` is ``kept`` + ``saved`` + ``gathered`` + the larger of
    ``head`` and ``grads`` + ``layer``. Under gradient accumulation the
    summed gradients are held from the first micro-batch on, beside the
    head's backward of the next: ``grads`` then stands outside the
    larger."""
    t = cfg.text
    D, F, V, L = t.hidden_size, t.intermediate_size, t.vocab_size, t.num_hidden_layers
    kv = t.num_key_value_heads * t.head_dim
    layer_params = D * D + 2 * D * kv + D * D + 3 * D * F
    whole_tower = state_bytes(cfg, None)["vision_tower"]
    st = state_bytes(cfg, mesh)
    trained = st["language_model"] + st["mm_projector"]
    parts = {"kept": 3 * trained + st["vision_tower"],
             "grads": trained,
             "saved": L * rows * T * D * 2,
             "head": rows * T * (V * (4 + 4 + 4) + D * (4 + 4 + 2)),
             "layer": 2 * rows * T * (3 * F + 8 * D) * 2,
             "gathered": 2 * layer_params * 2 + whole_tower}
    held = parts["grads"] if accum > 1 else 0
    parts["total"] = (parts["kept"] + parts["saved"] + parts["gathered"] + held
                      + max(parts["head"], parts["grads"] - held + parts["layer"]))
    return parts


# ---------------------------------------------------------------------------
# The flash kernels at a rank's shape
# ---------------------------------------------------------------------------

def _within(kernel_err, plain_err):
    return kernel_err <= max(2.5 * plain_err, 2e-3)


def _bound(nbytes, flops):
    """The least ms the card could take to move ``nbytes`` and do ``flops``
    bf16 operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def flash_bounds(B: int, T: int, H: int, lengths) -> dict:
    """The bounds of the flash forward, dK/dV and dQ at [B, T, H, 128]
    bf16, causal, row b valid for its first ``lengths[b]`` tokens: each
    input read once and each output written once (a [B, T, H, D] bf16
    tensor each of q, k, v, out / dO, dQ, dK, dV; the f32 lse and delta
    [B, H, T]; the int32 segment ids [B, T] of queries and keys), and the
    causal pairs' products (JAX's 4, 8 and 6 x T x T x D a head)."""
    io = B * T * H * HEAD_DIM * 2       # one [B, T, H, D] bf16 tensor
    rows, seg = 4 * B * H * T, 2 * 4 * B * T
    pairs = sum(n * (n + 1) // 2 for n in lengths)
    # q k v -> out lse; q k v dO lse delta -> dK dV; the same -> dQ
    return {"fwd": _bound(4 * io + rows + seg, 4 * H * HEAD_DIM * pairs),
            "dkv": _bound(6 * io + 2 * rows + seg, 8 * H * HEAD_DIM * pairs),
            "dq": _bound(5 * io + 2 * rows + seg, 6 * H * HEAD_DIM * pairs)}


def _event_ms(fn, iters=3):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def check_flash_kernels(B: int, T: int, H: int, lengths, chunk: int = 2) -> dict:
    """The flash forward, dK/dV and dQ kernels on one card at [B, T, H,
    128], causal, row b valid for its first ``lengths[b]`` tokens: each
    launched twice (bit for bit), its error against the f64 truth within
    ``max(2.5 x plain error, 2e-3)``, the plain version and the truth
    computed ``chunk`` rows at a time (the same function: rows are
    independent). Padding rows are left out of the forward's errors and
    must come out 0 in every gradient. Times each kernel, its plain version
    (``chunk`` rows at a time, summed) and the library's call on the same
    tensors (sdpa with the kernels' mask; its one backward gives dQ, dK and
    dV together). Raises AssertionError on a miss."""
    import torch.nn.functional as F

    from llava_plus_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(25)
    dev, D = "cuda", HEAD_DIM
    scale = D ** -0.5
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
                   for _ in range(4))
    seg = torch.zeros(B, T, dtype=torch.int32, device=dev)
    for b, n in enumerate(lengths):
        seg[b, :n] = 1
    kw = dict(causal=True, sm_scale=scale)
    counts = (fa.flash_attention.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    out, lse = fa.flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
    out2, lse2 = fa.flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
    same_fwd = torch.equal(out, out2) and torch.equal(lse, lse2)
    del out2, lse2
    grads = fa.flash_attention_backward(q, k, v, seg, seg, out, lse, do, **kw)
    same_bwd = all(torch.equal(a, b) for a, b in zip(
        grads, fa.flash_attention_backward(q, k, v, seg, seg, out, lse, do, **kw)))
    launched = (fa.flash_attention.launches - counts[0], fa.flash_bwd_dkv.launches - counts[1],
                fa.flash_bwd_dq.launches - counts[2])
    errs = {n: [0.0, 0.0] for n in ("out", "lse", "dq", "dk", "dv")}   # kernel, plain
    zero_pad = True
    for s in range(0, B, chunk):
        c = slice(s, s + chunk)
        qc, kc, vc, dc, sc = q[c], k[c], v[c], do[c], seg[c]
        p_out, p_lse = fa.flash_attention_reference(qc, kc, vc, sc, sc, **kw)
        plain = fa.flash_attention_backward_reference(qc, kc, vc, sc, sc, p_out, p_lse, dc, **kw)
        q64, k64, v64 = qc.double(), kc.double(), vc.double()
        t_out, t_lse = fa.flash_attention_reference(q64, k64, v64, sc, sc, **kw)
        truth = fa.flash_attention_backward_reference(q64, k64, v64, sc, sc, t_out, t_lse,
                                                      dc.double(), **kw)
        live = (sc > 0)[:, :, None, None]
        live_lse = (sc > 0)[:, None, :]

        def err(x, t, mask):
            return torch.where(mask, (x.double() - t).abs(), 0.0).amax().item()

        for name, got, ref, t, mask in (("out", out[c], p_out, t_out, live),
                                        ("lse", lse[c], p_lse, t_lse, live_lse)):
            errs[name][0] = max(errs[name][0], err(got, t, mask))
            errs[name][1] = max(errs[name][1], err(ref, t, mask))
        for name, got, ref, t in zip(("dq", "dk", "dv"), (g[c] for g in grads), plain, truth):
            errs[name][0] = max(errs[name][0], (got.double() - t).abs().max().item())
            errs[name][1] = max(errs[name][1], (ref.double() - t).abs().max().item())
            zero_pad &= torch.where(~live, got.abs(), 0).amax().item() == 0.0
        del p_out, p_lse, plain, t_out, t_lse, truth, q64, k64, v64
    torch.cuda.synchronize()
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    ms = {"fwd": _event_ms(lambda: fa.flash_attention(q, k, v, q_segment_ids=seg,
                                                      kv_segment_ids=seg)),
          "dkv": _event_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, seg, seg, lse, delta, **kw)),
          "dq": _event_ms(lambda: fa.flash_bwd_dq(q, k, v, do, seg, seg, lse, delta, **kw))}

    def plain_fwd():
        for s in range(0, B, chunk):
            c = slice(s, s + chunk)
            fa.flash_attention_reference(q[c], k[c], v[c], seg[c], seg[c], **kw)

    def plain_bwd():
        for s in range(0, B, chunk):
            c = slice(s, s + chunk)
            fa.flash_attention_backward_reference(q[c], k[c], v[c], seg[c], seg[c], out[c],
                                                  lse[c], do[c], **kw)

    plain_ms = {"fwd": _event_ms(plain_fwd, iters=1), "bwd": _event_ms(plain_bwd, iters=1)}
    # the library's attention on the same tensors, heads-major as it takes
    # them, with the kernels' mask (the same segment, a key that is not
    # padding, causal): on every row that is not padding it computes the
    # kernels' function; the copies and the mask are made before the timing
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    pos = torch.arange(T, device=dev)
    mask = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] != 0)
            & (pos[None, :] <= pos[:, None])[None])[:, None]
    with torch.no_grad():
        lib_fwd = _event_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    g_lib = do.transpose(1, 2).contiguous()
    lib_bwd = _event_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), g_lib,
                                                    retain_graph=True))
    del o_lib, qt, kt, vt, g_lib, mask
    library_ms = {"fwd": lib_fwd, "dkv": lib_bwd, "dq": lib_bwd}
    bounds = flash_bounds(B, T, H, lengths)
    # two launches of each kernel above, before the timing
    ok = {"fwd": same_fwd and launched[0] == 2 and _within(*errs["out"])
          and _within(*errs["lse"]),
          "dkv": same_bwd and zero_pad and launched[1] == 2 and _within(*errs["dk"])
          and _within(*errs["dv"]),
          "dq": same_bwd and zero_pad and launched[2] == 2 and _within(*errs["dq"])}
    result = {"shape": f"B={B} T={T} H={H} D={D} causal, rows of {min(lengths)}-{max(lengths)}",
              "errors_kernel_plain": errs, "padding_grads_zero": zero_pad,
              "bit_for_bit_twice": {"fwd": same_fwd, "bwd": same_bwd},
              "ms": ms, "plain_ms": {"fwd": plain_ms["fwd"], "dkv": plain_ms["bwd"],
                                     "dq": plain_ms["bwd"]},
              "library_ms": library_ms,
              "bound_ms": {n: b["bound_ms"] for n, b in bounds.items()},
              "bound_by": {n: b["bound_by"] for n, b in bounds.items()}, "ok": ok}
    if not all(ok.values()):
        raise AssertionError(f"flash kernels at the rank's shape: {result}")
    return result


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def _peak_gib(dev, reset=False):
    if dev.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return peak


def _flash_counts():
    from llava_plus_torch.ops import flash_attention as fa

    return [fa.flash_attention.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches]


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _f32_norm(leaves) -> float:
    """The f32 norm of the whole tensors ``leaves`` (DTensors: over the
    mesh; a collective)."""
    return float(_full(torch.sqrt(sum(x.float().square().sum() for x in leaves))))


class StepRecorder:
    """The trainer's ``on_step`` hook: each step's metrics, host seconds,
    non-pad tokens and peak device memory; the first step's batch; the
    last step profiled on the device (``torch.profiler`` from the report of
    step n - 1 to that of step n)."""

    def __init__(self, dev, n_steps):
        self.dev, self.n_steps = dev, n_steps
        self.steps, self.first, self.prof, self.profile = [], None, None, None
        self.t_last = None

    def __call__(self, step, metrics, seconds, arrays):
        from torch.profiler import ProfilerActivity, profile

        tokens = int((arrays["segment_ids"] > 0).sum())
        self.steps.append({"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                           "accuracy": metrics["accuracy"], "non_pad_tokens": tokens,
                           "shape": list(arrays["tokens"].shape), "host_ms": seconds * 1e3,
                           "non_pad_tokens_per_s": tokens / seconds,
                           "peak_gib": _peak_gib(self.dev, reset=True)})
        if step == 1:
            self.first = {k: np.array(v) for k, v in arrays.items()}
        if self.dev.type == "cuda" and step == self.n_steps - 1:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        elif self.prof is not None and step == self.n_steps:
            torch.cuda.synchronize(self.dev)
            self.prof.__exit__(None, None, None)
            self.profile = self._read(self.prof, seconds * 1e3)
            self.prof = None
        self.t_last = time.perf_counter()

    @staticmethod
    def _read(prof, host_ms):
        got = common.device_ms_by_class(prof)
        with_nccl = sum(got["ms"].values())
        busy = with_nccl - got["ms"]["nccl"]
        return {"host_ms": host_ms, "device_ms_by_class": got["ms"],
                "busy_ms": busy, "busy_ms_with_nccl": with_nccl,
                "idle_share": 1 - busy / host_ms,
                "idle_share_nccl_busy": 1 - with_nccl / host_ms,
                "launches": sum(got["launches"].values()),
                "launches_by_kernel": got["by_kernel"]}


class FirstUpdate:
    """``train.build_optimizer`` wrapped while the trainer runs: at the
    optimizer's first update every rank takes the f32 norm of all the
    gradients it is given, and gathers the projector's parameters before
    and after, its gradient and its two moments after (rank 0 keeps them,
    on the host), and the optimizer's config."""

    def __init__(self, rank):
        from llava_plus_torch.train import train as train_lib

        self.rank, self.train_lib = rank, train_lib
        self.real = train_lib.build_optimizer
        self.seen = None

    def __enter__(self):
        from llava_plus_torch.train.optimizer import tree_leaves, tree_unflatten

        def gather(tree):
            out = [_full(x).to("cpu", copy=True) for x in tree_leaves(tree)]
            return tree_unflatten(tree, out) if self.rank == 0 else None

        def build(params, cfg):
            opt = self.real(params, cfg)
            update = opt.update

            def first(grads, state, params):
                if self.seen is None:
                    seen = {"cfg": cfg, "grad_norm_f32": _f32_norm(
                        [g for k in grads for g in tree_leaves(grads[k])]),
                        "p0": gather(params["mm_projector"]),
                        "g": gather(grads["mm_projector"])}
                    state = update(grads, state, params)
                    seen.update(p1=gather(params["mm_projector"]),
                                mu=gather(state["mu"]["mm_projector"]),
                                nu=gather(state["nu"]["mm_projector"]))
                    self.seen = seen
                    return state
                return update(grads, state, params)

            opt.update = first
            return opt

        self.train_lib.build_optimizer = build
        return self

    def __exit__(self, *exc):
        self.train_lib.build_optimizer = self.real


def bf16_steps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The most bf16 values between ``a`` and ``b`` elementwise (0: equal;
    +0 and -0 are one value)."""
    def ordered(x):
        i = x.bfloat16().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def check_update(seen: dict, device="cpu") -> dict:
    """The projector's update at the first step (``FirstUpdate.seen``: trees
    of the projector on the host) against the port's AdamW applied on one
    device to the same gathered parameters and gradient, with the trainer's
    optimizer config (the projector's group alone: each group is clipped by
    its own norm)."""
    from llava_plus_torch.models.convert import tree_map
    from llava_plus_torch.train.optimizer import AdamW, tree_leaves

    tree = {"mm_projector": tree_map(lambda x: x.to(device).clone(), seen["p0"])}
    grads = {"mm_projector": tree_map(lambda x: x.to(device), seen["g"])}
    opt = AdamW(tree, dataclasses.replace(seen["cfg"], train_language_model=False,
                                          train_vision_tower=False))
    state = opt.update(grads, opt.init(tree), tree)

    def apart(got, want):
        return max(bf16_steps(a, b.cpu()) for a, b in zip(tree_leaves(got), tree_leaves(want)))

    steps = {"param": apart(seen["p1"], tree["mm_projector"]),
             "mu": apart(seen["mu"], state["mu"]["mm_projector"]),
             "nu": apart(seen["nu"], state["nu"]["mm_projector"])}
    p0, p1 = tree_leaves(seen["p0"]), tree_leaves(seen["p1"])
    moved = sum(int((a != b).sum()) for a, b in zip(p1, p0))
    n = sum(x.numel() for x in p0)
    return {"bf16_steps": steps, "moved_share": moved / n,
            "ok": (steps["param"] <= PARAM_ULPS and steps["mu"] <= MOMENT_ULPS
                   and steps["nu"] <= MOMENT_ULPS and moved > 0)}


class Timed:
    """``checkpoint.gathered`` and ``checkpoint.export_hf_llava`` wrapped
    while the trainer runs: the seconds and the GB passed to ``write()`` of
    the export's gather and of its write."""

    def __init__(self):
        from llava_plus_torch.train import checkpoint

        self.ckpt, self.real = checkpoint, (checkpoint.gathered, checkpoint.export_hf_llava)
        self.seen = {"gather_s": 0.0, "write_s": 0.0, "write_gb": 0.0}

    def __enter__(self):
        gathered, export = self.real

        def timed_gathered(*a, **kw):
            t0 = time.perf_counter()
            out = gathered(*a, **kw)
            self.seen["gather_s"] += time.perf_counter() - t0
            return out

        def timed_export(*a, **kw):
            t0, w0 = time.perf_counter(), common.written_gb()
            out = export(*a, **kw)
            self.seen["write_s"] += time.perf_counter() - t0
            self.seen["write_gb"] += common.written_gb() - w0
            return out

        self.ckpt.gathered, self.ckpt.export_hf_llava = timed_gathered, timed_export
        return self

    def __exit__(self, *exc):
        self.ckpt.gathered, self.ckpt.export_hf_llava = self.real


def compare_export(params, export_dir: Path, rank: int) -> dict:
    """The export read back by ``builder.load_pretrained_model`` (rank 0)
    against the trained tree gathered leaf by leaf (a collective over
    every rank), bit for bit."""
    from llava_plus_torch.models import builder

    loaded, t0 = None, time.perf_counter()
    if rank == 0:
        _, loaded, _, _, _ = builder.load_pretrained_model(str(export_dir), dtype="bfloat16")
    read_s = time.perf_counter() - t0
    n = equal = 0
    differ = []
    for path, x in builder._leaf_paths(params):
        full = _full(x)
        if rank == 0:
            got = loaded
            try:
                for p in path:
                    got = got[p]
                same = got.dtype == full.dtype and torch.equal(got, full.cpu())
            except (KeyError, IndexError, TypeError):
                same = False
            n, equal = n + 1, equal + same
            if not same and len(differ) < 8:
                differ.append("/".join(map(str, path)))
        del full
    return {"read_s": read_s, "leaves": n, "equal": equal, "differ": differ,
            "bit_for_bit": rank != 0 or (n > 0 and equal == n)}


def one_card_step(build_model, argv, dtype, dev, arrays, rows: int) -> dict:
    """Step 1's loss and gradients recomputed from the same seed-0 tree on
    this card alone (the same hook, flags and projector file), ``rows``
    rows of the global batch at a time: each chunk's mean loss, scaled by
    its share of the batch's valid tokens, summed and differentiated
    (remat; the language model's gradients summed in the parameters' dtype,
    the projector's in f32). Returns the loss, the f32 norm of every
    trained gradient and the projector's gradient (f32, on the host)."""
    from llava_plus_torch.constants import IGNORE_INDEX
    from llava_plus_torch.models.convert import per_layer
    from llava_plus_torch.models.llava import MultimodalBatch
    from llava_plus_torch.train import step as step_lib
    from llava_plus_torch.train import train as train_lib
    from llava_plus_torch.train.optimizer import tree_leaves

    args = train_lib.build_parser().parse_args(argv)
    margs = train_lib.ModelArguments(**{f.name: getattr(args, f.name)
                                        for f in dataclasses.fields(train_lib.ModelArguments)})
    params, cfg, _ = build_model(margs, dtype, dev, seed=args.seed)
    params = per_layer(params)
    lm, proj = tree_leaves(params["language_model"]), tree_leaves(params["mm_projector"])
    for x in lm + proj:
        x.requires_grad_(True)
    proj_grad = [torch.zeros_like(x, dtype=torch.float32) for x in proj]
    n_valid = float((arrays["labels"][:, 1:] != IGNORE_INDEX).sum())
    total = 0.0
    for s in range(0, arrays["tokens"].shape[0], rows):
        batch = MultimodalBatch(**{k: torch.from_numpy(v[s:s + rows]).to(dev)
                                   for k, v in arrays.items()})
        loss, m = step_lib.loss_fn(params, cfg, batch, remat=True)
        share = float(m["tokens"]) / n_valid
        (loss * share).backward()
        total += float(loss.detach()) * share
        with torch.no_grad():
            for acc, x in zip(proj_grad, proj):
                acc += x.grad.float()
                x.grad = None
        del loss, m, batch
    with torch.no_grad():
        grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in lm] + proj_grad
        out = {"loss": total, "grad_norm_f32": _f32_norm(grads),
               "g_projector": [g.cpu() for g in proj_grad]}
    del params, grads, lm, proj, proj_grad
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true",
                        help="the tiny test config (with --device cpu, a dry run over gloo)")
    parser.add_argument("--layers", type=int, default=None,
                        help="13B's width at this many of its 40 layers")
    parser.add_argument("--rows", type=int, default=ROWS_A_RANK, help="rows a rank a step")
    parser.add_argument("--work", default=".smoke/train_13b_mesh",
                        help="the corpus, the projector and the output (removed at the end)")
    parser.add_argument("--out", default=None, help="also write the rank lines here")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("train_13b_mesh: no CUDA device (pass --device cpu --tiny for a dry run)")
    if "RANK" not in os.environ:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                          MASTER_PORT=str(29500 + os.getpid() % 1000))
    from llava_plus_torch.parallel import tp as tp_lib
    from llava_plus_torch.parallel.mesh import make_mesh

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if cuda else "gloo", timeout=tp_lib.DATA_TIMEOUT)
    idle = dist.new_group(backend="gloo", timeout=datetime.timedelta(hours=1))
    dev = torch.device(f"cuda:{torch.cuda.current_device()}" if cuda else "cpu")
    if cuda and rank == 0:
        from llava_plus_torch.kernels import build

        build.lib()   # built once, before the other ranks load it
    card = common.describe_device(str(dev))
    cfg = run_config(args.tiny, args.layers)
    work = Path(args.work).resolve()
    rows = args.rows
    batch = rows * world
    T = cfg.max_sequence_length if args.tiny else 2048
    b = bound(cfg, rows, T, make_mesh(1, world, 1, device_type=dev.type) if world > 1 else None)
    data, proj = work / "data" / "data.json", work / "mm_projector.bin"
    tower = (work / "tower") if args.tiny else "openai/clip-vit-large-patch14-336"
    t0 = time.perf_counter()
    kernels = "not run: no card"
    if rank == 0:
        from llava_plus_torch.models import clip_vit

        shutil.rmtree(work, ignore_errors=True)
        write_corpus(data.parent, batch * STEPS, cfg.vision.image_size, args.tiny)
        write_projector(proj, cfg)
        if args.tiny:
            common.write_tower(tower, clip_vit.init_params(
                cfg.vision, torch.Generator().manual_seed(1), "cpu", torch.float32), cfg.vision)
    inputs_s = time.perf_counter() - t0
    if rank == 0 and cuda:
        # the corpus's length range, padded to the model's longest row
        lengths = [int(n) for n in np.linspace(700, 2048, rows)]
        kernels = check_flash_kernels(rows, 2048, cfg.text.num_attention_heads, lengths)
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier(group=idle)

    argv_train, _ = common.script_argv(
        SCRIPT, model_name_or_path=BASE_NAME, data_path=data, image_folder=data.parent,
        vision_tower=tower, pretrain_mm_mlp_adapter=proj, output_dir=work / "out",
        per_device_train_batch_size=batch, fsdp_axis=world, max_steps=STEPS,
        save_only_model="true", device=args.device)
    from llava_plus_torch.data.debug_tokenizer import DebugTokenizer
    from llava_plus_torch.ops import flash_attention as fa
    from llava_plus_torch.train import train as train_lib
    from llava_plus_torch.train.optimizer import tree_leaves

    tok = DebugTokenizer(vocab_size=cfg.text.vocab_size)
    build_model = in_memory_base(cfg.text, tok)
    recorder = StepRecorder(dev, STEPS)
    for k in (fa.flash_attention, fa.flash_bwd_dkv, fa.flash_bwd_dq):
        k.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    w0, t0 = common.written_gb(), time.perf_counter()
    with Timed() as timed, FirstUpdate(rank) as first:
        params, _ = train_lib.main(argv_train, build_model=build_model, on_step=recorder)
    if cuda:
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    launches = _flash_counts()
    peak_export = _peak_gib(dev)
    export_s = time.perf_counter() - recorder.t_last
    export_dir = work / "out" / "hf_export"
    export_bytes = (export_dir / "model.safetensors").stat().st_size if rank == 0 else None
    written_train = common.written_gb() - w0

    export_check = compare_export(params, export_dir, rank)
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    step_check = update_check = None
    if rank == 0:
        t1 = time.perf_counter()
        one = one_card_step(build_model, argv_train, torch.bfloat16, dev, recorder.first,
                            min(rows, REF_ROWS))
        seen = first.seen
        got, g_mesh = recorder.steps[0]["loss"], tree_leaves(seen["g"])
        proj_err = math.sqrt(sum(float((a.float() - b.float()).square().sum())
                                 for a, b in zip(g_mesh, one["g_projector"])))
        proj_ref = math.sqrt(sum(float(b.float().square().sum()) for b in one["g_projector"]))
        step_check = {"loss_mesh": got, "loss_one_card": one["loss"],
                      "loss_rel_diff": abs(got - one["loss"]) / abs(one["loss"]),
                      "grad_norm_f32_mesh": seen["grad_norm_f32"],
                      "grad_norm_f32_one_card": one["grad_norm_f32"],
                      "grad_norm_rel_diff": abs(seen["grad_norm_f32"] - one["grad_norm_f32"])
                      / one["grad_norm_f32"],
                      "projector_grad_rel_diff": proj_err / proj_ref,
                      "seconds": time.perf_counter() - t1}
        update_check = check_update(seen, dev)
        del one
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    peaks = [s["peak_gib"] for s in recorder.steps] + [peak_export]
    peak = max(peaks) if cuda else None
    mine = {"rank": rank, "card": card, "steps": recorder.steps,
            "host_ms_after_first": [s["host_ms"] for s in recorder.steps[1:]],
            "peak_gib": peak, "peak_gib_after_steps": peaks[:-1], "peak_gib_export": peak_export,
            "bound_gib": b["total"] / 2 ** 30,
            "bound_parts_gib": {k: v / 2 ** 30 for k, v in b.items()},
            "host_peak_rss_gb": common.host_peak_gb(), "written_gb": common.written_gb(),
            "written_gb_train": written_train, "launches": dict(zip(("fwd", "dkv", "dq"),
                                                                    launches)),
            "profile": recorder.profile or "not measured (no card)",
            "train_s": train_s}
    lines = [None] * world
    dist.all_gather_object(lines, mine, group=idle)
    ok = None
    if rank == 0:
        L = cfg.text.num_hidden_layers
        want = [2 * L * STEPS, L * STEPS, L * STEPS]
        checks = {
            "losses_finite": all(math.isfinite(s["loss"]) for r in lines for s in r["steps"]),
            "steps": all(len(r["steps"]) == STEPS for r in lines),
            "loss_vs_one_card": step_check["loss_rel_diff"] <= LOSS_RTOL,
            "grad_norm_vs_one_card": step_check["grad_norm_rel_diff"] <= GRAD_RTOL,
            "projector_grad_vs_one_card": step_check["projector_grad_rel_diff"]
            <= PROJ_GRAD_RTOL,
            "update_vs_one_card": update_check["ok"],
            "export_bit_for_bit": export_check["bit_for_bit"],
            "peaks_under_bound": (not cuda) or all(r["peak_gib"] <= r["bound_gib"] for r in lines),
            "flash_launches": (not cuda) or all(list(r["launches"].values()) == want
                                                for r in lines),
        }
        ok = all(checks.values())
        for r in lines:
            if r["rank"] == 0:
                r.update(
                    mesh=[1, world, 1], config={"layers": cfg.text.num_hidden_layers,
                                                "hidden": cfg.hidden_size,
                                                "heads": cfg.text.num_attention_heads,
                                                "ffn": cfg.text.intermediate_size,
                                                "tiny": args.tiny},
                    recipe=SCRIPT, argv=argv_train, global_batch=batch, rows_a_rank=rows,
                    kernels_at_rank_shape=kernels, inputs_s=inputs_s,
                    export={"gather_s": timed.seen["gather_s"], "write_s": timed.seen["write_s"],
                            "write_gb": timed.seen["write_gb"], "bytes": export_bytes,
                            "seconds_after_last_step": export_s, **export_check},
                    step_check=step_check, update_check=update_check,
                    written_gb_all_ranks=sum(x["written_gb"] for x in lines),
                    host_peak_rss_gb_all_ranks=[x["host_peak_rss_gb"] for x in lines],
                    checks=checks, ok=ok, seconds=time.perf_counter() - t_start)
            print(json.dumps(r), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("\n".join(json.dumps(r) for r in lines) + "\n")
        shutil.rmtree(work, ignore_errors=True)
    verdict = [ok]
    dist.broadcast_object_list(verdict, src=0, group=idle)
    dist.barrier(group=idle)
    dist.destroy_process_group()
    if not verdict[0]:
        raise SystemExit("train_13b_mesh: a check failed (rank 0's line, \"checks\")")


if __name__ == "__main__":
    main()
