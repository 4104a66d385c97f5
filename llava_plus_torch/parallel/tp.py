"""Tensor-parallel serving: local shards, explicit collectives, and the step
broadcast that keeps one model's ranks in lockstep.

The JAX package serves one model over a ``(1, 1, tp)`` mesh from one
process: ``place_params`` shards the tree and GSPMD inserts the collectives.
Here one process drives each card. The serving tree is cut Megatron-style
into each rank's plain local tensors (:func:`shard_for_serving`): attention
heads and the FFN's columns over ``tp`` for the column-parallel matrices
(``wq``/``wk``/``wv`` or the fused ``wqkv``, ``w_gate``/``w_up`` or
``w_gateup``, MPT's ``wqkv`` and ``up_proj``), the matching rows of the
row-parallel ones (``wo``, ``w_down``, ``out_proj``, ``down_proj``), and the
vocab of the head. The model code then runs on local heads and sums the
row-parallel products over the group (:func:`reduce_partial`: two
all-reduces a layer) and gathers the vocab-parallel logits
(:func:`gather_vocab`), so every rank holds the full logits and samples the
same token. Nothing here is a DTensor: serving's decode loop is host-bound,
and DTensor dispatch doubles a step's host time.

The tree is cut so that each rank's shard is a slice of the whole model:

- fused matrices split by section: rank r takes ``[q_r | k_r | v_r]`` and
  ``[gate_r | up_r]``, never a contiguous run of the fused columns;
- a quantized matrix is quantized whole first (the caller's job) and cut
  after, so a row-parallel int8 matrix keeps the whole matrix's per-column
  scales (int4 block scales go with their rows);
- the FFN dim splits in units of :data:`FFN_UNIT` rows, unevenly where the
  units do not divide (LLaMA-7B's 11008 over 4: 2816, 2816, 2688, 2688),
  since the quantized kernels need K % 128 == 0;
- the vision tower, projector, norms and embedding stay whole on every rank
  (a row gather is exact either way); the head is split over the vocab
  (MPT's and a tied LLaMA's head read their rank's rows of the embedding).

Rank 0 owns serving: the HTTP app, the engine's scheduling, the page
accounting and the prefix cache. Every call that writes device state is an
op that :class:`StepDriver` broadcasts from rank 0, as a pickled
descriptor of host values over a gloo group, before rank 0 runs it; the
followers replay the ops in that order on one thread and return nothing
but their part of the collectives. One lock covers "broadcast the
descriptor" and "run the op", since two threads of rank 0 issue device
work, and collectives issued in different orders on different ranks
deadlock.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import pickle
import threading
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the quantized kernels take K % 128 == 0 (ops/quant_matmul.py)
FFN_UNIT = 128
# a descriptor up to this size travels in one broadcast
CAPACITY = 16384
# the model collectives' timeout (a follower's first call may build kernels)
DATA_TIMEOUT = datetime.timedelta(seconds=900)
# the descriptors' timeout: rank 0 sends a keepalive op when idle for
# KEEPALIVE_S, so an idle server never lets its followers time out
CONTROL_TIMEOUT = datetime.timedelta(seconds=600)
KEEPALIVE_S = 60.0


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """One served model's tensor-parallel group: the process group of its
    collectives, this process's rank in it and its size, and the gloo group
    that carries the step descriptors."""

    group: Optional[object]
    rank: int
    size: int
    control: Optional[object] = None

    @property
    def leader(self) -> bool:
        return self.rank == 0


_ACTIVE: contextvars.ContextVar[Optional[TPGroup]] = contextvars.ContextVar(
    "llava_active_tp", default=None)


@contextlib.contextmanager
def activate_tp(tp: Optional[TPGroup]):
    """Make the model code inside the block run on this group's local shards
    (heads, FFN columns and vocab as :func:`shard_for_serving` cuts them) and
    sum over it. Without an active group every helper here is the identity,
    so single-card paths are untouched."""
    token = _ACTIVE.set(tp)
    try:
        yield tp
    finally:
        _ACTIVE.reset(token)


def active_tp() -> Optional[TPGroup]:
    return _ACTIVE.get()


def tp_size() -> int:
    tp = _ACTIVE.get()
    return 1 if tp is None else tp.size


def tp_rank() -> int:
    tp = _ACTIVE.get()
    return 0 if tp is None else tp.rank


def local_heads(n: int, what: str = "heads", size: Optional[int] = None) -> int:
    """``n`` heads over the group: this rank's count. Raises ValueError when
    they do not divide (an MQA decoder's one kv head over tp = 2)."""
    size = tp_size() if size is None else size
    if n % size:
        raise ValueError(f"{n} {what} do not split over tp = {size}")
    return n // size


def vocab_range(V: int, rank: Optional[int] = None, size: Optional[int] = None):
    """This rank's vocab rows [lo, hi) of the head."""
    rank = tp_rank() if rank is None else rank
    size = tp_size() if size is None else size
    if V % size:
        raise ValueError(f"a vocab of {V} does not split over tp = {size}")
    return rank * (V // size), (rank + 1) * (V // size)


def ffn_split(F: int, size: int) -> List[int]:
    """Each rank's FFN columns: units of :data:`FFN_UNIT`, the first ranks
    taking one more where they do not divide; an even split where ``F`` has
    fewer units than ranks (narrow test models)."""
    n, rem = divmod(F, FFN_UNIT)
    if rem == 0 and n >= size:
        base, extra = divmod(n, size)
        return [(base + (r < extra)) * FFN_UNIT for r in range(size)]
    if F % size:
        raise ValueError(f"an FFN dim of {F} does not split over tp = {size}")
    return [F // size] * size


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """Sum the ranks' partial products in place, in ``x``'s dtype (as GSPMD
    reduces a dot's output); the identity at tp = 1."""
    tp = _ACTIVE.get()
    if tp is not None and tp.size > 1:
        dist.all_reduce(x, group=tp.group)
    return x


def reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the ranks, in place."""
    tp = _ACTIVE.get()
    if tp is not None and tp.size > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=tp.group)
    return x


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """[..., V / tp] vocab-parallel logits -> [..., V] on every rank."""
    tp = _ACTIVE.get()
    if tp is None or tp.size == 1:
        return logits
    x = logits.contiguous()
    out = torch.empty(tp.size * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.view(-1), group=tp.group)
    out = out.view((tp.size,) + tuple(x.shape))
    return out.movedim(0, -2).reshape(*x.shape[:-1], tp.size * x.shape[-1])


# ---------------------------------------------------------------------------
# The shard plan
# ---------------------------------------------------------------------------

def _cut(x: torch.Tensor, dim: int, segments, div: int = 1) -> torch.Tensor:
    """The rows ``segments`` ([(lo, hi), ...] in the whole matrix's units,
    divided by ``div`` for a packed or blocked leaf) of ``x`` along ``dim``,
    concatenated, as a fresh contiguous tensor."""
    parts = []
    for lo, hi in segments:
        if lo % div or hi % div:
            raise ValueError(f"a cut at [{lo}, {hi}) is not aligned to {div} rows")
        parts.append(x.narrow(dim, lo // div, (hi - lo) // div))
    if len(parts) > 1:
        return torch.cat(parts, dim=dim)
    return parts[0].clone() if parts[0].is_contiguous() else parts[0].contiguous()


def _take(w, axis: str, segments):
    """A plain or quantized weight [..., K, N] cut to ``segments`` of its
    columns (``axis="cols"``) or rows (``"rows"``). Quantized columns take
    their scales along; quantized rows keep an int8 matrix's per-column
    scales whole and take an int4 matrix's block scales with their rows.
    A K-major copy is dropped (the engine makes it again)."""
    from llava_plus_torch.ops import quant

    if isinstance(w, dict):
        if not quant.is_quantized(w) or quant.LORA_A in w:
            raise ValueError(f"tensor-parallel serving takes plain or quantized matrices, not "
                             f"{sorted(w)}")
        out = {}
        for k, v in w.items():
            if k == quant.QTKEY:
                continue
            if axis == "cols":
                out[k] = _cut(v, -1, segments)
            elif k == quant.QKEY:
                out[k] = _cut(v, -2, segments)
            elif k == quant.Q4KEY:
                out[k] = _cut(v, -2, segments, div=2)
            elif quant.Q4KEY in w:
                out[k] = _cut(v, -2, segments, div=quant.INT4_BLOCK)
            else:
                out[k] = v   # int8 per-column scales: the whole matrix's
        return out
    return _cut(w, -1 if axis == "cols" else -2, segments)


def _sections(widths, splits, rank: int):
    """Rank ``rank``'s piece of each section of a fused matrix, as column
    segments of the fused matrix."""
    segs, start = [], 0
    for width, split in zip(widths, splits):
        lo = start + sum(split[:rank])
        segs.append((lo, lo + split[rank]))
        start += width
    return segs


# each split leaf's role: LLaMA's and MPT's names for the same matrices
_ROLES = {
    "llama": {("lm_head",): "head", ("layers", "attn", "wq"): "q",
              ("layers", "attn", "wk"): "kv", ("layers", "attn", "wv"): "kv",
              ("layers", "attn", "wqkv"): "qkv", ("layers", "attn", "wo"): "out",
              ("layers", "mlp", "w_gate"): "ffn", ("layers", "mlp", "w_up"): "ffn",
              ("layers", "mlp", "w_gateup"): "gateup", ("layers", "mlp", "w_down"): "down"},
    "mpt": {("layers", "attn", "wqkv"): "qkv", ("layers", "attn", "out_proj"): "out",
            ("layers", "mlp", "up_proj"): "ffn", ("layers", "mlp", "down_proj"): "down"},
}


def shard_plan(cfg, rank: int, size: int):
    """The language model's split leaves for ``cfg`` (a LlavaConfig): {path
    under ``language_model``: (axis, column or row segments)}. Every other
    leaf stays whole (MPT's head is the whole ``wte``, each rank reading
    its vocab rows). Raises ValueError for shapes that do not split."""
    if cfg.language_model_type == "mpt":
        c = cfg.mpt
        H, Hkv, F, V = c.n_heads, c.kv_heads, c.expansion_ratio * c.d_model, c.vocab_size
        if c.qk_ln and size > 1:
            raise ValueError("MPT's qk LayerNorm spans every head: it does not split over tp")
    else:
        c = cfg.text
        H, Hkv, F, V = (c.num_attention_heads, c.num_key_value_heads, c.intermediate_size,
                        c.vocab_size)
    Dh = c.head_dim
    qs = [local_heads(H, "attention heads", size) * Dh] * size
    kvs = [local_heads(Hkv, "kv heads", size) * Dh] * size
    fsplit = ffn_split(F, size)
    ff = _sections([F], [fsplit], rank)
    segments = {
        "head": ("cols", [vocab_range(V, rank, size)]),
        "q": ("cols", _sections([H * Dh], [qs], rank)),
        "kv": ("cols", _sections([Hkv * Dh], [kvs], rank)),
        "qkv": ("cols", _sections([H * Dh, Hkv * Dh, Hkv * Dh], [qs, kvs, kvs], rank)),
        "out": ("rows", _sections([H * Dh], [qs], rank)),
        "ffn": ("cols", ff),
        "gateup": ("cols", _sections([F, F], [fsplit, fsplit], rank)),
        "down": ("rows", ff),
    }
    return {path: segments[role] for path, role in _ROLES[cfg.language_model_type].items()}


def shard_leaf(path: Tuple[str, ...], leaf, plan):
    """One leaf of the language model (``path`` under it) cut by ``plan``,
    or the leaf itself."""
    if path in plan:
        axis, segments = plan[path]
        return _take(leaf, axis, segments)
    return leaf


def is_local(params, cfg, size: int) -> bool:
    """Whether ``params`` is already one rank's shard at ``size`` ranks (the
    attention output's rows tell: H * Dh whole, H * Dh / size local)."""
    if size == 1:
        return True
    from llava_plus_torch.ops import quant

    attn = params["language_model"]["layers"]["attn"]
    w = attn["out_proj"] if cfg.language_model_type == "mpt" else attn["wo"]
    if isinstance(w, dict):
        rows = w[quant.QKEY].shape[-2] if quant.QKEY in w else 2 * w[quant.Q4KEY].shape[-2]
    else:
        rows = w.shape[-2]
    whole = (cfg.mpt.d_model if cfg.language_model_type == "mpt"
             else cfg.text.num_attention_heads * cfg.text.head_dim)
    return rows != whole


def shard_for_serving(params, cfg, rank: int, size: int):
    """This rank's serving tree: the language model's split leaves cut to
    the rank's slice (fresh contiguous tensors), everything else the
    caller's leaf. Identity at ``size`` 1 and on a tree already cut."""
    if is_local(params, cfg, size):
        return params
    plan = shard_plan(cfg, rank, size)

    def walk(t, path):
        if path in plan:
            return shard_leaf(path, t, plan)
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, path + (i,)) for i, v in enumerate(t)]
        return t

    return dict(params, language_model=walk(params["language_model"], ()))


# ---------------------------------------------------------------------------
# The group and the step broadcast
# ---------------------------------------------------------------------------

def serving_group(mesh) -> TPGroup:
    """The serving group of a ``make_mesh(1, 1, tp)`` mesh (its ``tp``
    dimension) or of a process group, with a gloo group over the same ranks
    for the step descriptors: every rank of the default process group calls
    it, as ``new_group`` requires. A :class:`TPGroup` (:func:`make_group`)
    is taken as it is."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, TPGroup):
        return mesh
    if isinstance(mesh, DeviceMesh):
        names = mesh.mesh_dim_names or ()
        shape = dict(zip(names, mesh.mesh.shape))
        if shape.get("dp", 1) != 1 or shape.get("fsdp", 1) != 1:
            raise ValueError(f"serving takes a (1, 1, tp) mesh, got {shape}")
        group = mesh.get_group("tp")
    else:
        group = mesh
    ranks = dist.get_process_group_ranks(group)
    control = dist.new_group(ranks, backend="gloo", timeout=CONTROL_TIMEOUT)
    return TPGroup(group=group, rank=dist.get_rank(group), size=len(ranks), control=control)


def make_group(ranks: Sequence[int], backend: Optional[str] = None) -> TPGroup:
    """A serving group over ``ranks`` of the default process group (its
    collectives on ``backend``, the default group's by default), made once
    and passed as ``mesh=`` to each engine or Generator served over those
    ranks in turn. Every rank of the default group calls it; a rank outside
    ``ranks`` gets rank -1."""
    ranks = list(ranks)
    group = dist.new_group(ranks, backend=backend, timeout=DATA_TIMEOUT)
    control = dist.new_group(ranks, backend="gloo", timeout=CONTROL_TIMEOUT)
    me = dist.get_rank()
    return TPGroup(group=group, rank=ranks.index(me) if me in ranks else -1, size=len(ranks),
                   control=control)


class StepDriver:
    """Rank 0 issues ops; the other ranks replay them.

    :meth:`issue` (rank 0) broadcasts ``(op, args)`` and then runs
    ``target._op_<op>(*args)`` under the serving group, both under one lock;
    :meth:`follow` (a follower) receives descriptors and runs the same ops,
    in order, until rank 0's ``stop``. ``args`` are host values (numbers,
    lists, numpy arrays): a descriptor is pickled into one uint8 buffer of
    :data:`CAPACITY` bytes (its length first) and broadcast over the gloo
    control group, with a second broadcast for the rest of a longer one.
    A keepalive thread sends a no-op when rank 0 has been idle for
    :data:`KEEPALIVE_S`."""

    def __init__(self, tp: TPGroup):
        self.tp = tp
        self.lock = threading.RLock()
        self.sent = 0              # descriptors broadcast (rank 0)
        self._last = time.monotonic()
        self._closed = threading.Event()
        self._root = dist.get_global_rank(tp.control, 0) if tp.size > 1 else 0
        if tp.leader and tp.size > 1:
            threading.Thread(target=self._keepalive, daemon=True).start()

    def _broadcast(self, buf: torch.Tensor):
        dist.broadcast(buf, self._root, group=self.tp.control)

    def _send(self, message):
        data = pickle.dumps(message, protocol=pickle.HIGHEST_PROTOCOL)
        n = len(data)
        head = torch.zeros(CAPACITY, dtype=torch.uint8)
        head[:8] = torch.tensor([n], dtype=torch.int64).view(torch.uint8)
        first = min(n, CAPACITY - 8)
        head[8:8 + first] = torch.frombuffer(bytearray(data[:first]), dtype=torch.uint8)
        self._broadcast(head)
        if n > first:
            self._broadcast(torch.frombuffer(bytearray(data[first:]), dtype=torch.uint8))
        self.sent += 1
        self._last = time.monotonic()

    def _receive(self):
        head = torch.empty(CAPACITY, dtype=torch.uint8)
        self._broadcast(head)
        n = int(head[:8].view(torch.int64)[0])
        first = min(n, CAPACITY - 8)
        data = head[8:8 + first].numpy().tobytes()
        if n > first:
            rest = torch.empty(n - first, dtype=torch.uint8)
            self._broadcast(rest)
            data += rest.numpy().tobytes()
        return pickle.loads(data)

    def issue(self, target, op: str, *args):
        """Broadcast ``op`` and run it here (rank 0); returns its result."""
        with self.lock:
            if self._closed.is_set():
                raise RuntimeError(f"the serving group is stopped; cannot issue {op}")
            if self.tp.size > 1:
                self._send((op, args))
            with activate_tp(self.tp), target._op_context():
                return getattr(target, "_op_" + op)(*args)

    def follow(self, target) -> int:
        """Replay rank 0's ops on ``target`` until its ``stop``; returns the
        ops replayed."""
        n = 0
        while True:
            op, args = self._receive()
            if op == "stop":
                return n
            if op == "noop":
                continue
            with activate_tp(self.tp), target._op_context():
                getattr(target, "_op_" + op)(*args)
            n += 1

    def close(self):
        """Rank 0: end the followers' replay (once)."""
        with self.lock:
            if self._closed.is_set():
                return
            if self.tp.size > 1:
                self._send(("stop", ()))
            self._closed.set()

    def _keepalive(self):
        while not self._closed.wait(KEEPALIVE_S / 4):
            if time.monotonic() - self._last < KEEPALIVE_S:
                continue
            with self.lock:
                if not self._closed.is_set() and time.monotonic() - self._last >= KEEPALIVE_S:
                    self._send(("noop", ()))


class Replicated:
    """The op plumbing that the serving engine and the Generator share: a
    target of :class:`StepDriver` whose ``_op_<name>`` methods write its
    device state from host arguments. Without a serving group an op is a
    plain call."""

    tp: Optional[TPGroup] = None
    _driver: Optional[StepDriver] = None
    leader = True

    def _serve_over(self, mesh, params, cfg):
        """Join the serving group of ``mesh`` (None: one card) and return
        this rank's shard of ``params``."""
        if mesh is None:
            return params
        self.tp = serving_group(mesh)
        params = shard_for_serving(params, cfg, self.tp.rank, self.tp.size)
        self._driver = StepDriver(self.tp)
        self.leader = self.tp.leader
        return params

    def _op_context(self):
        """What every op runs inside, whichever thread issues or replays it
        (an op must do the same work on every rank)."""
        return contextlib.nullcontext()

    def _issue(self, op: str, *args):
        """Run ``self._op_<op>(*args)``: directly on one card; under tensor
        parallelism broadcast to the followers first (rank 0)."""
        if self._driver is None:
            with self._op_context():
                return getattr(self, "_op_" + op)(*args)
        return self._driver.issue(self, op, *args)

    def _follow(self) -> int:
        if self.leader:
            raise RuntimeError("rank 0 serves; only the other ranks follow")
        with torch.inference_mode():
            return self._driver.follow(self)

    def _end_followers(self):
        if self._driver is not None and self.leader:
            self._driver.close()
