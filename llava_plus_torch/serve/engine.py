"""Continuous-batching inference engine over a dense or paged KV cache.

Counterpart of ``llava_plus_tpu/serve/engine.py`` (``BatchedEngine``). One
engine thread decodes a fixed pool of ``max_slots`` slots in chunks of
``decode_chunk`` steps; a prefill thread tokenizes, prefills arrivals in
batches (padded to a power-of-two batch size, one bucket-sized dense cache
per batch), emits each request's first token and hands it to the engine
thread, which copies its cache stripe into a free slot between chunks.
Requests leave on eos, a stop string or their token budget.

With ``paged=True`` the slots share one pool of KV pages
(:class:`~llava_plus_torch.models.llama.PagedKVCache`): a request gets
pages for its prompt and token budget at insert (refcounted, under one
lock), and waits while the pool is exhausted. With the prefix cache on
(the default), the pages of every full prompt page are published under
chain hashes of their content (``serve/prefix_cache.py``); a later prompt
that starts with a published prefix, images included, shares those pages
and prefills only its suffix, on the engine thread, with no vision encode.

PyTorch runs eagerly, so the JAX package's compiled prefill / insert /
decode programs become plain calls that update the pool cache in place.
Both threads queue their work on the device's default CUDA stream, so the
card runs prefill and decode kernels one after another in the order they
were queued; a prefill on a side stream, overlapping decode, is later work.

Sampling: greedy rows take the argmax. A sampled row draws by Gumbel-max
from counter-based uniforms keyed on (request seed, position), so its
tokens depend only on its seed and positions, never on which requests
share the batch or how decode is chunked (the JAX engine folds the
position into the request's key for the same reason; its random bits are
not reproduced).

Both backbones serve: LLaMA and MPT (ALiBi slopes ride the same kernels).

Prompt-lookup speculative decoding (``speculate=k``, greedy-exact): each
slot proposes the k tokens that followed the latest earlier occurrence of
its history's last 3, 2 or 1 tokens, and one verify step runs the current
token and the proposals through the model as one chunk of k + 1 tokens
(the dense decode kernel or the paged general kernel on the card), keeping
the proposals that match the greedy tokens and one more. The state a step
needs (current token, history, proposals, budget) stays on the device
between steps, ``spec_chunk`` steps run per dispatch, and the host keeps
``spec_depth`` chunks in flight, fetching the oldest one's ``[m, B, k + 2]``
rows through pinned memory behind an event: a chunk makes no host sync.
When too few proposals are accepted the engine decodes plain chunks for a
while and probes again. A sampled slot takes one token a step, drawn from
``counter_uniform(seed, position)`` as a plain step at that position draws.

``w8a8=True`` runs the prefills' int8 products with int8 activations (the
JAX engine's ``w8a8``), for this engine's forward calls only.

Tensor parallelism (``mesh=make_mesh(1, 1, tp)``, ``parallel/tp.py``): one
process a card, every rank constructing the engine with the same arguments.
Each rank keeps its shard of the tree (heads, FFN columns, the head's
vocab), its kv heads of the caches and a replica of every other piece of
device state. Rank 0 serves: it runs the two threads, tokenizes, plans,
keeps the pages, their refcounts and the prefix cache, and issues each
call that writes device state (a prefill, an insert, a page attach, a
suffix prefill, a token write, a decode chunk, a speculative refresh or
step) as an op with host arguments through :class:`~llava_plus_torch.
parallel.tp.StepDriver`; every other rank calls :meth:`BatchedEngine.follow`,
which replays the ops in rank 0's order until :meth:`BatchedEngine.stop`.
Both backbones, dense and paged caches, bf16 or int8 KV, plain, int8 or
int4 weights, ``speculate`` and ``w8a8`` serve so; the paged kernels run on
the rank's kv heads (the JAX engine forces its XLA attention under a mesh,
since its Pallas kernel has no partitioning rule).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from llava_plus_torch.constants import IMAGE_TOKEN_INDEX
from llava_plus_torch.data.multimodal import plan_multimodal_batch
from llava_plus_torch.generate import batch_to_device, multimodal_arrays, nucleus
from llava_plus_torch.mm_utils import tokenizer_image_token
from llava_plus_torch.models import llama, llava as llava_model
from llava_plus_torch.models.configs import LlavaConfig
from llava_plus_torch.models.llava import MultimodalBatch
from llava_plus_torch.ops import quant
from llava_plus_torch.parallel import tp as tp_lib
from llava_plus_torch.serve.prefix_cache import PagePrefixCache, image_digest, page_keys

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    prompt: str
    images: Optional[np.ndarray] = None
    max_new_tokens: int = 256
    temperature: float = 0.0
    top_p: float = 1.0
    stop_strings: Sequence[str] = ()
    seed: int = 0

    # filled by the engine
    submit_ts: float = 0.0
    first_token_ts: float = 0.0
    _chunks: "queue.Queue" = dataclasses.field(default_factory=queue.Queue, repr=False)
    _done: threading.Event = dataclasses.field(default_factory=threading.Event, repr=False)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_ts and self.submit_ts:
            return self.first_token_ts - self.submit_ts
        return None


class _PageCounts:
    """A paged pool's page refcounts and free list. A page's refcount is one
    per slot page table that holds it, plus one while the prefix cache
    publishes it; it returns to the free list at 0. Callers hold the
    engine's ``_page_lock``."""

    def __init__(self, num_pages: int):
        self.refs = [0] * num_pages
        self.free = list(range(num_pages))

    def incref(self, pid: int):
        """Only a referenced page gains references (a page at refcount 0 is
        on the free list)."""
        if self.refs[pid] <= 0:
            raise RuntimeError(f"page {pid} is free and cannot be shared")
        self.refs[pid] += 1

    def decref(self, pid: int):
        if self.refs[pid] <= 0:
            raise RuntimeError(f"page {pid} released more often than taken")
        self.refs[pid] -= 1
        if self.refs[pid] == 0:
            self.free.append(pid)


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    out_ids: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0
    budget: int = 0
    # the prefill already emitted this slot's first token; the next decode
    # column for it is that same token and must not be emitted twice
    skip_next_emit: bool = False
    # prompt + generated token ids
    history: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)  # paged: its pool pages


class _PoolExhausted(Exception):
    """Not enough free KV pages to admit; retry after slots finish."""


@dataclasses.dataclass
class _Prepared:
    """A request whose prefill finished (first token already emitted to the
    client), waiting for the engine loop to insert it into a slot."""

    req: Request
    cache1: llama.KVCache   # bucket-sized prefill cache, maybe a whole batch's
    pid: int                # its id (the ops name it by id)
    row: int                # this request's row of it
    first_id: int
    prompt_len: int
    budget: int
    out_ids: List[int]
    history: List[int]
    needed_pages: int = 0   # paged: pages to allocate at insert
    # paged + prefix cache: chain hashes of the prompt's full pages,
    # published at insert so later requests can share the pages
    page_keys: List[bytes] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _PreparedSuffix:
    """A request whose prompt prefix was found in the page prefix cache:
    pages ``hit_pages`` already hold positions [0, prefix_len), so only the
    suffix still needs a prefill, which runs on the engine thread (it owns
    the pool) and emits the first token there. No device work has happened
    yet. ``hit_pages`` were pinned at match time and stay pinned until the
    slot finishes (or the insert fails)."""

    req: Request
    hit_pages: List[int]
    prefix_len: int
    suffix_ids: np.ndarray   # fused ids of positions [prefix_len, prompt_len)
    prompt_len: int
    budget: int
    history: List[int]       # the full fused prompt ids
    needed_pages: int        # fresh pages beyond the hits
    page_keys: List[bytes]


@dataclasses.dataclass
class _InflightPrefill:
    """A prefill batch whose kernels are queued but whose first tokens are
    not fetched yet. The prefill loop keeps up to two in flight, so batch
    N+1's host work is queued while batch N still runs on the card."""

    reqs: List[Request]
    firsts: torch.Tensor    # [N] sampled first tokens, on the device
    cacheN: llama.KVCache   # bucket-sized prefill cache
    pid: int                # its id
    plan: object            # host token plan (lengths, tokens)
    keymap: Dict[int, List[bytes]]  # paged: id(request) -> its page keys
    t0: float               # host clock at the start (for the debug log)
    t_host: float
    t_dispatch: float


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (two multiply-xorshift rounds) on int64 values
    in [0, 2^32); every product stays below 2^59."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _MASK32
    return x ^ (x >> 16)


def counter_uniform(seeds: torch.Tensor, positions: torch.Tensor, n: int) -> torch.Tensor:
    """Uniforms in (0, 1), [B, n] f32, a function of (seed, position, column)
    only: row b is the same whatever other rows the call holds."""
    key = _mix32((_mix32(seeds.long() & _MASK32) + positions.long()) & _MASK32)
    cols = (torch.arange(n, device=seeds.device, dtype=torch.int64) * 0x9E3779B1) & _MASK32
    bits = _mix32(key[:, None] ^ cols[None, :])
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample_batch(logits: torch.Tensor, temperature: torch.Tensor, top_p: torch.Tensor,
                 seeds: torch.Tensor, positions: torch.Tensor, any_sampled: bool) -> torch.Tensor:
    """[B, V] f32 logits -> [B] token ids. Rows with temperature <= 0 take
    the argmax; the others draw from the temperature-scaled nucleus (top-p)
    by Gumbel-max over :func:`counter_uniform` noise. ``any_sampled`` is the
    host's knowledge that some row samples (all-greedy batches skip the
    sort)."""
    greedy = torch.argmax(logits, dim=-1)
    if not any_sampled:
        return greedy
    filtered = nucleus(logits / temperature.clamp_min(1e-6)[:, None], top_p[:, None])
    gumbel = -torch.log(-torch.log(counter_uniform(seeds, positions, logits.shape[-1])))
    sampled = torch.argmax(filtered + gumbel, dim=-1)
    return torch.where(temperature > 0.0, sampled, greedy)


def _sampling(reqs: List[Request], n_real: int):
    """The rows' (temperatures, top-ps, seeds) as host lists; rows from
    ``n_real`` on are batch padding and take the argmax."""
    return ([r.temperature if i < n_real else 0.0 for i, r in enumerate(reqs)],
            [r.top_p for r in reqs], [r.seed & _MASK32 for r in reqs])


# ---------------------------------------------------------------------------
# Speculation
# ---------------------------------------------------------------------------

def propose_dev(hist: torch.Tensor, hlen: torch.Tensor, k: int) -> torch.Tensor:
    """Prompt-lookup proposals on the device, [B, k] (0 where none): for
    n = 3, 2, 1 find the latest earlier occurrence of the history's n-token
    tail (``hist`` [B, S], its first ``hlen`` [B] entries valid) and propose
    the k tokens that followed it, as far as the history reaches (JAX
    ``engine.py:_propose_dev``)."""
    B, S = hist.shape
    dev = hist.device
    idx = torch.arange(S, device=dev)[None]
    hlen = hlen.long()
    best_j = torch.full((B,), -1, dtype=torch.int64, device=dev)
    best_n = torch.zeros(B, dtype=torch.int64, device=dev)
    for n in (3, 2, 1):
        tail_idx = hlen[:, None] - n + torch.arange(n, device=dev)[None]
        tail = torch.gather(hist, 1, tail_idx.clamp(0, S - 1))             # [B, n]
        padded = torch.nn.functional.pad(hist, (0, n))
        m = torch.ones(B, S, dtype=torch.bool, device=dev)
        for i in range(n):
            m &= padded[:, i:i + S] == tail[:, i:i + 1]
        m &= idx < (hlen - n)[:, None]      # not the tail itself
        m &= (hlen > n)[:, None]
        jstar = torch.where(m, idx, -1).amax(dim=1)
        take = m.any(dim=1) & (best_j < 0)
        best_j = torch.where(take, jstar, best_j)
        best_n = torch.where(take, n, best_n)
    pidx = best_j[:, None] + best_n[:, None] + torch.arange(k, device=dev)[None]
    prop = torch.gather(hist, 1, pidx.clamp(0, S - 1))
    ok = (best_j[:, None] >= 0) & (pidx < hlen[:, None])
    return torch.where(ok, prop, 0)


def propose(history: List[int], k: int) -> List[int]:
    """:func:`propose_dev` for one slot on the host, over its whole
    history (JAX ``engine.py:_propose``)."""
    L = len(history)
    for n in (3, 2, 1):
        if L <= n:
            continue
        tail = history[-n:]
        for j in range(L - n - 1, -1, -1):   # the latest earlier occurrence
            if history[j:j + n] == tail:
                cont = history[j + n:j + n + k]
                return (cont + [0] * k)[:k]
    return [0] * k


def _to_host(t: torch.Tensor):
    """Start ``t``'s copy to the host: (host tensor, event) for a CUDA
    tensor (pinned memory, a non-blocking copy behind an event), else
    (``t``, None)."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class BatchedEngine(tp_lib.Replicated):
    def __init__(
        self,
        params,
        cfg: LlavaConfig,
        tokenizer,
        *,
        max_slots: int = 8,
        max_seq_len: int = 2048,
        prefill_bucket: int = 256,
        prefill_batch: int = 4,
        cache_dtype=torch.bfloat16,
        idle_sleep: float = 0.002,
        decode_chunk: int = 4,
        mesh=None,
        paged: bool = False,
        page_size: int = 128,
        pool_tokens: Optional[int] = None,
        prefix_cache: bool = True,
        speculate: int = 0,
        spec_chunk: int = 4,
        w8a8: bool = False,
    ):
        """``paged=True`` keeps the KV cache in a pool of ``page_size``-token
        pages shared by the slots: pages are allocated per request for
        prompt + budget, so long contexts and short chats share one pool.
        ``pool_tokens`` sizes it (default ``max_slots * max_seq_len``, no
        overcommit); requests wait while it is exhausted. ``prefix_cache``
        (paged only) shares the pages of identical prompt prefixes.
        ``speculate=k`` (at most 7: the verify chunk of k + 1 tokens is what
        the decode and paged kernels take) verifies k prompt-lookup
        proposals a step, ``spec_chunk`` steps per dispatch.
        ``w8a8=True`` runs the int8 products of at least 256 rows (the
        prefills) with int8 activations (``ops/w8a8.py``): the engine's
        threads and :meth:`warmup` hold ``quant.w8a8_scope``, so no other
        code of the process is switched. It gives the decoder's int8
        matrices their K-major copies (``quant.add_kmajor_copies``, in the
        caller's tree: as many bytes again as those matrices).

        ``mesh`` (a ``make_mesh(1, 1, tp)`` mesh, or a process group) serves
        over tensor parallelism: ``params`` (the whole tree, quantized
        whole first if at all, or this rank's shard of it) is cut to this
        rank's shard (``parallel/tp.shard_for_serving``, which raises for
        heads that do not split); rank 0 serves and every other rank must
        call :meth:`follow`."""
        params = self._serve_over(mesh, params, cfg)
        self.w8a8 = bool(w8a8)
        if self.w8a8:
            # the IMMA product reads K-major int8 (ops/w8a8.py)
            quant.add_kmajor_copies(params["language_model"])
        if paged and (max_seq_len % page_size or prefill_bucket % page_size):
            raise ValueError(f"max_seq_len {max_seq_len} and prefill_bucket {prefill_bucket} "
                             f"must be multiples of page_size {page_size}")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.lm, self.lm_cfg = llava_model.backbone(cfg)
        lm = params["language_model"]
        self.device = (lm["embed_tokens"] if "embed_tokens" in lm else lm["wte"]).device
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.prefill_bucket = prefill_bucket
        self.prefill_batch = max(int(prefill_batch), 1)
        self.cache_dtype = cache_dtype
        self.idle_sleep = idle_sleep
        self.decode_chunk = max(decode_chunk, 1)
        self.paged = paged
        self.page_size = page_size
        self.num_pages = 0
        self._prefix: Optional[PagePrefixCache] = None  # the worker's metrics read it
        if paged:
            total = pool_tokens or max_slots * max_seq_len
            self.num_pages = max(total // page_size, max_seq_len // page_size)
            # Refcounts, the free list and the prefix cache are guarded by
            # _page_lock (the prefill thread matches prefixes, the engine
            # thread allocates and publishes). The prefix cache calls back
            # into the page counts, not into the engine: a bound method of
            # the engine there would make a cycle that keeps a dropped
            # engine's pool on the card until the cycle collector runs.
            self._pages = _PageCounts(self.num_pages)
            self._free_pages = self._pages.free
            self._page_refs = self._pages.refs
            self._page_lock = threading.Lock()
            if prefix_cache:
                self._prefix = PagePrefixCache(incref=self._pages.incref,
                                               decref=self._pages.decref)

        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._ready: "queue.Queue[_Prepared]" = queue.Queue()
        self._slots = [_Slot() for _ in range(max_slots)]
        self._stop = threading.Event()
        self._waiting = None  # a prepared request held back: the pool is exhausted
        self.ttfts: "deque[float]" = deque(maxlen=512)
        # burst admission shows as prefill_requests > prefill_dispatches
        self.prefill_dispatches = 0
        self.prefill_requests = 0
        # batched decode steps (one forward each), and how many of them ran
        # with more than one active slot
        self.decode_steps = 0
        self.multi_slot_steps = 0
        # prompt tokens whose KV came from the page prefix cache (paged)
        self.prefix_hit_tokens = 0
        self.warmup_s = 0.0  # set by warmup()

        self.speculate = min(max(int(speculate), 0), 7)
        self.spec_chunk = max(int(spec_chunk), 1)
        self.verify_steps = 0     # verify steps run (one forward each)
        self.spec_steps = 0       # of those, steps with a live slot
        self.spec_emitted = 0     # greedy tokens they delivered
        self.spec_slot_steps = 0  # greedy slots' verify steps (the emitted's divisor a slot)
        # adaptive gating: recent tokens a step; below spec_min_accept the
        # engine decodes spec_pause_len plain chunks, then probes again
        self._spec_recent: "deque[int]" = deque(maxlen=32)
        self._spec_pause = 0
        self.spec_pause_len = 64
        self.spec_min_accept = 1.1
        self.spec_pauses = 0      # times the gate paused speculation
        self.spec_refreshes = 0   # device-state rebuilds (membership changes)
        # host seconds by part of the speculative loop (tools/bench_spec.py)
        self.spec_timers = {"dispatch": 0.0, "fetch": 0.0, "emit": 0.0,
                            "refresh": 0.0, "iters": 0}
        # the device-resident state (cur, hlen, hist, prop, budget and the
        # slots' sampling settings), and the dispatched chunks whose rows
        # the host has not read: (host rows, event, the slots' requests)
        self._spec_dev: Optional[Dict[str, object]] = None
        self._spec_inflight: "deque" = deque()
        self.spec_depth = 2
        self._eos_id = int(getattr(tokenizer, "eos_token_id", 2) or 2)
        # the prefill caches that inserts will read, by id: rank 0 holds
        # each through its prepared requests (weakly here); a follower keeps
        # those that rank 0 still held at its latest prefill
        self._caches = weakref.WeakValueDictionary() if self.leader else {}
        self._pids = itertools.count()

        with tp_lib.activate_tp(self.tp):
            self.cache = self._make_cache()
        self.tokens = torch.zeros(max_slots, 1, dtype=torch.int64, device=self.device)
        self._thread = self._prefill_thread = None
        if self.leader:
            self._thread = threading.Thread(target=self._scoped(self._loop), daemon=True)
            self._thread.start()
            self._prefill_thread = threading.Thread(target=self._scoped(self._prefill_loop),
                                                    daemon=True)
            self._prefill_thread.start()

    # ------------------------------------------------------------------

    def _scoped(self, fn):
        """``fn`` run inside the engine's W8A8 scope."""
        def run(*args, **kwargs):
            with quant.w8a8_scope(self.w8a8):
                return fn(*args, **kwargs)
        return run

    def _op_context(self):
        """Every op runs in the engine's W8A8 scope, whichever thread issues
        or replays it."""
        return quant.w8a8_scope(self.w8a8)

    def follow(self) -> int:
        """A follower rank's serving loop: replay rank 0's ops until it
        stops; returns the ops replayed."""
        return self._follow()

    # -- ops: every call that writes device state, with host arguments ----

    def _op_prefill(self, pid: int, live: List[int], arrays: Dict[str, np.ndarray],
                    temps, tops, seeds, positions):
        """A batch's prefill into a fresh bucket-sized cache (kept as
        ``pid``): (the cache, the first tokens, the last-token logits); the
        prefill caches not in ``live`` are dropped."""
        for k in [k for k in self._caches.keys() if k not in live]:
            self._caches.pop(k, None)
        batch = batch_to_device(arrays, self.device)
        N, T = batch.tokens.shape
        cacheN = self._make_cache(batch=N, seq_len=T, force_dense=True)
        logits = self._prefill(batch, cacheN)
        firsts = self._sample_first(logits, temps, tops, seeds, positions)
        self._caches[pid] = cacheN
        return cacheN, firsts, logits

    def _op_insert(self, pid: int, row: int, slot: int, first_token: int):
        self._insert(self._caches[pid], row, slot, first_token)

    def _op_insert_paged(self, pid: int, row: int, slot: int, pages: List[int],
                         first_token: int):
        self._insert_paged(self._caches[pid], row, slot, pages, first_token)

    def _op_suffix(self, slot: int, pages: List[int], prefix_len: int, toks: np.ndarray,
                   seg: np.ndarray, temps, tops, seeds, positions) -> torch.Tensor:
        """A prefix-cache hit's suffix prefill and its first token [1]."""
        last = self._prefill_suffix(slot, pages, prefix_len, torch.from_numpy(toks).to(self.device),
                                    torch.from_numpy(seg).to(self.device))
        return self._sample_first(last, temps, tops, seeds, positions)

    def _op_set_token(self, tid: int, slot: int):
        self._set_token(tid, slot)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device without waiting for the card: staged
        in pinned memory and copied behind the work already queued (a
        pageable copy would hold the host until the stream drains)."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _op_set_tokens(self, tokens: np.ndarray):
        self.tokens = self._upload(tokens)

    def _op_decode(self, positions, active, temps, tops, seeds, any_sampled: bool,
                   n_steps: int) -> torch.Tensor:
        """A decode chunk from host arrays; ``self.tokens`` takes its last
        column. Returns its tokens [B, n_steps]."""
        dev = self._upload
        toks, self.tokens = self._decode_n(dev(positions), dev(active), dev(temps), dev(tops),
                                           dev(seeds), any_sampled, n_steps)
        return toks

    def _op_spec_refresh(self, cur, hlen, hist, prop, budget, active, seeds, temps, tops):
        dev = self._upload
        self._spec_dev = self._spec_state(
            cur=cur, hlen=hlen, hist=hist, prop=prop, budget=budget, active=dev(active),
            seeds=dev(seeds), temps=dev(temps), tops=dev(tops),
            any_sampled=bool((temps > 0).any()))

    def _op_spec_step(self, m: int) -> torch.Tensor:
        return self._spec_step(self._spec_dev, m)

    def _make_cache(self, batch=None, seq_len=None, force_dense=False) -> llama.Cache:
        """The slot pool's cache (paged when the engine is), or with
        ``force_dense`` a dense one (a prefill batch's bucket-sized cache)."""
        if self.paged and not force_dense:
            return llama.PagedKVCache.create(
                self.lm_cfg, batch or self.max_slots, num_pages=self.num_pages,
                max_pages_per_slot=self.max_seq_len // self.page_size,
                page_size=self.page_size, dtype=self.cache_dtype, device=self.device)
        return llama.KVCache.create(self.lm_cfg, batch or self.max_slots,
                                    seq_len or self.max_seq_len, self.cache_dtype,
                                    device=self.device)

    # -- paged-pool page accounting ----------------------------------------

    def _alloc_pages(self, n: int) -> List[int]:
        """Take ``n`` free pages at refcount 1, evicting least recently used
        prefix-cache entries if needed (an evicted entry frees its page only
        when no live slot holds it). Raises :class:`_PoolExhausted`."""
        with self._page_lock:
            while (len(self._free_pages) < n and self._prefix is not None
                   and self._prefix.evict_lru()):
                pass
            if len(self._free_pages) < n:
                raise _PoolExhausted(n)
            pages = [self._free_pages.pop() for _ in range(n)]
            for p in pages:
                self._page_refs[p] = 1
            return pages

    def _release_pages(self, pages: List[int]):
        with self._page_lock:
            for p in pages:
                self._pages.decref(p)

    def _match_prefix(self, keys: List[bytes]) -> List[int]:
        """Longest published prefix of ``keys``, its pages pinned for the
        caller (released when its slot finishes or its insert fails)."""
        if self._prefix is None or not keys:
            return []
        with self._page_lock:
            pages = self._prefix.match(keys)
            for p in pages:
                self._pages.incref(p)
            return pages

    def _publish_prefix(self, keys: List[bytes], pages: List[int]):
        if self._prefix is None or not keys:
            return
        with self._page_lock:
            self._prefix.publish(keys, pages[:len(keys)])

    def _prefill(self, batch: MultimodalBatch, cache1: llama.KVCache) -> torch.Tensor:
        """Logits [N, V] at each row's last valid token (the lm_head runs
        only there), the bucket cache filled in place."""
        last = (batch.segment_ids.sum(dim=1) - 1).clamp_min(0)
        logits, _ = llava_model.forward(self.params, self.cfg, batch, cache=cache1,
                                        fresh_prefill=True, logits_positions=last)
        return logits[:, 0]

    def _insert(self, cache1: llama.KVCache, row: int, slot: int, first_token: int):
        """Copy row ``row``'s stripe of a bucket-sized prefill cache into
        slots [0, S1) of pool slot ``slot``, and rebuild the slot's seg row
        from zeros so stale entries of its previous occupant are never
        attended."""
        S1 = cache1.max_len
        c = self.cache
        c.k[:, slot, :S1] = cache1.k[:, row]
        c.v[:, slot, :S1] = cache1.v[:, row]
        if c.k_scale is not None:
            c.k_scale[:, slot, :S1] = cache1.k_scale[:, row]
            c.v_scale[:, slot, :S1] = cache1.v_scale[:, row]
        c.seg[slot].zero_()
        c.seg[slot, :S1] = cache1.seg[row]
        self.tokens[slot, 0] = first_token

    def _insert_paged(self, cache1: llama.KVCache, row: int, slot: int, pages: List[int],
                      first_token: int):
        """Copy row ``row`` of a bucket-sized dense prefill cache into the
        pool pages ``pages`` (the first S1 / P of them; token-major pages make
        each a plain reshape of the dense stripe), and give slot ``slot`` its
        page table, allocation and a seg row rebuilt from zeros."""
        c, P = self.cache, self.page_size
        L, _, S1, Hkv, D = cache1.k.shape
        n1 = S1 // P
        ids = torch.tensor(pages[:n1], dtype=torch.int64, device=self.device)
        c.pool[:, ids, 0] = cache1.k[:, row].reshape(L, n1, P, Hkv, D).to(c.pool.dtype)
        c.pool[:, ids, 1] = cache1.v[:, row].reshape(L, n1, P, Hkv, D).to(c.pool.dtype)
        if c.quantized:
            # scale pages are head-major [L, Np, 2, Hkv, P]
            c.scale_pool[:, ids, 0] = cache1.k_scale[:, row].reshape(L, n1, P, Hkv).transpose(2, 3)
            c.scale_pool[:, ids, 1] = cache1.v_scale[:, row].reshape(L, n1, P, Hkv).transpose(2, 3)
        c.seg_buf[slot].zero_()
        c.seg_buf[slot, :S1] = cache1.seg[row]
        self._attach_pages(slot, pages)
        self.tokens[slot, 0] = first_token

    def _attach_pages(self, slot: int, pages: List[int]):
        """Slot ``slot``'s page table (filler entries 0: positions past its
        allocation are never written or read) and allocation."""
        maxp = self.max_seq_len // self.page_size
        table = torch.tensor((pages + [0] * maxp)[:maxp], dtype=torch.int32)
        self.cache.page_table[slot] = table.to(self.device)
        self.cache.alloc[slot] = len(pages) * self.page_size

    def _prefill_suffix(self, slot: int, pages: List[int], prefix_len: int,
                        tokens: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """Prefill only a prompt's suffix over the pool: pages
        ``pages[:prefix_len // P]`` already hold the prefix (shared, read
        only here). Attaches the slot's pages and prefix seg, then runs the
        suffix [1, Tb] (right-padded to a bucket) as a cache continuation
        from ``prefix_len`` through the gathered pages, as the JAX package
        forces its XLA path there (for MPT too, JAX ``engine.py:569-577``).
        Writes land in the fresh pages only. Returns the logits [1, V] at the
        last valid suffix token."""
        self._attach_pages(slot, pages)
        self.cache.seg_buf[slot].zero_()
        self.cache.seg_buf[slot, :prefix_len] = 1
        Tb = tokens.shape[1]
        positions = prefix_len + torch.arange(Tb, dtype=torch.int32, device=self.device)[None]
        last = (seg.sum(dim=1) - 1).clamp_min(0)
        logits, _ = self.lm.forward(self.params["language_model"], self.lm_cfg, tokens,
                                    positions=positions, segment_ids=seg,
                                    cache=self.cache.row(slot), logits_positions=last,
                                    paged_gather=True)
        return logits[:, 0]

    def _set_token(self, tid: int, slot: int):
        self.tokens[slot, 0] = tid

    def _decode_n(self, positions, active, temps, tops, seeds, any_sampled: bool,
                  n_steps: int):
        """``n_steps`` batched decode steps from ``self.tokens``. Inactive
        slots carry seg 0 and position max_seq_len (their cache writes are
        dropped) and their tokens are forced to 0. Slots whose request ends
        mid-chunk keep stepping; the host discards their tail. Returns the
        tokens [B, n_steps] and the last column [B, 1], on the device."""
        seg = active[:, None].to(torch.int32)
        tokens, cols = self.tokens, []
        for _ in range(n_steps):
            logits, _ = llava_model.decode_step(self.params, self.cfg, tokens,
                                                positions[:, None], seg, self.cache)
            nxt = sample_batch(logits[:, 0], temps, tops, seeds, positions, any_sampled)
            tokens = torch.where(active, nxt, 0)[:, None]
            cols.append(tokens)
            positions = positions + 1
            self.decode_steps += 1
        return torch.cat(cols, dim=1), tokens

    def _spec_body(self, cur, hlen, hist, prop, budget, active, seeds, temps, tops,
                   any_sampled: bool):
        """One verify step on the device-resident state (JAX ``_spec_body``):
        [cur | k proposals] at positions hlen - 1 ... as one chunk over the
        cache; a greedy slot accepts the proposals that match its greedy
        tokens and one more, a sampled slot takes one token; the tokens go
        into ``hist`` [B, S + 1] (column S takes the writes JAX drops) and
        the next proposals are made. Stops at the first eos (inclusive) and
        at the budget; a slot that emits 0 is finished. Returns ([B, k + 2]
        emitted tokens and their count, cur, hlen, hist, prop, budget)."""
        k, S = self.speculate, self.max_seq_len
        B = cur.shape[0]
        dev = cur.device
        pos = (hlen - 1).clamp_min(0)           # cur's position; dead slots at 0, seg 0
        offs = torch.arange(k + 1, device=dev)[None]
        tokens = torch.cat([cur[:, None], prop], dim=1)
        positions = pos[:, None] + offs
        act = active.to(torch.int32)[:, None]
        greedy_slot = temps <= 0.0
        seg = torch.where(offs == 0, act, act * greedy_slot.to(torch.int32)[:, None])
        seg = seg * (positions < S).to(torch.int32)
        logits, _ = llava_model.decode_step(self.params, self.cfg, tokens,
                                            positions.to(torch.int32), seg, self.cache)
        self.verify_steps += 1
        greedy = torch.argmax(logits, dim=-1)                               # [B, k + 1]
        sampled0 = sample_batch(logits[:, 0], temps, tops, seeds, pos, any_sampled)
        match = (prop == greedy[:, :k]) & (seg[:, 1:] > 0)
        acc = torch.cumprod(match.to(torch.int64), dim=1).sum(dim=1)
        out = torch.where(greedy_slot[:, None], greedy,
                          torch.cat([sampled0[:, None], torch.zeros_like(prop)], dim=1))
        e = torch.where(greedy_slot, acc + 1, 1)
        is_eos = (out == self._eos_id) & (offs < e[:, None])
        eos_j = torch.argmax(is_eos.to(torch.int32), dim=1)
        e = torch.where(is_eos.any(dim=1), torch.minimum(e, eos_j + 1), e)
        e = torch.minimum(e, budget)
        e = torch.where(active & (seg[:, 0] > 0), e, 0)
        new_cur = torch.gather(out, 1, (e - 1).clamp_min(0)[:, None])[:, 0]
        new_cur = torch.where(e > 0, new_cur, cur)
        jidx = hlen[:, None] + offs
        hist.scatter_(1, torch.where((offs < e[:, None]) & (jidx < S), jidx, S), out)
        hlen = hlen + e
        prop = propose_dev(hist[:, :S], hlen, k)
        return (torch.cat([out, e[:, None]], dim=1), new_cur, hlen, hist, prop,
                budget - e)

    def _spec_step(self, st: Dict[str, object], m: int) -> torch.Tensor:
        """``m`` verify steps on ``st``'s device state, updated in place;
        returns their rows stacked, [m, B, k + 2]."""
        rows = []
        for _ in range(m):
            ret, st["cur"], st["hlen"], st["hist"], st["prop"], st["budget"] = self._spec_body(
                st["cur"], st["hlen"], st["hist"], st["prop"], st["budget"], st["active"],
                st["seeds"], st["temps"], st["tops"], st["any_sampled"])
            rows.append(ret)
        return torch.stack(rows)

    # -- public API ----------------------------------------------------

    def submit(self, request: Request) -> Request:
        request.submit_ts = time.time()
        self._queue.put(request)
        return request

    def stream(self, request: Request):
        """Yield cumulative text for a request (submitted here)."""
        self.submit(request)
        while True:
            try:
                item = request._chunks.get(timeout=600)
            except queue.Empty:
                return
            if item is None:
                return
            yield item

    def drain(self, request: Request) -> str:
        """Block until an already-``submit``ted request finishes; its final text."""
        text = ""
        while True:
            try:
                item = request._chunks.get(timeout=600)
            except queue.Empty:
                return text
            if item is None:
                return text
            text = item

    def generate(self, request: Request) -> str:
        self.submit(request)
        return self.drain(request)

    def stop(self):
        """End the threads and, under tensor parallelism, the followers'
        replay (rank 0)."""
        self._stop.set()
        for thread in (self._thread, self._prefill_thread):
            if thread is not None:
                thread.join(timeout=5)
        self._end_followers()

    @property
    def num_active(self) -> int:
        return sum(1 for s in self._slots if s.request is not None)

    # -- warmup ----------------------------------------------------------

    def _warmup_prompt(self, prompt_len: int, image: bool) -> str:
        """A prompt whose fused length (text tokens + image patches) lands in
        the same prefill bucket as ``prompt_len``."""
        npatch = self.cfg.num_image_tokens
        prompt_len = min(prompt_len, self.max_seq_len - 8)
        bucket = -(-prompt_len // self.prefill_bucket) * self.prefill_bucket
        lo, hi = bucket - self.prefill_bucket + 1, min(bucket, self.max_seq_len - 2)
        target = hi - 4
        prefix = "<image>\n" if image else ""
        n_words = max(target - (npatch if image else 0), 4)
        for _ in range(12):
            prompt = prefix + " ".join(f"w{i % 31}" for i in range(n_words))
            ids = tokenizer_image_token(prompt, self.tokenizer)
            n_img = sum(1 for t in ids if t == IMAGE_TOKEN_INDEX)
            fused = len(ids) + n_img * (npatch - 1)
            if lo <= fused <= hi:
                return prompt
            # Newton step on the measured tokens-per-word rate
            per = max(fused / max(n_words, 1), 0.25)
            step = int(round((target - fused) / per))
            n_words = max(n_words + (step or (1 if fused < lo else -1)), 1)
        return prompt  # best effort: worst case warms a neighbouring bucket

    @torch.inference_mode()
    def warmup(self, prompt_len: int = 768, *, image: bool = True) -> float:
        """Run every prefill batch size at ``prompt_len``'s bucket (with the
        vision tower when ``image``), the insert, both decode chunk lengths,
        the verify chunk lengths when speculating and, paged with the prefix
        cache, a suffix prefill once before
        serving: the first use builds the CUDA kernels and warms cuBLAS and
        the allocator. Call on an idle engine (it writes into slot 0 without
        occupying it). Returns the seconds spent, also kept as
        ``warmup_s``."""
        return self._scoped(self._warmup)(prompt_len, image)

    def _warmup(self, prompt_len: int, image: bool) -> float:
        t0 = time.perf_counter()
        image = image and self.cfg.num_image_tokens > 0
        prompt = self._warmup_prompt(prompt_len, image)
        img_shape = (1, self.cfg.vision.image_size, self.cfg.vision.image_size, 3)
        rng = np.random.default_rng(0)
        for n in self._prefill_batch_sizes():
            reqs = [Request(prompt=prompt, max_new_tokens=4, temperature=0.0,
                            images=(rng.normal(size=img_shape).astype(np.float32)
                                    if image else None))
                    for _ in range(n)]
            prep = next((p for p in self._prepare(reqs) if p is not None), None)
            if prep is None:
                continue
            # slot 0 gets a stale seg row (and page table), the state a
            # finished request leaves behind; the next insert rebuilds it
            if self.paged:
                pages = self._alloc_pages(prep.needed_pages)
                self._issue("insert_paged", prep.pid, prep.row, 0, pages, prep.first_id)
                self._release_pages(pages)
            else:
                self._issue("insert", prep.pid, prep.row, 0, prep.first_id)
        B, S = self.max_slots, self.max_seq_len
        positions = np.full(B, S, np.int32)
        active = np.zeros(B, bool)
        temps = np.zeros(B, np.float32)
        tops = np.ones(B, np.float32)
        seeds = np.zeros(B, np.int64)
        for k in sorted({1, self.decode_chunk}):
            self._issue("decode", positions, active, temps, tops, seeds, False, k)
        if self.speculate:
            # every slot dead (hlen 0, inactive): nothing is attended or
            # emitted; the writes land where the next insert rewrites
            k = self.speculate
            for m in sorted({1, self.spec_chunk}):
                self._issue("spec_refresh", np.zeros(B, np.int64), np.zeros(B, np.int64),
                            np.zeros((B, S + 1), np.int64), np.zeros((B, k), np.int64),
                            np.zeros(B, np.int64), active, seeds, temps, tops)
                self._issue("spec_step", m)
            self._spec_dev = None
        if self.paged and self._prefix is not None:
            # a suffix prefill of 8 tokens after one page, in a single bucket,
            # and its first-token sampling (nothing else is live: page 0 is
            # free, and slot 0's state is rebuilt at its next insert)
            toks = np.zeros((1, self.prefill_bucket), np.int64)
            seg = np.zeros((1, self.prefill_bucket), np.int32)
            toks[0, :8], seg[0, :8] = 1, 1
            self._issue("suffix", 0, [0, 0], self.page_size, toks, seg, [0.0], [1.0], [0], [S])
        self._issue("set_token", 0, 0)
        self.tokens.cpu()  # wait for all of it
        self.warmup_s = time.perf_counter() - t0
        logger.info("warmup: %.1fs (prompt bucket for len %d, image=%s, batch sizes %s)",
                    self.warmup_s, prompt_len, image, self._prefill_batch_sizes())
        return self.warmup_s

    # -- prefill thread ---------------------------------------------------

    def _prefill_loop(self):
        """Admission pipeline: take everything waiting (up to
        ``prefill_batch``) into one batched prefill, keep up to two batches
        in flight, and fetch the oldest one's first tokens when the pipeline
        is full or nothing new arrived."""
        with torch.inference_mode():
            inflight: "deque[_InflightPrefill]" = deque()
            while not self._stop.is_set():
                dispatched = False
                if len(inflight) < 2 and self._ready.qsize() < 2:
                    reqs: List[Request] = []
                    try:
                        if inflight:
                            reqs.append(self._queue.get_nowait())
                        else:  # idle: block briefly instead of spinning
                            reqs.append(self._queue.get(timeout=0.05))
                    except queue.Empty:
                        pass
                    while reqs and len(reqs) < self.prefill_batch:
                        try:
                            reqs.append(self._queue.get_nowait())
                        except queue.Empty:
                            break
                    # Prefix-cache routing (paged): a request whose prompt
                    # prefix is pooled skips the full prefill; only host
                    # hashing happens here, its suffix prefill runs on the
                    # engine thread, which owns the pool.
                    keymap: Dict[int, List[bytes]] = {}
                    if reqs and self._prefix is not None:
                        remaining = []
                        for r in reqs:
                            try:
                                route = self._route_prefix(r)
                            except Exception:
                                logger.exception("prefix routing failed")
                                route = []
                            if isinstance(route, _PreparedSuffix):
                                self._ready.put(route)
                            else:
                                keymap[id(r)] = route
                                remaining.append(r)
                        reqs = remaining
                    if reqs:
                        try:
                            inflight.append(self._dispatch_prefill(reqs, keymap))
                            self.prefill_dispatches += 1
                            self.prefill_requests += len(reqs)
                            dispatched = True
                        except Exception:
                            logger.exception("prefill dispatch failed")
                            self._end(reqs)
                if inflight and (len(inflight) >= 2 or not dispatched):
                    inf = inflight.popleft()
                    try:
                        preps = self._finish_prefill(inf)
                    except Exception:
                        logger.exception("prefill failed")
                        self._end(inf.reqs)
                        continue
                    for prep in preps:
                        if prep is not None:
                            self._ready.put(prep)
                elif not dispatched and not inflight and self._ready.qsize() >= 2:
                    time.sleep(self.idle_sleep)
            # stop() raced a queued but unfetched batch: its requests still
            # get their terminal chunk, or their readers stall until timeout
            while inflight:
                self._end(inflight.popleft().reqs)

    @staticmethod
    def _end(reqs: List[Request]):
        for req in reqs:
            req._chunks.put(None)
            req._done.set()

    def _prefill_batch_sizes(self) -> List[int]:
        """The batch sizes a prefill pads to: powers of two up to
        ``prefill_batch``, and ``prefill_batch`` itself."""
        sizes, p = [], 1
        while p < self.prefill_batch:
            sizes.append(p)
            p *= 2
        sizes.append(self.prefill_batch)
        return sizes

    def _route_prefix(self, req: Request):
        """A request's admission path: a :class:`_PreparedSuffix` when a
        usable pooled prefix exists (its pages pinned), else the chain hashes
        of the prompt's full pages, for the full prefill to publish.

        A hit is usable when at least one full page matched, every image's
        feature span lies inside the matched prefix (the suffix prefill is
        text only: a multi-turn follow-up skips the vision tower), and at
        least one prompt token remains to give the first token's logits."""
        ids = np.asarray(tokenizer_image_token(req.prompt, self.tokenizer), np.int64)
        npatch = self.cfg.num_image_tokens
        plan = plan_multimodal_batch([ids], num_patches=npatch, max_len=self.max_seq_len)
        prompt_len = int(plan.lengths[0])
        fused = np.asarray(plan.tokens[0][:prompt_len])
        n_img = int(plan.num_images[0])
        imgs = None if req.images is None else np.asarray(req.images)
        if n_img and (imgs is None or imgs.shape[0] < n_img):
            return []  # malformed: the full prefill path raises or handles it
        spans = [(int(plan.image_pos[0][j * npatch]), image_digest(imgs[j]))
                 for j in range(n_img)]
        P = self.page_size
        keys = page_keys(fused, spans, npatch, P, n_pages=prompt_len // P)
        # the Generator's clamp, as on the full prefill path
        budget = min(req.max_new_tokens, self.max_seq_len - prompt_len)
        n_max = (prompt_len - 1) // P
        n_lo = max((-(-(s + npatch) // P) for s, _ in spans), default=1)
        if budget <= 0 or n_max < n_lo:
            return keys
        hit = self._match_prefix(keys[:n_max])
        if len(hit) < n_lo:
            if hit:
                self._release_pages(hit)
            return keys
        prefix_len = len(hit) * P
        total_pages = -(-(prompt_len + budget + 1) // P)
        return _PreparedSuffix(
            req=req, hit_pages=hit, prefix_len=prefix_len,
            suffix_ids=fused[prefix_len:prompt_len].astype(np.int64),
            prompt_len=prompt_len, budget=budget, history=[int(t) for t in fused],
            needed_pages=max(total_pages - len(hit), 0), page_keys=keys)

    def _prepare(self, reqs: List[Request],
                 keymap: Optional[Dict[int, List[bytes]]] = None) -> List[Optional[_Prepared]]:
        """Dispatch and finish in one call (warmup and tests; the serving
        loop pipelines the two phases across batches)."""
        return self._finish_prefill(self._dispatch_prefill(reqs, keymap))

    def _dispatch_prefill(self, reqs: List[Request],
                          keymap: Optional[Dict[int, List[bytes]]] = None) -> _InflightPrefill:
        """Host prep (tokenize, plan, pad to a batch size), then queue the
        prefill and the first-token sampling without waiting for them."""
        n_real = len(reqs)
        N = next(s for s in self._prefill_batch_sizes() if s >= n_real)
        pad = N - n_real
        t0 = time.perf_counter()
        prompts = [r.prompt for r in reqs] + [reqs[-1].prompt] * pad
        images = None
        if any(r.images is not None for r in reqs):
            images = [r.images for r in reqs] + [reqs[-1].images] * pad
        arrays, plan = multimodal_arrays(
            self.cfg, self.tokenizer, prompts, images, max_seq_len=self.max_seq_len,
            prefill_bucket=self.prefill_bucket)
        t_host = time.perf_counter()

        pid = next(self._pids)
        cacheN, firsts, _ = self._issue(
            "prefill", pid, list(self._caches.keys()), arrays,
            *_sampling(reqs + [reqs[-1]] * pad, n_real),
            np.maximum(np.asarray(plan.lengths) - 1, 0).tolist())
        return _InflightPrefill(reqs=reqs, firsts=firsts, cacheN=cacheN, pid=pid, plan=plan,
                                keymap=keymap or {}, t0=t0, t_host=t_host,
                                t_dispatch=time.perf_counter())

    def _sample_first(self, logits: torch.Tensor, temps, tops, seeds,
                      positions: List[int]) -> torch.Tensor:
        """First tokens [N] from the last-token logits [N, V] and the rows'
        sampling settings (:func:`_sampling`), keyed on (seed, position) as
        every decode step samples."""
        def dev(values, dtype):
            return torch.tensor(values, dtype=dtype, device=self.device)

        return sample_batch(logits, dev(temps, torch.float32), dev(tops, torch.float32),
                            dev(seeds, torch.int64), dev(positions, torch.int64),
                            any(t > 0.0 for t in temps))

    def _finish_prefill(self, inf: _InflightPrefill) -> List[Optional[_Prepared]]:
        """Fetch the batch's first tokens (the wait for its prefill), emit
        each client's first token, and build the slot-insertion records."""
        tids = inf.firsts.tolist()
        now = time.time()
        logger.debug("prepare n=%d: host=%.3fs queue=%.3fs fetch=%.3fs", len(tids),
                     inf.t_host - inf.t0, inf.t_dispatch - inf.t_host,
                     time.perf_counter() - inf.t_dispatch)
        tokens_host = np.asarray(inf.plan.tokens)
        preps: List[Optional[_Prepared]] = []
        for i, req in enumerate(inf.reqs):
            prompt_len = int(inf.plan.lengths[i])
            # the Generator's clamp: as many tokens as the window holds
            budget = min(req.max_new_tokens, self.max_seq_len - prompt_len)
            needed_pages = 0
            if self.paged:
                P = self.page_size
                needed_pages = max(inf.cacheN.max_len // P, -(-(prompt_len + budget + 1) // P))
            tid = int(tids[i])
            req.first_token_ts = now
            if req.submit_ts:
                self.ttfts.append(now - req.submit_ts)
            out_ids, budget, finished = self._emit_first(req, tid, budget)
            if finished:
                preps.append(None)  # never occupies a slot
                continue
            history = [int(t) for t in tokens_host[i][:prompt_len]] + [tid]
            preps.append(_Prepared(req=req, cache1=inf.cacheN, pid=inf.pid, row=i, first_id=tid,
                                   prompt_len=prompt_len, budget=budget, out_ids=out_ids,
                                   history=history, needed_pages=needed_pages,
                                   page_keys=inf.keymap.get(id(req), [])))
        return preps

    # -- engine thread ----------------------------------------------------

    def _emit_first(self, req: Request, tid: int, budget: int):
        """eos / budget / stop-string checks on the first sampled token.
        Returns (out_ids, budget, finished); finished requests are complete."""
        out_ids: List[int] = []
        finished = False
        if tid == self.tokenizer.eos_token_id or budget <= 0:
            finished = True
        else:
            out_ids.append(tid)
            budget -= 1
            text = self.tokenizer.decode(out_ids, skip_special_tokens=True)
            for stop_s in req.stop_strings:
                if stop_s and stop_s in text:
                    text = text.split(stop_s)[0]
                    finished = True
            req._chunks.put(text)
        if finished:
            req._chunks.put(None)
            req._done.set()
        return out_ids, budget, finished

    def _admit(self) -> int:
        inserted = 0
        free = [i for i, s in enumerate(self._slots) if s.request is None]
        while free:
            prep, self._waiting = self._waiting, None
            if prep is None:
                try:
                    prep = self._ready.get_nowait()
                except queue.Empty:
                    break
            slot_id = free.pop(0)
            try:
                self._insert_prepared(slot_id, prep)
                inserted += 1
            except _PoolExhausted:
                # hold the prepared request until finished slots free pages
                self._waiting = prep
                break
            except Exception:
                logger.exception("insert failed")
                self._end([prep.req])
        return inserted

    def _insert_prepared(self, slot_id: int, prep):
        if isinstance(prep, _PreparedSuffix):
            return self._insert_suffix(slot_id, prep)
        pages: List[int] = []
        if self.paged:
            pages = self._alloc_pages(prep.needed_pages)  # may raise _PoolExhausted
            try:
                self._issue("insert_paged", prep.pid, prep.row, slot_id, pages, prep.first_id)
            except Exception:
                self._release_pages(pages)
                raise
            self._publish_prefix(prep.page_keys, pages)
        else:
            self._issue("insert", prep.pid, prep.row, slot_id, prep.first_id)
        slot = self._slots[slot_id]
        slot.pages = pages
        slot.request = prep.req
        slot.out_ids = prep.out_ids
        slot.pos = prep.prompt_len
        slot.budget = prep.budget
        slot.history = prep.history
        slot.skip_next_emit = True

    def _insert_suffix(self, slot_id: int, prep: _PreparedSuffix):
        """Admit a prefix-cache hit: attach the shared prefix pages and fresh
        ones to the slot, prefill only the suffix over the pool, emit the
        first token (so a hit's TTFT is the suffix prefill's, with no vision
        encode) and activate the slot."""
        req = prep.req
        fresh = self._alloc_pages(prep.needed_pages)  # may raise _PoolExhausted
        pages = prep.hit_pages + fresh
        suffix_len = prep.prompt_len - prep.prefix_len
        Tb = -(-suffix_len // self.prefill_bucket) * self.prefill_bucket
        toks = np.zeros((1, Tb), np.int64)
        toks[0, :suffix_len] = prep.suffix_ids
        seg = np.zeros((1, Tb), np.int32)
        seg[0, :suffix_len] = 1
        try:
            tid = int(self._issue("suffix", slot_id, pages, prep.prefix_len, toks, seg,
                                  *_sampling([req], 1), [prep.prompt_len - 1])[0])
        except Exception:
            self._release_pages(pages)  # the pinned hits are this request's too
            raise
        now = time.time()
        req.first_token_ts = now
        if req.submit_ts:
            self.ttfts.append(now - req.submit_ts)
        self.prefix_hit_tokens += prep.prefix_len
        out_ids, budget, finished = self._emit_first(req, tid, prep.budget)
        self._publish_prefix(prep.page_keys, pages)
        if finished:
            # the slot stays free; its next occupant's insert rebuilds its
            # seg row and page table
            self._release_pages(pages)
            return
        self._issue("set_token", tid, slot_id)
        slot = self._slots[slot_id]
        slot.request = req
        slot.out_ids = out_ids
        slot.pos = prep.prompt_len
        slot.budget = budget
        slot.pages = pages
        slot.history = prep.history + [tid]
        slot.skip_next_emit = True

    def _emit_token(self, slot: _Slot, tid: int) -> bool:
        """Emit one decoded token for a slot (eos / budget / stop strings
        matched on the decoded text). Frees the slot and returns True when
        the request finished."""
        req = slot.request
        finished = False
        if tid == self.tokenizer.eos_token_id or slot.budget <= 0:
            finished = True
        else:
            slot.out_ids.append(tid)
            slot.history.append(tid)
            slot.budget -= 1
            text = self.tokenizer.decode(slot.out_ids, skip_special_tokens=True)
            for stop_s in req.stop_strings:
                if stop_s and stop_s in text:
                    text = text.split(stop_s)[0]
                    finished = True
            req._chunks.put(text)
        if finished:
            self._finish_slot(slot)
        return finished

    def _finish_slot(self, slot: _Slot):
        slot.request._chunks.put(None)
        slot.request._done.set()
        slot.request = None
        if slot.pages:
            self._release_pages(slot.pages)
            slot.pages = []

    def _emit_column(self, tokens_host):
        """Emit one decoded column: each active slot's token, with eos /
        budget / stop handling; finished slots are freed."""
        for i, slot in enumerate(self._slots):
            if slot.request is None:
                continue
            if slot.skip_next_emit:
                slot.skip_next_emit = False
                continue
            self._emit_token(slot, int(tokens_host[i]))

    def _current_tokens(self) -> np.ndarray:
        """Host mirror of each slot's current token (its history's tail)."""
        return np.array([slot.history[-1] if slot.request is not None and slot.history else 0
                         for slot in self._slots], np.int64)

    # -- speculation (engine thread) --------------------------------------

    def _spec_state(self, *, cur=None, hlen=None, hist=None, prop=None, budget=None,
                    active, seeds, temps, tops, any_sampled: bool) -> Dict[str, object]:
        """A verify step's device state; the parts not given are zeros."""
        B, S, k, dev = self.max_slots, self.max_seq_len, self.speculate, self.device

        def dev_or_zeros(x, *shape):
            if x is None:
                return torch.zeros(shape, dtype=torch.int64, device=dev)
            return self._upload(x)

        return {"cur": dev_or_zeros(cur, B), "hlen": dev_or_zeros(hlen, B),
                "hist": dev_or_zeros(hist, B, S + 1), "prop": dev_or_zeros(prop, B, k),
                "budget": dev_or_zeros(budget, B), "active": active, "seeds": seeds,
                "temps": temps, "tops": tops, "any_sampled": any_sampled}

    def _spec_refresh(self):
        """Build the device state from the host mirrors (each slot's history
        and budget). Runs only when the slots' membership changes
        (admission, a finish, the end of a pause); steps otherwise update
        the state on the device."""
        t0 = time.perf_counter()
        self.spec_refreshes += 1
        B, S, k = self.max_slots, self.max_seq_len, self.speculate
        hist = np.zeros((B, S + 1), np.int64)
        hlen = np.zeros(B, np.int64)
        cur = np.zeros(B, np.int64)
        budget = np.zeros(B, np.int64)
        prop = np.zeros((B, k), np.int64)
        temps = np.zeros(B, np.float32)
        tops = np.ones(B, np.float32)
        active = np.zeros(B, bool)
        seeds = np.zeros(B, np.int64)
        for i, slot in enumerate(self._slots):
            if slot.request is None:
                continue
            h = slot.history[-S:]
            hist[i, :len(h)] = h
            hlen[i] = len(h)
            cur[i] = h[-1]
            budget[i] = slot.budget
            prop[i] = propose(slot.history, k)
            temps[i] = slot.request.temperature
            tops[i] = slot.request.top_p
            seeds[i] = slot.request.seed & _MASK32
            active[i] = True
            # the verify steps' rows emit everything from here on; the first
            # token, emitted by the prefill, enters as cur
            slot.skip_next_emit = False

        self._issue("spec_refresh", cur, hlen, hist, prop, budget, active, seeds, temps, tops)
        self.spec_timers["refresh"] += time.perf_counter() - t0

    def _spec_dispatch(self, m: int):
        """Queue a chunk of ``m`` verify steps on the current device state and
        start the copy of its rows to the host, with no host sync."""
        t0 = time.perf_counter()
        host, event = _to_host(self._issue("spec_step", m))
        self.spec_timers["dispatch"] += time.perf_counter() - t0
        # the slots' requests now: a slot that turns over before the fetch
        # (a finish, then an admission) must not take this chunk's tokens
        self._spec_inflight.append((host, event, [s.request for s in self._slots]))

    def _spec_collect(self) -> bool:
        """Wait for the oldest chunk's rows and emit them row by row. A slot
        that finishes on a row (eos, stop string, budget) skips the later
        rows of the chunk: the device kept stepping it, but they are
        garbage and the refresh rebuilds its state. Returns True when the
        slots' membership changed (the device state is stale)."""
        host, event, owners = self._spec_inflight.popleft()
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        out = host.numpy()                   # [m, B, k + 2]
        t1 = time.perf_counter()
        self.spec_timers["fetch"] += t1 - t0
        changed = False
        done = [False] * len(self._slots)
        for row in out:
            row_live = False
            for i, slot in enumerate(self._slots):
                if done[i] or slot.request is None or slot.request is not owners[i]:
                    continue
                row_live = True
                e = int(row[i, -1])
                if e == 0:
                    # its device budget ran out on an earlier step
                    self._finish_slot(slot)
                    changed = done[i] = True
                    continue
                greedy = slot.request.temperature <= 0.0
                finished, delivered = False, 0
                for j in range(e):
                    finished = self._emit_token(slot, int(row[i, j]))
                    if finished:
                        break
                    delivered += 1
                if greedy:
                    # the acceptance counts delivered tokens (not a final eos
                    # or stop)
                    self.spec_emitted += delivered
                    self.spec_slot_steps += 1
                    self._spec_recent.append(delivered)
                if finished:
                    changed = done[i] = True
                else:
                    slot.pos += e
            if row_live:
                # rows in which every slot had already finished are masked
                # no-ops, not steps
                self.spec_steps += 1
        self.spec_timers["emit"] += time.perf_counter() - t1
        return changed

    def _spec_drain(self):
        """Collect every chunk in flight: the host catches up with the
        device (before a refresh or a switch to plain decoding)."""
        while self._spec_inflight:
            self._spec_collect()

    @property
    def spec_acceptance(self) -> float:
        """Tokens the greedy slots delivered per verify step with a live slot,
        summed over the slots as the JAX engine sums them (1 to k + 1 for a
        single slot)."""
        return self.spec_emitted / self.spec_steps if self.spec_steps else 0.0

    def _spec_iteration(self, inserted: int) -> bool:
        """One pass of the speculative loop; False when the engine is paused
        and a plain chunk should run instead."""
        if inserted and self._spec_dev is not None:
            # new occupants: emit what is in flight (its writes to their
            # slots are queued before their inserts), then rebuild
            self._spec_drain()
            self._spec_dev = None
        if self._spec_pause > 0:
            self._spec_pause -= 1
            if self._spec_pause:
                return False
            # plain -> spec: the plain path holds one column not yet emitted;
            # emit it, so the host mirrors (histories) are current
            self._emit_column(self.tokens[:, 0].tolist())
            self._spec_recent.clear()
            self._spec_dev = None
            return True
        self.spec_timers["iters"] += 1
        if self._spec_dev is None:
            self._spec_refresh()
        # a prepared request waiting to insert gets an admission point after
        # one step; otherwise spec_chunk steps share a dispatch and a fetch
        m = 1 if (self._waiting is not None or not self._ready.empty()) else self.spec_chunk
        while len(self._spec_inflight) < self.spec_depth:
            self._spec_dispatch(m)
        if self._spec_collect():
            self._spec_drain()
            self._spec_dev = None
            return True
        recent = self._spec_recent
        if len(recent) == recent.maxlen and sum(recent) / len(recent) < self.spec_min_accept:
            # too few accepted to pay for the verify: plain chunks a while.
            # spec -> plain: the current tokens (already emitted) seed the
            # plain path, which skips their emission
            self._spec_drain()
            self._spec_pause = self.spec_pause_len
            self.spec_pauses += 1
            recent.clear()
            self._spec_dev = None
            self._issue("set_tokens", self._current_tokens()[:, None])
            for slot in self._slots:
                if slot.request is not None:
                    slot.skip_next_emit = True
        return True

    def _loop(self):
        with torch.inference_mode():
            while not self._stop.is_set():
                inserted = self._admit()
                active_idx = [i for i, s in enumerate(self._slots) if s.request is not None]
                if not active_idx:
                    time.sleep(self.idle_sleep)
                    continue
                try:
                    if self.speculate and self._spec_iteration(inserted):
                        continue
                    self._decode_chunk(active_idx)
                except Exception:
                    logger.exception("decode failed; ending the active requests")
                    self._spec_inflight.clear()
                    self._spec_dev = None
                    for slot in self._slots:
                        if slot.request is not None:
                            self._finish_slot(slot)

    def _decode_chunk(self, active_idx: List[int]):
        # A prepared request waiting to insert gets the next admission point
        # after one step (its first token was already emitted).
        k = 1 if (self._waiting is not None or not self._ready.empty()) else self.decode_chunk
        B = self.max_slots
        active = np.zeros(B, bool)
        temps = np.zeros(B, np.float32)
        tops = np.ones(B, np.float32)
        positions = np.full(B, self.max_seq_len, np.int32)  # idle: writes dropped
        seeds = np.zeros(B, np.int64)
        for i in active_idx:
            req = self._slots[i].request
            active[i] = True
            temps[i] = req.temperature
            tops[i] = req.top_p
            positions[i] = self._slots[i].pos
            seeds[i] = req.seed & _MASK32
        if len(active_idx) > 1:
            self.multi_slot_steps += k

        prev = self.tokens
        toks = self._issue("decode", positions, active, temps, tops, seeds,
                           bool((temps > 0).any()), k)
        # The column held over from the previous chunk (or a fresh slot's
        # first token, skipped), then this chunk's columns but its last,
        # which is held in self.tokens and emitted next time.
        self._emit_column(prev[:, 0].tolist())
        cols = toks.tolist()
        for j in range(k - 1):
            self._emit_column([row[j] for row in cols])
        for i in active_idx:
            self._slots[i].pos += k
