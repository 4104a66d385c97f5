"""Exact cross-request KV prefix reuse over the paged pool (the port's own
copy of ``llava_plus_tpu/serve/prefix_cache.py``; the chain hashes are the
same bytes, so both packages address pages alike).

Multi-turn chat resends the whole conversation every turn (the reference
web servers rebuild the full prompt from conversation state each round —
``llava/serve/gradio_web_server.py:156-305``), so turn N's prefill
recomputes everything turn N-1 already computed — including the 576-token
vision encode. Because attention is causal, the KV of a page (128
contiguous positions) is a pure function of the token/image prefix up to
that page's end, so pages can be content-addressed and shared across
requests: a new request whose prompt starts with an already-cached prefix
skips straight to prefilling only the suffix.

Host-side bookkeeping only — the shared pages live in the engine's paged
pool (``models/llama.py:PagedKVCache``); this module maps chain hashes to
page ids and tracks reuse. Sharing is EXACT (same fused tokens + same
image bytes -> bit-identical KV), so generation with the prefix cache on
equals generation with it off (tests/test_torch_paged.py).

Page lifetime is refcounted by the engine: a page is referenced by each
slot whose page table contains it, plus once by this cache while
published. Eviction (LRU) only drops the cache's own reference; pages in
use by live requests are never recycled under them.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# (feature_start_position, image_digest) — one per image in the request;
# the digest folds the image CONTENT into every page whose span overlaps
# the image's feature positions (fused token ids at those positions are
# all pad and carry no identity).
ImageSpan = Tuple[int, bytes]


def image_digest(image: Optional[np.ndarray]) -> bytes:
    if image is None:
        return b""
    arr = np.ascontiguousarray(image)
    return hashlib.blake2b(
        arr.tobytes() + str(arr.shape).encode(), digest_size=16
    ).digest()


def page_keys(
    fused_tokens: np.ndarray,
    image_spans: Sequence[ImageSpan],
    num_patches: int,
    page_size: int,
    n_pages: Optional[int] = None,
) -> List[bytes]:
    """Chain hashes for the first ``n_pages`` FULL pages of a fused token
    sequence (default: every full page). Key i commits to everything that
    determines the KV content of positions [0, (i+1)*page_size): the fused
    token ids AND the digest of every image whose feature span overlaps
    the range — two prompts share page i iff they are byte-identical up
    to its end."""
    ids = np.asarray(fused_tokens, np.int64)
    total = len(ids) // page_size if n_pages is None else n_pages
    keys: List[bytes] = []
    chain = b"llava-plus-tpu/prefix/v1"
    for i in range(total):
        lo, hi = i * page_size, (i + 1) * page_size
        h = hashlib.blake2b(chain, digest_size=16)
        h.update(ids[lo:hi].tobytes())
        for start, digest in image_spans:
            if start < hi and start + num_patches > lo:
                h.update(digest)
        chain = h.digest()
        keys.append(chain)
    return keys


class PagePrefixCache:
    """LRU map of chain hash -> pool page id.

    NOT thread-safe by itself: the engine serializes all calls (and the
    incref/decref callbacks) under its page-allocator lock.
    """

    def __init__(self, incref: Callable[[int], None],
                 decref: Callable[[int], None]):
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self._incref = incref
        self._decref = decref
        # observability
        self.lookups = 0
        self.hit_requests = 0
        self.hit_pages_total = 0

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, keys: Sequence[bytes]) -> List[int]:
        """Longest-prefix match: page ids for the leading run of ``keys``
        present in the cache (refreshing their LRU position). The CALLER
        must incref the returned pages (under the same lock) before
        releasing the lock — matched pages must not be evictable between
        match and use."""
        self.lookups += 1
        pages: List[int] = []
        for k in keys:
            pid = self._entries.get(k)
            if pid is None:
                break
            self._entries.move_to_end(k)
            pages.append(pid)
        if pages:
            self.hit_requests += 1
            self.hit_pages_total += len(pages)
        return pages

    def publish(self, keys: Sequence[bytes], pages: Sequence[int]) -> int:
        """Register pages under their chain hashes (increfs each newly
        published page; already-known hashes keep their existing page and
        are only LRU-refreshed). Returns the number newly published."""
        added = 0
        for k, pid in zip(keys, pages):
            if k in self._entries:
                self._entries.move_to_end(k)
                continue
            self._entries[k] = pid
            self._incref(pid)
            added += 1
        return added

    def evict_lru(self) -> bool:
        """Drop the least-recently-used entry (decrefs its page; the page
        only becomes reusable if no live slot still references it).
        Returns False when empty."""
        if not self._entries:
            return False
        _, pid = self._entries.popitem(last=False)
        self._decref(pid)
        return True
