"""The port's paged KV slice against the JAX package, on the CPU, in f32
(mirrors ``tests/test_paged_attention.py``, ``tests/test_paged_cache.py``,
``tests/test_engine_paged.py`` and ``tests/test_engine_prefix.py``).

- the plain paged attention (what both CUDA kernels compute) against JAX
  ``paged_attention_reference`` on seeded inputs, live rows, atol 1e-5 (f32
  softmax sums in another order);
- the paged write (int8 quantization, page addressing, writes past the
  allocation dropped) byte for byte against the jitted JAX write;
- the decoder over a ``PagedKVCache`` against the jitted JAX decoder (logits
  atol 1e-4, the cache state array for array: segment ids exactly, pools to
  1e-5 in f32 and to one int8 step, since the chunk's k/v differ from JAX's
  in the last bit), against the port's dense cache, and a short (kernel
  path) and a long (gather path) continuation against the uncached forward;
- the paged engine's greedy text against the JAX paged engine and the
  port's dense engine, with page recycling, pool exhaustion, an image
  request, prefix hits, image identity and eviction under a small pool.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.models import llama as jax_llama
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.ops import paged_attention as jax_paged
from llava_plus_tpu.serve import engine as jax_engine
from llava_plus_torch.models import llama
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.ops import paged_attention as paged
from llava_plus_torch.serve.engine import BatchedEngine, Request

from .test_generate import CharTokenizer

torch.set_num_threads(1)
CFG = tiny_llava_config()
JCFG = jax_tiny_config()  # the same config, the JAX package's own
LOGITS = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# ---------------------------------------------------------------- attention

def _pool_inputs(rng, B, Tq, H, Hkv, D, P, maxp, quantized, cur):
    NP = B * maxp + 3
    page_ids = rng.permutation(NP)[:B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = rng.integers(1, maxp * P + 1, size=B).astype(np.int32)
    kv = rng.normal(size=(NP, 2, P, Hkv, D)).astype(np.float32)
    scale = None
    if quantized:
        s = np.maximum(np.abs(kv).max(-1), 1e-8) / 127.0
        kv = np.clip(np.round(kv / s[..., None]), -127, 127).astype(np.int8)
        scale = np.ascontiguousarray(s.transpose(0, 1, 3, 2)).astype(np.float32)
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    ck = cv = valid = None
    if cur:
        ck = rng.normal(size=(B, Tq, Hkv, D)).astype(np.float32)
        cv = rng.normal(size=(B, Tq, Hkv, D)).astype(np.float32)
        valid = rng.integers(1, Tq + 1, size=B).astype(np.int32)
    return q, kv, page_ids, lengths, scale, ck, cv, valid


@pytest.mark.parametrize("H,Hkv,Tq,quantized,cur", [
    (4, 4, 1, False, False),   # MHA decode, query already in the pool
    (4, 4, 1, False, True),    # MHA decode (decode1 on the card)
    (4, 4, 1, True, True),
    (4, 2, 1, True, True),     # GQA decode (the general kernel)
    (4, 4, 4, False, True),    # 4-token chunk with valid prefixes
    (4, 1, 8, True, True),     # MQA, 8-token chunk
    (8, 2, 7, False, True),
])
def test_plain_paged_attention_matches_jax(H, Hkv, Tq, quantized, cur):
    rng = np.random.default_rng(H * 100 + Hkv * 10 + Tq)
    q, kv, pt, lengths, scale, ck, cv, valid = _pool_inputs(
        rng, B=3, Tq=Tq, H=H, Hkv=Hkv, D=32, P=16, maxp=4, quantized=quantized, cur=cur)
    want = jax_paged.paged_attention_reference(
        _j(q), _j(kv), _j(pt), _j(lengths), _j(scale),
        cur_k=_j(ck), cur_v=_j(cv), cur_valid=_j(valid))
    args = [_t(x) for x in (q, kv, pt, lengths, scale, ck, cv, valid)]
    got = paged.paged_attention_reference(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the dispatch takes the plain version for CPU tensors
    torch.testing.assert_close(paged.paged_decode_attention(*args), got, atol=0, rtol=0)


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(5)
    _, kv, pt, _, scale, _, _, _ = _pool_inputs(rng, 2, 1, 4, 2, 16, 8, 3, True, False)
    for s in (None, scale):
        want = jax_paged.gather_pages(_j(kv), _j(pt), _j(s))
        got = paged.gather_pages(_t(kv), _t(pt), _t(s))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dead_slot_output_is_finite_and_alibi_raises():
    """A slot with no past token and no valid chunk token comes out finite,
    with ALiBi too (whose live rows equal the JAX reference); slopes that
    are not f32 [H] raise."""
    from llava_plus_torch.models.mpt import alibi_slopes

    rng = np.random.default_rng(6)
    q, kv, pt, lengths, scale, ck, cv, valid = _pool_inputs(
        rng, 2, 2, 4, 2, 16, 8, 2, True, True)
    lengths[1], valid[1] = 0, 0
    args = [_t(x) for x in (q, kv, pt, lengths, scale, ck, cv, valid)]
    assert torch.isfinite(paged.paged_decode_attention(*args)).all()
    got = paged.paged_decode_attention(*args, alibi_slopes=alibi_slopes(4))
    assert torch.isfinite(got).all()
    from llava_plus_tpu.models import mpt as jax_mpt
    want = jax_paged.paged_attention_reference(
        *(_j(x) for x in (q, kv, pt, lengths, scale)), cur_k=_j(ck), cur_v=_j(cv),
        cur_valid=_j(valid), alibi_slopes=jax_mpt.alibi_slopes(4))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], atol=1e-5, rtol=1e-4)
    for bad in (torch.ones(3), torch.ones(4, dtype=torch.float64)):
        with pytest.raises(ValueError):
            paged.paged_decode_attention(*args, alibi_slopes=bad)


def test_kernel_input_checks():
    """What the kernels do not take raises before a launch (checked here on
    CPU tensors; on the card the wrappers run these checks first)."""
    B, Tq, H, Hkv, D, P, NP = 2, 1, 4, 4, 128, 16, 6
    q = torch.zeros(B, Tq, H, D, dtype=torch.bfloat16)
    kv = torch.zeros(NP, 2, P, Hkv, D, dtype=torch.bfloat16)
    pt = torch.zeros(B, 2, dtype=torch.int32)
    lens = torch.zeros(B, dtype=torch.int32)
    ck = torch.zeros(B, Tq, Hkv, D, dtype=torch.bfloat16)
    valid = torch.ones(B, dtype=torch.int32)
    paged._check_kernel_inputs(q, kv, pt, lens, None, ck, ck, valid)
    bad = [
        (q.float(), kv, pt, lens, None, ck, ck, valid),                  # f32 query
        (q[..., :64], kv[..., :64], pt, lens, None, ck[..., :64], ck[..., :64], valid),
        (torch.zeros(B, 9, H, D, dtype=torch.bfloat16), kv, pt, lens, None,
         torch.zeros(B, 9, Hkv, D, dtype=torch.bfloat16),
         torch.zeros(B, 9, Hkv, D, dtype=torch.bfloat16), valid),         # 9 chunk tokens
        (q, kv.to(torch.int8), pt, lens, None, ck, ck, valid),           # int8 pool, no scales
        (q, kv, pt.long(), lens, None, ck, ck, valid),                    # int64 page ids
        (torch.zeros(B, 2, H, D, dtype=torch.bfloat16), kv, pt, lens, None, None, None, None),
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            paged._check_kernel_inputs(*args)


# ---------------------------------------------------------------- cache

@pytest.mark.parametrize("int8", [False, True])
def test_paged_write_matches_jitted_jax(int8):
    """The deferred write of every layer's chunk: int8 values and scales
    (and f32 values) land byte for byte where the jitted JAX write puts
    them, and writes of padding, of positions past the slot's allocation
    (page table filler 0) and past max_len are dropped."""
    rng = np.random.default_rng(1)
    L, B, T, Hkv, D, P, Np, maxp = 2, 3, 5, 2, 16, 8, 6, 3
    new_k = rng.normal(size=(L, B, T, Hkv, D)).astype(np.float32)
    new_v = rng.normal(size=(L, B, T, Hkv, D)).astype(np.float32)
    pt = np.array([[4, 1, 0], [2, 5, 0], [3, 0, 0]], np.int32)
    alloc = np.array([3 * P, 2 * P, P], np.int32)
    positions = np.array([[3, 4, 5, 6, 7], [14, 15, 16, 17, 18], [6, 7, 8, 9, 10]], np.int32)
    positions[0, 4] = maxp * P                      # past max_len
    seg = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    if int8:
        kv0 = rng.integers(-127, 128, size=(L, Np, 2, P, Hkv, D)).astype(np.int8)
        sc0 = rng.uniform(0.1, 1, size=(L, Np, 2, Hkv, P)).astype(np.float32)
    else:
        kv0, sc0 = rng.normal(size=(L, Np, 2, P, Hkv, D)).astype(np.float32), None

    def jax_write(kv, sc, nk, nv, positions, seg, pt, alloc):
        pidx = jnp.clip(positions // P, 0, maxp - 1)
        pages = jnp.take_along_axis(pt, pidx, axis=1)
        valid = (positions < maxp * P) & (seg > 0) & (positions < alloc[:, None])
        if sc is None:
            zeros = jnp.zeros(nk.shape[:-1], jnp.float32)
            return jax_llama._paged_write_all(kv, None, nk, nv, zeros, zeros, pages,
                                              positions % P, valid)
        (qk, sk), (qv, sv) = jax_llama._paged_quant(nk), jax_llama._paged_quant(nv)
        return jax_llama._paged_write_all(kv, sc, qk, qv, sk, sv, pages, positions % P, valid)

    want_kv, want_sc = jax.jit(jax_write)(*map(_j, (kv0, sc0, new_k, new_v, positions, seg,
                                                    pt, alloc)))
    cache = llama.PagedKVCache.create(
        dataclasses.replace(CFG.text, num_hidden_layers=L, num_key_value_heads=Hkv,
                            num_attention_heads=Hkv, hidden_size=Hkv * D),
        B, num_pages=Np, max_pages_per_slot=maxp, page_size=P,
        dtype=torch.int8 if int8 else torch.float32, device="cpu")
    cache.kv.copy_(_t(kv0))
    if int8:
        cache.kv_scale.copy_(_t(sc0))
    cache.page_table.copy_(_t(pt))
    cache.alloc.copy_(_t(alloc))
    step = llama._paged_step(cache, _t(positions), _t(seg))
    llama._paged_write_all(cache, [llama._stage(cache, _t(new_k[i]), _t(new_v[i]))
                                   for i in range(L)], step)
    np.testing.assert_array_equal(cache.kv.numpy(), np.asarray(want_kv))
    if int8:
        np.testing.assert_array_equal(cache.kv_scale.numpy(), np.asarray(want_sc))
    want_seg = np.zeros((B, maxp * P), np.int32)
    for b in range(B):
        for t in range(T):
            if positions[b, t] < maxp * P:
                want_seg[b, positions[b, t]] = seg[b, t]
    np.testing.assert_array_equal(cache.seg.numpy(), want_seg)


@pytest.fixture(scope="module")
def lm_params():
    p = jax_llama.init_params(JCFG.text, jax.random.PRNGKey(0), dtype=jnp.float32)
    return p, from_numpy(_np(p), "cpu")


_jax_forward = jax.jit(jax_llama.forward, static_argnames=("cfg", "attn_impl", "fresh_prefill"))


@pytest.mark.parametrize("int8", [False, True])
def test_paged_decoder_and_cache_state_match_jax(lm_params, int8):
    """A prefill (row 1 padded) and 14 decode steps over scrambled page
    tables, row 1's last two steps past its allocation (the page table's
    filler entry, page 0): logits and the cache state against the jitted
    JAX decoder, which the JAX engine runs."""
    jp, tp = lm_params
    P, B, T0, maxp, Np, steps = 16, 2, 24, 4, 9, 14
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 250, size=(B, T0)).astype(np.int32)
    pos = np.tile(np.arange(T0, dtype=np.int32), (B, 1))
    seg = np.ones((B, T0), np.int32)
    seg[1, 20:], pos[1, 20:] = 0, maxp * P             # row 1: a 20-token prompt
    pt = np.array([[3, 1, 5, 0], [7, 4, 0, 0]], np.int32)
    alloc = np.array([4 * P, 2 * P], np.int32)
    jdt, tdt = (jnp.int8, torch.int8) if int8 else (jnp.float32, torch.float32)
    jc = jax_llama.PagedKVCache.create(JCFG.text, B, num_pages=Np, max_pages_per_slot=maxp,
                                       page_size=P, dtype=jdt)
    jc = dataclasses.replace(jc, page_table=jnp.asarray(pt), alloc=jnp.asarray(alloc))
    tc = llama.PagedKVCache.create(CFG.text, B, num_pages=Np, max_pages_per_slot=maxp,
                                   page_size=P, dtype=tdt, device="cpu")
    tc.page_table.copy_(_t(pt))
    tc.alloc.copy_(_t(alloc))
    want, jc = _jax_forward(jp, JCFG.text, jnp.asarray(ids), positions=jnp.asarray(pos),
                            segment_ids=jnp.asarray(seg), cache=jc, attn_impl="xla",
                            fresh_prefill=True)
    got, _ = llama.forward(tp, CFG.text, _t(ids).long(), positions=_t(pos),
                           segment_ids=_t(seg), cache=tc, fresh_prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    tok = np.asarray(jnp.argmax(want[np.arange(B), [T0 - 1, 19]], -1)).astype(np.int32)
    for i in range(steps):
        p = np.array([[T0 + i], [20 + i]], np.int32)
        one = np.ones((B, 1), np.int32)
        want, jc = _jax_forward(jp, JCFG.text, jnp.asarray(tok[:, None]),
                                positions=jnp.asarray(p), segment_ids=jnp.asarray(one),
                                cache=jc, attn_impl="xla")
        got, _ = llama.forward(tp, CFG.text, _t(tok[:, None]).long(), positions=_t(p),
                               segment_ids=_t(one), cache=tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS, err_msg=f"step {i}")
        tok = np.asarray(jnp.argmax(want[:, 0], -1)).astype(np.int32)
    np.testing.assert_array_equal(tc.seg.numpy(), np.asarray(jc.seg))
    np.testing.assert_array_equal(tc.page_table.numpy(), np.asarray(jc.page_table))
    if int8:
        diff = np.abs(tc.kv.numpy().astype(np.int32) - np.asarray(jc.kv).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        np.testing.assert_allclose(tc.kv_scale.numpy(), np.asarray(jc.kv_scale), rtol=1e-5)
    else:
        np.testing.assert_allclose(tc.kv.numpy(), np.asarray(jc.kv), atol=1e-5, rtol=1e-5)
    # row 1's writes at positions 32 and 33 were dropped: page 0 (row 0's
    # fourth page, which row 0 has not reached) is still empty
    assert not tc.kv[:, 0].any() and not np.asarray(jc.kv[:, 0]).any()


@pytest.mark.parametrize("T1", [6, 12])
def test_paged_continuation_matches_dense_and_uncached(lm_params, T1):
    """A fresh prefill then a multi-token continuation over the paged cache
    (6 tokens: the paged kernels' path; 12: the gathered pages) equals the
    port's dense cache, the JAX paged cache and the uncached forward."""
    jp, tp = lm_params
    B, T0, P = 1, 8, 16
    rng = np.random.default_rng(7)
    full = rng.integers(3, 250, size=(B, T0 + T1)).astype(np.int32)
    pos0 = np.arange(T0, dtype=np.int32)[None]
    pos1 = np.arange(T0, T0 + T1, dtype=np.int32)[None]
    one0, one1 = np.ones((B, T0), np.int32), np.ones((B, T1), np.int32)
    ref, _ = jax_llama.forward(jp, JCFG.text, jnp.asarray(full), attn_impl="xla")
    jc = dataclasses.replace(
        jax_llama.PagedKVCache.create(JCFG.text, B, num_pages=3, max_pages_per_slot=2,
                                      page_size=P, dtype=jnp.float32),
        page_table=jnp.asarray([[2, 0]], jnp.int32))
    _, jc = _jax_forward(jp, JCFG.text, jnp.asarray(full[:, :T0]), positions=jnp.asarray(pos0),
                         segment_ids=jnp.asarray(one0), cache=jc, attn_impl="xla",
                         fresh_prefill=True)
    want, _ = _jax_forward(jp, JCFG.text, jnp.asarray(full[:, T0:]), positions=jnp.asarray(pos1),
                           segment_ids=jnp.asarray(one1), cache=jc, attn_impl="xla")
    outs = []
    for cache in (llama.KVCache.create(CFG.text, B, 2 * P, torch.float32, device="cpu"),
                  llama.PagedKVCache.create(CFG.text, B, num_pages=3, max_pages_per_slot=2,
                                            page_size=P, dtype=torch.float32, device="cpu")):
        if isinstance(cache, llama.PagedKVCache):
            cache.page_table.copy_(torch.tensor([[2, 0]], dtype=torch.int32))
        llama.forward(tp, CFG.text, _t(full[:, :T0]).long(), positions=_t(pos0),
                      segment_ids=_t(one0), cache=cache, fresh_prefill=True)
        got, _ = llama.forward(tp, CFG.text, _t(full[:, T0:]).long(), positions=_t(pos1),
                               segment_ids=_t(one1), cache=cache)
        outs.append(got.numpy())
    dense, paged_out = outs
    np.testing.assert_allclose(paged_out, np.asarray(ref[:, T0:]), **LOGITS)
    np.testing.assert_allclose(paged_out, np.asarray(want), **LOGITS)
    np.testing.assert_allclose(paged_out, dense, **LOGITS)


# ---------------------------------------------------------------- engine

S = 96
KW = dict(max_slots=4, max_seq_len=S, prefill_bucket=32, page_size=32)


def _gen(eng, prompt, images=None, n=6, jax_side=False):
    req = (jax_engine.Request if jax_side else Request)(
        prompt=prompt, images=images, max_new_tokens=n, temperature=0.0)
    return eng.generate(req)


@pytest.fixture(scope="module")
def engines():
    jp = jax_llava.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = from_numpy(_np(jp), "cpu")
    tok = CharTokenizer()
    dense = BatchedEngine(tp, CFG, tok, cache_dtype=torch.float32,
                          **{k: v for k, v in KW.items() if k != "page_size"})
    pg = BatchedEngine(tp, CFG, tok, cache_dtype=torch.float32, paged=True, **KW)
    jpg = jax_engine.BatchedEngine(jp, JCFG, tok, cache_dtype=jnp.float32, paged=True, **KW)
    yield tp, dense, pg, jpg
    for e in (dense, pg, jpg):
        e.stop()


def _settle(eng, timeout=10.0):
    """Wait until every slot has finished (a request's stream ends just
    before its slot releases its pages)."""
    deadline = time.time() + timeout
    while (eng.num_active or eng._waiting is not None) and time.time() < deadline:
        time.sleep(0.01)


def test_paged_engine_matches_jax_paged_and_dense(engines):
    _, dense, pg, jpg = engines
    for prompt in ["hello", "xyz", "abab"]:
        want = _gen(jpg, prompt, jax_side=True)
        assert _gen(pg, prompt) == want
        assert _gen(dense, prompt) == want


def test_paged_engine_int8_pool_matches_jax(engines):
    tp, _, _, _ = engines
    jp = jax_llava.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tok = CharTokenizer()
    e8 = BatchedEngine(tp, CFG, tok, cache_dtype=torch.int8, paged=True, **KW)
    j8 = jax_engine.BatchedEngine(jp, JCFG, tok, cache_dtype=jnp.int8, paged=True, **KW)
    try:
        for prompt in ["hello", "abc def"]:
            assert _gen(e8, prompt, n=8) == _gen(j8, prompt, n=8, jax_side=True)
    finally:
        e8.stop()
        j8.stop()


def test_pages_recycled(engines):
    _, _, pg, _ = engines
    for i in range(6):  # more requests than slots, more pages than the pool if leaked
        _gen(pg, "ab" * (i + 1), n=4)
    _settle(pg)
    with pg._page_lock:
        held = sum(1 for r in pg._page_refs if r > 0)
        assert held == len(pg._prefix)  # only published pages stay referenced
        assert len(pg._free_pages) == pg.num_pages - held


def test_pool_exhaustion_queues_not_fails(engines):
    tp, dense, _, _ = engines
    # 4 pages of 32 tokens: at most two requests at a time
    eng = BatchedEngine(tp, CFG, CharTokenizer(), cache_dtype=torch.float32, paged=True,
                        pool_tokens=4 * 32, prefix_cache=False, **KW)
    try:
        prompts = ["ab" * (i % 3 + 1) for i in range(5)]
        want = {i: _gen(dense, p, n=30) for i, p in enumerate(prompts)}
        results = {}
        threads = [threading.Thread(target=lambda i=i, p=p: results.__setitem__(
            i, _gen(eng, p, n=30))) for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert results == want
        _settle(eng)
        assert len(eng._free_pages) == eng.num_pages
    finally:
        eng.stop()


def test_paged_multimodal(engines):
    _, dense, pg, jpg = engines
    img = np.random.default_rng(1).normal(size=(1, 28, 28, 3)).astype(np.float32)
    want = _gen(jpg, "<image>\nwhat?", img, n=4, jax_side=True)
    assert _gen(pg, "<image>\nwhat?", img, n=4) == want
    assert _gen(dense, "<image>\nwhat?", img, n=4) == want


TURN1 = "The quick brown fox jumps over the lazy dog near a river."
TURN2 = TURN1 + " Then what happened to it?"


@pytest.fixture(scope="module")
def prefix_engines(engines):
    tp = engines[0]
    tok = CharTokenizer()
    kw = dict(KW, max_seq_len=160)
    off = BatchedEngine(tp, CFG, tok, cache_dtype=torch.float32, paged=True,
                        prefix_cache=False, **kw)
    on = BatchedEngine(tp, CFG, tok, cache_dtype=torch.float32, paged=True, **kw)
    yield off, on
    off.stop()
    on.stop()


def test_prefix_hit_matches_uncached(prefix_engines):
    off, on = prefix_engines
    assert _gen(on, TURN1) == _gen(off, TURN1)  # publishes TURN1's full pages
    hits, tokens = on._prefix.hit_requests, on.prefix_hit_tokens
    dispatches = on.prefill_dispatches
    assert _gen(on, TURN2) == _gen(off, TURN2)  # served by a suffix prefill
    assert on._prefix.hit_requests == hits + 1
    assert on.prefix_hit_tokens - tokens >= 32
    assert on.prefill_dispatches == dispatches  # no full prefill ran


def test_image_identity_guards_reuse(prefix_engines, monkeypatch):
    """Same tokens with other image bytes share no page; a true multi-turn
    image hit reuses the image's pages and runs no vision encode."""
    from llava_plus_torch.models import llava as llava_model

    off, on = prefix_engines
    rng = np.random.default_rng(0)
    img_a, img_b = (rng.normal(size=(1, 28, 28, 3)).astype(np.float32) for _ in range(2))
    prompt = "<image>\n" + TURN1
    ref_a, ref_b = _gen(off, prompt, img_a), _gen(off, prompt, img_b)
    assert _gen(on, prompt, img_a) == ref_a      # publishes image A's pages
    before = on.prefix_hit_tokens
    assert _gen(on, prompt, img_b) == ref_b      # must not reuse A's pages
    assert on.prefix_hit_tokens == before
    follow = prompt + " More about the picture?"
    want = _gen(off, follow, img_a)
    encodes = []
    encode = llava_model.encode_images
    monkeypatch.setattr(llava_model, "encode_images",
                        lambda *a, **k: encodes.append(1) or encode(*a, **k))
    assert _gen(on, follow, img_a) == want
    assert on.prefix_hit_tokens > before and not encodes


def test_eviction_under_small_pool(engines):
    """A pool too small to keep the history: published pages are evicted
    least recently used to admit new work; answers stay right and every
    referenced page belongs to the prefix cache at the end."""
    tp, dense, _, _ = engines
    eng = BatchedEngine(tp, CFG, CharTokenizer(), cache_dtype=torch.float32, paged=True,
                        pool_tokens=6 * 32, **dict(KW, max_slots=2))
    try:
        for c in "abcdef":
            assert _gen(eng, c * 40, n=4) == _gen(dense, c * 40, n=4)
        _settle(eng)
        with eng._page_lock:
            live = sum(1 for r in eng._page_refs if r > 0)
            assert live == len(eng._prefix)
            assert len(eng._free_pages) == eng.num_pages - live
    finally:
        eng.stop()


def test_warmup_leaves_the_pool_free(engines):
    tp = engines[0]
    eng = BatchedEngine(tp, CFG, CharTokenizer(), cache_dtype=torch.float32, paged=True, **KW)
    try:
        assert eng.warmup(prompt_len=40) >= 0
        assert len(eng._free_pages) == eng.num_pages and len(eng._prefix) == 0
        assert _gen(eng, "hello") == _gen(engines[1], "hello")
    finally:
        eng.stop()


def test_stopped_paged_engine_frees_its_pool_without_the_cycle_collector(engines):
    """A paged engine with the prefix cache, stopped and dropped, frees its
    pool at once: nothing it owns refers back to it, so no reference cycle
    waits for the cycle collector (which stays off here)."""
    import gc
    import weakref

    tp, _, _, _ = engines
    eng = BatchedEngine(tp, CFG, CharTokenizer(), cache_dtype=torch.float32, paged=True, **KW)
    gc.collect()
    gc.disable()
    try:
        assert _gen(eng, "abcd" * 12, n=4)   # a full page of prompt
        _settle(eng)
        assert len(eng._prefix) > 0   # a page published: the cache holds callbacks
        eng.stop()
        engine, pool = weakref.ref(eng), weakref.ref(eng.cache.pool)
        del eng
        assert engine() is None and pool() is None
    finally:
        gc.enable()
