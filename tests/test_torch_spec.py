"""The port's prompt-lookup speculative decoding against the JAX package, on
the CPU with the tiny configs in f32 (mirrors the speculative tests of
``tests/test_engine.py``, ``tests/test_engine_paged.py`` and
``tests/test_engine_warmup.py``).

- the proposals, host and device, exactly against JAX's ``_propose`` and
  ``_propose_dev`` on seeded histories (repeats, short histories, none);
- one verify step of the engine against the JAX engine's ``_spec_prog(m=1)``
  from the same cache state, dense and paged, LLaMA and MPT: the emitted
  rows and the next state exactly (the greedy slots; a sampled slot's draw
  is the port's own), the cache to 1e-5; then a second step, which starts
  inside the first one's rejected writes;
- the verify chunk of k + 1 tokens through ``llama.forward`` over dense f32
  and int8 caches and the paged pool against the jitted JAX forward, twice,
  the second chunk inside the first one's written range, one row crossing
  the window's end;
- the plain version of the dense decode kernel at up to 8 query tokens
  against JAX ``quant_cache_attention`` (int8 cache) and ``attention(impl=
  "xla")`` (f32), with and without ALiBi;
- the speculative engines' greedy text against the port's plain engine and
  the JAX speculative engine: chunked dispatch, budgets that end mid-chunk,
  mixed temperatures, pause / resume, the paged pool with LLaMA and MPT,
  and a warmed paged engine serving a prefix hit.

The JAX function behind ``_spec_prog`` and its ``_propose_dev`` are read
from the jitted function's closure; the JAX package is not changed.
"""

import collections
import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.models import llama as jax_llama
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.models.configs import tiny_llava_mpt_config as jax_tiny_mpt
from llava_plus_tpu.ops import attention as jax_attention
from llava_plus_tpu.serve import engine as jax_engine
from llava_plus_torch.models import llama
from llava_plus_torch.models.configs import tiny_llava_config, tiny_llava_mpt_config
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.ops.decode_attention import decode_attention, decode_attention_reference
from llava_plus_torch.serve.engine import BatchedEngine, Request, propose, propose_dev

from .test_generate import CharTokenizer

torch.set_num_threads(1)
K = 3           # proposals a verify step
S = 64          # the engines' window
LOGITS = dict(atol=2e-5, rtol=2e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def _jax_spec_body(jeng):
    """The JAX engine's ``_spec_body``, from its jitted ``spec_step``."""
    return _closure(jeng._spec_prog.__wrapped__)["_spec_body"]


_jax_qca = jax.jit(jax_attention.quant_cache_attention)
_jax_xla_attention = jax.jit(functools.partial(jax_attention.attention, causal=True, impl="xla"))


CONFIGS = {"llama": (tiny_llava_config, jax_tiny_config, 0),
           "mpt": (tiny_llava_mpt_config, jax_tiny_mpt, 2)}


@pytest.fixture(scope="module", params=["llama", "mpt"])
def model(request):
    """(name, port cfg, JAX cfg, port params, JAX params), f32."""
    cfg_fn, jcfg_fn, seed = CONFIGS[request.param]
    jcfg = jcfg_fn()
    jp = jax_llava.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return request.param, cfg_fn(), jcfg, from_numpy(_np(jp), "cpu"), jp


def _engines(model, **kw):
    _, cfg, jcfg, tp, jp = model
    kw = dict(max_slots=5, max_seq_len=S, prefill_bucket=32, speculate=K, **kw)
    tok = CharTokenizer()
    return (BatchedEngine(tp, cfg, tok, cache_dtype=torch.float32, **kw),
            jax_engine.BatchedEngine(jp, jcfg, tok, cache_dtype=jnp.float32, **kw))


# ----------------------------------------------------------------- proposals

def test_proposals_match_jax(model):
    """Host and device proposals against JAX's on histories over a small
    alphabet (many repeats), short ones (hlen <= n) and ones without any
    repeat."""
    eng, jeng = _engines(model)
    try:
        jax_dev = _closure(_jax_spec_body(jeng))["_propose_dev"]
        rng = np.random.default_rng(0)
        B, L = 12, 40
        hist = rng.integers(3, 7, size=(B, L)).astype(np.int64)
        hist[8] = np.arange(100, 100 + L)          # no repeat anywhere
        hlen = np.array([0, 1, 2, 3, 4, 7, 19, 40, 40, 25, 33, 12])
        for k in (1, K, 7):
            got = propose_dev(_t(hist), _t(hlen), k).numpy()
            want = np.asarray(jax_dev(jnp.asarray(hist, jnp.int32), jnp.asarray(hlen, jnp.int32),
                                      k))
            np.testing.assert_array_equal(got, want)
            for b in range(B):
                h = [int(x) for x in hist[b, :hlen[b]]]
                host = propose(h, k)
                assert host == jeng._propose(jax_engine._Slot(history=h), k)
                assert host == list(got[b])
        assert got[8].tolist() == [0] * 7 and got[0].tolist() == [0] * 7
        assert got[7].any()
    finally:
        eng.stop()
        jeng.stop()


# ------------------------------------------------------------ one verify step

def _fill_slots(eng, jeng, prompts, paged):
    """Prefill ``prompts`` in both engines and insert them into slots 0...;
    returns the port's prepared records (histories, budgets)."""
    reqs = [Request(prompt=p, max_new_tokens=10) for p in prompts]
    jreqs = [jax_engine.Request(prompt=p, max_new_tokens=10) for p in prompts]
    preps, jpreps = eng._prepare(reqs), jeng._prepare(jreqs)
    maxp = S // eng.page_size
    for slot, (p, jp) in enumerate(zip(preps, jpreps)):
        assert p.first_id == jp.first_id and p.history == jp.history
        if paged:
            pages = eng._alloc_pages(p.needed_pages)
            assert jeng._alloc_pages(jp.needed_pages) == pages
            eng._insert_paged(p.cache1, p.row, slot, pages, p.first_id)
            jeng.cache, jeng.tokens = jeng._insert_paged(
                jeng.cache, jp.cache1, jnp.int32(jp.row), slot,
                jnp.asarray((pages + [0] * maxp)[:maxp], jnp.int32),
                jnp.int32(len(pages) * eng.page_size), jnp.asarray([jp.first_id], jnp.int32),
                jeng.tokens)
        else:
            eng._insert(p.cache1, p.row, slot, p.first_id)
            jeng.cache, jeng.tokens = jeng._insert(
                jeng.cache, jp.cache1, jnp.int32(jp.row), slot,
                jnp.asarray([jp.first_id], jnp.int32), jeng.tokens)
    return preps


def _port_cache_arrays(eng):
    c = eng.cache
    if eng.paged:
        return {"kv": c.kv, "seg": c.seg, "kv_scale": c.kv_scale}
    return {"kv": torch.stack([c.k, c.v]), "seg": c.seg}


def _jax_cache_arrays(jeng):
    c = jeng.cache
    if jeng.paged:
        return {"kv": c.kv, "seg": c.seg, "kv_scale": c.kv_scale}
    return {"kv": jnp.stack([c.k, c.v]), "seg": c.seg}


@pytest.mark.parametrize("paged", [False, True])
def test_verify_step_matches_jax_spec_prog(model, paged):
    """Slots: 0 greedy, its proposals the greedy chain (all accepted); 1
    greedy, the chain broken at its second proposal; 2 sampled; 3 greedy
    at the window's end (budget 2, its last position past S); 4 idle. The
    chains come from JAX steps over the same state. Two steps: the second
    starts inside the first one's rejected writes."""
    kw = dict(paged=True, page_size=32) if paged else {}
    eng, jeng = _engines(model, **kw)
    try:
        eng._stop.set()
        jeng._stop.set()
        eng._thread.join(5)
        jeng._thread.join(5)
        prompts = ["the cat sat on", "abc abc abc", "xyz xyz", "q" * 60]
        preps = _fill_slots(eng, jeng, prompts, paged)
        B = eng.max_slots
        hist = np.zeros((B, S + 1), np.int64)
        hlen, budget, cur = (np.zeros(B, np.int64) for _ in range(3))
        for i, p in enumerate(preps):
            hist[i, :len(p.history)] = p.history
            hlen[i], budget[i], cur[i] = len(p.history), p.budget, p.history[-1]
        assert budget[3] == 2
        temps = np.array([0, 0, 0.8, 0, 0], np.float32)
        active = np.array([1, 1, 1, 1, 0], bool)
        seeds = np.array([0, 0, 7, 0, 0], np.int64)
        keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
        greedy_rows = np.array([0, 1, 3, 4])
        body = jax.jit(_jax_spec_body(jeng), static_argnames=("k",))
        jcache0 = _np(jeng.cache)

        def jax_step(state, cache):
            ret, *rest = body(jeng.params, cache, *(jnp.asarray(state[n], jnp.int32) for n in
                                                    ("cur", "hlen", "hist", "prop", "budget")),
                              jnp.asarray(active), keys, jnp.asarray(temps),
                              jnp.ones(B, jnp.float32), k=K)
            return np.asarray(ret), [np.asarray(x) for x in rest[:5]], rest[5]

        # the greedy chains: each JAX step fixes one more proposal
        prop = np.zeros((B, K), np.int64)
        for i in range(K):
            ret, _, _ = jax_step(dict(cur=cur, hlen=hlen, hist=hist[:, :S], prop=prop,
                                      budget=budget), jax.tree.map(jnp.asarray, jcache0))
            prop[greedy_rows, i] = ret[greedy_rows, i]
        prop[1, 1] = (prop[1, 1] + 1) % 256 + 3

        state = dict(cur=cur, hlen=hlen, hist=hist, prop=prop, budget=budget)
        jstate = dict(state, hist=hist[:, :S])
        jeng.cache = jax.tree.map(jnp.asarray, jcache0)
        st = eng._spec_state(**{n: v.copy() for n, v in state.items()}, active=_t(active),
                             seeds=_t(seeds), temps=_t(temps), tops=torch.ones(B),
                             any_sampled=True)
        for step in range(2):
            ret, jrest, jeng.cache = jax_step(jstate, jeng.cache)
            got = eng._spec_step(st, 1)[0].numpy()
            # the greedy tokens of every query inside the window; the others
            # (past S, the idle slot's) are rows with no valid key, which the
            # two packages mask differently, and are never emitted
            pos0 = np.maximum(jstate["hlen"] - 1, 0)
            inside = np.concatenate([pos0[:, None] + np.arange(K + 1) < S,
                                     np.ones((B, 1), bool)], axis=1)
            rows = greedy_rows[:-1]
            np.testing.assert_array_equal(np.where(inside, got, -1)[rows],
                                          np.where(inside, ret, -1)[rows])
            assert got[4, -1] == ret[4, -1] == 0
            assert got[2, -1] == ret[2, -1] == 1 and not got[2, 1:K + 1].any()
            if step == 0:
                assert ret[:, -1].tolist() == [K + 1, 2, 1, 2, 0]
            names = ("cur", "hlen", "hist", "prop", "budget")
            for n, want in zip(names, jrest):
                mine = st[n].numpy()[:, :S] if n == "hist" else st[n].numpy()
                rows = greedy_rows if n in ("cur", "hist", "prop") else slice(None)
                np.testing.assert_array_equal(mine[rows], want[rows], err_msg=f"{n} {step}")
            # the sampled slot continues from JAX's draw on both sides
            for n, want in zip(names, jrest):
                if n == "hist":
                    st[n][2, :S] = _t(want[2]).long()
                else:
                    st[n][2] = _t(np.asarray(want[2])).long()
            jstate = dict(zip(names, jrest))
            for n, want in _jax_cache_arrays(jeng).items():
                mine = _port_cache_arrays(eng)[n]
                if n == "seg":
                    np.testing.assert_array_equal(mine.numpy(), np.asarray(want))
                elif want is not None:
                    mine, want = mine.numpy(), np.asarray(want)
                    if not paged:
                        # the dense slots of tokens with seg 0 (the sampled
                        # slot's proposals, the idle slot) hold, from the
                        # second layer on, the k / v of a query row that the
                        # two packages mask differently: never attended
                        live = eng.cache.seg.numpy()[None, None, :, :, None, None] != 0
                        mine, want = mine * live, want * live
                    np.testing.assert_allclose(mine, want, atol=1e-5,
                                               err_msg=f"{n} after step {step}")
    finally:
        eng.stop()
        jeng.stop()


# ---------------------------------------------------- the verify chunk, forward

_jax_forward = jax.jit(jax_llama.forward, static_argnames=("cfg", "attn_impl", "fresh_prefill"))


@pytest.fixture(scope="module")
def lm_params():
    p = jax_llama.init_params(jax_tiny_config().text, jax.random.PRNGKey(0), dtype=jnp.float32)
    return p, from_numpy(_np(p), "cpu")


@pytest.mark.parametrize("kind", ["dense", "dense-int8", "paged", "paged-int8"])
def test_verify_chunk_forward_matches_jax(lm_params, kind):
    """A prefill, then two verify chunks of k + 1 = 5 tokens: row 0 greedy,
    row 1 sampled (only its first token valid), row 2 crossing the window's
    end. The second chunk starts two positions into the first one's range
    (its last three writes rejected). The logits of the valid tokens and the
    cache state against the jitted JAX forward."""
    jp, tp = lm_params
    jcfg, cfg = jax_tiny_config().text, tiny_llava_config().text
    int8 = kind.endswith("int8")
    jdt, tdt = (jnp.int8, torch.int8) if int8 else (jnp.float32, torch.float32)
    B, T0, Tq, P = 3, 45, K + 2, 16
    win = 48
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 250, size=(B, T0)).astype(np.int32)
    pos = np.tile(np.arange(T0, dtype=np.int32), (B, 1))
    seg = np.ones((B, T0), np.int32)
    seg[:2, 24:], pos[:2, 24:] = 0, win      # rows 0 and 1: 24-token prompts
    if kind.startswith("paged"):
        maxp = win // P
        jc = jax_llama.PagedKVCache.create(jcfg, B, num_pages=10, max_pages_per_slot=maxp,
                                           page_size=P, dtype=jdt)
        pt = np.array([[3, 1, 5], [7, 4, 0], [2, 6, 8]], np.int32)
        alloc = np.full(B, win, np.int32)
        jc = dataclasses.replace(jc, page_table=jnp.asarray(pt), alloc=jnp.asarray(alloc))
        tc = llama.PagedKVCache.create(cfg, B, num_pages=10, max_pages_per_slot=maxp,
                                       page_size=P, dtype=tdt, device="cpu")
        tc.page_table.copy_(_t(pt))
        tc.alloc.copy_(_t(alloc))
    else:
        jc = jax_llama.KVCache.create(jcfg, B, win, jdt)
        tc = llama.KVCache.create(cfg, B, win, tdt, device="cpu")
    jlogits, jc = _jax_forward(jp, jcfg, jnp.asarray(ids), positions=jnp.asarray(pos),
                               segment_ids=jnp.asarray(seg), cache=jc, attn_impl="xla",
                               fresh_prefill=True)
    llama.forward(tp, cfg, _t(ids).long(), positions=_t(pos), segment_ids=_t(seg), cache=tc,
                  fresh_prefill=True)
    start = np.array([24, 24, T0], np.int32)
    for step in range(2):
        chunk = rng.integers(3, 250, size=(B, Tq)).astype(np.int32)
        p = start[:, None] + np.arange(Tq, dtype=np.int32)
        s = np.ones((B, Tq), np.int32)
        s[1, 1:] = 0
        s = s * (p < win)
        want, jc = _jax_forward(jp, jcfg, jnp.asarray(chunk), positions=jnp.asarray(p),
                                segment_ids=jnp.asarray(s), cache=jc, attn_impl="xla")
        got, _ = llama.forward(tp, cfg, _t(chunk).long(), positions=_t(p), segment_ids=_t(s),
                               cache=tc)
        valid = s > 0
        tol = LOGITS if not int8 else dict(atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **tol,
                                   err_msg=f"{kind} chunk {step}")
        assert np.isfinite(got.numpy()).all()
        start = start + np.array([2, 1, 0], np.int32)   # inside the chunk just written
    np.testing.assert_array_equal(tc.seg.numpy(), np.asarray(jc.seg))
    if kind.startswith("paged"):
        mine, theirs = tc.kv.numpy(), np.asarray(jc.kv)
    else:
        # the slots of tokens with seg 0 hold, from the second layer on, the
        # k / v of a query row that the two packages mask differently
        live = tc.seg.numpy()[None, None, :, :, None, None] != 0
        mine = np.stack([tc.k.numpy(), tc.v.numpy()]) * live
        theirs = np.stack([np.asarray(jc.k), np.asarray(jc.v)]) * live
    if int8:
        diff = np.abs(mine.astype(np.int32) - theirs.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    else:
        np.testing.assert_allclose(mine, theirs, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------ decode attention, Tq <= 8

@pytest.mark.parametrize("Tq", [1, 2, 5, 8])
@pytest.mark.parametrize("G", [1, 4, 32])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_chunk_matches_jax(Tq, G, int8):
    """The decode kernel's plain version at Tq query tokens (token t at
    q_pos + t) against JAX: ``quant_cache_attention`` over an int8 cache,
    ``attention(impl="xla")`` over an f32 one; ALiBi on the int8 cache with
    G = 1 and the f32 one with G = 4."""
    rng = np.random.default_rng(Tq * 100 + G)
    B, Sc, Hkv, D = 3, 40, 2 if G < 32 else 1, 16
    H = G * Hkv
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sc, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sc, Hkv, D)).astype(np.float32)
    seg = (rng.random((B, Sc)) > 0.2).astype(np.int32)
    seg[:, 0] = 1
    q_pos = np.array([0, 17, Sc - Tq], np.int32)
    qp = q_pos[:, None] + np.arange(Tq, dtype=np.int32)
    alibi = (G == 1) == int8
    slopes = (2.0 ** -np.arange(1, H + 1, dtype=np.float32) * 8 / H) if alibi else None
    bias = None
    if alibi:
        dist = np.abs(qp[:, :, None] - np.arange(Sc)[None, None]).astype(np.float32)
        bias = jnp.asarray(-dist[:, None] * slopes[None, :, None, None])
    if int8:
        scale = np.maximum(np.abs(k).max(-1, keepdims=True), 1e-8) / 127
        vscale = np.maximum(np.abs(v).max(-1, keepdims=True), 1e-8) / 127
        kq = np.clip(np.round(k / scale), -127, 127).astype(np.int8)
        vq = np.clip(np.round(v / vscale), -127, 127).astype(np.int8)
        want = _jax_qca(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(scale), jnp.asarray(vq),
            jnp.asarray(vscale), kv_segment_ids=jnp.asarray(seg), q_positions=jnp.asarray(qp),
            bias=bias)
        args = (_t(kq), _t(vq), _t(seg), _t(q_pos), _t(scale), _t(vscale))
    else:
        want = _jax_xla_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=bias,
            q_segment_ids=jnp.ones((B, Tq), jnp.int32), kv_segment_ids=jnp.asarray(seg),
            q_positions=jnp.asarray(qp))
        args = (_t(k), _t(v), _t(seg), _t(q_pos))
    kw = dict(alibi_slopes=None if slopes is None else _t(slopes))
    got = decode_attention_reference(_t(q), *args, sm_scale=D ** -0.5, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert torch.equal(decode_attention(_t(q), *args, **kw), got)


# ------------------------------------------------------------------ engines

PROMPTS = ["the cat sat on the mat the cat sat on the", "abc abc abc abc abc"]


@pytest.fixture(scope="module")
def llama_tree():
    jp = jax_llava.init_params(jax_tiny_config(), jax.random.PRNGKey(0), dtype=jnp.float32)
    return from_numpy(_np(jp), "cpu"), jp


def _run(tree, budgets=(12, 12), prompts=PROMPTS, jax_side=False, cfg=None, **kw):
    tp, jp = tree
    tok = CharTokenizer()
    kw = {"max_slots": 2, "max_seq_len": 96, "prefill_bucket": 32, **kw}
    if jax_side:
        eng = jax_engine.BatchedEngine(jp, cfg or jax_tiny_config(), tok,
                                       cache_dtype=jnp.float32, **kw)
        req = jax_engine.Request
    else:
        eng = BatchedEngine(tp, cfg or tiny_llava_config(), tok, cache_dtype=torch.float32,
                            **kw)
        req = Request
    try:
        out = [eng.generate(req(prompt=p, max_new_tokens=b)) for p, b in zip(prompts, budgets)]
        return out, eng.spec_steps if kw.get("speculate") else None
    finally:
        eng.stop()


def test_speculative_matches_plain_and_jax_spec(llama_tree):
    plain, _ = _run(llama_tree)
    spec, steps = _run(llama_tree, speculate=4)
    jspec, _ = _run(llama_tree, jax_side=True, speculate=4)
    assert spec == plain == jspec and steps > 0


@pytest.mark.parametrize("chunk", [1, 3, 4, 8])
def test_speculative_chunked_exact(llama_tree, chunk):
    """m verify steps a dispatch, budgets that end mid-chunk (7 and 13 are
    no multiple of a chunk's tokens)."""
    budgets = (7, 13)
    plain, _ = _run(llama_tree, budgets)
    assert _run(llama_tree, budgets, speculate=4, spec_chunk=chunk)[0] == plain


def test_speculative_mixed_temperature(llama_tree):
    """A sampled stream beside a greedy one: both finish, the greedy one
    equals the plain engine's; the sampled one is the port's own draw."""
    tp, _ = llama_tree
    ref, _ = _run(llama_tree, (8,), ["aba aba aba"])
    eng = BatchedEngine(tp, tiny_llava_config(), CharTokenizer(), max_slots=2, max_seq_len=96,
                        prefill_bucket=32, cache_dtype=torch.float32, speculate=3)
    try:
        reqs = {"g": Request(prompt="aba aba aba", max_new_tokens=8),
                "s": Request(prompt="xyz xyz", max_new_tokens=8, temperature=0.8, seed=7)}
        results = {}
        threads = [threading.Thread(target=lambda n=n, r=r: results.__setitem__(
            n, eng.generate(r))) for n, r in reqs.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert results["g"] == ref[0] and "s" in results and eng.spec_steps > 0
    finally:
        eng.stop()


def test_speculative_pause_resume_exact(llama_tree):
    """Low acceptance pauses speculation (plain chunks) and probes again;
    the text stays the plain engine's across both hand-overs."""
    tp, _ = llama_tree
    prompt = "qwertzuiopasdfgh"
    ref, _ = _run(llama_tree, (60,), [prompt], max_seq_len=256)
    eng = BatchedEngine(tp, tiny_llava_config(), CharTokenizer(), max_slots=1,
                        max_seq_len=256, prefill_bucket=32, cache_dtype=torch.float32,
                        speculate=3, spec_chunk=1)
    eng._spec_recent = collections.deque(maxlen=6)
    eng.spec_pause_len = 5
    try:
        assert eng.generate(Request(prompt=prompt, max_new_tokens=60)) == ref[0]
        assert eng.spec_pauses >= 1
    finally:
        eng.stop()


@pytest.mark.parametrize("arch", ["llama", "mpt"])
@pytest.mark.parametrize("paged", [False, True])
def test_speculative_backbones_match_plain_and_jax(arch, paged):
    """Dense and paged, LLaMA and MPT: the spec engine's greedy text equals
    the port's plain dense engine's and the JAX spec engine's."""
    cfg_fn, jcfg_fn, seed = CONFIGS[arch]
    jp = jax_llava.init_params(jcfg_fn(), jax.random.PRNGKey(seed), dtype=jnp.float32)
    tree = (from_numpy(_np(jp), "cpu"), jp)
    kw = dict(paged=True, page_size=32) if paged else {}
    prompts = ["the cat sat on the mat the cat sat on the", "abab abab abab"]
    plain, _ = _run(tree, (10, 12), prompts, cfg=cfg_fn(), max_slots=4)
    spec, steps = _run(tree, (10, 12), prompts, cfg=cfg_fn(), max_slots=4, speculate=3, **kw)
    jspec, _ = _run(tree, (10, 12), prompts, jax_side=True, cfg=jcfg_fn(), max_slots=4,
                    speculate=3, **kw)
    assert spec == plain == jspec and steps > 0


def test_warmup_paged_spec_then_serve(llama_tree):
    """A warmed paged speculative engine hands back every page, and serves a
    repeated prompt (the second time a prefix hit) as the plain engine does."""
    tp, _ = llama_tree
    prompt = "the quick brown fox jumps over the lazy dog again and"
    ref, _ = _run(llama_tree, (6,), [prompt], max_seq_len=64)
    eng = BatchedEngine(tp, tiny_llava_config(), CharTokenizer(), max_slots=2, max_seq_len=64,
                        prefill_bucket=32, paged=True, page_size=32,
                        cache_dtype=torch.float32, speculate=2)
    try:
        eng.warmup(prompt_len=50, image=False)
        assert len(eng._free_pages) == eng.num_pages
        for _ in range(2):
            assert eng.generate(Request(prompt=prompt, max_new_tokens=6)) == ref[0]
        assert eng.prefix_hit_tokens > 0 and eng.spec_steps > 0
    finally:
        eng.stop()
