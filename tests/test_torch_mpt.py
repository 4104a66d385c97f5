"""The port's MPT backbone (``llava_plus_torch/models/mpt.py``) and LLaVA-MPT
serving against the JAX package, on the CPU, in f32 (mirrors
``tests/test_mpt_parity.py``).

The same numpy parameters (JAX ``init_params`` through ``convert``) and
inputs go through both packages:

- the building blocks (LayerNorm without bias, embeddings);
- ``mpt.forward`` logits with ALiBi, MQA, qk-LayerNorm with a qkv clamp,
  prefix-LM, sequence ids, learned positions with ALiBi off, and a softmax
  and logit scale;
- a prefill and incremental decode over a dense f32 cache, an int8 cache
  and a paged pool (f32 and int8), MHA and MQA, the paged pool's state
  included; the multi-token continuation of ``test_mpt_parity.py:131``;
- int8 and int4 weights (``quantize_llava_params("mpt")``): the quantized
  bytes equal, and the forward over them;
- the tiny LLaVA-MPT through ``Generator``, ``BatchedEngine`` (dense f32,
  int8 KV, int8 weights, paged with prefix hits) and the engine-backed
  ``TorchBackend`` over HTTP with image start / end tokens: greedy tokens
  and text exactly equal to the JAX package's.

Tolerance: logits atol 1e-4, rtol 1e-4 (f32 sums in another order over 2
layers); an int8 pool's values to one step where a chunk's k/v differ from
JAX's in the last bit, as ``tests/test_torch_paged.py`` holds them.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu import generate as jax_generate
from llava_plus_tpu.models import llama as jax_llama
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models import mpt as jax_mpt
from llava_plus_tpu.models.configs import tiny_llava_mpt_config as jax_tiny_mpt
from llava_plus_tpu.ops import quant as jax_quant
from llava_plus_tpu.serve import engine as jax_engine
from llava_plus_torch import generate
from llava_plus_torch.models import llama, llava, mpt
from llava_plus_torch.models.configs import tiny_llava_mpt_config
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.ops import quant
from llava_plus_torch.serve.engine import BatchedEngine, Request

from .test_generate import CharTokenizer

torch.set_num_threads(1)
CFG = tiny_llava_mpt_config()
JCFG = jax_tiny_mpt()  # the same config, the JAX package's own
LOGITS = dict(atol=1e-4, rtol=1e-4)

VARIANTS = {
    "alibi": {},
    "mqa": dict(multiquery=True),
    "qk_ln_clip": dict(qk_ln=True, clip_qkv=0.2),
    "prefix_lm": dict(prefix_lm=True),
    "sequence_id": dict(attn_uses_sequence_id=True),
    "learned_pos": dict(alibi=False, learned_pos_emb=True),
    "scales": dict(softmax_scale=0.2, logit_scale=0.5),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _cfgs(variant):
    kw = VARIANTS[variant]
    return dataclasses.replace(JCFG.mpt, **kw), dataclasses.replace(CFG.mpt, **kw)


_params_cache = {}


def _params(variant):
    if variant not in _params_cache:
        jc, _ = _cfgs(variant)
        jp = jax_mpt.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
        _params_cache[variant] = (jp, from_numpy(_np(jp), "cpu"))
    return _params_cache[variant]


_jax_forward = jax.jit(jax_mpt.forward, static_argnames=("cfg", "attn_impl", "fresh_prefill"))


# ---------------------------------------------------------------- blocks

def test_layer_norm_and_embeddings_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.normal(size=(64,)).astype(np.float32)
    want = jax_mpt._layer_norm_nobias(jnp.asarray(x), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(mpt.layer_norm(_t(x), _t(w), 1e-5).numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-5)
    jp, tp = _params("alibi")
    ids = np.array([[5, -200, 0, 17]], np.int32)
    np.testing.assert_array_equal(mpt.embed_tokens(tp, _t(ids)).numpy(),
                                  np.asarray(jax_mpt.embed_tokens(jp, jnp.asarray(ids))))


def test_init_params_shapes_match_jax():
    for variant in ("alibi", "mqa", "qk_ln_clip", "learned_pos"):
        jc, tc = _cfgs(variant)
        want = jax.tree.map(lambda a: tuple(a.shape),
                            jax_mpt.init_params(jc, jax.random.PRNGKey(0), jnp.float32))
        got = mpt.init_params(tc, torch.Generator().manual_seed(0), "cpu", torch.float32)
        assert jax.tree.map(lambda a: tuple(a.shape), got) == want


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant):
    jc, tc = _cfgs(variant)
    jp, tp = _params(variant)
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 500, size=(2, 12)).astype(np.int32)
    kw = {}
    if variant == "prefix_lm":
        kw["prefix_mask"] = np.array([[1] * 4 + [0] * 8, [1] * 7 + [0] * 5], np.int32)
    if variant == "sequence_id":
        kw["sequence_id"] = np.array([[0] * 5 + [1] * 7, [0] * 12], np.int32)
    want, _ = jax_mpt.forward(jp, jc, jnp.asarray(ids), attn_impl="xla",
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    got, _ = mpt.forward(tp, tc, _t(ids).long(), **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    if kw:
        # the mask matters; over a dense cache it spans the cache's slots
        # (tests/test_torch_repairs.py holds that to JAX), so a chunk shorter
        # than the cache, which JAX's bias does not broadcast over, raises
        plain, _ = mpt.forward(tp, tc, _t(ids).long())
        assert not np.allclose(plain.numpy(), got.numpy(), atol=1e-3)
        cache = mpt.create_cache(tc, 2, 16, torch.float32, device="cpu")
        with pytest.raises(ValueError, match="dense cache"):
            mpt.forward(tp, tc, _t(ids).long(), cache=cache, **{k: _t(v) for k, v in kw.items()})


# ---------------------------------------------------------------- caches

@pytest.mark.parametrize("variant", ["alibi", "mqa", "qk_ln_clip"])
@pytest.mark.parametrize("int8", [False, True])
def test_dense_cache_decode_matches_jax(variant, int8):
    """A prefill over the cache (row 1 padded), then 6 decode steps, against
    the jitted JAX decoder; and a fresh prefill (the local flash path) of an
    f32 cache against the same JAX logits."""
    jc, tc = _cfgs(variant)
    jp, tp = _params(variant)
    B, T0, S = 2, 9, 24
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 500, size=(B, T0)).astype(np.int32)
    pos = np.tile(np.arange(T0, dtype=np.int32), (B, 1))
    seg = np.ones((B, T0), np.int32)
    seg[1, 7:], pos[1, 7:] = 0, S                      # row 1: a 7-token prompt
    jdt, tdt = (jnp.int8, torch.int8) if int8 else (jnp.float32, torch.float32)
    jcache = jax_mpt.create_cache(jc, B, S, jdt)
    tcache = mpt.create_cache(tc, B, S, tdt, device="cpu")
    want, jcache = _jax_forward(jp, jc, jnp.asarray(ids), positions=jnp.asarray(pos),
                                segment_ids=jnp.asarray(seg), cache=jcache, attn_impl="xla")
    got, _ = mpt.forward(tp, tc, _t(ids).long(), positions=_t(pos), segment_ids=_t(seg),
                         cache=tcache)
    valid = seg.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **LOGITS)
    if not int8:
        fresh = mpt.create_cache(tc, B, S, tdt, device="cpu")
        got2, _ = mpt.forward(tp, tc, _t(ids).long(), positions=_t(pos), segment_ids=_t(seg),
                              cache=fresh, fresh_prefill=True)
        np.testing.assert_allclose(got2.numpy()[valid], np.asarray(want)[valid], **LOGITS)
        np.testing.assert_allclose(fresh.k.numpy(), tcache.k.numpy(), atol=1e-5, rtol=1e-5)
    tok = np.asarray(jnp.argmax(want[np.arange(B), [T0 - 1, 6]], -1)).astype(np.int32)
    for i in range(6):
        p = np.array([[T0 + i], [7 + i]], np.int32)
        one = np.ones((B, 1), np.int32)
        want, jcache = _jax_forward(jp, jc, jnp.asarray(tok[:, None]), positions=jnp.asarray(p),
                                    segment_ids=jnp.asarray(one), cache=jcache, attn_impl="xla")
        got, _ = mpt.forward(tp, tc, _t(tok[:, None]).long(), positions=_t(p),
                             segment_ids=_t(one), cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS, err_msg=f"step {i}")
        tok = np.asarray(jnp.argmax(want[:, 0], -1)).astype(np.int32)


@pytest.mark.parametrize("variant", ["alibi", "mqa"])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_and_pool_match_jax(variant, int8):
    """A fresh prefill (row 1 padded) and 10 decode steps over scrambled
    page tables (row 1 runs past its allocation at the end): logits and the
    pool against the jitted JAX decoder."""
    jc, tc = _cfgs(variant)
    jp, tp = _params(variant)
    P, B, T0, maxp, Np, steps = 8, 2, 12, 3, 7, 10
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 500, size=(B, T0)).astype(np.int32)
    pos = np.tile(np.arange(T0, dtype=np.int32), (B, 1))
    seg = np.ones((B, T0), np.int32)
    seg[1, 10:], pos[1, 10:] = 0, maxp * P
    pt = np.array([[3, 1, 5], [6, 4, 0]], np.int32)
    alloc = np.array([3 * P, 2 * P], np.int32)
    jdt, tdt = (jnp.int8, torch.int8) if int8 else (jnp.float32, torch.float32)
    jcache = jax_llama.PagedKVCache.create(jc, B, num_pages=Np, max_pages_per_slot=maxp,
                                           page_size=P, dtype=jdt)
    jcache = dataclasses.replace(jcache, page_table=jnp.asarray(pt), alloc=jnp.asarray(alloc))
    tcache = llama.PagedKVCache.create(tc, B, num_pages=Np, max_pages_per_slot=maxp,
                                       page_size=P, dtype=tdt, device="cpu")
    tcache.page_table.copy_(_t(pt))
    tcache.alloc.copy_(_t(alloc))
    want, jcache = _jax_forward(jp, jc, jnp.asarray(ids), positions=jnp.asarray(pos),
                                segment_ids=jnp.asarray(seg), cache=jcache, attn_impl="xla",
                                fresh_prefill=True)
    got, _ = mpt.forward(tp, tc, _t(ids).long(), positions=_t(pos), segment_ids=_t(seg),
                         cache=tcache, fresh_prefill=True)
    valid = seg.astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **LOGITS)
    tok = np.asarray(jnp.argmax(want[np.arange(B), [T0 - 1, 9]], -1)).astype(np.int32)
    for i in range(steps):
        p = np.array([[T0 + i], [10 + i]], np.int32)
        one = np.ones((B, 1), np.int32)
        want, jcache = _jax_forward(jp, jc, jnp.asarray(tok[:, None]), positions=jnp.asarray(p),
                                    segment_ids=jnp.asarray(one), cache=jcache, attn_impl="xla")
        got, _ = mpt.forward(tp, tc, _t(tok[:, None]).long(), positions=_t(p),
                             segment_ids=_t(one), cache=tcache)
        # row 1 writes past its 16-token allocation from step 6 on: both
        # packages drop the write and attend the rest
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS, err_msg=f"step {i}")
        tok = np.asarray(jnp.argmax(want[:, 0], -1)).astype(np.int32)
    np.testing.assert_array_equal(tcache.seg.numpy(), np.asarray(jcache.seg))
    if int8:
        diff = np.abs(tcache.kv.numpy().astype(np.int32) - np.asarray(jcache.kv).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    else:
        np.testing.assert_allclose(tcache.kv.numpy(), np.asarray(jcache.kv), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T1", [3, 12])
def test_multitoken_continuation(T1):
    """Several tokens at once over the cache (tests/test_mpt_parity.py:131):
    equal to the full-sequence logits and to JAX, over a dense cache and a
    paged one (3 tokens: the paged kernels' path; 12: the gathered pages)."""
    jc, tc = _cfgs("alibi")
    jp, tp = _params("alibi")
    T0 = 6
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 500, size=(1, T0 + T1)).astype(np.int32)
    full, _ = jax_mpt.forward(jp, jc, jnp.asarray(ids), attn_impl="xla")
    jcache = jax_mpt.create_cache(jc, 1, 32, jnp.float32)
    pos0 = np.arange(T0, dtype=np.int32)[None]
    pos1 = np.arange(T0, T0 + T1, dtype=np.int32)[None]
    one0, one1 = np.ones((1, T0), np.int32), np.ones((1, T1), np.int32)
    _, jcache = jax_mpt.forward(jp, jc, jnp.asarray(ids[:, :T0]), positions=jnp.asarray(pos0),
                                segment_ids=jnp.asarray(one0), cache=jcache, attn_impl="xla")
    want, _ = jax_mpt.forward(jp, jc, jnp.asarray(ids[:, T0:]), positions=jnp.asarray(pos1),
                              segment_ids=jnp.asarray(one1), cache=jcache, attn_impl="xla")
    np.testing.assert_allclose(np.asarray(want), np.asarray(full[:, T0:]), atol=1e-4, rtol=1e-3)
    paged = llama.PagedKVCache.create(tc, 1, num_pages=3, max_pages_per_slot=2, page_size=16,
                                      dtype=torch.float32, device="cpu")
    paged.page_table.copy_(torch.tensor([[2, 0]], dtype=torch.int32))
    for cache in (mpt.create_cache(tc, 1, 32, torch.float32, device="cpu"), paged):
        mpt.forward(tp, tc, _t(ids[:, :T0]).long(), positions=_t(pos0), segment_ids=_t(one0),
                    cache=cache, fresh_prefill=True)
        got, _ = mpt.forward(tp, tc, _t(ids[:, T0:]).long(), positions=_t(pos1),
                             segment_ids=_t(one1), cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
        np.testing.assert_allclose(got.numpy(), np.asarray(full[:, T0:]), **LOGITS)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_forward_matches_jax(bits):
    """The four MPT matrices quantized by both packages (bytes equal, the
    tied ``wte`` untouched), then a prefill and decode steps over an int8
    cache with those weights."""
    jc, tc = _cfgs("alibi")
    jp = jax_mpt.init_params(jc, jax.random.PRNGKey(2), dtype=jnp.float32)
    tp = {"language_model": from_numpy(_np(jp), "cpu")}
    jq = jax_quant.quantize_lm_params(jp, jax_quant.MPT_QUANT_PATHS, bits=bits)
    quant.quantize_llava_params(tp, "mpt", bits=bits, fuse=True)
    tq = tp["language_model"]
    key = "qvalue" if bits == 8 else "qvalue4"
    for path in quant.MPT_QUANT_PATHS:
        for k in (key, "scale"):
            np.testing.assert_array_equal(quant._get(tq, path)[k].numpy(),
                                          np.asarray(jax_quant._get(jq, path)[k]))
    assert not quant.is_quantized(tq["wte"])
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 500, size=(1, 10)).astype(np.int32)
    jcache = jax_mpt.create_cache(jc, 1, 16, jnp.int8)
    tcache = mpt.create_cache(tc, 1, 16, torch.int8, device="cpu")
    pos = np.arange(7, dtype=np.int32)[None]
    one = np.ones((1, 7), np.int32)
    want, jcache = _jax_forward(jq, jc, jnp.asarray(ids[:, :7]), positions=jnp.asarray(pos),
                                segment_ids=jnp.asarray(one), cache=jcache, attn_impl="xla")
    got, _ = mpt.forward(tq, tc, _t(ids[:, :7]).long(), positions=_t(pos),
                         segment_ids=_t(one), cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    for t in range(7, 10):
        p, one = np.array([[t]], np.int32), np.ones((1, 1), np.int32)
        want, jcache = _jax_forward(jq, jc, jnp.asarray(ids[:, t:t + 1]),
                                    positions=jnp.asarray(p), segment_ids=jnp.asarray(one),
                                    cache=jcache, attn_impl="xla")
        got, _ = mpt.forward(tq, tc, _t(ids[:, t:t + 1]).long(), positions=_t(p),
                             segment_ids=_t(one), cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


# ---------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def llava_params():
    jp = jax_llava.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, from_numpy(_np(jp), "cpu")


def _images(n, seed=0):
    s = CFG.vision.image_size
    return np.random.default_rng(seed).normal(size=(n, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("prompt,with_image", [
    ("tell me a story about the sea", False),
    ("<image>\nwhat is in this picture", True),
])
def test_generator_stream_matches_jax(llava_params, kv, prompt, with_image):
    """The single-stream slice: 12 greedy tokens, identical ids and text."""
    jp, tp = llava_params
    tok = CharTokenizer()
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.bfloat16, torch.bfloat16)
    jg = jax_generate.Generator(jp, JCFG, tok, max_seq_len=96, prefill_bucket=32,
                                cache_dtype=jdt)
    tg = generate.Generator(tp, CFG, tok, device="cpu", max_seq_len=96, prefill_bucket=32,
                            cache_dtype=tdt)
    img = _images(1, seed=3) if with_image else None
    want = list(jg.stream(prompt, img, max_new_tokens=12))
    got = list(tg.stream(prompt, img, max_new_tokens=12))
    assert tg._last_output_ids == jg._last_output_ids and len(got) == 12
    assert got == want


S = 96
KW = dict(max_slots=3, max_seq_len=S, prefill_bucket=32, page_size=32)
TURN1 = "The quick brown fox jumps over the lazy dog near a river."
TURN2 = TURN1 + " Then what happened to it?"


def _gen(eng, prompt, images=None, n=6, jax_side=False):
    req = (jax_engine.Request if jax_side else Request)(
        prompt=prompt, images=images, max_new_tokens=n, temperature=0.0)
    return eng.generate(req)


@pytest.mark.parametrize("mode", ["dense", "dense_int8", "int8_weights", "paged",
                                  "paged_int8"])
def test_engine_matches_jax_engine(llava_params, mode):
    """Greedy text of the port's engine against the JAX engine on the tiny
    LLaVA-MPT: text and image prompts; int8 KV, or int8 weights quantized by
    each package; paged with the prefix cache, a follow-up served from its
    pooled prefix (no full prefill)."""
    jp, tp = llava_params
    if mode == "int8_weights":
        jp = jax_quant.quantize_llava_params(
            jax_llava.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32), "mpt")
        tp = quant.quantize_llava_params(from_numpy(_np(llava_params[0]), "cpu"), "mpt",
                                         fuse=True)
    tok = CharTokenizer()
    paged = mode.startswith("paged")
    int8 = mode.endswith("int8")
    kw = dict(KW, max_seq_len=160) if paged else {k: v for k, v in KW.items() if k != "page_size"}
    jeng = jax_engine.BatchedEngine(jp, JCFG, tok, cache_dtype=jnp.int8 if int8 else jnp.float32,
                                    paged=paged, **kw)
    eng = BatchedEngine(tp, CFG, tok, cache_dtype=torch.int8 if int8 else torch.float32,
                        paged=paged, **kw)
    img = _images(1, seed=1)
    try:
        for prompt, images in (("hello", None), ("abab cd", None), ("<image>\nwhat?", img)):
            want = _gen(jeng, prompt, images, jax_side=True)
            assert _gen(eng, prompt, images) == want, prompt
        if paged:
            assert _gen(eng, TURN1) == _gen(jeng, TURN1, jax_side=True)
            hits, dispatches = eng._prefix.hit_requests, eng.prefill_dispatches
            assert _gen(eng, TURN2) == _gen(jeng, TURN2, jax_side=True)
            assert eng._prefix.hit_requests == hits + 1
            assert eng.prefill_dispatches == dispatches   # served by a suffix prefill
            deadline = time.time() + 10
            while eng.num_active and time.time() < deadline:
                time.sleep(0.01)
            with eng._page_lock:
                live = sum(1 for r in eng._page_refs if r > 0)
                assert live == len(eng._prefix)
    finally:
        eng.stop()
        jeng.stop()


def test_backend_over_http_matches_jax_backend(llava_params, tmp_path):
    """The engine-backed ``TorchBackend`` serving the tiny LLaVA-MPT over
    HTTP in a subprocess that loads no JAX module, with image start / end
    tokens around each image (as LLaVA-MPT-7B): the same chunks as the JAX
    backend's ``generate_stream`` for an image and a text request."""
    from llava_plus_tpu.data.image_processing import ClipImageProcessor
    from llava_plus_tpu.serve.model_worker import JaxBackend

    from .test_torch_engine import HTTP_SCRIPT, ROOT, _png_b64

    jp, _ = llava_params
    ctx = 256
    tok = CharTokenizer()
    size = CFG.vision.image_size
    jb = object.__new__(JaxBackend)
    jcfg = dataclasses.replace(JCFG, mm_use_im_start_end=True)
    jb.tokenizer, jb.cfg, jb.context_len, jb.is_multimodal = tok, jcfg, ctx, True
    jb.image_processor = ClipImageProcessor(shortest_edge=size, crop_size=size)
    jb.stream_interval, jb.generator = 2, None
    jb.engine = jax_engine.BatchedEngine(jp, jcfg, tok, max_slots=8, max_seq_len=ctx,
                                         cache_dtype=jnp.bfloat16)
    cases = {
        "image": {"prompt": "<image>\nwhat is shown here", "images": [_png_b64(0, size)],
                  "temperature": 0.0, "max_new_tokens": 8},
        "text": {"prompt": "tell me about the sea", "temperature": 0.0, "max_new_tokens": 12},
    }
    try:
        want = {name: list(jb.generate_stream(body)) for name, body in cases.items()}
    finally:
        jb.engine.stop()
    params_path, cases_path = tmp_path / "params.pkl", tmp_path / "cases.json"
    with open(params_path, "wb") as f:
        pickle.dump(_np(jp), f)
    cases_path.write_text(json.dumps(cases))
    script = (HTTP_SCRIPT
              .replace("import tiny_llava_config", "import tiny_llava_mpt_config")
              .replace("cfg = tiny_llava_config()", "cfg = dataclasses.replace("
                       "tiny_llava_mpt_config(), mm_use_im_start_end=True)")
              .replace("import asyncio, json,", "import asyncio, dataclasses, json,"))
    assert script.count("tiny_llava_mpt_config") == 2 and "dataclasses, json" in script
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", script, str(params_path), str(cases_path),
                          str(ctx)], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])["results"]
    for name, chunks in want.items():
        assert all(c["error_code"] == 0 for c in got[name]), got[name]
        assert [c["text"] for c in got[name]] == chunks, name
