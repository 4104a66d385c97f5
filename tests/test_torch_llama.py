"""The port's LLaMA decoder against the JAX package, on the CPU, in fp32.

Same numpy parameters and inputs go through ``llava_plus_tpu.models.llama``
and ``llava_plus_torch.models.llama``: the building blocks, the int8 cache
write (bytes and scales equal exactly), and a prefill plus decode steps over
bf16 and int8 caches, with logits held to 1e-4 of their largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.models import llama as jax_llama
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_torch.models import llama
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.models.convert import from_numpy

torch.set_num_threads(1)
CFG = tiny_llava_config().text  # GQA: 4 query heads over 2 kv heads
JCFG = jax_tiny_config().text   # the same config, the JAX package's own


@pytest.fixture(scope="module")
def params():
    p = jax_llama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    npp = jax.tree.map(np.asarray, p)
    return p, from_numpy(npp, "cpu")


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    want = jax_llama.rms_norm(x, w, 1e-5)
    got = llama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("scaling", [None, ("linear", 4.0), ("dynamic", 2.0),
                                     ("dynamic", 3.0)])
def test_rope_matches_jax(scaling):
    typ, fac = scaling or (None, 1.0)
    pos = np.array([[0, 1, 7, 100], [3, 511, 2047, 4000]], np.int32)
    cj, sj = jax_llama.rope_cos_sin(jnp.asarray(pos), 16, 10000.0, typ, fac)
    ct, st = llama.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0, typ, fac)
    # large positions: an f32 angle of ~4000 rad carries ~2e-4 absolute error
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-3)
    x = np.random.default_rng(1).normal(size=(2, 4, 3, 16)).astype(np.float32)
    want = jax_llama.apply_rope(jnp.asarray(x), cj, sj)
    got = llama.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(cj)),
                           torch.from_numpy(np.array(sj)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_embed_tokens_clamps_negative_ids(params):
    jp, tp = params
    ids = np.array([[5, -200, 0, 17]], np.int32)
    want = jax_llama.embed_tokens(jp, jnp.asarray(ids))
    got = llama.embed_tokens(tp, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_cache_write_is_exact():
    """Same int8 bytes and f32 scales as the JAX write, padding dropped. The
    JAX write runs jitted, as its engine and ``Generator`` run it (XLA turns
    its division by 127 into a product by ``f32(1/127)``, which the port
    computes)."""
    rng = np.random.default_rng(2)
    L, B, S, H, D = 2, 2, 8, 2, 16
    new = (rng.normal(size=(B, 3, H, D)) * rng.uniform(0.01, 10, size=(B, 3, H, 1))
           ).astype(np.float32)
    new[0, 1] = 0.0  # an all-zero row: the 1e-8 scale floor
    positions = np.array([[0, 1, 2], [5, 6, S]], np.int32)  # last row: padding
    vals = np.zeros((L, B, S, H, D), np.int8)
    scales = np.zeros((L, B, S, H, 1), np.float32)
    write = jax.jit(lambda v, s, n, p: jax_llama._cache_write(v, s, n, 1,
                                                              jnp.arange(B)[:, None], p))
    jv, js = write(jnp.asarray(vals), jnp.asarray(scales), jnp.asarray(new),
                   jnp.asarray(positions))
    tv, ts = torch.from_numpy(vals.copy()), torch.from_numpy(scales.copy())
    pos = torch.from_numpy(positions)
    b, t = torch.nonzero(pos < S, as_tuple=True)
    llama._cache_write(tv, ts, torch.from_numpy(new), 1, (b, t, pos[b, t]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _prompt_batch():
    ids = np.array([[1, 17, 99, 250, 3, 42, 7, 300],
                    [1, 5, 6, 7, 8, 0, 0, 0]], np.int32)
    seg = np.array([[1] * 8, [1] * 5 + [0] * 3], np.int32)
    S = 32
    pos = np.where(seg > 0, np.arange(8)[None], S).astype(np.int32)
    return ids, seg, pos, S


@pytest.mark.parametrize("cache_kind", ["none", "bf16", "int8"])
def test_prefill_and_decode_match_jax(params, cache_kind):
    """A fresh prefill then 4 greedy decode steps (tokens taken from the JAX
    run and fed to both)."""
    jp, tp = params
    ids, seg, pos, S = _prompt_batch()
    B = ids.shape[0]
    if cache_kind == "none":
        want, _ = jax_llama.forward(jp, JCFG, jnp.asarray(ids), segment_ids=jnp.asarray(seg))
        got, _ = llama.forward(tp, CFG, torch.from_numpy(ids),
                               segment_ids=torch.from_numpy(seg))
        rows = seg > 0
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                                   atol=1e-4 * np.abs(np.asarray(want)[rows]).max())
        return
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if cache_kind == "bf16"
                else (jnp.int8, torch.int8))
    jcache = jax_llama.KVCache.create(JCFG, B, S, jdt)
    tcache = llama.KVCache.create(CFG, B, S, tdt, device="cpu")
    last = seg.sum(1) - 1
    want, jcache = jax_llama.forward(
        jp, JCFG, jnp.asarray(ids), positions=jnp.asarray(pos),
        segment_ids=jnp.asarray(seg), cache=jcache, fresh_prefill=True,
        logits_positions=jnp.asarray(last))
    got, _ = llama.forward(
        tp, CFG, torch.from_numpy(ids), positions=torch.from_numpy(pos),
        segment_ids=torch.from_numpy(seg), cache=tcache, fresh_prefill=True,
        logits_positions=torch.from_numpy(last))
    steps = [(np.asarray(want), got)]
    tok = np.asarray(jnp.argmax(want[:, 0], -1)).astype(np.int32)[:, None]
    p = last[:, None].astype(np.int32)
    for _ in range(4):
        p = p + 1
        one = np.ones((B, 1), np.int32)
        want, jcache = jax_llama.forward(jp, JCFG, jnp.asarray(tok), positions=jnp.asarray(p),
                                         segment_ids=jnp.asarray(one), cache=jcache)
        got, _ = llama.forward(tp, CFG, torch.from_numpy(tok), positions=torch.from_numpy(p),
                               segment_ids=torch.from_numpy(one), cache=tcache)
        steps.append((np.asarray(want), got))
        tok = np.asarray(jnp.argmax(want[:, 0], -1)).astype(np.int32)[:, None]
    for want, got in steps:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(tcache.seg.numpy(), np.asarray(jcache.seg))
