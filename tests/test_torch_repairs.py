"""Three faults of the port against the JAX package, repaired, on the CPU:

- the dense int8 KV cache write: values and scales bit for bit equal to
  the jitted JAX ``_cache_write`` (XLA computes its scale as ``amax *
  f32(1/127)``; the port once divided);
- dense decode for any number of query heads per kv head: the decode
  kernel's plain version at 32 heads over 1 kv head and 16 over 2, bf16 and
  int8 caches, against the Pallas ``decode_attention`` in interpret mode and,
  with ALiBi slopes, against the JAX MPT decode's XLA path
  (``quant_cache_attention(bias=...)`` / ``xla_attention(bias=...)``); the
  kernel's input checks take such a group (they once refused more than 8);
- MPT's prefix-LM and sequence-id masks over a dense KV cache: ``mpt.forward``
  against JAX ``mpt.forward`` (they once raised); over a paged cache, where
  JAX builds no such bias, they still raise.

Tolerance: bit for bit for the cache write; atol 1e-5, rtol 1e-4 otherwise
(f32 sums in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.models import llama as jax_llama
from llava_plus_tpu.models import mpt as jax_mpt
from llava_plus_tpu.models.configs import tiny_llava_mpt_config as jax_tiny_mpt
from llava_plus_tpu.ops import attention as jax_attn
from llava_plus_tpu.ops import decode_attention as jax_decode
from llava_plus_torch.models import llama, mpt
from llava_plus_torch.models.configs import tiny_llava_mpt_config
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.ops import decode_attention as dec

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------- int8 KV write

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_int8_write_matches_jitted_jax(dtype):
    """A prefill chunk written into layer 1 of a stacked int8 cache (row 1
    padded at its end, one position past max_len dropped): the int8 values,
    the scales and the segment ids equal the jitted JAX write's bit for
    bit. With a division, 68 of these 1024 scales differ in the last bit."""
    rng = np.random.default_rng(5)
    L, B, T, S, H, D = 2, 2, 64, 64, 8, 128
    new = rng.normal(size=(B, T, H, D)).astype(np.float32) * rng.uniform(0.1, 9, (B, T, H, 1))
    new = np.asarray(jnp.asarray(new, dtype).astype(jnp.float32))   # representable in dtype
    positions = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    positions[1, -1] = S                                              # past max_len
    seg = np.ones((B, T), np.int32)
    seg[1, -9:] = 0
    vals = np.zeros((L, B, S, H, D), np.int8)
    scales = np.zeros((L, B, S, H, 1), np.float32)

    write = jax.jit(lambda v, s, n, p: jax_llama._cache_write(
        v, s, n, 1, jnp.arange(B)[:, None], p))
    want_v, want_s = write(_j(vals), _j(scales), jnp.asarray(new, dtype), _j(positions))
    cache = llama.KVCache(k=_t(vals.copy()), v=_t(vals.copy()),
                          seg=torch.zeros(B, S, dtype=torch.int32),
                          k_scale=_t(scales.copy()), v_scale=_t(scales.copy()))
    sel = llama._write_slots(cache, _t(positions), _t(seg))
    llama._cache_write(cache.k, cache.k_scale, _t(new).to(getattr(torch, dtype)), 1, sel)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(cache.k_scale.numpy(), np.asarray(want_s))
    want_seg = np.zeros((B, S), np.int32)
    want_seg[0], want_seg[1, :T - 1] = 1, seg[1, :T - 1]
    np.testing.assert_array_equal(cache.seg.numpy(), want_seg)


# ---------------------------------------------------------------- wide groups

def _decode_inputs(H, Hkv, int8, seed):
    rng = np.random.default_rng(seed)
    B, S, D = 3, 256, 128
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    fills = [100, 37, S]
    seg = np.zeros((B, S), np.int32)
    for i, f in enumerate(fills):
        seg[i, :f] = 1
    ks = vs = None
    if int8:
        def quant(x):
            s = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) / 127.0
            return np.clip(np.round(x / s), -127, 127).astype(np.int8), s.astype(np.float32)
        (k, ks), (v, vs) = quant(k), quant(v)
    return q, k, v, seg, np.array(fills, np.int32) - 1, ks, vs


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("H,Hkv", [(32, 1), (16, 2)])
def test_wide_group_decode_matches_pallas(H, Hkv, int8):
    """G = 32 and G = 8 x 2: the plain version against the Pallas kernel in
    interpret mode (which takes the whole group as one block)."""
    q, k, v, seg, qpos, ks, vs = _decode_inputs(H, Hkv, int8, seed=H + Hkv + int8)
    hsd = lambda a: None if a is None else np.ascontiguousarray(np.swapaxes(a, 1, 2))  # noqa: E731
    want = jax_decode.decode_attention(q, hsd(k), hsd(v), seg, hsd(ks), hsd(vs), interpret=True)
    got = dec.decode_attention(_t(q), _t(k), _t(v), _t(seg), _t(qpos), _t(ks), _t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("H,Hkv", [(32, 1), (16, 2)])
def test_wide_group_alibi_decode_matches_jax_mpt(H, Hkv, int8):
    """With MPT's slopes: against the JAX MPT decode's XLA path over the
    same cache (the bias JAX builds from the positions)."""
    q, k, v, seg, qpos, ks, vs = _decode_inputs(H, Hkv, int8, seed=7 * H + Hkv + int8)
    B, S = seg.shape
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    bias = jax_mpt.alibi_bias_from_positions(_j(qpos[:, None]), _j(kv_pos), H)
    if int8:
        want = jax_attn.quant_cache_attention(_j(q), _j(k), _j(ks), _j(v), _j(vs),
                                              kv_segment_ids=_j(seg),
                                              q_positions=_j(qpos[:, None]), bias=bias)
    else:
        want = jax_attn.xla_attention(_j(q), _j(k), _j(v), causal=True, bias=bias,
                                      q_segment_ids=jnp.ones((B, 1), jnp.int32),
                                      kv_segment_ids=_j(seg), q_positions=_j(qpos[:, None]))
    got = dec.decode_attention(_t(q), _t(k), _t(v), _t(seg), _t(qpos), _t(ks), _t(vs),
                               alibi_slopes=mpt.alibi_slopes(H))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("H,Hkv", [(32, 1), (16, 2), (48, 2)])
def test_kernel_checks_take_any_group(H, Hkv):
    """What the card's wrapper checks before a launch (run here on CPU
    tensors): a group wider than 8 is taken; over 2 kv heads an odd head
    count, which does not group, still raises."""
    q, k, v, seg, qpos, ks, vs = _decode_inputs(H, Hkv, True, seed=1)
    args = (_t(q).bfloat16(), _t(k), _t(v), _t(seg), _t(qpos), _t(ks), _t(vs))
    dec._check_kernel_inputs(*args)
    if Hkv == 2:
        with pytest.raises(ValueError):
            dec._check_kernel_inputs(_t(q[:, :, :H - 1]).bfloat16(), *args[1:])


# ---------------------------------------------------------------- MPT masks over a cache

VARIANTS = {"prefix_lm": dict(prefix_lm=True), "sequence_id": dict(attn_uses_sequence_id=True)}


def _mpt(variant, multiquery=False):
    kw = dict(VARIANTS[variant], multiquery=multiquery)
    jc = dataclasses.replace(jax_tiny_mpt().mpt, **kw)
    tc = dataclasses.replace(tiny_llava_mpt_config().mpt, **kw)
    jp = jax.tree.map(np.asarray, jax_mpt.init_params(jc, jax.random.PRNGKey(0), jnp.float32))
    return jc, tc, jp, from_numpy(jp, "cpu")


def _mask(variant, B, T, rng):
    if variant == "prefix_lm":
        return {"prefix_mask": (np.arange(T)[None] < rng.integers(1, T, (B, 1))).astype(np.int32)}
    return {"sequence_id": (np.arange(T)[None] >= rng.integers(1, T, (B, 1))).astype(np.int32)}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mpt_masks_over_a_dense_cache_match_jax(variant, int8):
    """A chunk as long as the cache with the mask (JAX builds the bias over
    the cache's slots, ``arange(max_len)``), then, into a second cache
    prefilled without it, one token with a one-token mask: logits against
    JAX ``mpt.forward`` over the same cache (f32 MHA, or an int8 cache of
    the MQA model), and the cache's segment ids."""
    jc, tc, jp, tp = _mpt(variant, multiquery=int8)
    rng = np.random.default_rng(len(variant) + int8)
    B, S = 2, 12
    ids = rng.integers(3, 500, size=(B, S)).astype(np.int32)
    jdt, tdt = (jnp.int8, torch.int8) if int8 else (jnp.float32, torch.float32)
    mask = _mask(variant, B, S, rng)
    jcache = jax_mpt.create_cache(jc, B, S, jdt)
    want, jcache = jax_mpt.forward(jp, jc, _j(ids), cache=jcache,
                                   **{k: _j(v) for k, v in mask.items()})
    cache = mpt.create_cache(tc, B, S, tdt, device="cpu")
    got, cache = mpt.forward(tp, tc, _t(ids).long(), cache=cache,
                             **{k: _t(v) for k, v in mask.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache.seg.numpy(), np.asarray(jcache.seg))
    # the mask matters over the cache too (without it the logits move)
    plain, _ = mpt.forward(tp, tc, _t(ids).long(),
                           cache=mpt.create_cache(tc, B, S, tdt, device="cpu"))
    if variant == "sequence_id":
        assert not np.allclose(plain.numpy(), got.numpy(), atol=1e-3)

    # one decode token after an unmasked prefill of S - 1 tokens
    jcache = jax_mpt.create_cache(jc, B, S, jdt)
    cache = mpt.create_cache(tc, B, S, tdt, device="cpu")
    _, jcache = jax_mpt.forward(jp, jc, _j(ids[:, :-1]), cache=jcache)
    mpt.forward(tp, tc, _t(ids[:, :-1]).long(), cache=cache)
    pos = np.full((B, 1), S - 1, np.int32)
    one = {k: v[:, -1:] for k, v in mask.items()}
    want, _ = jax_mpt.forward(jp, jc, _j(ids[:, -1:]), cache=jcache, positions=_j(pos),
                              **{k: _j(v) for k, v in one.items()})
    got, _ = mpt.forward(tp, tc, _t(ids[:, -1:]).long(), cache=cache, positions=_t(pos),
                         **{k: _t(v) for k, v in one.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mpt_masks_over_a_paged_cache_raise(variant):
    _, tc, _, tp = _mpt(variant)
    B, T = 1, 8
    mask = _mask(variant, B, T, np.random.default_rng(0))
    cache = llama.PagedKVCache.create(tc, B, num_pages=4, max_pages_per_slot=2, page_size=8,
                                      device="cpu")
    cache.page_table[0] = torch.tensor([2, 0], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="paged"):
        mpt.forward(tp, tc, torch.arange(3, 3 + T)[None], cache=cache,
                    **{k: _t(v) for k, v in mask.items()})
