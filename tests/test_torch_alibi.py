"""The port's ALiBi (MPT) attention against the JAX package, on the CPU, in
f32.

The same numpy inputs go through the JAX function and the port's plain
version of each ALiBi kernel variant, with the slopes of
``llava_plus_torch.models.mpt.alibi_slopes``:

- the slopes themselves against JAX ``alibi_slopes`` (4, 6 and 32 heads;
  rtol 1e-6, f32 powers of two);
- the reference attention with ``alibi_slopes`` against ``xla_attention``
  with the dense JAX bias;
- the flash forward's plain version against the Pallas ``flash_attention``
  with ``alibi_nheads`` in interpret mode (as ``tests/test_flash_attention.py``
  runs it);
- the dense decode's plain version against ``quant_cache_attention(bias=...)``
  over an int8 cache and ``xla_attention(bias=...)`` over an f32 one;
- the paged plain version against JAX ``paged_attention_reference`` with
  ``alibi_slopes``, with and without a current chunk.

Tolerance: atol 1e-5, rtol 1e-4 (f32 sums taken in another order), on the
rows that see at least one key.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llava_plus_tpu.models import mpt as jax_mpt
from llava_plus_tpu.ops import attention as jax_attn
from llava_plus_tpu.ops import flash_attention as jax_flash
from llava_plus_tpu.ops import paged_attention as jax_paged
from llava_plus_torch.models import mpt
from llava_plus_torch.ops import paged_attention as paged
from llava_plus_torch.ops.attention import (
    _is_flash_call, quant_cache_attention, reference_attention,
)
from llava_plus_torch.ops.decode_attention import decode_attention
from llava_plus_torch.ops.flash_attention import flash_attention

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _quant(x):
    s = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) / 127.0
    return np.clip(np.round(x / s), -127, 127).astype(np.int8), s.astype(np.float32)


@pytest.mark.parametrize("n_heads", [4, 6, 32])
def test_alibi_slopes_match_jax(n_heads):
    want = np.asarray(jax_mpt.alibi_slopes(n_heads, 8))
    got = mpt.alibi_slopes(n_heads, 8)
    assert got.dtype == torch.float32 and got.shape == (n_heads,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_alibi_bias_from_positions_matches_jax():
    q_pos = np.array([[5, 6, 7], [0, 1, 2]], np.int32)
    kv_pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    want = jax_mpt.alibi_bias_from_positions(_j(q_pos), _j(kv_pos), 6)
    got = mpt.alibi_bias_from_positions(_t(q_pos), _t(kv_pos), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("H,Hkv,Tq", [(4, 4, 12), (4, 2, 3), (4, 1, 1)])
def test_reference_attention_alibi_matches_xla(H, Hkv, Tq):
    """Explicit positions (a cache continuation): the bias comes from them."""
    rng = np.random.default_rng(H * 10 + Hkv + Tq)
    B, Tkv, D = 2, 12, 16
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Tkv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Tkv, Hkv, D)).astype(np.float32)
    seg = np.ones((B, Tkv), np.int32)
    seg[1, 9:] = 0
    q_pos = np.stack([np.arange(Tkv - Tq, Tkv), np.arange(9 - Tq, 9)]).astype(np.int32)
    kv_pos = np.tile(np.arange(Tkv, dtype=np.int32), (B, 1))
    bias = jax_mpt.alibi_bias_from_positions(_j(q_pos), _j(kv_pos), H)
    want = jax_attn.xla_attention(_j(q), _j(k), _j(v), causal=True, bias=bias,
                                  q_segment_ids=jnp.ones((B, Tq), jnp.int32),
                                  kv_segment_ids=_j(seg), q_positions=_j(q_pos),
                                  kv_positions=_j(kv_pos), softmax_scale=0.3)
    got = reference_attention(_t(q), _t(k), _t(v), causal=True,
                              q_segment_ids=torch.ones(B, Tq, dtype=torch.int32),
                              kv_segment_ids=_t(seg), q_positions=_t(q_pos),
                              kv_positions=_t(kv_pos), softmax_scale=0.3,
                              alibi_slopes=mpt.alibi_slopes(H))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,Hkv,pad", [(True, 4, False), (True, 1, True),
                                            (False, 2, False)])
def test_flash_alibi_plain_matches_pallas(causal, Hkv, pad):
    """The plain version of the ALiBi flash forward (what the CUDA variant
    computes) against the Pallas kernel in interpret mode; with padding,
    on the rows that are not padding."""
    rng = np.random.default_rng(3 + Hkv)
    B, T, H, D = 2, 256, 4, 128
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    seg = np.ones((B, T), np.int32)
    if pad:
        seg[1, 200:] = 0
    want = jax_flash.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                                     q_segment_ids=_j(seg), kv_segment_ids=_j(seg),
                                     alibi_nheads=H, block_q=128, block_k=128)
    got, _ = flash_attention(_t(q), _t(k), _t(v), causal=causal, q_segment_ids=_t(seg),
                             kv_segment_ids=_t(seg), alibi_slopes=mpt.alibi_slopes(H))
    rows = seg != 0
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows], **TOL)


def test_alibi_self_attention_takes_the_flash_kernel():
    """Slopes are no additive bias: an ALiBi prefill is still a flash call."""
    q = torch.zeros(1, 8, 2, 128)
    assert _is_flash_call(q, q, None, None, None)
    assert not _is_flash_call(q, q, torch.zeros(1, 1, 8, 8), None, None)


@pytest.mark.parametrize("int8,H,Hkv", [(False, 4, 4), (True, 4, 4), (True, 4, 1),
                                        (False, 8, 2)])
def test_decode_alibi_plain_matches_jax(int8, H, Hkv):
    """One query token over a dense cache (slot == position): the decode
    kernel's plain version against the JAX MPT decode's XLA path."""
    rng = np.random.default_rng(int8 * 10 + H + Hkv)
    B, S, D = 2, 24, 16
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    seg = np.zeros((B, S), np.int32)
    seg[0, :20], seg[1, :9] = 1, 1
    q_pos = np.array([19, 8], np.int32)
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    bias = jax_mpt.alibi_bias_from_positions(_j(q_pos[:, None]), _j(kv_pos), H)
    slopes = mpt.alibi_slopes(H)
    if int8:
        (kq, ks), (vq, vs) = _quant(k), _quant(v)
        want = jax_attn.quant_cache_attention(_j(q), _j(kq), _j(ks), _j(vq), _j(vs),
                                              kv_segment_ids=_j(seg),
                                              q_positions=_j(q_pos[:, None]), bias=bias)
        got = decode_attention(_t(q), _t(kq), _t(vq), _t(seg), _t(q_pos), _t(ks), _t(vs),
                               alibi_slopes=slopes)
        # the port's quant_cache_attention takes the same bias (multi-token chunks)
        also = quant_cache_attention(_t(q), _t(kq), _t(ks), _t(vq), _t(vs),
                                     kv_segment_ids=_t(seg), q_positions=_t(q_pos[:, None]),
                                     bias=torch.from_numpy(np.array(bias)))
        np.testing.assert_allclose(also.numpy(), np.asarray(want), **TOL)
    else:
        want = jax_attn.xla_attention(_j(q), _j(k), _j(v), causal=True, bias=bias,
                                      q_segment_ids=jnp.ones((B, 1), jnp.int32),
                                      kv_segment_ids=_j(seg), q_positions=_j(q_pos[:, None]))
        got = decode_attention(_t(q), _t(k), _t(v), _t(seg), _t(q_pos), alibi_slopes=slopes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    (4, 4, 1, False, False),   # the query already pooled, at lengths - 1
    (4, 4, 1, True, True),     # MHA decode (decode1 on the card)
    (4, 1, 1, True, True),     # MQA decode (the general kernel)
    (4, 4, 4, False, True),    # a 4-token chunk with valid prefixes
    (8, 2, 7, True, True),
])
def test_paged_alibi_plain_matches_jax(H, Hkv, Tq, quantized, cur):
    rng = np.random.default_rng(H * 100 + Hkv * 10 + Tq)
    q, kv, pt, lengths, scale, ck, cv, valid = _pool_inputs(
        rng, B=3, Tq=Tq, H=H, Hkv=Hkv, D=32, P=16, maxp=4, quantized=quantized, cur=cur)
    want = jax_paged.paged_attention_reference(
        _j(q), _j(kv), _j(pt), _j(lengths), _j(scale), cur_k=_j(ck), cur_v=_j(cv),
        cur_valid=_j(valid), alibi_slopes=jax_mpt.alibi_slopes(H))
    got = paged.paged_decode_attention(*(_t(x) for x in (q, kv, pt, lengths, scale, ck, cv,
                                                         valid)),
                                       alibi_slopes=mpt.alibi_slopes(H))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
