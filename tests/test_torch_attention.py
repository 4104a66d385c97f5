"""The port's attention ops against the JAX package, on the CPU, in fp32.

Same numpy inputs go through the JAX function and its PyTorch counterpart:
the reference attention (every masking rule), the int8-cache reference, and
the plain versions of the two CUDA kernels (flash forward, flash decode)
against the JAX Pallas kernels run in interpret mode. Tolerance: atol 1e-5,
rtol 1e-4 (fp32 sums taken in a different order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.ops import attention as jax_attn
from llava_plus_tpu.ops import decode_attention as jax_decode
from llava_plus_tpu.ops import flash_attention as jax_flash
from llava_plus_torch.ops.attention import (
    _is_flash_call, attention, quant_cache_attention, reference_attention,
)
from llava_plus_torch.ops.decode_attention import decode_attention
from llava_plus_torch.ops.flash_attention import flash_attention

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, mask=None):
    got = got.detach().numpy()
    want = np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, **TOL)


def _qkv(rng, B, Tq, Tkv, H, Hkv, D):
    return (rng.normal(size=(B, Tq, H, D)).astype(np.float32),
            rng.normal(size=(B, Tkv, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Tkv, Hkv, D)).astype(np.float32))


def _quant(x):
    s = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) / 127.0
    return np.clip(np.round(x / s), -127, 127).astype(np.int8), s.astype(np.float32)


REFERENCE_CASES = {
    "causal": dict(H=4, Hkv=4),
    "non_causal": dict(H=4, Hkv=4, causal=False),
    "segments": dict(H=4, Hkv=4, segments=True),
    "gqa_segments": dict(H=4, Hkv=2, segments=True),
    "positions": dict(H=4, Hkv=2, Tq=3, positions=True),
    "bias": dict(H=4, Hkv=4, bias=True),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_attention_matches_xla(case):
    c = REFERENCE_CASES[case]
    rng = np.random.default_rng(0)
    B, Tkv, D = 2, 16, 16
    Tq = c.get("Tq", Tkv)
    q, k, v = _qkv(rng, B, Tq, Tkv, c["H"], c["Hkv"], D)
    kw = dict(causal=c.get("causal", True))
    if c.get("segments"):
        seg = np.array([[1] * 6 + [2] * 7 + [0] * 3, [1] * 16], np.int32)
        kw.update(q_segment_ids=seg, kv_segment_ids=seg)
    if c.get("positions"):
        kw.update(q_positions=np.array([[3, 4, 5], [10, 11, 12]], np.int32),
                  kv_positions=np.tile(np.arange(Tkv, dtype=np.int32)[::-1], (B, 1)))
    if c.get("bias"):
        kw["bias"] = rng.normal(size=(B, c["H"], Tq, Tkv)).astype(np.float32)
    want = jax_attn.xla_attention(q, k, v, **{n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
                                             for n, a in kw.items()})
    got = reference_attention(_t(q), _t(k), _t(v), **{n: (_t(a) if isinstance(a, np.ndarray) else a)
                                                      for n, a in kw.items()})
    _close(got, want)
    # on the CPU the dispatching entry point is the reference
    _close(attention(_t(q), _t(k), _t(v), **{n: (_t(a) if isinstance(a, np.ndarray) else a)
                                             for n, a in kw.items()}), want)


@pytest.mark.parametrize("Tq,H,Hkv", [(1, 4, 4), (1, 4, 2), (3, 4, 2)])
def test_quant_cache_attention_matches_jax(Tq, H, Hkv):
    rng = np.random.default_rng(1)
    B, S, D = 2, 24, 16
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    kq, ks = _quant(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
    vq, vs = _quant(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
    seg = np.zeros((B, S), np.int32)
    seg[0, :20], seg[1, :9] = 1, 1
    qpos = np.array([[19 - Tq + 1 + i for i in range(Tq)],
                     [8 - Tq + 1 + i for i in range(Tq)]], np.int32)
    want = jax_attn.quant_cache_attention(
        q, kq, ks, vq, vs, kv_segment_ids=seg, q_positions=qpos)
    got = quant_cache_attention(_t(q), _t(kq), _t(ks), _t(vq), _t(vs),
                                kv_segment_ids=_t(seg), q_positions=_t(qpos))
    _close(got, want)


FLASH_CASES = {
    "mha_padded_tail": dict(H=2, Hkv=2, T=40, pad_tail=9),
    "gqa": dict(H=4, Hkv=2, T=72, pad_tail=0),
    "mha_non_causal": dict(H=2, Hkv=2, T=40, pad_tail=5, causal=False),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax_kernel(case):
    """Output on rows with seg > 0 (padded rows differ by design) and lse."""
    c = FLASH_CASES[case]
    rng = np.random.default_rng(2)
    B, T, D = 2, c["T"], 128
    q, k, v = _qkv(rng, B, T, T, c["H"], c["Hkv"], D)
    seg = np.ones((B, T), np.int32)
    if c["pad_tail"]:
        seg[1, T - c["pad_tail"]:] = 0
    causal = c.get("causal", True)
    want_out, res = jax_flash._flash_fwd_rule(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg), jnp.asarray(seg),
        causal, D ** -0.5, 0, 512, 512, c["Hkv"])
    want_lse = np.asarray(res[6]).reshape(B, c["H"], -1)[:, :, :T]
    got_out, got_lse = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                       q_segment_ids=_t(seg), kv_segment_ids=_t(seg))
    rows = seg > 0
    _close(got_out, want_out, rows)
    _close(got_lse, want_lse, np.broadcast_to(rows[:, None, :], want_lse.shape))
    assert got_out.shape == (B, T, c["H"], D) and got_lse.shape == (B, c["H"], T)


DECODE_CASES = {"bf16_gqa": (8, 4, False), "int8_gqa": (8, 4, True),
                "bf16_mha": (4, 4, False)}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_jax_kernel(case):
    """Ragged fills as in tests/test_decode_attention.py; the port reads the
    model's [B, S, Hkv, D] layout, the JAX kernel [B, Hkv, S, D]."""
    H, Hkv, quantized = DECODE_CASES[case]
    rng = np.random.default_rng(3)
    B, S, D = 3, 256, 128
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    fills = [100, 37, S]
    seg = np.zeros((B, S), np.int32)
    for i, f in enumerate(fills):
        seg[i, :f] = 1
    qpos = np.array(fills, np.int32) - 1
    hsd = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))
    if quantized:
        (k, ks), (v, vs) = _quant(k), _quant(v)
        want = jax_decode.decode_attention(q, hsd(k), hsd(v), seg, hsd(ks), hsd(vs),
                                           interpret=True)
        got = decode_attention(_t(q), _t(k), _t(v), _t(seg), _t(qpos), _t(ks), _t(vs))
    else:
        want = jax_decode.decode_attention(q, hsd(k), hsd(v), seg, interpret=True)
        got = decode_attention(_t(q), _t(k), _t(v), _t(seg), _t(qpos))
    _close(got, want)


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    q = torch.zeros(1, 64, 2, 128, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    seg = torch.ones(1, 64, dtype=torch.int32, device="meta")
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        decode_attention(q[:, :1], q, q, seg, pos)


def test_flash_rejects_alibi():
    """What the ALiBi variant does not take raises: slopes that are not f32
    [H]. Its forward and its gradient (through the ALiBi backward's plain
    version) are the JAX function's (``test_torch_alibi.py`` and
    ``test_torch_alibi_bwd.py`` hold them to the Pallas kernels); here, to
    the f32 reference with the dense JAX bias and its ``jax.grad``."""
    from llava_plus_tpu.models import mpt as jax_mpt
    from llava_plus_torch.models.mpt import alibi_slopes

    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 1, 20, 20, 2, 2, 128)
    for bad in (torch.ones(3), torch.ones(2, dtype=torch.float64)):
        with pytest.raises(ValueError):
            flash_attention(_t(q), _t(k), _t(v), alibi_slopes=bad)
    qt = _t(q).requires_grad_()
    out, _ = flash_attention(qt, _t(k), _t(v), alibi_slopes=alibi_slopes(2))
    pos = jnp.arange(20, dtype=jnp.int32)[None]
    bias = jax_mpt.alibi_bias_from_positions(pos, pos, 2)
    want = jax_attn.xla_attention(q, k, v, causal=True, bias=bias)
    _close(out, want)
    out.sum().backward()
    want_dq = jax.grad(lambda x: jax_attn.xla_attention(x, k, v, causal=True,
                                                        bias=bias).sum())(jnp.asarray(q))
    _close(qt.grad, want_dq)


@pytest.mark.parametrize("case,want", [
    ("self T=8", True), ("self T=768", True), ("cached Tq<Tkv", False),
    ("q_positions", False), ("kv_positions", False), ("bias", False),
])
def test_flash_dispatch_takes_every_self_attention_call(case, want):
    """On the card every bias-free self-attention call goes to the flash
    kernel, whatever its length; only calls the kernel does not compute
    take the reference."""
    T = 768 if case == "self T=768" else 8
    q = torch.zeros(1, T, 2, 128)
    k = torch.zeros(1, 2 * T if case == "cached Tq<Tkv" else T, 2, 128)
    pos = torch.arange(T, dtype=torch.int32)[None]
    bias = torch.zeros(1, 2, T, T) if case == "bias" else None
    assert _is_flash_call(q, k, bias, pos if case == "q_positions" else None,
                          pos if case == "kv_positions" else None) is want
