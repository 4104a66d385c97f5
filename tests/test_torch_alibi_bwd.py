"""The ALiBi flash backward (MPT training) against the JAX package's, on the CPU.

On the card ``flash_attention(..., alibi_slopes=...)`` differentiates through
the ALiBi instances of the CUDA backward kernels (``csrc/flash_bwd.cu``, the
Pallas ``use_alibi`` branches of ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``);
here it runs their plain version, ``flash_attention_backward_reference`` with
the slopes, which ``chip_smoke.py`` holds the kernels to. That plain version
is compared with ``jax.vjp`` of the JAX package's ``flash_attention(...,
alibi_nheads=H)``, whose Pallas kernels run in interpret mode: MHA, GQA and
MQA, causal and not, a row padded at its end and a row packed with two
segments, f32, rtol 1e-4 / atol 1e-5; padding rows' gradients exactly 0.
The plain backward is also the gradient of the plain forward (f64 finite
differences through ``torch.autograd.gradcheck``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.ops.flash_attention import flash_attention as jax_flash
from llava_plus_torch.models.mpt import alibi_slopes
from llava_plus_torch.ops import flash_attention as fa

torch.set_num_threads(1)
B, H, D, T = 2, 4, 128, 256
TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(Hkv, seed):
    """Row 0 padded over its last 50 tokens, row 1 packed as 2 segments."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    seg = np.ones((B, T), np.int32)
    seg[0, T - 50:] = 0
    seg[1, T // 3:] = 2
    g = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return q, k, v, seg, g


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("Hkv", [4, 2, 1], ids=["mha", "gqa", "mqa"])
def test_alibi_backward_matches_pallas(Hkv, causal):
    q, k, v, seg, g = _inputs(Hkv, seed=Hkv + 10 * causal)
    seg_j = jnp.asarray(seg)

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, q_segment_ids=seg_j, kv_segment_ids=seg_j,
                         alibi_nheads=H, block_q=128, block_k=128)

    want_out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))

    slopes = alibi_slopes(H)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    s = torch.from_numpy(seg)
    out, lse = fa.flash_attention_reference(qt, kt, vt, s, s, causal=causal,
                                            sm_scale=D ** -0.5, alibi_slopes=slopes)
    live = seg != 0
    np.testing.assert_allclose(out.numpy()[live], np.asarray(want_out)[live], **TOL)
    got = fa.flash_attention_backward_reference(qt, kt, vt, s, s, out, lse, torch.from_numpy(g),
                                                causal=causal, sm_scale=D ** -0.5,
                                                alibi_slopes=slopes)
    for name, a, b in zip("qkv", got, want):
        a, b = a.numpy(), np.asarray(b)
        # the Pallas cotangent reaches padding rows through the XLA fold
        # only as zeros too; both must be exactly 0 there
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"d{name} (Hkv={Hkv}, causal={causal})")
        assert np.abs(a[~live]).max() == 0.0
        assert np.abs(a[live]).max() > 0.0


@pytest.mark.parametrize("Hkv", [2, 1], ids=["mha", "mqa"])
def test_alibi_autograd_is_the_plain_backward(Hkv):
    """Through the autograd Function (the card's wiring, CPU path): the
    gradients equal the plain backward's, and the slopes take none."""
    q, k, v, seg, g = _inputs(Hkv, seed=3)
    q, k, v, g = q[:, :, :2], k, v, g[:, :, :2]
    slopes = alibi_slopes(2)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    s = torch.from_numpy(seg)
    out, _ = fa.flash_attention(qt, kt, vt, q_segment_ids=s, kv_segment_ids=s,
                                alibi_slopes=slopes)
    out.backward(torch.from_numpy(g))
    p_out, p_lse = fa.flash_attention_reference(*(x.detach() for x in (qt, kt, vt)), s, s,
                                                causal=True, sm_scale=D ** -0.5,
                                                alibi_slopes=slopes)
    want = fa.flash_attention_backward_reference(
        *(x.detach() for x in (qt, kt, vt)), s, s, p_out, p_lse, torch.from_numpy(g),
        causal=True, sm_scale=D ** -0.5, alibi_slopes=slopes)
    for a, b in zip((qt.grad, kt.grad, vt.grad), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not slopes.requires_grad


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_alibi_backward_finite_differences(causal):
    """f64 at T = 64: the backward through ``flash_attention`` with slopes
    (its plain version on the CPU) against central differences of the
    forward, along random directions (``gradcheck``'s fast mode), on a
    packed and a padded row."""
    rng = np.random.default_rng(11)
    Tn, Hn, Dn = 64, 2, 16
    q, k, v = (torch.tensor(rng.normal(size=(2, Tn, Hn, Dn)), dtype=torch.float64,
                            requires_grad=True) for _ in range(3))
    seg = torch.ones(2, Tn, dtype=torch.int32)
    seg[0, 40:] = 2
    seg[1, 50:] = 0
    slopes = alibi_slopes(Hn)

    def f(q, k, v):
        return fa.flash_attention(q, k, v, causal=causal, q_segment_ids=seg, kv_segment_ids=seg,
                                  alibi_slopes=slopes)[0]

    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-7, rtol=1e-5,
                                    fast_mode=True)
