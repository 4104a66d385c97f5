"""The port's flash-attention backward against the JAX package's, on the CPU.

``llava_plus_torch.ops.flash_attention.flash_attention`` runs its plain
forward and plain backward here (the CUDA kernels run only on the card,
where ``chip_smoke.py`` holds them against these plain versions). Its
gradients are compared with ``jax.grad`` through the JAX package's
``flash_attention``, which runs the Pallas backward kernels in interpret
mode on the CPU, in f32: atol 5e-4, rtol 1e-3, the JAX package's own
tolerance for its Pallas backward against XLA (the two sum in different
orders). The plain backward is also held to torch autograd through the
plain forward in f64 (atol 1e-10)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.ops.flash_attention import flash_attention as jax_flash
from llava_plus_torch.ops import flash_attention as fa

torch.set_num_threads(1)
B, H, D = 2, 4, 128
CASES = ["causal", "noncausal", "gqa", "packed", "padded"]


def _inputs(case, T, seed=7):
    rng = np.random.default_rng(seed)
    Hkv = 2 if case == "gqa" else H
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    seg = np.ones((B, T), np.int32)
    if case == "packed":
        seg[0, T // 3:] = 2
        seg[1, T // 2:] = 2
    elif case == "padded":
        seg[0, T - 37:] = 0
        seg[1, T - 90:] = 0
    # the cotangent is 0 at padding rows: the XLA path inside the JAX
    # package's tests gives them a uniform average, the kernels zero them,
    # and no loss reads them
    g = (rng.normal(size=(B, T, H, D)) * (seg != 0)[:, :, None, None]).astype(np.float32)
    return q, k, v, seg, g, case != "noncausal"


def _torch_grads(q, k, v, seg, g, causal, dtype=torch.float32):
    qt, kt, vt = (torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v))
    s = torch.from_numpy(seg)
    out, _ = fa.flash_attention(qt, kt, vt, causal=causal, q_segment_ids=s, kv_segment_ids=s)
    out.backward(torch.tensor(g, dtype=dtype))
    return out, (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize("T", [256, 200])
@pytest.mark.parametrize("case", CASES)
def test_grads_match_jax_pallas_backward(case, T):
    q, k, v, seg, g, causal = _inputs(case, T)
    seg_j = jnp.asarray(seg)

    def loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, q_segment_ids=seg_j, kv_segment_ids=seg_j,
                      block_q=128, block_k=128)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    _, got = _torch_grads(q, k, v, seg, g, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=1e-3,
                                   err_msg=f"d{name} ({case}, T={T})")


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_is_the_gradient_of_the_plain_forward(case):
    """f64: the plain backward (replaying P from lse) equals autograd through
    the plain forward, every row included (the cotangent is not masked)."""
    T = 200
    q, k, v, seg, _, causal = _inputs(case, T, seed=3)
    g = np.random.default_rng(4).normal(size=q.shape)
    _, got = _torch_grads(q, k, v, seg, g, causal, dtype=torch.float64)
    qt, kt, vt = (torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (q, k, v))
    s = torch.from_numpy(seg)
    out, _ = fa.flash_attention_reference(qt, kt, vt, s, s, causal=causal, sm_scale=D ** -0.5)
    want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0, msg=f"d{name} ({case})")


@pytest.mark.parametrize("case", ["packed", "padded"])
def test_padding_rows_get_zero_gradient(case):
    """Rows of segment 0 (the tail padding, and the wrapper's own padding to
    the 64-row tile) take no gradient and give none, even under a cotangent
    that is nonzero there; every gradient is finite."""
    T = 200
    q, k, v, seg, _, causal = _inputs(case, T, seed=5)
    seg[1, T - 20:] = 0
    g = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    out, grads = _torch_grads(q, k, v, seg, g, causal)
    assert out.requires_grad and out.shape == (B, T, H, D)
    pad = torch.from_numpy(seg == 0)
    for x in grads:
        assert torch.isfinite(x).all()
        assert x[pad].abs().max() == 0.0
        assert x[~pad].abs().max() > 0.0


def test_lse_carries_no_gradient_and_output_keeps_the_graph():
    """The output is differentiable; lse is marked non-differentiable, and
    the backward saves the padded tensors (T 200 -> 256)."""
    q, k, v, seg, g, causal = _inputs("causal", 200)
    qt = torch.tensor(q, requires_grad=True)
    out, lse = fa.flash_attention(qt, torch.tensor(k), torch.tensor(v), causal=True)
    assert out.grad_fn is not None and not lse.requires_grad
    assert lse.shape == (B, H, 200)
    saved = out.grad_fn.saved_tensors
    assert saved[0].shape == (B, 256, H, D)
