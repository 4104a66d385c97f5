"""The port's W8A8 (``ops/w8a8.py`` and the gate in ``ops/quant.matmul``)
against the JAX package's ``_w8a8_matmul`` / ``matmul`` under
``set_w8a8(True)``, on the CPU (the kernels' plain versions).

Tolerances: the int8 activations and the row scales equal JAX's bit for
bit; products within 1e-6 relative in f32 and one bf16 ulp in bf16 (they
come out equal: both sum the int8 product exactly and apply the same two
f32 multiplies). The JAX engine runs its forward compiled, where XLA
computes the row scale as ``f32(amax) * f32(1/127)`` (ops/w8a8.py), so the
engines are held to the same greedy tokens."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.ops import quant as jq
from llava_plus_tpu.serve import engine as jax_engine
from llava_plus_torch.models.configs import LlavaConfig
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.ops import quant, quant_matmul, w8a8
from llava_plus_torch.serve.engine import BatchedEngine, Request

from .test_generate import CharTokenizer

torch.set_num_threads(1)
F32 = dict(rtol=1e-6, atol=0)
BF16_ULP = 2.0 ** -7   # one bf16 ulp, relative to the value


@pytest.fixture
def jax_w8a8():
    """JAX's process-wide W8A8 flag on for the test, restored after."""
    saved = jq._W8A8
    jq.set_w8a8(True)
    yield
    jq._W8A8 = saved


def _x(shape, seed, dtype=np.float32):
    """Rows of very different magnitudes (the per-row scale matters)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * rng.uniform(0.01, 10.0, size=shape[:-1] + (1,))
    return x.astype(dtype)


def _qw(K, N, seed):
    rng = np.random.default_rng(seed)
    w = jq.quantize_array(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32)))
    return w, {k: torch.from_numpy(np.array(v)) for k, v in w.items()}


def _pair(x, dtype):
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_array_less(np.abs(got - want), BF16_ULP * np.abs(want) + 1e-30)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(256, 64), (300, 64), (4, 128, 32)])
def test_matmul_matches_jax_w8a8(jax_w8a8, dtype, shape):
    """At 256 rows and more (and lead dims [4, 128], as JAX
    ``tests/test_quant.py``) the gate routes to W8A8 on both sides."""
    jw, tw = _qw(shape[-1], 48, seed=1)
    jx, tx = _pair(_x(shape, seed=2), dtype)
    want = jq.matmul(jx, jw)
    with quant.w8a8_scope():
        got = quant.matmul(tx, tw)
    assert got.shape == tuple(want.shape) and got.dtype == tx.dtype
    _close(got, want, dtype)
    # and it is not the weight-only product
    assert not torch.equal(got, quant.matmul(tx, tw))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_w8a8_matmul_equals_jax_function(dtype):
    """``quant._w8a8_matmul`` against JAX's ``_w8a8_matmul`` itself, at any
    row count (the gate is ``matmul``'s)."""
    jw, tw = _qw(64, 40, seed=18)
    jx, tx = _pair(_x((3, 70, 64), seed=19), dtype)
    want = jq._w8a8_matmul(jx, jw["qvalue"], jw["scale"])
    got = quant._w8a8_matmul(tx, tw["qvalue"], tw["scale"])
    assert got.shape == (3, 70, 40) and got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gate_at_255_rows_keeps_the_weight_only_product(jax_w8a8, dtype):
    jw, tw = _qw(64, 48, seed=3)
    jx, tx = _pair(_x((255, 64), seed=4), dtype)
    jq._W8A8 = False
    jax_plain = jq.matmul(jx, jw)
    jq._W8A8 = True
    np.testing.assert_array_equal(np.asarray(jq.matmul(jx, jw).astype(jnp.float32)),
                                  np.asarray(jax_plain.astype(jnp.float32)))
    with quant.w8a8_scope():
        got = quant.matmul(tx, tw)
    torch.testing.assert_close(got, quant.matmul(tx, tw), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_activations_and_row_scales_equal_jax(jax_w8a8, monkeypatch, dtype):
    """JAX's int8 x, read where it enters ``dot_general``, equals the port's
    bit for bit; so do the dequantized outputs' row scales."""
    seen = []
    real = jax.lax.dot_general

    def spy(a, b, *args, **kw):
        seen.append(np.asarray(a))
        return real(a, b, *args, **kw)

    monkeypatch.setattr(jax.lax, "dot_general", spy)
    jw, tw = _qw(64, 48, seed=5)
    x = _x((300, 64), seed=6)
    x[7] = 0.0                                    # the 1e-6 floor
    jx, tx = _pair(x, dtype)
    jq.matmul(jx, jw)
    xq, scale = w8a8.w8a8_quantize_rows(tx)
    assert xq.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(xq.numpy(), seen[0])
    amax = jnp.maximum(jnp.max(jnp.abs(jx), axis=-1), 1e-6)
    np.testing.assert_array_equal(scale.numpy(), np.asarray((amax / 127.0).astype(jnp.float32)))


def test_bf16_row_scale_is_rounded_to_bf16(jax_w8a8):
    """A bf16 row whose amax / 127 is not a bf16 number: JAX rounds the
    dequantizing scale to bf16, and so does the port; an f32 scale would
    give other outputs."""
    jw, tw = _qw(64, 48, seed=7)
    x = _x((256, 64), seed=8)
    x[0, 0] = 3.0                                 # row 0's absmax ...
    x[0, 1:] = np.clip(x[0, 1:], -1.0, 1.0)
    jx, tx = _pair(x, "bf16")
    assert float(torch.tensor(3.0 / 127.0, dtype=torch.bfloat16)) != np.float32(3.0) / 127
    with quant.w8a8_scope():
        got = quant.matmul(tx, tw)
    _close(got, jq.matmul(jx, jw), "bf16")
    xq, scale = w8a8.w8a8_quantize_rows(tx)
    assert float(scale[0]) == float(torch.tensor(3.0 / 127.0, dtype=torch.bfloat16))
    acc = w8a8.w8a8_int_mm(xq, tw["qvalue"])
    f32_scale = (acc[0].float() * float(np.float32(3.0) / np.float32(127.0))) * tw["scale"][0]
    assert not torch.equal(got[0], f32_scale.to(torch.bfloat16))


def test_steps_match_their_definitions():
    """The three steps one by one: the int32 product is exact, the epilogue
    multiplies the row scale first, and the product of the steps is
    ``matmul_w8a8``."""
    _, tw = _qw(64, 40, seed=9)
    tx = torch.from_numpy(_x((260, 64), seed=10))
    xq, rs = w8a8.w8a8_quantize_rows(tx)
    acc = w8a8.w8a8_int_mm(xq, tw["qvalue"])
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), xq.numpy().astype(np.int64)
                                  @ tw["qvalue"].numpy().astype(np.int64))
    out = w8a8.w8a8_epilogue(acc, rs, tw["scale"], torch.float32)
    want = (acc.numpy().astype(np.float32) * rs.numpy()[:, None]) * tw["scale"].numpy()
    np.testing.assert_array_equal(out.numpy(), want)
    torch.testing.assert_close(w8a8.matmul_w8a8(tx, tw["qvalue"], tw["scale"]), out,
                               rtol=0, atol=0)


def test_int4_and_lora_weights(jax_w8a8):
    """int4 weights never take W8A8; a LoRA weight takes it through its
    int8 base (JAX ``quant.py:204-207``)."""
    rng = np.random.default_rng(11)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    x = _x((256, 64), seed=12)
    j4 = jq.quantize_array_int4(jnp.asarray(w))
    t4 = {k: torch.from_numpy(np.array(v)) for k, v in j4.items()}
    with quant.w8a8_scope():
        torch.testing.assert_close(quant.matmul(torch.from_numpy(x), t4),
                                   quant.matmul(torch.from_numpy(x), t4), rtol=0, atol=0)
    jw, tw = _qw(64, 48, seed=13)
    a = (rng.normal(size=(64, 4)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(4, 48)) * 0.1).astype(np.float32)
    jl = dict(jw, lora_a=jnp.asarray(a), lora_b=jnp.asarray(b))
    tl = dict(tw, lora_a=torch.from_numpy(a), lora_b=torch.from_numpy(b))
    with quant.w8a8_scope():
        got = quant.matmul(torch.from_numpy(x), tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(jq.matmul(jnp.asarray(x), jl)),
                               rtol=1e-5, atol=1e-5)


def test_gradient_is_the_weight_only_one_where_jax_keeps_only_the_amax_path(jax_w8a8):
    """JAX differentiates through round and the int8 cast (derivative 0):
    its gradient reaches x only through each row's absmax, one entry a row.
    The port's W8A8 backward is the weight-only product's, dy @ dequant(w)^T,
    equal to JAX's gradient with W8A8 off (rtol 1e-5, atol 1e-5: JAX
    scales the cotangent by the column scales before the product, the port
    the weight)."""
    jw, tw = _qw(64, 48, seed=14)
    x = _x((300, 64), seed=15)
    g = np.random.default_rng(16).normal(size=(300, 48)).astype(np.float32)

    def jloss(xx):
        return jnp.sum(jq.matmul(xx, jw) * g)

    j_w8a8 = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    assert np.count_nonzero(j_w8a8) == 300
    assert (np.count_nonzero(j_w8a8, axis=1) == 1).all()
    jq._W8A8 = False
    j_plain = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    jq._W8A8 = True
    assert np.abs(j_w8a8 - j_plain).max() > np.abs(j_plain).max()

    tx = torch.from_numpy(x).requires_grad_(True)
    calls = w8a8.matmul_w8a8.backward_calls
    with quant.w8a8_scope():
        (quant.matmul(tx, tw) * torch.from_numpy(g)).sum().backward()
    assert w8a8.matmul_w8a8.backward_calls == calls + 1
    np.testing.assert_allclose(tx.grad.numpy(), j_plain, rtol=1e-5, atol=1e-5)
    want = torch.from_numpy(g) @ quant_matmul.dequantize(8, tw["qvalue"], tw["scale"],
                                                         torch.float32).T
    torch.testing.assert_close(tx.grad, want, rtol=0, atol=0)


def test_wrappers_raise_for_other_devices():
    for fn, args in ((w8a8.w8a8_quantize_rows, (torch.zeros(256, 64, device="meta"),)),
                     (w8a8.w8a8_int_mm, (torch.zeros(256, 64, dtype=torch.int8, device="meta"),
                                         torch.zeros(64, 8, dtype=torch.int8))),
                     (w8a8.w8a8_epilogue, (torch.zeros(256, 8, dtype=torch.int32,
                                                       device="meta"),
                                           torch.zeros(256), torch.zeros(8), torch.float32))):
        with pytest.raises(ValueError, match="no path for device meta"):
            fn(*args)


@pytest.fixture(scope="module")
def w8a8_engines():
    """A tiny fused int8 LLaMA, the JAX tree carried across; both engines
    with W8A8 and a 256-token prefill bucket, so every prefill's products
    have 256 rows."""
    cfg = dataclasses.replace(jax_tiny_config(), text=dataclasses.replace(
        jax_tiny_config().text, num_key_value_heads=4))
    jp = jq.quantize_llava_params(jax_llava.init_params(cfg, jax.random.PRNGKey(2),
                                                        dtype=jnp.float32), bits=8, fuse=True)
    tp = from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(max_slots=2, max_seq_len=384, prefill_bucket=256)
    saved = jq._W8A8
    jeng = jax_engine.BatchedEngine(jp, cfg, CharTokenizer(), cache_dtype=jnp.float32,
                                    w8a8=True, **kw)
    eng = BatchedEngine(tp, LlavaConfig.from_json(cfg.to_json()), CharTokenizer(),
                        cache_dtype=torch.float32, w8a8=True, **kw)
    yield eng, jeng, tp
    eng.stop()
    jeng.stop()
    jq._W8A8 = saved


def test_w8a8_engine_greedy_tokens_equal_jax(w8a8_engines, monkeypatch):
    eng, jeng, _ = w8a8_engines
    calls = []
    real = w8a8.matmul_w8a8
    monkeypatch.setattr(w8a8, "matmul_w8a8",
                        lambda x, *a, **kw: calls.append(x.shape[0]) or real(x, *a, **kw))
    for prompt in ["hello", "quantized rows"]:
        want = jeng.generate(jax_engine.Request(prompt=prompt, max_new_tokens=8))
        assert eng.generate(Request(prompt=prompt, max_new_tokens=8)) == want
    # the prefills took W8A8 (4 fused products a layer and the 2 layers), the
    # decode steps (2 rows) did not
    assert calls and set(calls) == {256}


def test_w8a8_engine_does_not_leak(w8a8_engines, monkeypatch):
    """After the W8A8 engine has served, a plain 256-row product in this
    thread is the weight-only one, bit for bit."""
    eng, _, tp = w8a8_engines
    eng.generate(Request(prompt="leak?", max_new_tokens=2))
    monkeypatch.delenv("LLAVA_W8A8", raising=False)
    assert not quant.w8a8_enabled()
    w = {k: v[0] for k, v in tp["language_model"]["layers"]["mlp"]["w_gateup"].items()}
    x = torch.from_numpy(_x((256, w["qvalue"].shape[0]), seed=17))
    got = quant.matmul(x, w)
    want = quant_matmul.matmul_int8(x, w["qvalue"], w["scale"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_process_switches(monkeypatch):
    """``set_w8a8`` and ``LLAVA_W8A8`` keep JAX's process-wide meaning; the
    scope turns W8A8 on for its block only."""
    monkeypatch.setattr(quant, "_W8A8", None)
    monkeypatch.setenv("LLAVA_W8A8", "1")
    assert quant.w8a8_enabled()
    monkeypatch.setenv("LLAVA_W8A8", "0")
    assert not quant.w8a8_enabled()
    with quant.w8a8_scope():
        assert quant.w8a8_enabled()
    assert not quant.w8a8_enabled()
    quant.set_w8a8(True)
    assert quant.w8a8_enabled()
