"""The port's native-int4 matmul against the JAX int4 measurement tool, on
the CPU.

``tools/bench_int4_variants.py`` is loaded unmodified with ``importlib``
and its ``matmul_int4_native`` (Pallas ``_int4n_kernel``) runs in interpret
mode; the port's ``matmul_int4_native`` takes its plain path here. Also: the
native packing, the quantizer bit for bit against the tool's inline
quantization, the tool's K-tail truncation (its grid takes ``K // bk``
steps) against the port's full contraction, the wrapper's rejections, and
both ported tools end to end at one small shape.

Tolerance: f32 outputs within ``1e-4 * max |out|`` (the same bf16 operands,
products exact in f32, summed in another order)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from llava_plus_tpu.ops import quant as jq
from llava_plus_torch.ops import quant, quant_matmul as qm
from llava_plus_torch.tools import bench_int4, bench_int4_variants

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("jax_bench_int4_variants",
                                               ROOT / "tools" / "bench_int4_variants.py")
jax_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_tool)


def _case(R, K, N, seed):
    """bf16-exact x [R, K] as f32, int4 values [K, N] covering -8 and 7, and
    block scales [K/32, N]."""
    rng = np.random.default_rng(seed)
    x = np.array(jnp.asarray(rng.normal(size=(R, K)), jnp.bfloat16).astype(jnp.float32))
    q = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    q[0, 0], q[1, 1] = -8, 7
    s = rng.uniform(0.005, 0.1, size=(K // 32, N)).astype(np.float32)
    return x, q, s


def _jax(x, q, s, block_k):
    with pltpu.force_tpu_interpret_mode():
        out = jax_tool.matmul_int4_native(jnp.asarray(x, jnp.bfloat16),
                                          jnp.asarray(q).astype(jnp.int4), jnp.asarray(s),
                                          block_k=block_k)
    return np.asarray(out)


def _port(x, q, s):
    out = qm.matmul_int4_native(torch.from_numpy(x).bfloat16(),
                                qm.pack_int4_native(torch.from_numpy(q)), torch.from_numpy(s))
    assert out.dtype == torch.float32
    return out.numpy()


def _full_product(x, q, s, rows=None):
    """x @ bf16(q * scale) in f64 over the first ``rows`` rows of K (all)."""
    K, N = q.shape
    w = (q.astype(np.float32).reshape(K // 32, 32, N) * s[:, None, :]).reshape(K, N)
    w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32), np.float64)
    rows = rows or K
    return x[:, :rows].astype(np.float64) @ w[:rows]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("N", [256, 512])
@pytest.mark.parametrize("K", [256, 512])
@pytest.mark.parametrize("R", [1, 5, 16, 33])
def test_plain_matches_jax_pallas(R, K, N):
    x, q, s = _case(R, K, N, seed=R * 1000 + K + N)
    want = _jax(x, q, s, block_k=256)   # divides K: one or two grid steps over K
    got = _port(x, q, s)
    assert got.shape == want.shape == (R, N)
    _close(got, want)


def test_k_tail_truncated_by_jax_computed_by_port():
    """K = 384 with the tool's ``block_k = 256``: the Pallas grid has one K
    step, so the JAX output is the product over the first 256 rows; the
    port's is the whole product (and equals JAX with a block that divides K)."""
    x, q, s = _case(2, 384, 256, seed=7)
    jax_out = _jax(x, q, s, block_k=256)
    full = _full_product(x, q, s)
    _close(jax_out, _full_product(x, q, s, rows=256))
    assert np.abs(jax_out - full).max() > 0.05 * np.abs(full).max()
    port = _port(x, q, s)
    _close(port, full)
    _close(port, _jax(x, q, s, block_k=128))


def test_packing_round_trips_and_layout():
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.integers(-8, 8, size=(2, 64, 10)).astype(np.int8))
    packed = qm.pack_int4_native(v)
    assert packed.dtype == torch.uint8 and packed.shape == (2, 64, 5)
    assert torch.equal(qm.unpack_int4_native(packed), v)
    # element (k, n) in byte (k, n // 2): low nibble for even n, high for odd
    pair = qm.pack_int4_native(torch.tensor([[1, -1, -8, 7]], dtype=torch.int8))
    assert pair.tolist() == [[0xF1, 0x78]]
    with pytest.raises(ValueError):
        qm.pack_int4_native(torch.zeros(4, 3, dtype=torch.int8))


@pytest.mark.parametrize("K,N", [(256, 128), (1024, 320)])
def test_quantizer_matches_the_jax_tool_bit_for_bit(K, N):
    """The tool's inline native quantization (``bench_int4_variants.py``
    main): the int4 scales, ``round(w / scale)`` in f32 clipped to [-8, 7],
    cast to ``jnp.int4``."""
    rng = np.random.default_rng(K + N)
    w = (rng.normal(size=(K, N)) * rng.uniform(0.001, 30, size=(1, N))).astype(np.float32)
    w[:, 3] = 0.0
    scale = jq.quantize_array_int4(jnp.asarray(w))[jq.SKEY]
    wf = w.reshape(K // 32, 32, N)
    q4n = np.clip(np.round(wf / np.asarray(scale)[:, None, :]), -8, 7)
    q4n = jnp.asarray(q4n.reshape(K, N), jnp.int8).astype(jnp.int4)
    packed, port_scale = quant.quantize_array_int4_native(torch.from_numpy(w))
    np.testing.assert_array_equal(quant.unpack_int4_native(packed).numpy(),
                                  np.asarray(q4n).astype(np.int8))
    np.testing.assert_array_equal(port_scale.numpy(), np.asarray(scale))


def _inputs(R=2, K=64, N=128):
    return (torch.zeros(R, K, dtype=torch.bfloat16), torch.zeros(K, N // 2, dtype=torch.uint8),
            torch.ones(K // 32, N))


@pytest.mark.parametrize("case", ["odd_n", "k_not_32", "scale_shape", "int8_weight", "meta"])
def test_wrapper_rejects(case):
    x, qw, s = _inputs()
    if case == "odd_n":
        s = torch.ones(2, 129)
    elif case == "k_not_32":
        x, qw, s = torch.zeros(2, 48, dtype=torch.bfloat16), torch.zeros(48, 64, dtype=torch.uint8), \
            torch.ones(1, 128)
    elif case == "scale_shape":
        s = torch.ones(4, 128)
    elif case == "int8_weight":
        qw = qw.view(torch.int8)
    else:
        x, qw, s = x.to("meta"), qw.to("meta"), s.to("meta")
    with pytest.raises((ValueError, TypeError)):
        qm.matmul_int4_native(x, qw, s)
    assert qm.matmul_int4_native.launches == 0


@pytest.mark.parametrize("tool", [bench_int4_variants, bench_int4])
def test_tool_runs_at_one_small_shape(tool, capsys):
    argv = ["--device", "cpu", "--rows", "5", "--shape", "256x512"]
    assert tool.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu") and len(lines) == 2
    want = ("V0-packed", "V3-native", "int8") if tool is bench_int4_variants else (
        "int4-kernel", "int4-library", "int8-kernel", "int8-library")
    assert lines[1].startswith("[256x512] R=5: ") and all(w in lines[1] for w in want)


def test_tool_exits_nonzero_on_a_miss(monkeypatch, capsys):
    monkeypatch.setattr(qm, "matmul_int4_native",
                        lambda x, q, s: torch.zeros(x.shape[0], 2 * q.shape[1]))
    assert bench_int4_variants.main(["--device", "cpu", "--rows", "2", "--shape", "256x256"]) == 1
    assert "FAIL V3-native" in capsys.readouterr().out
