"""How much of dS the dQ kernel keeps, emulated on the CPU.

The CUDA dQ kernel (``llava_plus_torch/csrc/flash_bwd.cu``) feeds dS to the
tensor cores as two bf16 halves, hi = bf16(dS) and lo = bf16(dS - hi), and
adds both products into one f32 accumulator; the Pallas ``_bwd_dq_kernel``
(``llava_plus_tpu/ops/flash_attention.py``) rounds dS to bf16 once. Here both
are emulated in f32 on bf16-exact inputs (causal, T = 256, two heads, head
dim 128, seed 0) and held against the f64 gradient: relative to max |dq|,
the f32 plain backward errs 2.6e-7, the hi/lo split 1.8e-6 and the bf16
rounding 1.4e-3 (this test's own run). The test bounds the split at 1e-5
and requires the rounding to err at least 100 times that.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

T, H, D = 256, 2, 128
SPLIT_BOUND = 1e-5   # hi / lo split: error relative to max |dq|


def _bf16_exact(rng, shape):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.bfloat16().double()


def _case(seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16_exact(rng, (H, T, D)) for _ in range(4))
    scale = D ** -0.5
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool))

    def forward(dtype):
        s = (q.to(dtype) @ k.to(dtype).transpose(-1, -2)) * scale
        s = torch.where(causal, s, -torch.inf)
        p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
        return p, p @ v.to(dtype)

    def d_s(dtype):
        p, o = forward(dtype)
        dof = do.to(dtype)
        delta = (dof * o).sum(-1, keepdim=True)
        return p * (dof @ v.to(dtype).transpose(-1, -2) - delta) * scale

    truth = d_s(torch.float64) @ k
    ds = d_s(torch.float32)
    kf = k.float()
    hi = ds.bfloat16().float()
    lo = (ds - hi).bfloat16().float()
    return truth, {"f32": ds @ kf, "hi_lo": hi @ kf + lo @ kf, "bf16": hi @ kf}


def _rel_err(x, truth):
    return ((x.double() - truth).abs().max() / truth.abs().max()).item()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hi_lo_split_keeps_dq_near_the_f32_backward(seed):
    truth, dq = _case(seed)
    errs = {name: _rel_err(x, truth) for name, x in dq.items()}
    assert errs["f32"] < 1e-6, errs
    assert errs["hi_lo"] <= SPLIT_BOUND, errs
    # the bf16 rounding the Pallas kernel does falls well outside that bound
    assert errs["bf16"] >= 100 * SPLIT_BOUND, errs


def test_split_halves_hold_ds_to_sixteen_bits():
    """hi + lo equals dS to ~2^-16 relative, where hi alone keeps ~2^-8."""
    rng = np.random.default_rng(4)
    ds = torch.from_numpy((rng.standard_normal(4096) * np.exp(rng.uniform(-8, 2, 4096)))
                          .astype(np.float32))
    hi = ds.bfloat16().float()
    lo = (ds - hi).bfloat16().float()
    rel = ((hi + lo - ds).abs() / ds.abs()).max().item()
    rel_hi = ((hi - ds).abs() / ds.abs()).max().item()
    assert rel <= 2.0 ** -16, rel
    assert rel_hi > 2.0 ** -10, rel_hi
