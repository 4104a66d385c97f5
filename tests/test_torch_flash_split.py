"""The dK/dV kernel's split over query heads, on the CPU.

On the card ``flash_bwd_dkv`` splits the G query heads of each kv head into
``dkv_head_splits(B, T, Hkv, G, n_sms)`` contiguous ranges, one block each;
the blocks write f32 partial dK and dV and a second kernel adds them in
split order. Here the plan is checked on the shapes the port runs, and the
arithmetic of the split on the plain backward: run over S contiguous head
ranges of an MQA input and summed in f32, it equals the whole plain
backward (atol 1e-5: only the order of the sums differs) and ``jax.vjp``
through the JAX package's Pallas backward in interpret mode (atol 5e-4,
rtol 1e-3, the tolerance ``tests/test_torch_flash_bwd.py`` holds it to),
with and without ALiBi slopes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.ops.flash_attention import flash_attention as jax_flash
from llava_plus_torch.models.mpt import alibi_slopes
from llava_plus_torch.ops import flash_attention as fa

torch.set_num_threads(1)
H100_SMS = 132


# MHA (G = 1): phase 3's backward rows of chip_smoke.py (B = 2, T = 2048 and
# the ragged T = 1984), LLaVA-1.5-7B and LLaVA-MPT-7B training (32 heads of
# 128: stage 1 at batch 32, stage 2 and QLoRA at batch 4, rows of 700 to
# 2048 tokens), and the narrow models' short rows
@pytest.mark.parametrize("B,T", [(2, 2048), (2, 1984), (32, 768), (32, 2048), (4, 704),
                                 (4, 2048), (2, 128), (1, 64)])
def test_mha_never_splits(B, T):
    assert fa.dkv_head_splits(B, T, 32, 1, H100_SMS) == 1
    assert fa.dkv_head_splits(B, T, 4, 1, H100_SMS) == 1


def test_mqa_training_shape_fills_the_card():
    """MQA at B = 2, T = 2048, 32 query heads over one kv head: 16 kv tiles
    a row give 32 blocks; the split lifts that to at least two a SM."""
    S = fa.dkv_head_splits(2, 2048, 1, 32, H100_SMS)
    tiles = -(-2048 // fa.DKV_TILE) * 2 * 1
    assert 1 < S <= 32 and 32 % S == 0
    assert tiles * S >= 2 * H100_SMS
    # the smallest divisor of the group that does
    assert all(tiles * d < 2 * H100_SMS for d in range(1, S) if 32 % d == 0)


@pytest.mark.parametrize("B", [2, 32])
@pytest.mark.parametrize("T", [64, 1984, 2048])
@pytest.mark.parametrize("Hkv,G", [(32, 1), (8, 4), (4, 8), (1, 32), (1, 4), (2, 3), (1, 7)])
@pytest.mark.parametrize("n_sms", [132, 8])
def test_plan_splits_groups_evenly(B, T, Hkv, G, n_sms):
    """Every split is a divisor of G, at most G, and 1 whenever the kv
    tiles alone give two blocks a SM."""
    S = fa.dkv_head_splits(B, T, Hkv, G, n_sms)
    assert 1 <= S <= G and G % S == 0
    tiles = -(-T // fa.DKV_TILE) * B * Hkv
    if tiles >= 2 * n_sms:
        assert S == 1
    elif tiles * S < 2 * n_sms:
        assert S == G


B, H, D, T = 2, 8, 128, 256


def _mqa_inputs(seed):
    """Eight query heads over one kv head; row 0 padded over its last 40
    tokens, row 1 packed as two segments."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, 1, D)).astype(np.float32)
    v = rng.normal(size=(B, T, 1, D)).astype(np.float32)
    seg = np.ones((B, T), np.int32)
    seg[0, T - 40:] = 0
    seg[1, T // 3:] = 2
    g = (rng.normal(size=(B, T, H, D)) * (seg != 0)[:, :, None, None]).astype(np.float32)
    return q, k, v, seg, g


def _split_dkv(q, k, v, s, out, lse, do, splits, kw, slopes):
    """dK, dV of the plain backward run over `splits` contiguous ranges of
    the query heads (as the kernel's blocks split them), summed in f32."""
    dk = torch.zeros(k.shape, dtype=torch.float32)
    dv = torch.zeros(v.shape, dtype=torch.float32)
    for z in range(splits):
        lo, hi = z * H // splits, (z + 1) * H // splits
        part = fa.flash_attention_backward_reference(
            q[:, :, lo:hi], k, v, s, s, out[:, :, lo:hi], lse[:, lo:hi], do[:, :, lo:hi],
            **kw, alibi_slopes=None if slopes is None else slopes[lo:hi])
        dk += part[1].float()
        dv += part[2].float()
    return dk, dv


@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("splits", [2, 4, 8])
def test_split_backward_sums_to_the_whole(splits, causal, alibi):
    q, k, v, seg, g = _mqa_inputs(seed=splits + 10 * causal + 100 * alibi)
    slopes = alibi_slopes(H) if alibi else None
    kw = dict(causal=causal, sm_scale=D ** -0.5)
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    s = torch.from_numpy(seg)
    out, lse = fa.flash_attention_reference(qt, kt, vt, s, s, **kw, alibi_slopes=slopes)
    _, dk_all, dv_all = fa.flash_attention_backward_reference(qt, kt, vt, s, s, out, lse, gt,
                                                              **kw, alibi_slopes=slopes)
    dk, dv = _split_dkv(qt, kt, vt, s, out, lse, gt, splits, kw, slopes)
    np.testing.assert_allclose(dk.numpy(), dk_all.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dv.numpy(), dv_all.numpy(), atol=1e-5, rtol=0)

    seg_j = jnp.asarray(seg)

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, q_segment_ids=seg_j, kv_segment_ids=seg_j,
                         alibi_nheads=H if alibi else 0, block_q=128, block_k=128)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    _, want_dk, want_dv = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), atol=5e-4, rtol=1e-3)
    pad = seg == 0
    assert np.abs(dk.numpy()[pad]).max() == 0.0 and np.abs(dv.numpy()[pad]).max() == 0.0
