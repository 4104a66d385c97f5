"""The dense decode kernel's split of the cache, on the CPU.

``ops/decode_attention.decode_splits`` plans how many chunks of whole
64-slot tiles each (batch row, kv head)'s cache is cut into, one block
each; the CUDA kernel (``csrc/decode_attention.cu``) computes a partial
(m, l, acc) per chunk with an online softmax that starts from the finite
mask value, writes the empty partial (m = -inf, l = 0) for a chunk that
starts past the query, and the last block combines the partials in chunk
order. The plan is checked on the shapes the port runs; the arithmetic is
written out here in torch and held against ``decode_attention_reference``
(atol 1e-5: only the order of the sums differs) and against the JAX
package's Pallas ``decode_attention`` in interpret mode (atol 1e-5, rtol
1e-4, as ``tests/test_torch_attention.py``).
"""

import numpy as np
import pytest
import torch

from llava_plus_tpu.ops import decode_attention as jax_decode
from llava_plus_torch.ops.attention import DEFAULT_MASK_VALUE
from llava_plus_torch.ops.decode_attention import (
    BLOCKS_PER_SM, DECODE_TILE, MAX_SPLITS, decode_attention_reference, decode_splits,
    row_groups,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)
H100_SMS = 132

# (B, Hkv, G, S): LLaVA-1.5-7B (MHA, 32 kv heads) at batch 1 and 16 slots,
# LLaVA-MPT-7B's MQA variant (32 query heads over one), LLaVA-1.5-13B (MHA,
# 40 kv heads) at batch 1 and its engines' 8 and 16 slots, the narrow GQA
# LLaMA of the tests and chip_smoke
PLAN_CASES = [(1, 32, 1, 1024), (1, 32, 1, 2048), (16, 32, 1, 1024), (16, 32, 1, 2048),
              (1, 1, 32, 2048), (16, 1, 32, 1024), (16, 1, 32, 2048), (1, 40, 1, 2048),
              (8, 40, 1, 2048), (16, 40, 1, 2048),
              (4, 2, 2, 512), (2, 1, 40, 300), (1, 1, 80, 4096)]


@pytest.mark.parametrize("B,Hkv,G,S", PLAN_CASES)
def test_plan_fills_the_card_and_covers_the_cache(B, Hkv, G, S):
    splits = decode_splits(B, Hkv, G, S, H100_SMS)
    tiles = -(-S // DECODE_TILE)
    assert 1 <= splits <= min(tiles, MAX_SPLITS)
    per = -(-tiles // splits)
    # the chunks (as the kernel cuts them) cover every tile once, none empty
    covered = [t for c in range(splits) for t in range(c * per, min(tiles, (c + 1) * per))]
    assert covered == list(range(tiles))
    blocks = B * Hkv * row_groups(G)
    if blocks >= BLOCKS_PER_SM * H100_SMS:
        assert splits == 1
    elif G <= 16:
        # two blocks per SM (MHA at batch 1 and at 16 slots), or a chunk a tile
        assert blocks * splits >= min(2 * H100_SMS, blocks * tiles)
        if G == 1 and S >= 1024:
            assert blocks * splits >= 2 * H100_SMS
    else:
        # a wide group: as many blocks as chunks of two tiles allow
        assert blocks * splits >= min(2 * H100_SMS, blocks * (tiles // 2))
        assert per >= 2 or tiles < 2


def test_plan_depends_on_shapes_alone():
    assert decode_splits(1, 32, 1, 2048, H100_SMS) == 11
    assert decode_splits(16, 32, 1, 1024, H100_SMS) == 1
    assert decode_splits(16, 1, 32, 1024, H100_SMS) == 8
    assert row_groups(32) == 1 and row_groups(64) == 1 and row_groups(65) == 2


def split_combine(q, kc, vc, seg, q_pos, ks, vs, sm_scale, splits, slopes=None):
    """The kernel's arithmetic in f32: per chunk of whole tiles an online
    softmax tile by tile, from the mask value, over the slots up to the
    query (masked slots at the finite mask value), P times the v scale into
    acc; then the partials combined in chunk order, empty chunks skipped."""
    B, _, H, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    G = H // Hkv
    tiles = -(-S // DECODE_TILE)
    per = -(-tiles // splits)
    out = torch.zeros(B, 1, H, D)
    for b in range(B):
        used = min(S, int(q_pos[b]) + 1)
        for kvh in range(Hkv):
            rows = slice(kvh * G, (kvh + 1) * G)
            qg = q[b, 0, rows].float()
            slope = (slopes[rows].float() if slopes is not None else torch.zeros(G))[:, None]
            parts = []
            for c in range(splits):
                s0 = c * per * DECODE_TILE
                s1 = min(min(tiles, (c + 1) * per) * DECODE_TILE, used)
                if s1 <= s0:
                    parts.append((torch.full((G,), -torch.inf), torch.zeros(G), None))
                    continue
                m = torch.full((G,), DEFAULT_MASK_VALUE)
                l = torch.zeros(G)
                acc = torch.zeros(G, D)
                for t0 in range(s0, s1, DECODE_TILE):
                    sl = slice(t0, min(t0 + DECODE_TILE, s1))
                    pos = torch.arange(sl.start, sl.stop, dtype=torch.float32)
                    sc = qg @ kc[b, sl, kvh].float().T
                    if ks is not None:
                        sc = sc * ks[b, sl, kvh, 0]
                    sc = sc * sm_scale - slope * (float(q_pos[b]) - pos)
                    sc = torch.where(seg[b, sl] != 0, sc, DEFAULT_MASK_VALUE)
                    mx = torch.maximum(m, sc.amax(1))
                    alpha = torch.exp(m - mx)
                    p = torch.exp(sc - mx[:, None])
                    l = l * alpha + p.sum(1)
                    if vs is not None:
                        p = p * vs[b, sl, kvh, 0]
                    acc = acc * alpha[:, None] + p @ vc[b, sl, kvh].float()
                    m = mx
                parts.append((m, l, acc))
            M = torch.stack([pm for pm, _, _ in parts]).amax(0)
            L = torch.zeros(G)
            O = torch.zeros(G, D)
            for pm, pl, pacc in parts:
                if pacc is None:
                    continue
                f = torch.exp(pm - M)
                L = L + pl * f
                O = O + pacc * f[:, None]
            out[b, 0, rows] = O / L.clamp_min(1e-9)[:, None]
    return out


def _quant(x):
    s = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) / 127.0
    return np.clip(np.round(x / s), -127, 127).astype(np.int8), s.astype(np.float32)


def _inputs(H, Hkv, S, fills, quantized, masked_row=None, seed=5):
    rng = np.random.default_rng(seed)
    B, D = len(fills), 128
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    seg = np.zeros((B, S), np.int32)
    for i, f in enumerate(fills):
        seg[i, :f] = 0 if i == masked_row else 1
    qpos = np.array(fills, np.int32) - 1
    ks = vs = None
    if quantized:
        (k, ks), (v, vs) = _quant(k), _quant(v)
    return q, k, v, seg, qpos, ks, vs


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# (H, Hkv, S, fills, int8, ALiBi, a row whose visible slots are all segment 0)
SPLIT_CASES = {
    "bf16_mha": (4, 4, 256, [100, 37, 256], False, False, None),
    "gqa": (8, 4, 256, [100, 37, 256], False, False, None),
    "int8": (8, 4, 256, [200, 1, 256], True, False, None),
    "alibi_int8": (4, 4, 200, [130, 1, 200], True, True, None),
    "fill_1_and_all_masked": (4, 2, 256, [1, 90, 256], False, True, 1),
    "wide_group": (16, 1, 320, [300, 5, 64], False, True, 2),
    "int8_mha40": (40, 40, 256, [100, 37, 256], True, False, None),   # 13B's heads
}


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_and_combine_matches_the_reference(case, splits):
    H, Hkv, S, fills, quantized, alibi, masked = SPLIT_CASES[case]
    q, k, v, seg, qpos, ks, vs = map(_t, _inputs(H, Hkv, S, fills, quantized, masked))
    slopes = torch.tensor([2.0 ** -(i + 1) for i in range(H)]) if alibi else None
    splits = min(splits, -(-S // DECODE_TILE))
    scale = 128 ** -0.5
    got = split_combine(q, k, v, seg, qpos, ks, vs, scale, splits, slopes)
    want = decode_attention_reference(q, k, v, seg, qpos, ks, vs, sm_scale=scale,
                                      alibi_slopes=slopes)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


JAX_CASES = {"bf16_gqa": (8, 4, False), "int8_gqa": (8, 4, True), "bf16_mha": (4, 4, False),
             "int8_wide": (16, 1, True), "int8_mha40": (40, 40, True)}


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_split_and_combine_matches_the_jax_kernel(case, splits):
    """Fill 1, a chunk wholly past the query and a full row; the JAX kernel
    reads [B, Hkv, S, D] and attends every slot with seg != 0, which here
    are exactly the slots up to the query."""
    H, Hkv, quantized = JAX_CASES[case]
    S = 256
    q, k, v, seg, qpos, ks, vs = _inputs(H, Hkv, S, [1, 100, S], quantized, seed=3)
    hsd = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))
    if quantized:
        want = jax_decode.decode_attention(q, hsd(k), hsd(v), seg, hsd(ks), hsd(vs),
                                           interpret=True)
    else:
        want = jax_decode.decode_attention(q, hsd(k), hsd(v), seg, interpret=True)
    got = split_combine(*map(_t, (q, k, v, seg, qpos, ks, vs)), 128 ** -0.5, splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
