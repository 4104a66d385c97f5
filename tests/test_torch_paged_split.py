"""The paged decode1 kernel's split of a slot's pages, on the CPU.

``ops/paged_attention.decode1_splits`` plans how many chunks of whole
64-token tiles each (slot, kv head)'s ``maxp * P`` token positions are cut
into, one block each; the CUDA kernel (``csrc/paged_attention.cu``,
``paged_decode1_kernel``) reads each tile's tokens through the page list,
computes a partial (m, l, acc) per chunk with an online softmax that starts
from the finite mask value, writes the empty partial (m = -inf, l = 0) for a
chunk that starts past the slot's length, and the last block of a (slot,
head) combines the partials in chunk order and folds in the current token
as a self block. The plan is checked on the shapes the port runs; the
arithmetic is written out here in torch and held against
``paged_attention_reference`` (atol 1e-5: only the order of the sums
differs) and against the JAX package's ``paged_decode_attention`` as its
own tests run it on the CPU (interpret mode, which routes to its plain
reference; atol 1e-5, rtol 1e-5, as ``tests/test_torch_paged.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llava_plus_tpu.models import mpt as jax_mpt
from llava_plus_tpu.ops import paged_attention as jax_paged
from llava_plus_torch.models.mpt import alibi_slopes
from llava_plus_torch.ops.attention import DEFAULT_MASK_VALUE
from llava_plus_torch.ops.paged_attention import (
    BLOCKS_PER_SM, D1_CHUNK_TILES, D1_MAX_SPLITS, D1_TILE, decode1_splits,
    paged_attention_reference,
)

torch.set_num_threads(1)
H100_SMS = 132

# (B, Hkv, maxp, P): LLaVA-1.5-7B's paged engine (16 slots of up to 4096
# tokens in pages of 128) and chip_smoke's decode1 rows (16 pages a slot, and
# pages of 32), LLaVA-MPT-7B's paged engine, LLaVA-1.5-13B (40 kv heads) at
# one slot and at 8 and 16 slots of 32 pages, and the narrow models of the
# tests
PLAN_CASES = [(16, 32, 32, 128), (16, 32, 16, 128), (16, 32, 64, 32), (1, 32, 16, 128),
              (8, 32, 32, 128), (1, 40, 32, 128), (8, 40, 32, 128), (16, 40, 32, 128),
              (3, 4, 4, 16), (2, 2, 5, 8)]


def chunk_ranges(maxp, P, splits):
    """The token positions of each chunk, as the kernel cuts them."""
    tiles = -(-(maxp * P) // D1_TILE)
    per = -(-tiles // splits)
    return [range(c * per * D1_TILE, min(tiles, (c + 1) * per) * D1_TILE)
            for c in range(splits)]


@pytest.mark.parametrize("B,Hkv,maxp,P", PLAN_CASES)
def test_plan_covers_every_page_once_and_fills_the_card(B, Hkv, maxp, P):
    splits = decode1_splits(B, Hkv, maxp, P, H100_SMS)
    tiles = -(-(maxp * P) // D1_TILE)
    assert 1 <= splits <= min(tiles, D1_MAX_SPLITS)
    ranges = chunk_ranges(maxp, P, splits)
    # every token position of every page in exactly one chunk, none empty
    tokens = [s for r in ranges for s in r]
    assert tokens[:maxp * P] == list(range(maxp * P)) and all(len(r) for r in ranges)
    assert all(s >= maxp * P for s in tokens[maxp * P:])
    per = -(-tiles // splits)
    blocks = B * Hkv * splits
    # chunks of at most D1_CHUNK_TILES tiles, so that a long slot is spread
    # over many SMs; two blocks an SM wherever the pages have the tiles
    assert per <= max(D1_CHUNK_TILES, -(-tiles // D1_MAX_SPLITS))
    assert blocks >= min(BLOCKS_PER_SM * H100_SMS, B * Hkv * tiles)


def test_plan_depends_on_shapes_alone():
    assert decode1_splits(16, 32, 16, 128, H100_SMS) == 4
    assert decode1_splits(16, 32, 32, 128, H100_SMS) == 8
    assert decode1_splits(1, 32, 16, 128, H100_SMS) == 11
    assert decode1_splits(3, 4, 4, 16, H100_SMS) == 1


def split_combine(q, kv, pt, lengths, scale, ck, cv, valid, sm_scale, splits, slopes=None):
    """The kernel's arithmetic in f32: per chunk of whole 64-token tiles an
    online softmax tile by tile, from the mask value, over the slot's tokens
    (each through its page id; the k scale on the scores, the v scale on the
    probabilities), the empty partial for a chunk past the length; then the
    partials combined in chunk order with the current token folded in last
    (a dead slot comes out 0)."""
    B, _, H, D = q.shape
    _, _, P, Hkv, _ = kv.shape
    maxp = pt.shape[1]
    out = torch.zeros(B, 1, H, D)
    for b in range(B):
        n = min(int(lengths[b]), maxp * P)
        qp = int(lengths[b]) if ck is not None else int(lengths[b]) - 1
        for h in range(Hkv):
            qh = q[b, 0, h].float()
            slope = 0.0 if slopes is None else float(slopes[h])
            parts = []
            for r in chunk_ranges(maxp, P, splits):
                s0, s1 = r.start, min(r.stop, n)
                if s1 <= s0:
                    parts.append(None)
                    continue
                m, l, acc = torch.tensor(DEFAULT_MASK_VALUE), torch.tensor(0.0), torch.zeros(D)
                for t0 in range(s0, s1, D1_TILE):
                    pos = torch.arange(t0, min(t0 + D1_TILE, s1))
                    page = pt[b, pos // P].long()
                    off = pos % P
                    k = kv[page, 0, off, h].float()
                    v = kv[page, 1, off, h].float()
                    sc = k @ qh
                    if scale is not None:
                        sc = sc * scale[page, 0, h, off]
                    sc = sc * sm_scale - slope * (qp - pos).float()
                    mx = torch.maximum(m, sc.max())
                    alpha = torch.exp(m - mx)
                    p = torch.exp(sc - mx)
                    l = l * alpha + p.sum()
                    if scale is not None:
                        p = p * scale[page, 1, h, off]
                    acc = acc * alpha + p @ v
                    m = mx
                parts.append((m, l, acc))
            s_self = -torch.inf
            if ck is not None and int(valid[b]) > 0:
                s_self = float(ck[b, 0, h].float() @ qh) * sm_scale
            M = max([s_self] + [float(pm) for pm, _, _ in filter(None, parts)])
            if M == -torch.inf:
                continue
            L, O = torch.tensor(0.0), torch.zeros(D)
            for part in parts:
                if part is not None:
                    f = torch.exp(part[0] - M)
                    L, O = L + part[1] * f, O + part[2] * f
            if s_self != -torch.inf:
                ps = torch.exp(torch.tensor(s_self - M))
                L, O = L + ps, O + ps * cv[b, 0, h].float()
            out[b, 0, h] = O / L.clamp_min(1e-9)
    return out


def _inputs(B, H, P, maxp, lengths, quantized, seed, valid=None):
    rng = np.random.default_rng(seed)
    D = 128
    NP = B * maxp + 2
    pt = rng.permutation(NP)[:B * maxp].reshape(B, maxp).astype(np.int32)
    kv = rng.normal(size=(NP, 2, P, H, D)).astype(np.float32)
    scale = None
    if quantized:
        s = np.maximum(np.abs(kv).max(-1), 1e-8) / 127.0
        kv = np.clip(np.round(kv / s[..., None]), -127, 127).astype(np.int8)
        scale = np.ascontiguousarray(s.transpose(0, 1, 3, 2)).astype(np.float32)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    ck = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    cv = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    valid = np.ones(B, np.int32) if valid is None else np.asarray(valid, np.int32)
    return q, kv, pt, np.asarray(lengths, np.int32), scale, ck, cv, valid


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


# (H, P, maxp, lengths, int8, ALiBi, current token, valid): a full slot, a
# 1-token slot and chunks past the length; pages smaller than a tile (P = 16,
# 8) and pages of 32; a dead slot (length 0, no valid current token)
SPLIT_CASES = {
    "bf16_full_and_one": (4, 32, 8, [256, 1, 100], False, False, True, None),
    "int8": (4, 32, 8, [200, 37, 256], True, False, True, None),
    "int8_alibi": (4, 64, 4, [130, 256, 3], True, True, True, None),
    "small_pages": (2, 16, 12, [190, 17, 64], True, False, True, None),
    "pages_of_8_no_current": (2, 8, 20, [160, 9, 77], False, True, False, None),
    "dead_slot": (4, 32, 6, [150, 0, 192], True, True, True, [1, 0, 1]),
    "int8_mha40": (40, 32, 8, [200, 37, 256], True, False, True, None),   # 13B's heads
}


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_and_combine_matches_the_reference(case, splits):
    H, P, maxp, lengths, quantized, alibi, cur, valid = SPLIT_CASES[case]
    q, kv, pt, lens, scale, ck, cv, val = map(_t, _inputs(3, H, P, maxp, lengths, quantized,
                                                          seed=len(case), valid=valid))
    if not cur:
        ck = cv = val = None
    slopes = alibi_slopes(H, 8) if alibi else None
    sm = 128 ** -0.5
    splits = min(splits, -(-(maxp * P) // D1_TILE))
    got = split_combine(q, kv, pt, lens, scale, ck, cv, val, sm, splits, slopes)
    want = paged_attention_reference(q, kv, pt, lens, scale, ck, cv, val, sm_scale=sm,
                                     alibi_slopes=slopes)
    live = [b for b in range(3) if lengths[b] > 0 or (valid or [1] * 3)[b] > 0]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[live], want[live], atol=1e-5, rtol=0)


@pytest.mark.parametrize("splits", [2, 3])
@pytest.mark.parametrize("case", ["int8", "int8_alibi", "small_pages", "dead_slot",
                                  "int8_mha40"])
def test_split_and_combine_matches_the_jax_kernel(case, splits):
    H, P, maxp, lengths, quantized, alibi, cur, valid = SPLIT_CASES[case]
    arrays = _inputs(3, H, P, maxp, lengths, quantized, seed=7, valid=valid)
    q, kv, pt, lens, scale, ck, cv, val = arrays
    j = lambda a: None if a is None else jnp.asarray(a)
    want = jax_paged.paged_decode_attention(
        j(q), j(kv), j(pt), j(lens), j(scale), cur_k=j(ck), cur_v=j(cv), cur_valid=j(val),
        alibi_slopes=jax_mpt.alibi_slopes(H) if alibi else None, interpret=True)
    slopes = alibi_slopes(H, 8) if alibi else None
    got = split_combine(*map(_t, arrays), 128 ** -0.5, splits, slopes)
    live = [b for b in range(3) if lengths[b] > 0 or (valid or [1] * 3)[b] > 0]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], atol=1e-5, rtol=1e-5)
