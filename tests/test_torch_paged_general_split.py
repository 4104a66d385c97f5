"""The general paged kernel's rows, split and combine, on the CPU.

The general kernel (``csrc/paged_attention.cu``, ``paged_general_kernel``)
runs every paged attention call with ``G * Tq > 1`` (GQA and MQA decode,
chunks of 2-8 tokens). It puts the ``G * Tq`` query rows of a kv head (row
``c = g * Tq + t`` is head ``kvh * G + g`` at chunk token ``t``) in
``ops/paged_attention.general_groups`` groups of 8, each group the columns
of the n8 tile of the kernel's products, one block per (chunk, slot x kv head x group); ``general_splits`` plans the
chunks of whole 64-token tiles each slot's ``maxp * P`` token positions are
cut into. Each chunk computes a partial (m, l, acc) per row with an online
softmax that starts from the finite mask value; a chunk that starts past the
slot's length takes no part (its block exits at once; a slot without pool
tokens has chunk 0's empty partial, m = -inf and l = 0); one more block
makes the current chunk's causal self block, up to ``cur_valid``, a partial
of its own; ALiBi is taken over ``q_pos - kv_pos``; and the last block of a
(slot, head, group) to finish combines the partials in order, the self
block's last. The plan is checked on the shapes the port
runs; the arithmetic is written out here in torch and held against
``paged_attention_reference`` (atol 1e-5: only the order of the sums
differs) and against the JAX package's ``paged_decode_attention`` as its own
tests run it on the CPU (interpret mode, which routes to its plain
reference; atol 1e-5, rtol 1e-5, as ``tests/test_torch_paged.py``), for
GQA, MQA and chunks of 4 and 8 tokens over bf16 pools (values rounded to
bf16, carried in f32) and int8 pools.
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
    BLOCKS_PER_SM, D1_CHUNK_TILES, D1_MAX_SPLITS, D1_TILE, GENERAL_MIN_CHUNK_TILES,
    GENERAL_ROWS, general_groups, general_splits, paged_attention_reference,
)

torch.set_num_threads(1)
H100_SMS = 132


def chunk_ranges(maxp, P, splits):
    """The token positions of each chunk, as the kernel cuts them."""
    tiles = -(-(maxp * P) // D1_TILE)
    per = -(-tiles // splits)
    return [range(c * per * D1_TILE, min(tiles, (c + 1) * per) * D1_TILE)
            for c in range(splits)]


# (G, Tq): GQA decode (LLaVA-style 32 over 8), MQA decode (4 over 1, and
# the wide MQA MPT's 16 over 1), chunks of 4 and 8 tokens at MHA (a 7B
# engine's verify step), GQA chunks, and MQA chunks of 8 (128 rows)
ROW_CASES = [(4, 1), (16, 1), (1, 4), (1, 8), (4, 2), (4, 8), (16, 8), (2, 3)]


@pytest.mark.parametrize("G,Tq", ROW_CASES)
def test_rows_cover_every_query_once(G, Tq):
    rows, groups = GENERAL_ROWS, general_groups(G, Tq)
    assert (groups - 1) * rows < G * Tq <= groups * rows


# (B, Hkv, G, Tq, maxp, P): chip_smoke's general rows (GQA Hkv 8, chunks
# of 4 at Hkv 32, MQA 4 over 1; the 7B-width row of 8-token chunks over
# the paged engine's 32 pages), a 7B paged engine's GQA decode at 32
# pages, the narrow models of the tests, pages smaller than a tile
PLAN_CASES = [(16, 8, 4, 1, 16, 128), (16, 32, 1, 4, 16, 128), (16, 1, 4, 1, 16, 128),
              (16, 32, 1, 8, 32, 128), (16, 8, 4, 1, 32, 128), (1, 1, 16, 1, 16, 128),
              (3, 2, 2, 1, 4, 16), (2, 1, 16, 8, 5, 8)]


@pytest.mark.parametrize("B,Hkv,G,Tq,maxp,P", PLAN_CASES)
def test_plan_covers_every_page_once_and_fills_the_card(B, Hkv, G, Tq, maxp, P):
    groups = general_groups(G, Tq)
    splits = general_splits(B, Hkv, groups, maxp, P, H100_SMS)
    tiles = -(-(maxp * P) // D1_TILE)
    assert 1 <= splits <= min(tiles, D1_MAX_SPLITS)
    ranges = chunk_ranges(maxp, P, splits)
    # every token position of every page in exactly one chunk, none empty
    tokens = [s for r in ranges for s in r]
    assert tokens[:maxp * P] == list(range(maxp * P)) and all(len(r) for r in ranges)
    assert all(s >= maxp * P for s in tokens[maxp * P:])
    per = -(-tiles // splits)
    blocks = B * Hkv * groups * splits
    # chunks of at most D1_CHUNK_TILES tiles, so that a long slot is spread
    # over many SMs, and of at least GENERAL_MIN_CHUNK_TILES where the slot
    # has them; two blocks an SM wherever chunks of that size allow
    assert per <= max(D1_CHUNK_TILES, -(-tiles // D1_MAX_SPLITS))
    assert per >= min(GENERAL_MIN_CHUNK_TILES, tiles)
    pairs = B * Hkv * groups
    assert blocks >= min(BLOCKS_PER_SM * H100_SMS, pairs * -(-tiles // GENERAL_MIN_CHUNK_TILES))


def test_plan_depends_on_shapes_alone():
    # GQA over 16 pages, chunks of 4 tokens (MHA), MQA, the 7B-width row
    assert general_splits(16, 8, 1, 16, 128, H100_SMS) == 4
    assert general_splits(16, 32, 1, 16, 128, H100_SMS) == 4
    assert general_splits(16, 1, 1, 16, 128, H100_SMS) == 8
    assert general_splits(16, 32, 1, 32, 128, H100_SMS) == 8
    assert general_splits(3, 2, 1, 4, 16, H100_SMS) == 1


def general_split_combine(q, kv, pt, lengths, scale, ck, cv, valid, sm_scale, splits,
                          slopes=None):
    """The kernel's arithmetic in f32: for each (slot, kv head, row group),
    per chunk of whole 64-token tiles an online softmax of every row, tile
    by tile, from the mask value, over the slot's tokens (each through its
    page id; the k scale on the scores, the v scale on the probabilities;
    ALiBi at the row's query position, at ``lengths + t`` with a current
    chunk, else at ``lengths - 1``), nothing for a chunk past the length;
    the current chunk's visible tokens as one more partial; then each row's
    partials combined in order, the self block's last (a row that sees
    nothing comes out 0)."""
    B, Tq, H, D = q.shape
    _, _, P, Hkv, _ = kv.shape
    G = H // Hkv
    maxp = pt.shape[1]
    rows, groups = GENERAL_ROWS, general_groups(G, Tq)
    out = torch.zeros(B, Tq, H, D)
    for b in range(B):
        n = min(int(lengths[b]), maxp * P)
        for h in range(Hkv):
            for grp in range(groups):
                cs = torch.arange(grp * rows, min((grp + 1) * rows, G * Tq))
                tq, head = cs % Tq, h * G + cs // Tq
                Q = q[b, tq, head].float()                                  # [rows, D]
                qpos = (int(lengths[b]) + tq) if ck is not None else torch.full_like(
                    tq, int(lengths[b]) - 1)
                sl = torch.zeros(len(cs)) if slopes is None else slopes[head].float()
                parts = []
                for r in chunk_ranges(maxp, P, splits):
                    s0, s1 = r.start, min(r.stop, n)
                    if s1 <= s0:
                        parts.append(None)
                        continue
                    m = torch.full((len(cs),), DEFAULT_MASK_VALUE)
                    l, acc = torch.zeros(len(cs)), torch.zeros(len(cs), D)
                    for t0 in range(s0, s1, D1_TILE):
                        pos = torch.arange(t0, min(t0 + D1_TILE, s1))
                        page = pt[b, pos // P].long()
                        off = pos % P
                        k = kv[page, 0, off, h].float()
                        v = kv[page, 1, off, h].float()
                        sc = Q @ k.T
                        if scale is not None:
                            sc = sc * scale[page, 0, h, off]
                        sc = sc * sm_scale - sl[:, None] * (qpos[:, None] - pos[None]).float()
                        mx = torch.maximum(m, sc.max(dim=1).values)
                        alpha = torch.exp(m - mx)
                        p = torch.exp(sc - mx[:, None])
                        l = l * alpha + p.sum(dim=1)
                        if scale is not None:
                            p = p * scale[page, 1, h, off]
                        acc = acc * alpha[:, None] + p @ v
                        m = mx
                    parts.append((m, l, acc))
                if ck is not None:
                    # the self block's partial: its visible chunk tokens
                    j = torch.arange(Tq)
                    dots = Q @ ck[b, :, h].float().T                          # [rows, Tq]
                    seen = (j[None] <= tq[:, None]) & (j[None] < int(valid[b]))
                    ss = torch.where(seen, dots * sm_scale - sl[:, None]
                                     * (tq[:, None] - j[None]).float(), -torch.inf)
                    ms = ss.max(dim=1).values
                    ps = torch.where(seen, torch.exp(ss - ms[:, None]), 0.0)
                    parts.append((ms, ps.sum(dim=1), ps @ cv[b, :, h].float()))
                M = torch.full((len(cs),), -torch.inf)
                for part in filter(None, parts):
                    M = torch.maximum(M, part[0])
                L, O = torch.zeros(len(cs)), torch.zeros(len(cs), D)
                for part in filter(None, parts):
                    f = torch.where(part[0] > -torch.inf, torch.exp(part[0] - M), 0.0)
                    L, O = L + part[1] * f, O + part[2] * f[:, None]
                out[b, tq, head] = O / L.clamp_min(1e-9)[:, None]
    return out


def _inputs(B, Tq, H, Hkv, P, maxp, lengths, quantized, seed, valid=None):
    rng = np.random.default_rng(seed)
    D = 128
    NP = B * maxp + 2
    pt = rng.permutation(NP)[:B * maxp].reshape(B, maxp).astype(np.int32)
    kv = rng.normal(size=(NP, 2, P, Hkv, D)).astype(np.float32)
    scale = None
    if quantized:
        s = np.maximum(np.abs(kv).max(-1), 1e-8) / 127.0
        kv = np.clip(np.round(kv / s[..., None]), -127, 127).astype(np.int8)
        scale = np.ascontiguousarray(s.transpose(0, 1, 3, 2)).astype(np.float32)
    else:   # a bf16 pool's values, carried in f32
        kv = torch.from_numpy(kv).bfloat16().float().numpy()
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    ck = rng.normal(size=(B, Tq, Hkv, D)).astype(np.float32)
    cv = rng.normal(size=(B, Tq, Hkv, D)).astype(np.float32)
    valid = np.full(B, Tq, np.int32) if valid is None else np.asarray(valid, np.int32)
    return q, kv, pt, np.asarray(lengths, np.int32), scale, ck, cv, valid


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


# (H, Hkv, Tq, P, maxp, lengths, int8, ALiBi, current chunk, valid): GQA
# and MQA decode, chunks of 4 and of 8 tokens (MHA, and GQA whose 16 rows
# take two blocks), each over a bf16 and an int8 pool; a full slot, a
# 1-token slot, chunks past the length, pages smaller than a tile (16, 8), a
# dead slot (no past token, no valid chunk token), valid prefixes, and an
# MQA group of 32 rows (four groups of 8)
SPLIT_CASES = {
    "gqa_bf16": (8, 2, 1, 32, 8, [256, 1, 100], False, False, True, None),
    "gqa_int8_alibi": (8, 2, 1, 32, 8, [200, 37, 256], True, True, True, None),
    "mqa_bf16_no_current": (4, 1, 1, 8, 20, [160, 9, 77], False, True, False, None),
    "mqa_int8_alibi": (4, 1, 1, 16, 12, [190, 17, 64], True, True, True, None),
    "chunk4_bf16": (4, 4, 4, 32, 6, [150, 5, 192], False, False, True, [4, 2, 1]),
    "chunk4_int8_alibi": (4, 4, 4, 64, 4, [130, 256, 3], True, True, True, [3, 4, 1]),
    "chunk8_bf16_gqa_alibi": (4, 2, 8, 32, 6, [60, 100, 191], False, True, True, [8, 5, 8]),
    "chunk8_int8_dead_slot": (4, 4, 8, 32, 6, [100, 0, 180], True, False, True, [8, 0, 3]),
    "wide_group_int8_alibi": (16, 1, 2, 16, 8, [120, 30, 128], True, True, True, [2, 1, 2]),
}


def _case(case, seed):
    H, Hkv, Tq, P, maxp, lengths, quantized, alibi, cur, valid = SPLIT_CASES[case]
    arrays = list(_inputs(3, Tq, H, Hkv, P, maxp, lengths, quantized, seed, valid))
    if not cur:
        arrays[5] = arrays[6] = arrays[7] = None
    live = [b for b in range(3) if lengths[b] > 0 or (valid or [1] * 3)[b] > 0]
    return arrays, H, alibi, live, maxp * P


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_and_combine_matches_the_reference(case, splits):
    arrays, H, alibi, live, positions = _case(case, seed=len(case))
    q, kv, pt, lens, scale, ck, cv, val = map(_t, arrays)
    slopes = alibi_slopes(H, 8) if alibi else None
    sm = 128 ** -0.5
    splits = min(splits, -(-positions // D1_TILE))
    got = general_split_combine(q, kv, pt, lens, scale, ck, cv, val, sm, splits, slopes)
    want = paged_attention_reference(q, kv, pt, lens, scale, ck, cv, val, sm_scale=sm,
                                     alibi_slopes=slopes)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[live], want[live], atol=1e-5, rtol=0)


@pytest.mark.parametrize("splits", [2, 3])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_and_combine_matches_the_jax_kernel(case, splits):
    arrays, H, alibi, live, positions = _case(case, seed=7)
    q, kv, pt, lens, scale, ck, cv, val = arrays
    j = lambda a: None if a is None else jnp.asarray(a)
    want = jax_paged.paged_decode_attention(
        j(q), j(kv), j(pt), j(lens), j(scale), cur_k=j(ck), cur_v=j(cv), cur_valid=j(val),
        alibi_slopes=jax_mpt.alibi_slopes(H) if alibi else None, interpret=True)
    slopes = alibi_slopes(H, 8) if alibi else None
    splits = min(splits, -(-positions // D1_TILE))
    got = general_split_combine(*map(_t, arrays), 128 ** -0.5, splits, slopes)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], atol=1e-5, rtol=1e-5)
