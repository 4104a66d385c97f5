"""The native-int4 matmul's two row regimes and its split of K, on the CPU.

``ops/quant_matmul.int4n_plan`` picks the CUDA kernel (``csrc/quant_matmul.cu``)
for the native layout (``qw4n [K, N/2] uint8``, columns 2c and 2c + 1 of a
row in one byte) as ``int4_plan`` does for the split-half one: the decode
regime (R <= ``INT4N_CUT``, ``int4n_stream_kernel``) streams 128-column
strips in tiles of 128 k rows (128 rows of 64 bytes); the prefill regime
(``int4n_wgmma_kernel``) takes 128-row x 256-column tiles in 64-row k steps,
a warpgroup's 128 columns a box of 64-byte rows. Both read the bytes as
stored. The plan is checked at the int4 tools' five shapes, at every row
``chip_smoke.py`` phase 3 gives them and at a shape whose N is not a
multiple of 128.

The kernels' arithmetic is written out here in torch, down to each lane's
registers: TMA's 64-byte swizzle of a tile of 64-byte rows; per 32-row slab
and warp one ldmatrix.x4.trans (lane l points at row 32 sl + l of the warp's
16-byte column), which hands each thread two bytes (four columns) of rows k
and k + 1 in one register; each nibble ``(bits ^ 8) - 8`` times its block
scale in f32, rounded once to x's dtype (bf16 on the card); the mma A
fragments of two m16 tiles, whose rows are the warp's columns permuted
(m-tile j's row g is column 4 g + 2 j, row g + 8 the next column); the k16
steps summed in f32, the permutation undone at the store, and the K chunks'
partials summed in chunk order. It is held against
``matmul_int4_native_reference`` (f32 x, whose weights are then f32 too;
atol 1e-5: only the order of the sums differs) and against the plain
version's bf16 weights summed in f32 (bf16 x), and against the JAX int4
tool's Pallas ``matmul_int4_native`` in interpret mode, loaded as
``tests/test_torch_int4_native.py`` loads it, with ``block_k`` dividing K
(``rtol=1e-5, atol=1e-4``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from llava_plus_torch.ops import quant
from llava_plus_torch.ops.quant_matmul import (
    INT4_BLOCK, INT4_STREAM_K, INT4N_CUT, STREAM_COLS, STREAM_MAX_SPLITS,
    STREAM_MIN_BLOCKS_PER_SM, WGMMA_COLS, WGMMA_K, WGMMA_ROWS, dequantize_int4_native, int4_plan,
    int4n_plan, matmul_int4_native_reference,
)

torch.set_num_threads(1)
H100_SMS = 132
ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("jax_bench_int4_variants",
                                               ROOT / "tools" / "bench_int4_variants.py")
jax_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_tool)

# (K, N): the int4 tools' five shapes (LLaVA-1.5-7B's q/o, gate/up, down;
# LLaVA-1.5-13B's gate/up, down) and chip_smoke's edge shape (N % 128 == 64)
SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (5120, 13824), (13824, 5120),
          (1152, 4160)]
# phase 3's rows: one decode row, 16, both sides of the cut, 64, a 768-token
# prefill, the engine's 4-prompt batch
ROWS = [1, 16, INT4N_CUT, INT4N_CUT + 1, 64, 768, 3072]
BOX = 128   # columns of a decode strip and of a warpgroup's prefill box


def chunks(tiles, splits):
    """The K chunks as the kernels cut them: ceil(tiles / splits) tiles each."""
    per = -(-tiles // splits)
    return [range(c * per, min(tiles, (c + 1) * per)) for c in range(splits)]


def test_the_cut_fits_the_decode_kernel():
    # the decode kernel holds at most 48 x rows (6 n8 tiles)
    assert 1 <= INT4N_CUT <= 48


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("K,N", SHAPES)
def test_plan_covers_k_once_and_fills_the_card(K, N, R):
    regime, splits, whole = int4n_plan(R, K, N, H100_SMS)
    assert regime == ("stream" if R <= INT4N_CUT else "wgmma")
    tiles = K // (INT4_STREAM_K if regime == "stream" else WGMMA_K)
    assert 1 <= splits <= tiles
    parts = chunks(tiles, splits)
    assert [t for p in parts for t in p] == list(range(tiles))   # every k tile once
    assert all(len(p) for p in parts)                              # none empty
    if regime == "stream":
        blocks = -(-N // STREAM_COLS) * splits
        assert splits <= STREAM_MAX_SPLITS and whole == 0
        assert blocks >= STREAM_MIN_BLOCKS_PER_SM * H100_SMS
    else:
        out_tiles = -(-N // WGMMA_COLS) * -(-R // WGMMA_ROWS)
        assert whole == out_tiles or (whole % H100_SMS == 0
                                      and 0 < (out_tiles - whole) * splits <= H100_SMS)
    # shapes alone decide: the same plan on every call, and the split-half
    # layout's (the same tiles) wherever both regimes agree
    assert int4n_plan(R, K, N, H100_SMS) == (regime, splits, whole)
    if (R <= INT4N_CUT) == (R <= 48):
        assert int4_plan(R, K, N, H100_SMS) == (regime, splits, whole)


def test_plan_depends_on_shapes_alone():
    assert int4n_plan(16, 4096, 4096, H100_SMS) == ("stream", 8, 0)
    assert int4n_plan(1, 11008, 4096, H100_SMS) == ("stream", 8, 0)     # 86 tiles: 11 a chunk, 9
    assert int4n_plan(16, 5120, 13824, H100_SMS) == ("stream", 6, 0)
    assert int4n_plan(16, 1152, 4160, H100_SMS) == ("stream", 9, 0)     # 33 strips, one half
    assert int4n_plan(64, 4096, 4096, H100_SMS) == ("wgmma", 8, 0)      # 16 tiles, all cut
    assert int4n_plan(768, 4096, 4096, H100_SMS) == ("wgmma", 1, 96)    # 96 tiles, one wave
    assert int4n_plan(768, 4096, 11008, H100_SMS) == ("wgmma", 1, 258)
    assert int4n_plan(3072, 13824, 5120, H100_SMS) == ("wgmma", 1, 480)
    assert int4n_plan(16, 4096, 4096, 66) == ("stream", 4, 0)


# -- the kernels' arithmetic, lane by lane ----------------------------------

def tma_image(rows):
    """The shared-memory bytes of a tile of 64-byte rows as TMA writes it with
    the 64-byte swizzle: 16-byte chunk c of row r lands at chunk c ^ ((r >> 1)
    & 3) (address bits 4-5 XOR-ed with bits 7-8)."""
    n = rows.shape[0]
    r = torch.arange(n)[:, None]
    img = torch.empty(n, 4, 16, dtype=torch.uint8)
    img[r, torch.arange(4)[None, :] ^ ((r >> 1) & 3)] = rows.reshape(n, 4, 16)
    return img.reshape(-1)


def ldmatrix_x4_trans(img, w, sl):
    """The four registers of every lane, as bytes [lane, matrix, 4]: lane l
    gives the address of row 32 sl + l of the warp's 16-byte column w
    (swizzled as the kernel computes it); matrix m is the rows of lanes 8 m
    .. 8 m + 7, and thread (g, t) gets element g (bytes 2 g, 2 g + 1) of its
    rows 2 t (the low half) and 2 t + 1."""
    lane = torch.arange(32)
    row = 32 * sl + lane
    addr = row * 64 + (((w ^ (row >> 1)) & 3) << 4)
    mats = img[addr[:, None] + torch.arange(16)].reshape(4, 8, 16)
    g, t = lane // 4, lane % 4
    rr = 2 * t[:, None, None] + torch.tensor([0, 0, 1, 1])
    bb = 2 * g[:, None, None] + torch.tensor([0, 1, 0, 1])
    return mats[torch.arange(4)[None, :, None], rr, bb]


def native_pairs(reg, s, dtype):
    """csrc native_pairs for every lane: reg [32, 4] bytes (row k's two, row k
    + 1's two), s [32, 4] the four columns' scales -> [32, 4 columns, 2 rows]:
    the nibble ``(bits ^ 8) - 8`` of u = the low (even column) or high nibbles,
    times the scale in f32, rounded to ``dtype``."""
    reg = reg.to(torch.int32)
    u = [(reg & 0xF) ^ 8, ((reg >> 4) & 0xF) ^ 8]
    cols = []
    for q in range(4):
        f0 = (u[q & 1][:, q >> 1] - 8).float()
        f1 = (u[q & 1][:, 2 + (q >> 1)] - 8).float()
        cols.append(torch.stack([f0 * s[:, q], f1 * s[:, q]], dim=-1))
    return torch.stack(cols, dim=1).to(dtype).float()


def a_matrices(r01, r89, s, dtype):
    """The A operands of m-tiles 0 and 1 for one k16 step ([2, 16 m-rows, 16
    k]) from the lanes' registers, by mma's fragment layout: a0 = (row g, k
    2t, 2t + 1), a1 = (row g + 8, ..), a2 = (row g, k 2t + 8, ..), a3 = (row
    g + 8, ..), with a[j] = (p01[2 j], p01[2 j + 1], p89[2 j], p89[2 j + 1])."""
    p01, p89 = native_pairs(r01, s, dtype), native_pairs(r89, s, dtype)
    A = torch.zeros(2, 16, 16)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for j in range(2):
        for reg, (p, q, dr, dk) in enumerate(((p01, 2 * j, 0, 0), (p01, 2 * j + 1, 8, 0),
                                               (p89, 2 * j, 0, 8), (p89, 2 * j + 1, 8, 8))):
            for half in range(2):
                A[j, g + dr, 2 * t + dk + half] = p[:, q, half]
    return A


def tile_product(xf, qw4n, scale, c0, k_rows, step, dtype):
    """One 128-column tile (a decode strip, or a warpgroup's box) over the k
    rows ``k_rows`` of its chunk, as its four warps compute it: stage after
    stage of ``step`` rows (TMA's image of the stage's bytes, zero past N),
    slab after slab, k16 step after k16 step, the f32 sums [R, 128] of the
    tile's columns stored through the inverse of the warps' column
    permutation."""
    R = xf.shape[0]
    N = scale.shape[1]
    acc = torch.zeros(4, 2, 16, R)                      # warp, m-tile, m-row, x row
    g = torch.arange(32) // 4
    cols_in = max(0, min(BOX, N - c0))
    for k0 in range(k_rows.start, k_rows.stop, step):
        rows = torch.zeros(step, 64, dtype=torch.uint8)
        rows[:, :cols_in // 2] = qw4n[k0:k0 + step, c0 // 2:c0 // 2 + cols_in // 2]
        img = tma_image(rows)
        for sl in range(step // 32):
            srow = torch.zeros(BOX)
            srow[:cols_in] = scale[(k0 + 32 * sl) // INT4_BLOCK, c0:c0 + cols_in]
            for w in range(4):
                regs = ldmatrix_x4_trans(img, w, sl)
                s = srow[32 * w + 4 * g[:, None] + torch.arange(4)]
                for h in range(2):
                    A = a_matrices(regs[:, 2 * h], regs[:, 2 * h + 1], s, dtype)
                    ks = k0 + 32 * sl + 16 * h
                    acc[w] += A @ xf[:, ks:ks + 16].T
    out = torch.zeros(R, BOX)
    g8 = torch.arange(8)
    for w in range(4):
        for j in range(2):
            for hh in range(2):
                out[:, 32 * w + 4 * g8 + 2 * j + hh] = acc[w, j, 8 * hh:8 * hh + 8].T
    return out


def native_kernels(x, qw4n, scale, regime, splits):
    """The regime's kernel: per K chunk (whole stages: 128 k rows decode, 64
    prefill), every 128-column tile's sums; the chunks' partials summed in
    chunk order."""
    R, K = x.shape
    N = scale.shape[1]
    step = INT4_STREAM_K if regime == "stream" else WGMMA_K
    xf = x.float()
    total = None
    for part in chunks(K // step, splits):
        k_rows = range(part.start * step, part.stop * step)
        acc = torch.cat([tile_product(xf, qw4n, scale, c0, k_rows, step, x.dtype)
                         for c0 in range(0, N, BOX)], dim=1)[:, :N]
        total = acc if total is None else total + acc
    return total


def _inputs(R, K, N, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * rng.uniform(0.005, 0.03, size=(1, N))).astype(np.float32)
    q, s = quant.quantize_array_int4_native(torch.from_numpy(w))
    return torch.from_numpy(x).to(dtype), q, s


def test_tma_image_and_ldmatrix_give_each_lane_its_bytes():
    """Lane (g, t) of warp w gets bytes 2 g, 2 g + 1 of the warp's 16-byte
    column at rows 2 t, 2 t + 1 of each 8-row matrix, wherever the swizzle
    put them."""
    rows = torch.arange(128 * 64, dtype=torch.int64).remainder(251).to(torch.uint8).reshape(128, 64)
    img = tma_image(rows)
    for w, sl in ((0, 0), (3, 1), (2, 3)):
        regs = ldmatrix_x4_trans(img, w, sl)
        for lane in (0, 5, 31):
            g, t = lane // 4, lane % 4
            for m in range(4):
                r = 32 * sl + 8 * m + 2 * t
                want = [rows[r, 16 * w + 2 * g], rows[r, 16 * w + 2 * g + 1],
                        rows[r + 1, 16 * w + 2 * g], rows[r + 1, 16 * w + 2 * g + 1]]
                assert regs[lane, m].tolist() == [int(v) for v in want]


# (R, K, N, splits): the decode regime at one row, a ragged row count in
# three chunks with a chunk past K (4 tiles in 3 chunks of 2), 16 slots in
# unequal chunks, the cut with a half strip (N % 128 == 64); the prefill
# regime past the cut, with a half box, and at a ragged row count
SPLIT_CASES = {
    "decode_r1": (1, 512, 256, 2),
    "decode_r5_three_chunks": (5, 512, 128, 3),
    "decode_r16_unequal": (16, 640, 384, 2),
    "decode_cut_half_strip": (INT4N_CUT, 256, 192, 1),
    "prefill_past_cut": (INT4N_CUT + 1, 512, 256, 3),
    "prefill_half_box": (70, 384, 320, 2),
    "prefill_rows": (130, 256, 128, 1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_kernels_match_the_reference(case, dtype):
    R, K, N, splits = SPLIT_CASES[case]
    x, qw4n, scale = _inputs(R, K, N, seed=len(case), dtype=dtype)
    regime = "stream" if R <= INT4N_CUT else "wgmma"
    got = native_kernels(x, qw4n, scale, regime, splits)
    if dtype == torch.float32:
        want = matmul_int4_native_reference(x, qw4n, scale)
    else:
        # the plain version's weights (rounded to bf16), summed in f32
        want = x.float() @ dequantize_int4_native(qw4n, scale, torch.bfloat16).float()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["decode_r1", "decode_r16_unequal", "prefill_past_cut",
                                  "prefill_rows"])
def test_kernels_match_the_pallas_tool(case, dtype):
    """The JAX tool's ``_int4n_kernel`` in interpret mode with a ``block_k``
    that divides K (so it sums all of K, as the port does) and a ``block_n``
    that divides N: it scales each value in f32, rounds it to x's dtype and
    sums in f32."""
    R, K, N, splits = SPLIT_CASES[case]
    x, qw4n, scale = _inputs(R, K, N, seed=3, dtype=dtype)
    regime = "stream" if R <= INT4N_CUT else "wgmma"
    got = native_kernels(x, qw4n, scale, regime, splits)
    xj = jnp.asarray(x.float().numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    values = jnp.asarray(quant.unpack_int4_native(qw4n).numpy()).astype(jnp.int4)
    with pltpu.force_tpu_interpret_mode():
        want = jax_tool.matmul_int4_native(xj, values, jnp.asarray(scale.numpy()), block_n=128,
                                           block_k=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
