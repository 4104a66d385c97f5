"""The int4 weight-only matmul's two row regimes and its split of K, on the CPU.

``ops/quant_matmul.int4_plan`` picks the CUDA kernel (``csrc/quant_matmul.cu``)
from the row count and plans how many chunks of K each output tile is cut
into, as ``int8_plan`` does for int8: the decode regime (R <= ``INT4_CUT``,
``int4_stream_kernel``) streams 128-column strips of the packed weight in
tiles of 64 packed rows (128 k rows); the prefill regime
(``int4_wgmma_kernel``) takes 128-row x 256-column tiles in 64-row k steps.
Both unpack each 16-row slab of packed bytes as two k16 steps (the low
nibbles are rows 0-15 of the 32-row block, the high ones rows 16-31), make
each weight ``f32(nibble) * scale`` rounded once to x's dtype (bf16 on the
card), sum in f32 tile after tile, and sum the chunks' partials in chunk
order. The plan is checked on the shapes the port runs; the arithmetic is
written out here in torch and held against ``matmul_int4_reference`` (f32 x,
whose weights are then f32 too; atol 1e-5: only the order of the sums
differs) and against the plain version's bf16 weights summed in f32 (bf16
x), and against the JAX package's Pallas ``matmul_int4`` in interpret mode
(``rtol=1e-5, atol=1e-4``, as ``tests/test_torch_quant.py``), on f32 and bf16
x: the Pallas kernel rounds each weight to x's dtype and sums in f32, as the
CUDA kernels do.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llava_plus_tpu.ops import quant_matmul as jqm
from llava_plus_torch.ops import quant
from llava_plus_torch.ops.quant_matmul import (
    INT4_BLOCK, INT4_CUT, INT4_STREAM_K, MIN_CHUNK_STEPS, STREAM_COLS, STREAM_MAX_SPLITS,
    STREAM_MIN_BLOCKS_PER_SM, WGMMA_COLS, WGMMA_K, WGMMA_ROWS, dequantize, int4_plan,
    matmul_int4_reference,
)

torch.set_num_threads(1)
H100_SMS = 132

# (K, N): LLaVA-1.5-7B's fused wqkv, wo, w_gate_up, w_down and lm_head;
# LLaVA-MPT-7B's out_proj, up_proj, down_proj and tied head (50432);
# LLaVA-1.5-13B's fused wqkv, wo, w_gate_up, w_down and lm_head
SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
          (4096, 16384), (16384, 4096), (4096, 50432),
          (5120, 15360), (5120, 5120), (5120, 27648), (13824, 5120), (5120, 32000)]
# one decode row, 16 slots, the cut and one past it, 64, 768 per image
# prompt, the engine's 4-prompt batch, QLoRA's 4 x 2048
ROWS = [1, 16, INT4_CUT, INT4_CUT + 1, 64, 768, 3072, 8192]


def chunks(tiles, splits):
    """The K chunks as the kernels cut them: ceil(tiles / splits) tiles each."""
    per = -(-tiles // splits)
    return [range(c * per, min(tiles, (c + 1) * per)) for c in range(splits)]


def test_the_cut_fits_the_decode_kernel():
    # the decode kernel holds at most 48 x rows (6 n8 tiles)
    assert 1 <= INT4_CUT <= 48


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("K,N", SHAPES)
def test_plan_covers_k_once_and_fills_the_card(K, N, R):
    regime, splits, whole = int4_plan(R, K, N, H100_SMS)
    assert regime == ("stream" if R <= INT4_CUT else "wgmma")
    tiles = K // (INT4_STREAM_K if regime == "stream" else WGMMA_K)
    assert 1 <= splits <= tiles
    parts = chunks(tiles, splits)
    assert [t for p in parts for t in p] == list(range(tiles))   # every k tile once
    assert all(len(p) for p in parts)                              # none empty
    if regime == "stream":
        strips = -(-N // STREAM_COLS)
        blocks = strips * splits
        # every SM has its blocks (at least 1.5 on average), and the busiest
        # SM's share of the weight is within 10% of an even share
        assert splits <= STREAM_MAX_SPLITS and whole == 0
        assert blocks >= STREAM_MIN_BLOCKS_PER_SM * H100_SMS
        busiest = -(-blocks // H100_SMS) / splits
        assert busiest <= 1.1 * strips / H100_SMS or splits == 1
    else:
        out_tiles = -(-N // WGMMA_COLS) * -(-R // WGMMA_ROWS)
        tail = out_tiles - whole
        if splits > 1:
            # whole waves of tiles over all of K; the tiles of the last,
            # partial wave (or every tile) cut into chunks of at least
            # MIN_CHUNK_STEPS k steps that fit in one wave
            assert whole % H100_SMS == 0 and 0 < tail * splits <= H100_SMS
            assert min(len(p) for p in parts) >= MIN_CHUNK_STEPS
        else:
            # no cut: the last wave is at least half full, or K too short
            assert whole == out_tiles
            rem = out_tiles % H100_SMS
            assert rem == 0 or 2 * rem > H100_SMS or tiles < 2 * MIN_CHUNK_STEPS


def test_plan_depends_on_shapes_alone():
    assert int4_plan(16, 4096, 12288, H100_SMS) == ("stream", 4, 0)
    assert int4_plan(1, 4096, 12288, H100_SMS) == ("stream", 4, 0)
    assert int4_plan(16, 11008, 4096, H100_SMS) == ("stream", 8, 0)
    assert int4_plan(1, 4096, 32000, H100_SMS) == ("stream", 1, 0)
    assert int4_plan(768, 4096, 12288, H100_SMS) == ("wgmma", 5, 264)
    assert int4_plan(3072, 4096, 12288, H100_SMS) == ("wgmma", 1, 1152)
    assert int4_plan(8192, 11008, 4096, H100_SMS) == ("wgmma", 1, 1024)
    assert int4_plan(16, 4096, 12288, 66) == ("stream", 2, 0)


def split_k(x, qw, scale, regime, splits):
    """The kernels' arithmetic: per K chunk, tile after tile, each 32-row
    block of the tile's packed rows unpacked (low nibbles: block rows 0-15,
    high nibbles: 16-31, two's complement), times the block's scales in f32
    and rounded once to x's dtype, the product with x's columns summed in
    f32 into the chunk's partial; the partials summed in chunk order."""
    R, K = x.shape
    N = qw.shape[1]
    step = INT4_STREAM_K if regime == "stream" else WGMMA_K
    xf = x.float()
    p = qw.to(torch.int32)
    total = None
    for part in chunks(K // step, splits):
        acc = torch.zeros(R, N)
        for kt in part:
            for k0 in range(kt * step, (kt + 1) * step, INT4_BLOCK):
                slab = p[k0 // 2:k0 // 2 + INT4_BLOCK // 2]          # 16 packed rows
                lo = ((slab & 0xF) ^ 8) - 8
                hi = (((slab >> 4) & 0xF) ^ 8) - 8
                s = scale[k0 // INT4_BLOCK].float()
                for half, nib in ((0, lo), (1, hi)):
                    w = (nib.float() * s).to(x.dtype).float()
                    ks = slice(k0 + 16 * half, k0 + 16 * half + 16)
                    acc = acc + xf[:, ks] @ w
        total = acc if total is None else total + acc
    return total


def _inputs(R, K, N, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * rng.uniform(0.005, 0.03, size=(1, N))).astype(np.float32)
    q = quant.quantize_array_int4(torch.from_numpy(w))
    return torch.from_numpy(x).to(dtype), q[quant.Q4KEY], q[quant.SKEY]


# (R, K, N, splits): the decode regime at one row, a ragged row count, 16
# slots and the cut, with a chunk that would start past K (4 tiles in 3
# chunks of 2); the prefill regime past the cut, at a ragged edge and at
# QLoRA's row shape cut down
SPLIT_CASES = {
    "decode_r1": (1, 512, 256, 2),
    "decode_r5_three_chunks": (5, 512, 128, 3),
    "decode_r16": (16, 1024, 384, 5),
    "decode_cut": (INT4_CUT, 512, 256, 1),
    "prefill_past_cut": (INT4_CUT + 1, 512, 256, 3),
    "prefill_ragged": (130, 640, 384, 2),
    "prefill_rows": (300, 256, 192, 1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_k_matches_the_reference(case, dtype):
    R, K, N, splits = SPLIT_CASES[case]
    x, qw, scale = _inputs(R, K, N, seed=len(case), dtype=dtype)
    regime = "stream" if R <= INT4_CUT else "wgmma"
    got = split_k(x, qw, scale, regime, splits)
    if dtype == torch.float32:
        want = matmul_int4_reference(x, qw, scale)
    else:
        # the plain version's weights (rounded to bf16), summed in f32
        want = x.float() @ dequantize(4, qw, scale, torch.bfloat16).float()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["decode_r1", "decode_r16", "prefill_past_cut",
                                  "prefill_ragged"])
def test_split_k_matches_the_pallas_kernel(case, dtype):
    """Run as ``tests/test_quant.py`` runs the Pallas kernel (interpret mode,
    128-blocks): it scales and rounds each weight to x's dtype and sums in
    f32."""
    R, K, N, splits = SPLIT_CASES[case]
    x, qw, scale = _inputs(R, K, N, seed=3, dtype=dtype)
    regime = "stream" if R <= INT4_CUT else "wgmma"
    got = split_k(x, qw, scale, regime, splits)
    xj = jnp.asarray(x.float().numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    want = jqm.matmul_int4(xj, jnp.asarray(qw.numpy()), jnp.asarray(scale.numpy()),
                           block_k=128, block_n=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
