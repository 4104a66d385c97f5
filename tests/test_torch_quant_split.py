"""The int8 weight-only matmul's two row regimes and its split of K, on the CPU.

``ops/quant_matmul.int8_plan`` picks the CUDA kernel (``csrc/quant_matmul.cu``)
from the row count and plans how many chunks of K each output tile is cut
into: the decode regime (R <= ``INT8_CUT``) streams 128-column strips of the
weight in 64-row k tiles, each warp owning 32 columns over every k step of
its chunk; the prefill regime (wgmma) takes 128-row x 256-column tiles in
64-row k steps. Each chunk's f32 partial goes to a workspace and the last
block of a tile sums them in chunk order, then applies the per-channel
scale. The plan is checked on the shapes the port
runs; the arithmetic is written out here in torch and held against
``matmul_int8_reference`` (atol 1e-5: only the order of the sums differs)
and against the JAX package's Pallas ``matmul_int8`` in interpret mode
times the scale (``rtol=1e-5, atol=1e-4``, as ``tests/test_torch_quant.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llava_plus_tpu.ops import quant_matmul as jqm
from llava_plus_torch.ops import quant
from llava_plus_torch.ops.quant_matmul import (
    INT8_CUT, MIN_CHUNK_STEPS, STREAM_COLS, STREAM_K, STREAM_MAX_SPLITS,
    STREAM_MIN_BLOCKS_PER_SM, WGMMA_COLS, WGMMA_K, WGMMA_ROWS, int8_plan,
    matmul_int8_reference,
)

torch.set_num_threads(1)
H100_SMS = 132

# (K, N): LLaVA-1.5-7B's fused wqkv, wo, w_gate_up, w_down and lm_head;
# LLaVA-MPT-7B's out_proj, up_proj, down_proj and tied head (50432);
# LLaVA-1.5-13B's fused wqkv, wo, w_gate_up, w_down and lm_head
SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
          (4096, 16384), (16384, 4096), (4096, 50432),
          (5120, 15360), (5120, 5120), (5120, 27648), (13824, 5120), (5120, 32000)]
# one decode row, 16 slots, the cut and one past it, 768 per image prompt,
# the engine's 4-prompt batch, an 8-bit LoRA step
ROWS = [1, 16, INT8_CUT, INT8_CUT + 1, 64, 768, 3072, 8192]


def chunks(tiles, splits):
    """The K chunks as the kernels cut them: ceil(tiles / splits) tiles each."""
    per = -(-tiles // splits)
    return [range(c * per, min(tiles, (c + 1) * per)) for c in range(splits)]


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("K,N", SHAPES)
def test_plan_covers_k_once_and_fills_the_card(K, N, R):
    regime, splits, whole = int8_plan(R, K, N, H100_SMS)
    assert regime == ("stream" if R <= INT8_CUT else "wgmma")
    tiles = K // (STREAM_K if regime == "stream" else WGMMA_K)
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
    assert int8_plan(16, 4096, 12288, H100_SMS) == ("stream", 4, 0)
    assert int8_plan(1, 4096, 12288, H100_SMS) == ("stream", 4, 0)
    assert int8_plan(16, 11008, 4096, H100_SMS) == ("stream", 8, 0)
    assert int8_plan(1, 4096, 32000, H100_SMS) == ("stream", 1, 0)
    assert int8_plan(64, 4096, 12288, H100_SMS) == ("wgmma", 2, 0)
    assert int8_plan(768, 4096, 12288, H100_SMS) == ("wgmma", 5, 264)
    assert int8_plan(3072, 4096, 12288, H100_SMS) == ("wgmma", 1, 1152)
    assert int8_plan(16, 4096, 12288, 66) == ("stream", 2, 0)


def split_k(x, qw, scale, regime, splits):
    """The kernels' arithmetic in f32: per K chunk the product of x with the
    int8 values, one k tile after another into the chunk's sum, the chunks'
    partials summed in chunk order, then times the scale."""
    R, K = x.shape
    step = STREAM_K if regime == "stream" else WGMMA_K
    w = qw.float()
    total = None
    for part in chunks(K // step, splits):
        acc = torch.zeros(R, qw.shape[1])
        for kt in part:
            ks = slice(kt * step, (kt + 1) * step)
            acc = acc + x[:, ks] @ w[ks]
        total = acc if total is None else total + acc
    return total * scale.reshape(1, -1)


def _inputs(R, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.02).astype(np.float32)
    q = quant.quantize_array(torch.from_numpy(w))
    return torch.from_numpy(x), q[quant.QKEY], q[quant.SKEY]


# (R, K, N, splits): the decode regime at one row, a ragged row count, 16
# slots and the cut, with a chunk that would start past K (4 tiles in 3
# chunks of 2); the prefill regime past the cut and at a ragged edge
SPLIT_CASES = {
    "decode_r1": (1, 512, 256, 2),
    "decode_r5_three_chunks": (5, 256, 128, 3),
    "decode_r16": (16, 1024, 384, 5),
    "decode_cut": (INT8_CUT, 512, 256, 1),
    "prefill_past_cut": (INT8_CUT + 1, 512, 256, 3),
    "prefill_ragged": (130, 640, 384, 2),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_k_matches_the_reference(case):
    R, K, N, splits = SPLIT_CASES[case]
    x, qw, scale = _inputs(R, K, N, seed=len(case))
    regime = "stream" if R <= INT8_CUT else "wgmma"
    got = split_k(x, qw, scale, regime, splits)
    want = matmul_int8_reference(x, qw, scale)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["decode_r1", "decode_r16", "prefill_past_cut",
                                  "prefill_ragged"])
def test_split_k_matches_the_pallas_kernel(case):
    """Run as ``tests/test_quant.py`` runs the Pallas kernel (interpret mode,
    128-blocks), times the per-channel scale the kernel leaves to its
    caller."""
    R, K, N, splits = SPLIT_CASES[case]
    x, qw, scale = _inputs(R, K, N, seed=3)
    regime = "stream" if R <= INT8_CUT else "wgmma"
    got = split_k(x, qw, scale, regime, splits)
    want = jqm.matmul_int8(jnp.asarray(x.numpy()), jnp.asarray(qw.numpy()), block_k=128,
                           block_n=128, interpret=True) * scale.numpy().reshape(-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_launch_key_separates_what_the_checks_read():
    """The wrapper keeps each launch's arguments under ``_launch_key``: one
    entry for a weight at a row count (x's own address is checked on every
    call), a new one for anything its checks or its plan read."""
    from llava_plus_torch.ops.quant_matmul import _launch_key

    x, qw, scale = _inputs(16, 256, 128, seed=0)
    bf16 = torch.bfloat16
    key = _launch_key(8, x, qw, scale, bf16, 7)
    assert _launch_key(8, x.clone(), qw, scale, bf16, 7) == key
    wide = torch.zeros(16, 384)[:, :256]                   # the same shape, another row stride
    for other in (_launch_key(8, x[:15], qw, scale, bf16, 7),
                  _launch_key(8, wide, qw, scale, bf16, 7),
                  _launch_key(8, x.bfloat16(), qw, scale, bf16, 7),
                  _launch_key(8, x, qw.clone(), scale, bf16, 7),
                  _launch_key(8, x, qw, scale.clone(), bf16, 7),
                  _launch_key(8, x, qw, scale, torch.float32, 7),
                  _launch_key(8, x, qw, scale, bf16, 8),
                  _launch_key(4, x, qw, scale, bf16, 7)):
        assert other != key


def test_scratch_grows_twofold_and_keeps_its_zeros():
    """A wrapper's kept buffer: made once, grown at least twofold when a
    launch needs more (zeroed again for counters), reused when it fits."""
    from llava_plus_torch.kernels import build

    dev = torch.device("cpu")
    first = build.scratch("test.counters", dev, 0, 10, torch.int32, zeroed=True)
    assert first.numel() == 10 and not first.any()
    assert build.scratch("test.counters", dev, 0, 4, torch.int32, zeroed=True) is first
    grown = build.scratch("test.counters", dev, 0, 12, torch.int32, zeroed=True)
    assert grown.numel() == 20 and not grown.any()
    assert build.scratch("test.counters", dev, 1, 4, torch.int32, zeroed=True) is not grown


def test_count_launch_adds_to_each_named_counter():
    from llava_plus_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = wrapper.decode_launches = 0
    build.count_launch(wrapper)
    build.count_launch(wrapper, "launches", "decode_launches")
    assert (wrapper.launches, wrapper.decode_launches) == (2, 1)
