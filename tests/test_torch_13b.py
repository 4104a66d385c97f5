"""LLaVA-1.5-13B's shapes in the port, on the CPU.

- A narrow LLaMA with 13B's head count and FFN ratio (40 heads of 8, so
  hidden 320, FFN 864, 3 layers; the tiny CLIP tower), its weights drawn
  from one numpy seed: prefill logits and decode steps against the JAX
  package (bf16 and int8 caches, logits to 1e-4 of their largest magnitude,
  as ``tests/test_torch_llama.py``), and the greedy text of the dense engine
  (int4 fused weights, int8 KV) and of the paged engine over a prefix hit
  against the JAX engines'.
- ``LLAVA_15_13B`` on the meta device, int8 and fused int4: every quantized
  leaf passes the int8 / int4 kernels' input check, and their plans at the
  engine's row counts are the ones stated here.
- The layer-at-a-time quantization (``ops/quant._quantize_matrix``) gives
  the whole-leaf computation's bits on a stacked tree.
- A 40-head checkpoint written by the exporter loads back leaf for leaf,
  and 13B's ``config.json`` reads back as ``LLAMA_13B``.
- The worker's ``--load-4bit`` advice, under the JAX worker's condition.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.models import llama as jax_llama
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models import configs as jax_configs
from llava_plus_tpu.ops import quant as jax_quant
from llava_plus_tpu.serve import engine as jax_engine
from llava_plus_torch.models import llama, llava
from llava_plus_torch.models.configs import LLAMA_13B, LLAVA_15_13B, tiny_llava_config
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.ops import quant, quant_matmul
from llava_plus_torch.serve.engine import BatchedEngine, Request

from .test_generate import CharTokenizer

torch.set_num_threads(1)
H100_SMS = 132

# 13B's 40 heads (not a power of two) over 40 kv heads and its FFN ratio
# (13824 / 5120 = 2.7) at head dim 8
CFG = dataclasses.replace(tiny_llava_config(), text=dataclasses.replace(
    tiny_llava_config().text, hidden_size=320, intermediate_size=864, num_hidden_layers=3,
    num_attention_heads=40, num_key_value_heads=40))
JCFG = jax_configs.LlavaConfig.from_json(CFG.to_json())   # the JAX package's own copy
S = 160
KW = dict(max_slots=2, max_seq_len=S, prefill_bucket=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """The narrow tree in numpy: every matrix (2-D and up) drawn from one
    numpy seed (normal, scale 0.02); norms, biases and embeddings of one
    dim as the JAX init makes them. The JAX tree, and the port's."""
    rng = np.random.default_rng(0)
    shapes = _np(jax_llava.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32))
    npt = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.02).astype(np.float32)
                       if a.ndim >= 2 else a, shapes)
    return jax.tree.map(jnp.asarray, npt), from_numpy(npt, "cpu"), npt


def _prompt_batch():
    ids = np.array([[1, 17, 99, 250, 3, 42, 7, 300],
                    [1, 5, 6, 7, 8, 0, 0, 0]], np.int32)
    seg = np.array([[1] * 8, [1] * 5 + [0] * 3], np.int32)
    pos = np.where(seg > 0, np.arange(8)[None], 32).astype(np.int32)
    return ids, seg, pos, 32


@pytest.mark.parametrize("cache_kind", ["none", "bf16", "int8"])
def test_prefill_and_decode_match_jax_at_40_heads(trees, cache_kind):
    """A fresh prefill, then 4 greedy decode steps (tokens taken from the
    JAX run and fed to both)."""
    jp, tp, _ = trees
    jp, tp = jp["language_model"], tp["language_model"]
    jc, tc = JCFG.text, CFG.text
    ids, seg, pos, S_ = _prompt_batch()
    B = ids.shape[0]
    if cache_kind == "none":
        want, _ = jax_llama.forward(jp, jc, jnp.asarray(ids), segment_ids=jnp.asarray(seg))
        got, _ = llama.forward(tp, tc, torch.from_numpy(ids), segment_ids=torch.from_numpy(seg))
        rows = seg > 0
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                                   atol=1e-4 * np.abs(np.asarray(want)[rows]).max())
        return
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if cache_kind == "bf16"
                else (jnp.int8, torch.int8))
    jcache = jax_llama.KVCache.create(jc, B, S_, jdt)
    tcache = llama.KVCache.create(tc, B, S_, tdt, device="cpu")
    last = seg.sum(1) - 1
    want, jcache = jax_llama.forward(
        jp, jc, jnp.asarray(ids), positions=jnp.asarray(pos), segment_ids=jnp.asarray(seg),
        cache=jcache, fresh_prefill=True, logits_positions=jnp.asarray(last))
    got, _ = llama.forward(
        tp, tc, torch.from_numpy(ids), positions=torch.from_numpy(pos),
        segment_ids=torch.from_numpy(seg), cache=tcache, fresh_prefill=True,
        logits_positions=torch.from_numpy(last))
    steps = [(np.asarray(want), got)]
    tok = np.asarray(jnp.argmax(want[:, 0], -1)).astype(np.int32)[:, None]
    p = last[:, None].astype(np.int32)
    for _ in range(4):
        p = p + 1
        one = np.ones((B, 1), np.int32)
        want, jcache = jax_llama.forward(jp, jc, jnp.asarray(tok), positions=jnp.asarray(p),
                                         segment_ids=jnp.asarray(one), cache=jcache)
        got, _ = llama.forward(tp, tc, torch.from_numpy(tok), positions=torch.from_numpy(p),
                               segment_ids=torch.from_numpy(one), cache=tcache)
        steps.append((np.asarray(want), got))
        tok = np.asarray(jnp.argmax(want[:, 0], -1)).astype(np.int32)[:, None]
    assert tcache.k.shape[-2] == 40   # the cache holds 40 kv heads
    for want, got in steps:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(tcache.seg.numpy(), np.asarray(jcache.seg))


@pytest.fixture(scope="module")
def int4_trees(trees):
    """The narrow tree with int4 fused weights (wqkv, w_gateup), quantized
    by the JAX package and carried across."""
    jq = jax_quant.quantize_llava_params(trees[0], bits=4, fuse=True)
    tq = from_numpy(_np(jq), "cpu")
    attn = tq["language_model"]["layers"]["attn"]
    assert quant.Q4KEY in attn["wqkv"] and tuple(attn["wqkv"][quant.Q4KEY].shape) == (
        3, 320 // 2, 3 * 320)
    return jq, tq


def _image(seed):
    s = CFG.vision.image_size
    return np.random.default_rng(seed).normal(size=(1, s, s, 3)).astype(np.float32)


def test_dense_engine_int4_int8_kv_matches_jax_engine(int4_trees):
    """Configuration #2's engine at narrow width: int4 fused weights, an
    int8 KV cache; the greedy text of text and image requests equals the
    JAX engine's."""
    jq, tq = int4_trees
    tok = CharTokenizer()
    jeng = jax_engine.BatchedEngine(jq, JCFG, tok, cache_dtype=jnp.int8, **KW)
    eng = BatchedEngine(tq, CFG, tok, cache_dtype=torch.int8, **KW)
    try:
        for prompt, img in (("hello there", None), ("<image>\nwhat is it?", _image(1)),
                            ("thirteen billion", None)):
            want = jeng.generate(jax_engine.Request(prompt=prompt, images=img,
                                                    max_new_tokens=8))
            assert eng.generate(Request(prompt=prompt, images=img, max_new_tokens=8)) == want
            assert len(want) > 0
    finally:
        eng.stop()
        jeng.stop()


def test_paged_engine_prefix_hit_matches_jax_engine(int4_trees, monkeypatch):
    """The paged engine (int4 fused weights, an int8 pool of 32-token pages,
    the prefix cache on): an image turn, then a follow-up that re-sends it.
    The follow-up is a prefix hit on both sides, runs no vision encode in
    the port, and every greedy text equals the JAX paged engine's."""
    jq, tq = int4_trees
    tok = CharTokenizer()
    kw = dict(KW, page_size=32)
    jeng = jax_engine.BatchedEngine(jq, JCFG, tok, cache_dtype=jnp.int8, paged=True, **kw)
    eng = BatchedEngine(tq, CFG, tok, cache_dtype=torch.int8, paged=True, **kw)
    img = _image(2)
    turn1 = "<image>\nThe quick brown fox jumps over the lazy dog by a river."
    try:
        gen = lambda e, p, req: e.generate(req(prompt=p, images=img, max_new_tokens=6))
        first = gen(jeng, turn1, jax_engine.Request)
        assert gen(eng, turn1, Request) == first
        follow = turn1 + first + " And then?"
        encodes = []
        encode = llava.encode_images
        monkeypatch.setattr(llava, "encode_images",
                            lambda *a, **k: encodes.append(1) or encode(*a, **k))
        hits, jhits = eng._prefix.hit_requests, jeng._prefix.hit_requests
        tokens, dispatches = eng.prefix_hit_tokens, eng.prefill_dispatches
        want = gen(jeng, follow, jax_engine.Request)
        assert gen(eng, follow, Request) == want
        assert (eng._prefix.hit_requests, jeng._prefix.hit_requests) == (hits + 1, jhits + 1)
        assert eng.prefix_hit_tokens - tokens >= 32 and eng.prefill_dispatches == dispatches
        assert not encodes
    finally:
        eng.stop()
        jeng.stop()


# LLaVA-1.5-13B's fused matrices (K, N) and its head; per row count, the
# (regime, K chunks, whole tiles) that int8_plan and int4_plan give on an
# H100's 132 SMs: wo and w_down stream in 6 chunks at decode rows, wqkv at
# R = 80 runs the wgmma kernel in 2 chunks with no whole tiles, w_gateup at
# R = 768 runs all 648 tiles over the whole of K
PLANS_13B = {
    "wqkv": ((5120, 15360), {1: ("stream", 2, 0), 8: ("stream", 2, 0), 16: ("stream", 2, 0),
                             80: ("wgmma", 2, 0), 768: ("wgmma", 1, 360),
                             3072: ("wgmma", 1, 1440)}),
    "wo": ((5120, 5120), {1: ("stream", 6, 0), 8: ("stream", 6, 0), 16: ("stream", 6, 0),
                          80: ("wgmma", 6, 0), 768: ("wgmma", 1, 120),
                          3072: ("wgmma", 1, 480)}),
    "w_gateup": ((5120, 27648), {1: ("stream", 3, 0), 8: ("stream", 3, 0),
                                 16: ("stream", 3, 0), 80: ("wgmma", 1, 108),
                                 768: ("wgmma", 1, 648), 3072: ("wgmma", 1, 2592)}),
    "w_down": ((13824, 5120), {1: ("stream", 6, 0), 8: ("stream", 6, 0),
                               16: ("stream", 6, 0), 80: ("wgmma", 6, 0),
                               768: ("wgmma", 1, 120), 3072: ("wgmma", 1, 480)}),
    "lm_head": ((5120, 32000), {1: ("stream", 1, 0), 8: ("stream", 1, 0),
                                16: ("stream", 1, 0), 80: ("wgmma", 1, 125),
                                768: ("wgmma", 1, 750), 3072: ("wgmma", 1, 3000)}),
}


@pytest.mark.parametrize("bits", [8, 4])
def test_13b_quantized_tree_meets_the_kernels_rules(bits):
    """``LLAVA_15_13B`` on the meta device, quantized and fused as
    ``TorchBackend(quantize=...)`` does: every quantized leaf (a layer of a
    stacked one) passes the kernels' own input check at the engine's row
    counts, in the layout of ``bits``, with the plans above."""
    params = llava.init_params(LLAVA_15_13B, None, "meta")
    params = quant.quantize_llava_params(params, "llama", bits=bits, fuse=True)
    lm = params["language_model"]
    leaves = {"wqkv": lm["layers"]["attn"]["wqkv"], "wo": lm["layers"]["attn"]["wo"],
              "w_gateup": lm["layers"]["mlp"]["w_gateup"],
              "w_down": lm["layers"]["mlp"]["w_down"], "lm_head": lm["lm_head"]}
    assert set(lm["layers"]["attn"]) == {"wqkv", "wo"}
    assert set(lm["layers"]["mlp"]) == {"w_gateup", "w_down"}
    planner = quant_matmul.int8_plan if bits == 8 else quant_matmul.int4_plan
    key = quant.QKEY if bits == 8 else quant.Q4KEY
    for name, ((K, N), plans) in PLANS_13B.items():
        w = leaves[name]
        qw, scale = w[key], w[quant.SKEY]
        if name != "lm_head":   # stacked over the 40 layers
            assert qw.shape[0] == scale.shape[0] == 40
            qw, scale = qw[0], scale[0]
        assert tuple(qw.shape) == ((K, N) if bits == 8 else (K // 2, N))
        assert tuple(scale.shape) == ((1, N) if bits == 8 else (K // quant_matmul.INT4_BLOCK, N))
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        for R, plan in plans.items():
            x = torch.empty(R, K, device="meta", dtype=torch.bfloat16)
            quant_matmul._check_kernel_inputs(x, qw.contiguous(), scale.contiguous(), bits,
                                              out_dtype)
            assert planner(R, K, N, H100_SMS) == plan, (name, R)
    # the stream's K tiles: int8 64-row, int4 128-row
    assert 13824 // quant_matmul.STREAM_K == 216 and 13824 // quant_matmul.INT4_STREAM_K == 108


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_at_a_time_quantization_is_bit_for_bit(bits, dtype):
    """A stacked [L, K, N] leaf quantized one layer at a time into
    preallocated outputs (what ``quantize_lm_params`` runs) has the bits
    of the whole leaf's quantization; so does a tree quantized in place,
    leaf for leaf."""
    rng = np.random.default_rng(bits)
    w = torch.from_numpy((rng.normal(size=(3, 256, 192)) * rng.uniform(
        0.001, 1.0, size=(3, 1, 192))).astype(np.float32)).to(dtype)
    w[1, :, 5] = 0.0   # an all-zero column: the 1e-8 scale floor
    whole = (quant.quantize_array if bits == 8 else quant.quantize_array_int4)(w)
    sliced = quant._quantize_matrix(w, bits)
    assert sliced.keys() == whole.keys()
    for k in whole:
        assert sliced[k].dtype == whole[k].dtype and torch.equal(sliced[k], whole[k]), k
    tree = {"layers": {"mlp": {"w_down": w.clone()}, "attn": {"wo": w[:, :192, :].clone()}}}
    paths = (("layers", "mlp", "w_down"), ("layers", "attn", "wo"))
    want = {p: (quant.quantize_array if bits == 8 else quant.quantize_array_int4)(
        quant._get(tree, p)) for p in paths}
    quant.quantize_lm_params(tree, paths, bits=bits)
    for p in paths:
        for k, v in want[p].items():
            assert torch.equal(quant._get(tree, p)[k], v), (p, k)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            yield from _named_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_40_head_checkpoint_round_trip(tmp_path):
    """The exporter's checkpoint of the narrow 40-head tree loads back as its
    config, every leaf bit for bit; 13B's text config survives the
    ``config.json`` round trip."""
    from llava_plus_torch.models.builder import load_pretrained_model
    from llava_plus_torch.models.hf_import import llama_config_from_hf
    from llava_plus_torch.train.checkpoint import _llama_hf_config, export_hf_llava

    assert llama_config_from_hf(_llama_hf_config(LLAMA_13B)) == LLAMA_13B
    assert LLAVA_15_13B.text == LLAMA_13B and LLAVA_15_13B.hidden_size == 5120
    params = llava.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    path = tmp_path / "llava-narrow-13b-heads"
    export_hf_llava(params, CFG, path)
    _, loaded, cfg, _, ctx = load_pretrained_model(str(path))
    assert cfg == CFG and ctx == CFG.max_sequence_length
    got, want = dict(_named_leaves(loaded)), dict(_named_leaves(params))
    assert sorted(got) == sorted(want)
    for name, a in got.items():
        assert a.dtype == want[name].dtype and torch.equal(a, want[name]), name


@pytest.mark.parametrize("flags,name,warns", [
    (["--load-4bit"], "llava-v1.5-7b", True),
    (["--load-4bit"], "llava-v1.5-13b", False),
    (["--load-4bit"], "LLaVA-1.5-13B-random", False),
    (["--load-8bit"], "llava-v1.5-7b", False),
    ([], "llava-v1.5-7b", False),
])
def test_load_4bit_advice_follows_the_jax_condition(caplog, flags, name, warns):
    """The JAX worker warns on ``--load-4bit`` for a model whose name lacks
    "13b" (``llava_plus_tpu/serve/model_worker.py``); the port's worker
    gives its advice under the same condition, with no TPU figure."""
    from llava_plus_torch.serve import model_worker as mw

    args = mw.parse_args(["--model-path", "unused", *flags])
    with caplog.at_level(logging.WARNING, logger="model_worker"):
        mw.advise_load_4bit(args, name)
    got = [r for r in caplog.records if r.name == "model_worker"]
    assert bool(got) == warns
    if warns:
        assert "--load-4bit" in got[0].getMessage() and "13B" in got[0].getMessage()
        assert "img+tok/s" not in got[0].getMessage()

