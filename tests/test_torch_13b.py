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
- Training at 40 heads: the port's ``train()`` against JAX ``train()`` for
  LoRA and QLoRA ``--bits 4`` on the narrow config (f32, 3 steps, JAX's
  initial adapters in both; ``tests/test_torch_lora.py``'s check); merged
  adapters against the same adapters attached lazily, on a plain and an
  int4 base; ``LLAVA_15_13B`` on the meta device: the r-128 adapters' count
  and every QLoRA int4 leaf and the head against the kernels' input check
  at a training batch's rows, and the head's 32-bit row limit.
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
from llava_plus_torch.models.convert import from_numpy, per_layer
from llava_plus_torch.ops import quant, quant_matmul
from llava_plus_torch.serve.engine import BatchedEngine, Request
from llava_plus_torch.train import lora

from .test_generate import CharTokenizer
from .test_torch_lora import lora_train_against_jax
from .test_torch_trainer import corpus  # noqa: F401  (the corpus fixture)

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



@pytest.mark.parametrize("bits", [None, 4], ids=["lora", "qlora4"])
def test_lora_train_matches_jax_train_at_40_heads(monkeypatch, corpus, tmp_path,  # noqa: F811
                                                  bits):
    """LoRA and QLoRA ``--bits 4`` through both trainers on the narrow
    40-head config: per-step loss, accuracy, tokens and grad_norm, the
    frozen base and projector, and the saved adapters, at
    ``tests/test_torch_lora.py``'s tolerance."""
    lora_train_against_jax(monkeypatch, corpus, tmp_path, bits, cfg=CFG, jax_cfg=JCFG)


def _grid_lm(npt, rng):
    """The narrow language model with every LoRA target on a grid of
    2**-9 (q in -7..7, each 32-row block's column holding a 7): its int4
    quantization dequantizes to the same values (within f32's 1 / 7), and
    bf16 holds them, and their sums with :func:`_grid_adapters`' terms,
    exactly."""
    lm = jax.tree.map(np.copy, npt["language_model"])
    for path in lora.LLAMA_TARGETS:
        w = lm
        for p in path[:-1]:
            w = w[p]
        L, K, N = w[path[-1]].shape
        q = rng.integers(-6, 7, size=(L, K // 32, 32, N))
        q[:, :, 0, :] = 7 * rng.choice([-1, 1], size=(L, K // 32, N))
        w[path[-1]] = (q.reshape(L, K, N) * 2.0 ** -9).astype(np.float32)
    return lm


def _grid_adapters(lm, lcfg, rng):
    """r-4 adapters whose merged term (alpha / r) a @ b is a multiple of
    2**-9 of at most 4 of them: a in {0, +-2**-4}, b in {0, +-2**-6}."""
    out = {}
    for path in lora.LLAMA_TARGETS:
        L, K, N = lora._in_out(quant._get(lm, path))
        out["/".join(path)] = {
            "a": torch.from_numpy(rng.integers(-1, 2, (L, K, lcfg.r)) * 2.0 ** -4).float(),
            "b": torch.from_numpy(rng.integers(-1, 2, (L, lcfg.r, N)) * 2.0 ** -6).float()}
    return out


def _f64(tree):
    """``tree`` with its floating leaves in f64; a quantized leaf as it is
    (the kernels' plain version dequantizes in x's f64)."""
    if isinstance(tree, dict) and not quant.is_quantized(tree):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f64(v) for v in tree]
    return tree.double() if torch.is_tensor(tree) and tree.is_floating_point() else tree


@pytest.mark.parametrize("base", ["plain", "int4"])
def test_merged_adapters_match_lazy_logits(trees, base):
    """``merge_lora_into_base`` (an int4 base dequantized to bf16) against
    the same adapters attached lazily (``apply_lora``: the base product,
    int4 through its kernel's plain version, plus ``(x @ a) @ b``), on the
    narrow 40-head model: the logits of an f64 forward (every leaf cast to
    f64, exactly) at ``test_merge_matches_jax``'s tolerance. The weights
    and adapters lie on a grid on which every merged weight is exact, so
    what is left is summation order and the int4 scales' last f32 bit
    (``amax * f32(1 / 7)``, which the bf16 merge rounds away); the merge of the
    per-layer tree (as the card's phase 26 merges a 13B tree) equals the
    stacked merge bit for bit."""
    rng = np.random.default_rng(22)
    lcfg = lora.LoraConfig(r=4, alpha=8)
    lm = from_numpy(_grid_lm(trees[2], rng), "cpu")
    if base == "int4":
        lm = quant.quantize_llava_params({"language_model": lm}, "llama", bits=4)[
            "language_model"]
    ad = _grid_adapters(lm, lcfg, rng)
    ids = torch.as_tensor(rng.integers(3, CFG.text.vocab_size, (2, 24)))
    merged = lora.merge_lora_into_base({"language_model": lm}, ad, lcfg)["language_model"]
    target = quant._get(merged, lora.LLAMA_TARGETS[0])
    assert target.dtype == (torch.bfloat16 if base == "int4" else torch.float32)
    lazy, _ = llama.forward(_f64(lora.apply_lora(lm, ad, lcfg)), CFG.text, ids)
    got, _ = llama.forward(_f64(merged), CFG.text, ids)
    np.testing.assert_allclose(got.numpy(), lazy.numpy(), rtol=1e-6, atol=1e-7)
    plain, _ = llama.forward(_f64(lm), CFG.text, ids)
    assert (lazy - plain).abs().max() > 1e-3          # the adapters matter
    by_layer = lora.merge_lora_into_base(per_layer({"language_model": lm}), ad, lcfg)
    for i, lay in enumerate(by_layer["language_model"]["layers"]):
        for path in lora.LLAMA_TARGETS:
            assert torch.equal(quant._get(lay, path[1:]), quant._get(merged, path)[i]), path


def _trained_adapters(lm, lcfg, seed):
    """Adapters as two AdamW steps at finetune_lora.sh's lr 2e-4 leave them:
    a ~ N(0, 0.02) as made, b within 2 lr of its zeros."""
    ad = lora.init_lora_params(lm, lcfg, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for ab in ad.values():
        ab["b"] = (torch.rand(ab["b"].shape, generator=g) * 2 - 1) * 4e-4
    return ad


def _plant(fault, pl, ad, lcfg, monkeypatch):
    """The merge of ``ad`` into the per-layer tree ``pl``, right or with
    ``fault`` planted."""
    if fault == "half_scaling":
        lcfg = lora.LoraConfig(r=lcfg.r, alpha=lcfg.alpha / 2)
    elif fault == "layer_skipped":
        ad = {k: dict(ab, b=torch.cat([ab["b"][:1], 0 * ab["b"][1:2], ab["b"][2:]]))
              for k, ab in ad.items()}
    elif fault == "layers_swapped":
        ad = {k: {n: x.flip(0) for n, x in ab.items()} for k, ab in ad.items()}
    elif fault == "nibbles_swapped":   # the int4 base dequantized with its halves swapped
        unpack = quant._unpack_int4
        monkeypatch.setattr(quant, "_unpack_int4",
                            lambda p: unpack(p).roll(16, dims=-2))
    out = lora.merge_lora_into_base(pl, ad, lcfg)
    layers = out["language_model"]["layers"]
    if fault == "one_column":          # layer 0's w_down merged but for one column
        w = pl["language_model"]["layers"][0]["mlp"]["w_down"]
        base = quant.dequantize_array(w) if quant.is_quantized(w) else w
        layers[0]["mlp"]["w_down"][:, 5] = base[:, 5]
    elif fault == "toward_zero":       # every merged sum rounded toward zero
        for i, (lay, b_lay) in enumerate(zip(layers, pl["language_model"]["layers"])):
            for path in lora.LLAMA_TARGETS:
                w = quant._get(b_lay, path[1:])
                base = quant.dequantize_array(w) if quant.is_quantized(w) else w
                ab = ad["/".join(path)]
                f32 = base.float() + (ab["a"][i] @ ab["b"][i]) * lcfg.scaling
                quant._get(lay, path[1:]).copy_(
                    (f32.view(torch.int32) & -65536).view(torch.float32))
    return layers


_FAULTS = [None, "half_scaling", "layer_skipped", "layers_swapped", "one_column",
           "toward_zero"]


@pytest.mark.parametrize("base,fault", [("bf16", f) for f in _FAULTS]
                         + [("int4", f) for f in _FAULTS + ["nibbles_swapped"]])
def test_chip_merge_check_holds_the_merge_and_refuses_wrong_ones(trees, base, fault,
                                                                 monkeypatch):
    """``chip_smoke.check_merged_weights``, phase 26's gate on the merge of
    trained adapters into a 13B base, here on the narrow 40-head tree in
    bf16 (normal 0.02 weights, as the card's random ones) and quantized to
    int4, with r-128 adapters as two training steps leave them: the port's
    ``merge_lora_into_base`` passes it, and a merge with a fault planted
    raises (half the scaling; one layer's adapters left out; the layers'
    adapters swapped; one column of one matrix left unmerged; the sums
    rounded toward zero; an int4 base dequantized with its nibbles'
    halves swapped)."""
    import chip_smoke

    lm = from_numpy(trees[2]["language_model"], "cpu", torch.bfloat16)
    if base == "int4":
        lm = quant.quantize_llava_params({"language_model": lm}, "llama", bits=4)[
            "language_model"]
    lcfg = lora.LoraConfig(r=128, alpha=256)
    ad = _trained_adapters(lm, lcfg, 26)
    pl = per_layer({"language_model": lm})
    with torch.no_grad():
        layers = _plant(fault, pl, ad, lcfg, monkeypatch)
        args = (layers, pl["language_model"]["layers"], ad, lcfg.scaling)
        if fault is None:
            apart, footprint = chip_smoke.check_merged_weights(*args)
            assert apart < 1e-3 and footprint > 0.5
        else:
            with pytest.raises(AssertionError, match="not the base plus its adapters"):
                chip_smoke.check_merged_weights(*args)


# LLaVA-1.5-13B's r-128 adapters over the seven targets: 40 * 128 * (11 *
# 5120 + 3 * 13824) parameters (scripts/v1_5/finetune_lora.sh's rank)
ADAPTERS_13B = 500_695_040
ROWS_13B_TRAIN = 16 * 2048            # finetune_lora.sh's batch at its max length
HEAD_ROWS_MAX = (2 ** 31 - 1) // 32000   # 67,108: the int4 kernels' 32-bit offsets


def test_13b_lora_and_qlora_fit_the_kernels_on_meta():
    """``LLAVA_15_13B`` on the meta device as QLoRA ``--bits 4`` makes it
    (unfused int4 matrices and head): r-128 adapters as 14 stacked leaves
    (560 per-layer tensors) of ADAPTERS_13B parameters; every int4 leaf and
    the head pass the kernels' input check at a 16 x 2048 batch's rows; the
    head is refused past 67,108 rows (R * N at 2**31), the rule a larger
    batch meets first."""
    params = llava.init_params(LLAVA_15_13B, None, "meta")
    lm = quant.quantize_llava_params(params, "llama", bits=4)["language_model"]
    lcfg = lora.LoraConfig(r=128, alpha=256)
    ad = lora.init_lora_params(lm, lcfg, torch.Generator())   # made on the base's device
    assert sorted(ad) == sorted("/".join(p) for p in lora.LLAMA_TARGETS)
    assert sum(len(ab) for ab in ad.values()) == 14
    per = lora.lora_per_layer(ad)
    assert len(per) == 40 and sum(len(ab) for lay in per for ab in lay.values()) == 560
    assert sum(x.numel() for ab in ad.values() for x in ab.values()) == ADAPTERS_13B
    D, F = LLAVA_15_13B.hidden_size, LLAVA_15_13B.text.intermediate_size
    assert 40 * 128 * (11 * D + 3 * F) == ADAPTERS_13B
    for path in lora.LLAMA_TARGETS:
        w = quant._get(lm, path)
        assert quant.Q4KEY in w and w[quant.Q4KEY].shape[0] == 40
        qw, scale = w[quant.Q4KEY][0].contiguous(), w[quant.SKEY][0].contiguous()
        x = torch.empty(ROWS_13B_TRAIN, 2 * qw.shape[0], device="meta", dtype=torch.bfloat16)
        quant_matmul._check_kernel_inputs(x, qw, scale, 4, torch.bfloat16)
        assert ad["/".join(path)]["a"].shape == (40, x.shape[1], 128)
        assert ad["/".join(path)]["b"].shape == (40, 128, qw.shape[1])
    head = lm["lm_head"]
    assert tuple(head[quant.Q4KEY].shape) == (D // 2, 32000)
    assert HEAD_ROWS_MAX == 67_108
    for R in (ROWS_13B_TRAIN, HEAD_ROWS_MAX):
        x = torch.empty(R, D, device="meta", dtype=torch.bfloat16)
        quant_matmul._check_kernel_inputs(x, head[quant.Q4KEY], head[quant.SKEY], 4,
                                          torch.float32)
    with pytest.raises(ValueError, match="32-bit"):
        x = torch.empty(HEAD_ROWS_MAX + 1, D, device="meta", dtype=torch.bfloat16)
        quant_matmul._check_kernel_inputs(x, head[quant.Q4KEY], head[quant.SKEY], 4,
                                          torch.float32)
