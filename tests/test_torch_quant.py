"""The port's weight-only quantization against the JAX package, on the CPU:
int8 / int4 quantizers byte for byte, dequantization, the plain int8 / int4
matmuls against the Pallas kernels run in interpret mode and against JAX
``quant.matmul``, fused matrices, the int8 leaves carried across by
``from_numpy``, and a tiny fused quantized LLaVA (prefill with an image, then
8 decode steps) against the JAX forward on the same quantized tree.

Tolerances: quantized values and scales are compared exactly; f32 products
with ``rtol=1e-5, atol=1e-4`` as ``tests/test_quant.py`` holds the Pallas
kernels; model logits in f32 with ``atol=1e-4, rtol=1e-3`` (the same
arithmetic summed in another order across 2 layers)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu import generate as jax_generate
from llava_plus_tpu.data.debug_tokenizer import DebugTokenizer as JaxDebugTokenizer
from llava_plus_tpu.models import llama as jax_llama
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config
from llava_plus_tpu.ops import quant as jq
from llava_plus_tpu.ops import quant_matmul as jqm
from llava_plus_torch import generate
from llava_plus_torch.data import DebugTokenizer
from llava_plus_torch.models.configs import LlavaConfig
from llava_plus_torch.models.configs import tiny_llava_config as torch_tiny_config
from llava_plus_torch.models import llama, llava
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.ops import quant, quant_matmul

torch.set_num_threads(1)
EXACT_F32 = dict(rtol=1e-5, atol=1e-4)
LOGITS = dict(atol=1e-4, rtol=1e-3)


def _weights(shape, seed):
    """Normal weights with a different magnitude per output column and one
    all-zero column (the 1e-8 scale floor)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape) * rng.uniform(0.001, 30, size=shape[:-2] + (1, shape[-1]))
    w = w.astype(np.float32)
    w[..., 3] = 0.0
    return w


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _quantizers(bits):
    if bits == 8:
        return jq.quantize_array, quant.quantize_array
    return jq.quantize_array_int4, quant.quantize_array_int4


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(256, 128), (3, 512, 192)])
def test_quantize_array_is_byte_identical(bits, shape):
    w = _weights(shape, seed=len(shape) + bits)
    jf, tf = _quantizers(bits)
    want = _np(jf(jnp.asarray(w)))
    got = tf(torch.from_numpy(w))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == {"int8": torch.int8, "float32": torch.float32}[str(want[k].dtype)]
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_array_matches_jax(bits):
    w = _weights((2, 256, 96), seed=11)
    jf, _ = _quantizers(bits)
    qj = jf(jnp.asarray(w))
    qt = {k: torch.from_numpy(np.array(v)) for k, v in qj.items()}
    want = np.asarray(jq.dequantize_array(qj, jnp.float32))
    got = quant.dequantize_array(qt, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert quant.dequantize_array(qt).dtype == torch.bfloat16


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows", [1, 3, 20])
def test_plain_matmul_matches_pallas_kernel_and_jax_matmul(bits, rows):
    """Run as ``tests/test_quant.py`` runs the Pallas kernels (interpret
    mode, 128-blocks), and against the JAX package's ``quant.matmul``."""
    rng = np.random.default_rng(5 + bits + rows)
    x = rng.normal(size=(rows, 256)).astype(np.float32)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    jf, _ = _quantizers(bits)
    qj = jf(jnp.asarray(w))
    qt = {k: torch.from_numpy(np.array(v)) for k, v in qj.items()}
    xt = torch.from_numpy(x)
    if bits == 8:
        kern = jqm.matmul_int8(jnp.asarray(x), qj["qvalue"], block_k=128, block_n=128,
                               interpret=True) * qj["scale"].reshape(-1)
        plain = quant_matmul.matmul_int8_reference(xt, qt["qvalue"], qt["scale"])
        wrapped = quant_matmul.matmul_int8(xt, qt["qvalue"], qt["scale"])
    else:
        kern = jqm.matmul_int4(jnp.asarray(x), qj["qvalue4"], qj["scale"], block_k=128,
                               block_n=128, interpret=True)
        plain = quant_matmul.matmul_int4_reference(xt, qt["qvalue4"], qt["scale"])
        wrapped = quant_matmul.matmul_int4(xt, qt["qvalue4"], qt["scale"])
    np.testing.assert_allclose(plain.numpy(), np.asarray(kern), **EXACT_F32)
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())
    want = np.asarray(jq.matmul(jnp.asarray(x), qj))
    got = quant.matmul(xt, qt)
    np.testing.assert_allclose(got.numpy(), want, **EXACT_F32)
    # [B, T, K] inputs and an f32 output dtype go through the same product
    got3 = quant.matmul(xt.reshape(1, rows, 256), qt, out_dtype=torch.float64)
    assert got3.shape == (1, rows, 128) and got3.dtype == torch.float64
    np.testing.assert_allclose(got3[0].numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


def test_kernel_input_checks_raise():
    """The wrapper refuses what the CUDA kernel does not take (checked before
    any launch, so it runs on the CPU too)."""
    q = quant.quantize_array(torch.randn(256, 128))
    x = torch.randn(4, 256, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        quant_matmul._check_kernel_inputs(x.float(), q["qvalue"], q["scale"], 8, torch.bfloat16)
    with pytest.raises(ValueError):  # K not a multiple of the 128-deep tile
        q2 = quant.quantize_array(torch.randn(96, 128))
        quant_matmul._check_kernel_inputs(x[:, :96], q2["qvalue"], q2["scale"], 8,
                                          torch.bfloat16)
    with pytest.raises(ValueError):  # N not a multiple of 64
        q3 = quant.quantize_array(torch.randn(256, 96))
        quant_matmul._check_kernel_inputs(x, q3["qvalue"], q3["scale"], 8, torch.bfloat16)
    with pytest.raises(ValueError):  # int4 scales of the wrong shape
        q4 = quant.quantize_array_int4(torch.randn(256, 128))
        quant_matmul._check_kernel_inputs(x, q4["qvalue4"], q4["scale"][:4], 4, torch.bfloat16)
    quant_matmul._check_kernel_inputs(x, q["qvalue"], q["scale"], 8, torch.float32)
    # a quantized base with LoRA adapters is no kernel input of its own: the
    # base goes to the kernel, the adapters' products beside it
    # (tests/test_torch_lora.py holds the branch to JAX)
    a, b = torch.randn(256, 4), torch.randn(4, 128)
    got = quant.matmul(x.float(), {**q, "lora_a": a, "lora_b": b})
    want = quant.matmul(x.float(), q) + (x.float() @ a) @ b
    torch.testing.assert_close(got, want)


def _tiny(kv_heads):
    cfg = tiny_llava_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_key_value_heads=kv_heads))


@pytest.mark.parametrize("bits", [8, 4])
def test_fuse_llama_matrices_matches_jax(bits):
    cfg = _tiny(kv_heads=4)  # MHA: q/k/v fuse too
    p = jax_llama.init_params(cfg.text, jax.random.PRNGKey(3), dtype=jnp.float32)
    qj = jq.quantize_lm_params(jax.tree.map(lambda a: a, p), bits=bits)
    qt = from_numpy(_np(qj), "cpu")
    want = _np(jq.fuse_llama_matrices(qj))
    got = quant.fuse_llama_matrices(qt)
    assert set(got["layers"]["attn"]) == set(want["layers"]["attn"]) == {"wqkv", "wo"}
    assert set(got["layers"]["mlp"]) == {"w_gateup", "w_down"}
    for leaf_t, leaf_j in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)


@pytest.mark.parametrize("bits", [8, 4])
def test_from_numpy_keeps_int8_leaves(bits):
    """A quantized JAX tree, through numpy into the port, equals the port's
    own quantization of the same bf16 tree, byte for byte."""
    cfg = tiny_llava_config()
    p = jax_llava.init_params(cfg, jax.random.PRNGKey(4), dtype=jnp.bfloat16)
    carried = from_numpy(_np(jq.quantize_llava_params(
        jax.tree.map(lambda a: a, p), bits=bits, fuse=True)), "cpu")
    own = quant.quantize_llava_params(from_numpy(_np(p), "cpu", torch.bfloat16), bits=bits,
                                      fuse=True)
    def quantized(lm):
        mats = {(g, n): w for g in ("attn", "mlp") for n, w in lm["layers"][g].items()}
        mats["lm_head"] = lm["lm_head"]
        return {k: w for k, w in mats.items() if quant.is_quantized(w)}

    got, want = quantized(carried["language_model"]), quantized(own["language_model"])
    # GQA keeps wq/wk/wv apart: 3 + wo + w_gateup + w_down + lm_head
    assert got.keys() == want.keys() and len(got) == 7
    for name, w in got.items():
        assert w.keys() == want[name].keys()
        for leaf, value in w.items():
            assert value.dtype == want[name][leaf].dtype, (name, leaf)
            assert torch.equal(value, want[name][leaf]), (name, leaf)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_quantized_llava_prefill_and_decode_match_jax(bits, kv_heads):
    """A fused quantized tiny LLaVA: an image prompt's prefill, then 8 decode
    steps fed the JAX run's greedy tokens; logits compared at every step."""
    cfg = _tiny(kv_heads)
    p = jax_llava.init_params(cfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    jp = jq.quantize_llava_params(p, bits=bits, fuse=True)
    tp = from_numpy(_np(jp), "cpu")
    assert ("wqkv" in tp["language_model"]["layers"]["attn"]) == (kv_heads == 4)
    tcfg = LlavaConfig.from_json(cfg.to_json())  # the port's own copy of cfg
    tok = DebugTokenizer(vocab_size=cfg.text.vocab_size)
    jtok = JaxDebugTokenizer(vocab_size=cfg.text.vocab_size)
    img = np.random.default_rng(6).normal(size=(1, 28, 28, 3)).astype(np.float32)
    prompt = ["<image>\ndescribe this picture please"]
    S = 96
    batch_j, plan = jax_generate.prepare_multimodal_request(
        cfg, jtok, prompt, [img], max_seq_len=S, prefill_bucket=32)
    batch_t, _ = generate.prepare_multimodal_request(
        tcfg, tok, prompt, [img], max_seq_len=S, prefill_bucket=32, device="cpu")
    n = int(plan.lengths[0])
    last = np.array([n - 1], np.int32)
    cache_j = jax_llama.KVCache.create(cfg.text, 1, S, jnp.float32)
    cache_t = llama.KVCache.create(tcfg.text, 1, S, torch.float32, device="cpu")
    want, cache_j = jax_llava.forward(jp, cfg, batch_j, cache=cache_j, fresh_prefill=True,
                                      logits_positions=jnp.asarray(last))
    got, _ = llava.forward(tp, tcfg, batch_t, cache=cache_t, fresh_prefill=True,
                           logits_positions=torch.from_numpy(last).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    seg = np.ones((1, 1), np.int32)
    for i in range(8):
        token = np.asarray(jnp.argmax(want[:, -1], -1)).reshape(1, 1).astype(np.int32)
        pos = np.array([[n + i]], np.int32)
        want, cache_j = jax_llava.decode_step(jp, cfg, jnp.asarray(token), jnp.asarray(pos),
                                              jnp.asarray(seg), cache_j)
        got, _ = llava.decode_step(tp, tcfg, torch.from_numpy(token).long(),
                                   torch.from_numpy(pos), torch.from_numpy(seg), cache_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_quantize_is_in_place_and_mpt_raises():
    cfg = torch_tiny_config()
    params = llava.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    lm = params["language_model"]
    out = quant.quantize_llava_params(params, bits=8)
    assert out["language_model"] is lm  # the caller's tree, quantized in place
    assert quant.is_quantized(lm["layers"]["attn"]["wq"])
    assert lm["layers"]["attn"]["wq"]["qvalue"].shape == (2, 64, 64)
    assert not quant.is_quantized(lm["embed_tokens"])
    # MPT: the four matrices of JAX MPT_QUANT_PATHS, byte for byte equal to
    # the JAX quantizer's, unfused (``wqkv`` is one matrix), the tied ``wte``
    # left as it is; a backbone that is neither raises
    from llava_plus_tpu.models.configs import tiny_llava_mpt_config as jax_mpt_config
    from llava_plus_torch.models.configs import tiny_llava_mpt_config

    jp = jax_llava.init_params(jax_mpt_config(), jax.random.PRNGKey(1), dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jp)
    want = jq.quantize_llava_params(jp, "mpt", fuse=True)["language_model"]
    mp = from_numpy(np_params, "cpu")
    mlm = mp["language_model"]
    out = quant.quantize_llava_params(mp, "mpt", fuse=True)
    assert out["language_model"] is mlm
    assert not quant.is_quantized(mlm["wte"])
    for path in quant.MPT_QUANT_PATHS:
        got_w, want_w = quant._get(mlm, path), jq._get(want, path)
        for key in ("qvalue", "scale"):
            np.testing.assert_array_equal(got_w[key].numpy(), np.asarray(want_w[key]))
    assert set(mlm["layers"]["attn"]) == {"wqkv", "out_proj"}
    assert dataclasses.asdict(tiny_llava_mpt_config()) == dataclasses.asdict(jax_mpt_config())
    with pytest.raises(ValueError):
        quant.quantize_llava_params(copy.deepcopy(params), "gpt2")
