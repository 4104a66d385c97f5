"""LoRA / QLoRA in the port against the JAX package, on the CPU.

- ``ops.quant.matmul`` with adapters (``x @ base + (x @ a) @ b``) on a
  bf16, an int8 and an int4 base against JAX ``quant.matmul``: values and
  the gradients to x, a and b (f32 x on the quantized bases: rtol 1e-5,
  atol 1e-5 on values and gradients of order 1; bf16 on the bf16 base: 1% of the largest value, bf16 rounding
  in two orders);
- ``quant_matmul.matmul_int8`` / ``matmul_int4`` called with a ``x`` that
  requires a gradient: ``dx = dy @ dequant(W)^T`` through the autograd
  Function, which counts its backward calls (the contract the card keeps:
  there the kernel fills a raw buffer and only the Function carries the
  gradient);
- ``apply_lora`` lazy against ``materialize=True`` through the tiny LLaMA,
  and the port's ``merge_lora_into_base`` against JAX's;
- the port's ``train()`` against JAX ``train()`` for LoRA, QLoRA ``--bits
  8`` and ``--bits 4`` (tiny model, f32, 3 steps, the adapters injected from
  JAX's initial tree): per-step loss, accuracy, tokens and grad_norm at rtol
  1e-4, and the saved adapter and projector;
- the PEFT round trip with the ``peft`` package: the port's
  ``save_peft_adapter`` loads into a ``peft`` LLaMA with the same tensors,
  and ``load_peft_adapter`` reads what ``peft`` saves.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.ops import quant as jax_quant
from llava_plus_tpu.train import lora as jax_lora
from llava_plus_tpu.train import train as jax_train
from llava_plus_torch.models import llama
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.models.convert import from_numpy, to_numpy
from llava_plus_torch.ops import quant
from llava_plus_torch.ops import quant_matmul as qm
from llava_plus_torch.train import lora
from llava_plus_torch.train import train as port_train

from .test_torch_trainer import _tok, corpus  # noqa: F401  (the corpus fixture)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _base(kind, rng, K=256, N=128):
    """(JAX leaf, port leaf, x dtype name) of one weight."""
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    if kind == "bf16":
        jw = jnp.asarray(w, jnp.bfloat16)
        return jw, _t(np.asarray(jw, np.float32)).bfloat16(), "bfloat16"
    q = jax_quant.quantize_array(jnp.asarray(w)) if kind == "int8" else \
        jax_quant.quantize_array_int4(jnp.asarray(w))
    return q, {k: _t(v) for k, v in q.items()}, "float32"


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_lora_matmul_matches_jax(kind):
    rng = np.random.default_rng({"bf16": 0, "int8": 1, "int4": 2}[kind])
    jw, tw, dt = _base(kind, rng)
    r = 8
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    a = (rng.normal(size=(256, r)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(r, 128)) * 0.05).astype(np.float32)   # pre-scaled, as attached
    g = rng.normal(size=(2, 5, 128)).astype(np.float32)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    jx = jnp.asarray(x, jdt)

    def f(x, a, b):
        leaf = dict(jw) if isinstance(jw, dict) else {jax_quant.WKEY: jw}
        leaf.update({jax_quant.LORA_A: a, jax_quant.LORA_B: b})
        return jax_quant.matmul(x, leaf)

    want, vjp = jax.vjp(f, jx, jnp.asarray(a), jnp.asarray(b))
    wx, wa, wb = vjp(jnp.asarray(g, want.dtype))

    tx = _t(np.asarray(jx.astype(jnp.float32))).to(tdt).requires_grad_()
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    leaf = dict(tw) if isinstance(tw, dict) else {quant.WKEY: tw}
    leaf.update({quant.LORA_A: ta, quant.LORA_B: tb})
    got = quant.matmul(tx, leaf)
    assert got.dtype == tdt
    got.backward(_t(np.asarray(jnp.asarray(g, want.dtype).astype(jnp.float32))).to(tdt))

    def close(p, q, name):
        p, q = p.detach().float().numpy(), np.asarray(jnp.asarray(q).astype(jnp.float32))
        if kind == "bf16":
            np.testing.assert_allclose(p, q, rtol=0, atol=1e-2 * np.abs(q).max(), err_msg=name)
        else:
            np.testing.assert_allclose(p, q, **TOL, err_msg=name)

    close(got, want, "y")
    close(tx.grad, wx, "dx")
    close(ta.grad, wa, "da")
    close(tb.grad, wb, "db")


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_carries_a_gradient_to_x(bits):
    """The direct call: ``dx`` is the dequantized product, through the
    Function; without a gradient asked for, no Function (serving)."""
    g = torch.Generator().manual_seed(bits)
    w = torch.randn(256, 128, generator=g) * 0.05
    qw = quant.quantize_array(w) if bits == 8 else quant.quantize_array_int4(w)
    q, s = qw[quant.QKEY if bits == 8 else quant.Q4KEY], qw[quant.SKEY]
    fn = qm.matmul_int8 if bits == 8 else qm.matmul_int4
    x = torch.randn(6, 256, generator=g).requires_grad_()
    dy = torch.randn(6, 128, generator=g)
    n0 = fn.backward_calls
    y = fn(x, q, s)
    assert y.grad_fn is not None and "QuantMatmul" in type(y.grad_fn).__name__
    y.backward(dy)
    assert fn.backward_calls == n0 + 1
    wd = qm.dequantize(bits, q, s, torch.float32)
    torch.testing.assert_close(x.grad, dy @ wd.T, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y.detach(), x.detach() @ wd, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert fn(x, q, s).grad_fn is None
    assert fn(x.detach(), q, s).grad_fn is None


def _jax_lm_and_adapters(bits=None):
    jp = jax_llava.init_params(jax_tiny_config(), jax.random.PRNGKey(0), dtype=jnp.float32)
    jp = jax.tree.map(np.asarray, jp)
    cfg = jax_lora.LoraConfig(r=4, alpha=8)
    ad = jax_lora.init_lora_params(jp["language_model"], cfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    ad = {k: {"a": np.asarray(v["a"]), "b": (rng.normal(size=v["b"].shape) * 0.05).astype(
        np.float32)} for k, v in ad.items()}
    return jp, cfg, ad


def _port_adapters(ad):
    return {k: {n: _t(x) for n, x in v.items()} for k, v in ad.items()}


def test_apply_lora_lazy_equals_materialized():
    jp, jcfg, ad = _jax_lm_and_adapters()
    cfg = tiny_llava_config().text
    lm = from_numpy(jp, "cpu")["language_model"]
    lcfg = lora.LoraConfig(r=jcfg.r, alpha=jcfg.alpha)
    tad = _port_adapters(ad)
    ids = torch.as_tensor(np.random.default_rng(4).integers(3, 500, (2, 10)))
    lazy, _ = llama.forward(lora.apply_lora(lm, tad, lcfg), cfg, ids)
    merged, _ = llama.forward(lora.apply_lora(lm, tad, lcfg, materialize=True), cfg, ids)
    base, _ = llama.forward(lm, cfg, ids)
    torch.testing.assert_close(lazy, merged, rtol=1e-5, atol=1e-5)
    assert (lazy - base).abs().max() > 1e-3          # the adapters matter
    # the per-layer layout the trainer uses gives the same numbers
    from llava_plus_torch.models.convert import per_layer
    pl = per_layer({"language_model": lm})["language_model"]
    per, _ = llama.forward(lora.apply_lora(pl, lora.lora_per_layer(tad), lcfg), cfg, ids)
    torch.testing.assert_close(per, lazy, rtol=0, atol=0)
    # the base is shared, not copied, and keeps its bytes
    assert lora.apply_lora(lm, tad, lcfg)["embed_tokens"] is lm["embed_tokens"]


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_merge_matches_jax(bits):
    jp, jcfg, ad = _jax_lm_and_adapters()
    jparams = jax.tree.map(jnp.asarray, jp)
    tparams = from_numpy(jp, "cpu")
    if bits:
        jparams = jax_quant.quantize_llava_params(jparams, bits=bits)
        tparams = quant.quantize_llava_params(tparams, "llama", bits=bits)
    want = jax_lora.merge_lora_into_base(jparams, jax.tree.map(jnp.asarray, ad), jcfg)
    got = lora.merge_lora_into_base(tparams, _port_adapters(ad),
                                    lora.LoraConfig(r=jcfg.r, alpha=jcfg.alpha))
    for path in lora.LLAMA_TARGETS:
        w = want["language_model"]
        g = got["language_model"]
        for p in path:
            w, g = w[p], g[p]
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-7, err_msg="/".join(path))
        assert str(g.dtype)[6:] == str(w.dtype)


RUNS = {"lora": None, "qlora8": 8, "qlora4": 4}


@pytest.mark.parametrize("run", list(RUNS))
def test_lora_train_matches_jax_train(monkeypatch, corpus, tmp_path, run):  # noqa: F811
    bits = RUNS[run]
    seen = []
    real_jit = jax.jit

    def jit(fn, *args, **kwargs):
        compiled = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "lora_step":
            return compiled

        def run_step(*a):
            out = compiled(*a)
            seen.append({k: float(v) for k, v in out[2].items()})
            return out
        return run_step

    monkeypatch.setattr(jax, "jit", jit)
    data_path, img_dir = corpus
    kw = dict(per_device_train_batch_size=4, model_max_length=96, max_steps=3, save_steps=100,
              bf16=False, gradient_checkpointing=False, lora_enable=True, lora_r=4,
              lora_alpha=8, learning_rate=1e-2, bits=bits or 16)
    data = dict(data_path=str(data_path), image_folder=str(img_dir), image_aspect_ratio="pad")
    jax_train.train(jax_train.ModelArguments(tiny_debug_model=True, version="v1"),
                    jax_train.DataArguments(**data),
                    jax_train.TrainingArguments(output_dir=str(tmp_path / "jax"), dp=1,
                                                fsdp_axis=1, tp=1, **kw),
                    tokenizer=_tok())
    monkeypatch.setattr(jax, "jit", real_jit)
    assert len(seen) == 3

    jp = jax.tree.map(np.asarray, jax_llava.init_params(jax_tiny_config(), jax.random.PRNGKey(0),
                                                        dtype=jnp.float32))
    # JAX's initial adapters (PRNGKey(1), shapes of the base it was handed)
    jad = jax_lora.init_lora_params(jp["language_model"], jax_lora.LoraConfig(r=4, alpha=8),
                                    jax.random.PRNGKey(1))
    init = _port_adapters(jax.tree.map(np.asarray, jad))
    got, bases = [], []

    def init_lora(lm, cfg, generator):
        bases.append(lm)
        return init

    params, _ = port_train.train(
        port_train.ModelArguments(tiny_debug_model=True, version="v1"),
        port_train.DataArguments(**data),
        port_train.TrainingArguments(output_dir=str(tmp_path / "port"), device="cpu", **kw),
        tokenizer=_tok(),
        build_model=lambda m, dtype, device: (from_numpy(jp, device, dtype),
                                              tiny_llava_config(), None),
        init_lora=init_lora, on_step=lambda s, m, dt, a: got.append(m))
    assert len(got) == 3
    for i, (a, b) in enumerate(zip(got, seen)):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4, err_msg=f"step {i + 1}")
        assert a["tokens"] == b["tokens"] and a["accuracy"] == pytest.approx(b["accuracy"])
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    assert len({round(m["loss"], 6) for m in got}) == 3          # the adapters moved
    # the base the adapters were made on: quantized with --bits, before them
    wq = bases[0]["layers"]["attn"]["wq"]
    assert quant.is_quantized(wq) == bool(bits)
    if bits:
        assert (quant.Q4KEY in wq) == (bits == 4)
    # only the adapters trained: the base and the projector keep their bytes
    final = to_numpy(params)
    np.testing.assert_array_equal(final["mm_projector"]["layers"][0]["w"],
                                  jp["mm_projector"]["layers"][0]["w"])
    np.testing.assert_array_equal(final["language_model"]["embed_tokens"],
                                  jp["language_model"]["embed_tokens"])
    # the saves: the same files; the adapters within the steps' tolerance (an
    # element whose gradient is near 0 moves by up to lr a step, in a
    # direction the f32 summation order decides: 1% of the 3 steps' lr)
    from safetensors.numpy import load_file
    for name in ("adapter_config.json", "non_lora_trainables.bin", "config.json"):
        assert (tmp_path / "port" / name).exists() and (tmp_path / "jax" / name).exists()
    assert not list((tmp_path / "port").glob("checkpoint-*"))
    want_sd = load_file(str(tmp_path / "jax" / "adapter_model.safetensors"))
    got_sd = load_file(str(tmp_path / "port" / "adapter_model.safetensors"))
    assert sorted(got_sd) == sorted(want_sd)
    for k in want_sd:
        np.testing.assert_allclose(got_sd[k], want_sd[k], rtol=1e-4,
                                   atol=1e-2 * 3 * kw["learning_rate"], err_msg=k)
    proj_j = torch.load(tmp_path / "jax" / "non_lora_trainables.bin", weights_only=True)
    proj_t = torch.load(tmp_path / "port" / "non_lora_trainables.bin", weights_only=True)
    assert sorted(proj_t) == sorted(proj_j)
    for k in proj_j:
        torch.testing.assert_close(proj_t[k], proj_j[k], rtol=0, atol=0)


def _hf_llama(cfg):
    import transformers

    t = cfg.text
    hf = transformers.LlamaConfig(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                                  intermediate_size=t.intermediate_size,
                                  num_hidden_layers=t.num_hidden_layers,
                                  num_attention_heads=t.num_attention_heads,
                                  num_key_value_heads=t.num_key_value_heads)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(hf)


def _peft_llama(cfg, r, alpha):
    from peft import LoraConfig, get_peft_model

    return get_peft_model(_hf_llama(cfg), LoraConfig(
        r=r, lora_alpha=alpha, lora_dropout=0.0,
        target_modules=["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                        "down_proj"]))


def test_peft_round_trip(tmp_path):
    from peft import PeftModel, get_peft_model_state_dict

    cfg = tiny_llava_config()
    L = cfg.text.num_hidden_layers
    _, jcfg, ad = _jax_lm_and_adapters()
    lcfg = lora.LoraConfig(r=jcfg.r, alpha=jcfg.alpha)
    tad = _port_adapters(ad)

    # the port's save, loaded by peft
    lora.save_peft_adapter(tad, lcfg, tmp_path / "port")
    model = PeftModel.from_pretrained(_hf_llama(cfg), str(tmp_path / "port"))
    sd = get_peft_model_state_dict(model)
    assert len(sd) == 2 * 7 * L
    for k, (a, b) in [(k, (v["a"], v["b"])) for k, v in tad.items()]:
        proj = {"/".join(p): n for n, p in lora._PEFT_NAME_MAP.items()}[k]
        block = "self_attn" if "attn" in k else "mlp"
        for i in range(L):
            pre = f"base_model.model.model.layers.{i}.{block}.{proj}"
            torch.testing.assert_close(sd[f"{pre}.lora_A.weight"], a[i].T, rtol=0, atol=0)
            torch.testing.assert_close(sd[f"{pre}.lora_B.weight"], b[i].T, rtol=0, atol=0)
    assert model.peft_config["default"].lora_alpha == lcfg.alpha

    # what peft saves, read by the port
    pm = _peft_llama(cfg, 4, 8)
    with torch.no_grad():
        for name, p in pm.named_parameters():
            if "lora_B" in name:
                p.normal_(0, 0.02)
    pm.save_pretrained(str(tmp_path / "peft"))
    got, got_cfg = lora.load_peft_adapter(tmp_path / "peft", L)
    assert (got_cfg.r, got_cfg.alpha) == (4, 8)
    psd = get_peft_model_state_dict(pm)
    assert sorted(got) == sorted("/".join(p) for p in lora.LLAMA_TARGETS)
    for k, ab in got.items():
        proj = {"/".join(p): n for n, p in lora._PEFT_NAME_MAP.items()}[k]
        block = "self_attn" if "attn" in k else "mlp"
        for i in range(L):
            pre = f"base_model.model.model.layers.{i}.{block}.{proj}"
            torch.testing.assert_close(ab["a"][i], psd[f"{pre}.lora_A.weight"].T, rtol=0, atol=0)
            torch.testing.assert_close(ab["b"][i], psd[f"{pre}.lora_B.weight"].T, rtol=0, atol=0)
    # and the JAX package reads the same directory to the same numbers
    want, _ = jax_lora.load_peft_adapter(tmp_path / "peft", L)
    for k in want:
        np.testing.assert_array_equal(got[k]["a"].numpy(), want[k]["a"])
        np.testing.assert_array_equal(got[k]["b"].numpy(), want[k]["b"])
