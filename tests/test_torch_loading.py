"""The port's checkpoint loading against the JAX package's, on the CPU.

``models/hf_import.py`` (state-dict readers, the LLaMA / MPT / CLIP /
projector key maps, the config parsers), ``models/builder.py``'s four load
paths (full LLaVA on either backbone, base + ``mm_projector.bin``, LoRA +
base with a JAX-written and a ``peft``-written adapter, plain LM),
``train/lora.merge_lora_checkpoint``, ``models/utils.py`` and the delta
CLIs. Checkpoints are written in ``tmp_path`` from random tiny weights, by
the port's exporter or by transformers' ``save_pretrained``; both packages
read the same files. Trees must be equal leaf for leaf, exactly (compared as
f32); logits of the loaded models match the JAX package's at ``atol=1e-5,
rtol=1e-4`` (the tolerance of ``test_torch_llava.py``) and HF's
``LlamaForCausalLM`` / ``MptForCausalLM`` at the tolerances of
``tests/test_llama_parity.py`` / ``test_mpt_parity.py``."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu import mm_utils as jax_mm_utils
from llava_plus_tpu.models import builder as jax_builder
from llava_plus_tpu.models import hf_import as jax_hf
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models import utils as jax_utils
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_tpu.models.configs import tiny_llava_mpt_config as jax_tiny_mpt_config
from llava_plus_tpu.train import lora as jax_lora
from llava_plus_torch import mm_utils
from llava_plus_torch.models import builder, hf_import, llama, llava, mpt
from llava_plus_torch.models import utils as port_utils
from llava_plus_torch.models.configs import LlavaConfig, tiny_llava_config, tiny_llava_mpt_config
from llava_plus_torch.models.convert import from_numpy
from llava_plus_torch.train import checkpoint as ckpt
from llava_plus_torch.train import lora

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)


# -- helpers ---------------------------------------------------------------

def _flat(tree, prefix=""):
    """{path: f32 numpy} of a tree of numpy arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


# The LoRA targets after a merge: ``W + (alpha / r) * a @ b`` sums r f32
# products in another order than XLA's einsum, so these leaves hold to the
# tolerance of ``test_torch_lora.py::test_merge_matches_jax`` (one f32 ulp
# of the delta), and after a bf16 cast to one bf16 ulp.
MERGED = tuple("/language_model/" + "/".join(p) for p in lora.LLAMA_TARGETS)


def assert_trees_equal(port_tree, jax_tree, skip=(), merged=()):
    """Same paths, shapes and dtypes, and every value equal as f32 (paths
    under ``skip``: shapes and dtypes only; under ``merged``: LoRA-merged
    leaves, see ``MERGED``)."""
    got, want = _flat(port_tree), _flat(jax_tree)
    assert sorted(got) == sorted(want)
    dt_port = {p: _dtype_name(x) for p, x in _leaves(port_tree)}
    for path in got:
        assert got[path].shape == want[path].shape, path
        if path.startswith(tuple(skip)):
            continue
        if path.startswith(tuple(merged)):
            rtol = 2 ** -8 if dt_port[path] == "bfloat16" else 1e-6
            np.testing.assert_allclose(got[path], want[path], rtol=rtol, atol=1e-7,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert dt_port == {p: str(np.asarray(x).dtype) for p, x in _leaves(jax_tree)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _jax_init(cfg, seed=0):
    return jax.tree.map(np.asarray, jax_llava.init_params(cfg, jax.random.PRNGKey(seed),
                                                          dtype=jnp.float32))


def _export(jparams, port_cfg, path):
    """A full LLaVA checkpoint written by the port's exporter."""
    ckpt.export_hf_llava(from_numpy(jparams, "cpu"), port_cfg, path)
    return path


def _hf_llama(seed=0, **kw):
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM

    torch.manual_seed(seed)
    cfg = HFConfig(**{**dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                             num_hidden_layers=2, num_attention_heads=4,
                             num_key_value_heads=2, max_position_embeddings=512,
                             rms_norm_eps=1e-5, attention_bias=False,
                             tie_word_embeddings=False), **kw})
    return LlamaForCausalLM(cfg).eval()


def _hf_mpt(seed=0):
    from transformers import MptConfig as HFConfig
    from transformers import MptForCausalLM

    torch.manual_seed(seed)
    cfg = HFConfig(d_model=64, n_heads=4, n_layers=2, expansion_ratio=2, max_seq_len=128,
                   vocab_size=128,
                   attn_config={"attn_impl": "torch", "alibi": True, "alibi_bias_max": 8})
    return MptForCausalLM(cfg).eval()


def _both_load(path, base=None, dtype="float32"):
    """(port result, JAX result) of ``load_pretrained_model``."""
    got = builder.load_pretrained_model(str(path), None if base is None else str(base),
                                        dtype=dtype)
    want = jax_builder.load_pretrained_model(str(path), None if base is None else str(base),
                                             dtype=dtype)
    return got, want


def _assert_same_load(got, want, skip=(), merged=()):
    tok, params, cfg, proc, ctx = got
    jtok, jparams, jcfg, jproc, jctx = want
    assert_trees_equal(params, jax.tree.map(np.asarray, jparams), skip=skip, merged=merged)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert ctx == jctx
    assert type(tok).__name__ == type(jtok).__name__
    assert getattr(tok, "vocab_size", None) == getattr(jtok, "vocab_size", None)
    if jproc is None:
        assert proc is None
    else:
        assert (proc.shortest_edge, proc.crop_size) == (jproc.shortest_edge, jproc.crop_size)


def _llava_logits_both(params, jparams, cfg, jcfg):
    """Logits of one multimodal batch through both packages' forward."""
    from llava_plus_tpu.models.llava import MultimodalBatch as JBatch
    from llava_plus_torch.models.llava import MultimodalBatch

    rng = np.random.default_rng(0)
    P, S = cfg.num_image_tokens, cfg.vision.image_size
    T = P + 12
    vocab = cfg.mpt.vocab_size if cfg.language_model_type == "mpt" else cfg.text.vocab_size
    arrays = dict(
        tokens=rng.integers(3, vocab, size=(1, T)).astype(np.int32),
        positions=np.arange(T, dtype=np.int32)[None],
        segment_ids=np.ones((1, T), np.int32),
        images=rng.normal(size=(1, 1, S, S, 3)).astype(np.float32),
        image_pos=(np.arange(P, dtype=np.int32) + 2)[None],
    )
    want, _ = jax_llava.forward(jparams, jcfg, JBatch(**{k: jnp.asarray(v)
                                                         for k, v in arrays.items()}))
    with torch.no_grad():
        got, _ = llava.forward(params, cfg, MultimodalBatch(
            **{k: torch.from_numpy(v) for k, v in arrays.items()}))
    return got.numpy(), np.asarray(want)


# -- state-dict readers ----------------------------------------------------

def _state_dict(dtype):
    g = torch.Generator().manual_seed(0)
    return {f"model.layers.{i}.w{j}": torch.randn(5, 7, generator=g).to(dtype)
            for i in range(3) for j in range(2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["safetensors_shards", "bin_shards"])
def test_load_state_dict_dir_matches_jax(tmp_path, fmt, dtype):
    """Sharded ``model-0000x-of-00003.safetensors`` with their index, and
    ``pytorch_model-0000x-of-00003.bin`` shards: the same keys and values."""
    sd = _state_dict(dtype)
    keys = sorted(sd)
    index = {}
    for s in range(3):
        part = {k: sd[k] for k in keys[s::3]}
        if fmt == "safetensors_shards":
            from safetensors.torch import save_file

            name = f"model-{s + 1:05d}-of-00003.safetensors"
            save_file(part, str(tmp_path / name))
        else:
            name = f"pytorch_model-{s + 1:05d}-of-00003.bin"
            torch.save(part, str(tmp_path / name))
        index.update({k: name for k in part})
    index_name = ("model.safetensors.index.json" if fmt == "safetensors_shards"
                  else "pytorch_model.bin.index.json")
    (tmp_path / index_name).write_text(json.dumps({"weight_map": index}))
    got = hf_import.load_state_dict_dir(tmp_path)
    want = jax_hf.load_state_dict_dir(tmp_path)
    assert sorted(got) == sorted(want) == keys
    for k in keys:
        assert got[k].dtype == dtype
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32), err_msg=k)
    assert hf_import.strip_prefix(got, "model.layers.1.").keys() == {"w0", "w1"}


# -- config parsers ----------------------------------------------------------

LLAVA_15_7B_CONFIG = {
    "_name_or_path": "./checkpoints/vicuna-7b-v1-5", "architectures": ["LlavaLlamaForCausalLM"],
    "bos_token_id": 1, "eos_token_id": 2, "freeze_mm_mlp_adapter": False,
    "hidden_act": "silu", "hidden_size": 4096, "image_aspect_ratio": "pad",
    "initializer_range": 0.02, "intermediate_size": 11008, "max_length": 4096,
    "max_position_embeddings": 4096, "mm_hidden_size": 1024, "mm_projector_type": "mlp2x_gelu",
    "mm_use_im_patch_token": False, "mm_use_im_start_end": False,
    "mm_vision_select_feature": "patch", "mm_vision_select_layer": -2,
    "mm_vision_tower": "openai/clip-vit-large-patch14-336", "model_type": "llava",
    "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 32,
    "pad_token_id": 0, "pretraining_tp": 1, "rms_norm_eps": 1e-05, "rope_scaling": None,
    "tie_word_embeddings": False, "tokenizer_model_max_length": 2048, "torch_dtype": "float16",
    "tune_mm_mlp_adapter": False, "use_cache": True, "use_mm_proj": True, "vocab_size": 32000,
}
LLAVA_MPT_CONFIG = {
    "architectures": ["LlavaMPTForCausalLM"], "model_type": "llava_mpt", "d_model": 4096,
    "n_layers": 32, "n_heads": 32, "expansion_ratio": 4, "max_seq_len": 2048,
    "vocab_size": 50432, "no_bias": True, "learned_pos_emb": True, "logit_scale": None,
    "attn_config": {"alibi": True, "alibi_bias_max": 8, "attn_impl": "torch",
                    "attn_type": "multihead_attention", "clip_qkv": None, "qk_ln": False,
                    "prefix_lm": False, "attn_uses_sequence_id": False,
                    "softmax_scale": None},
    "mm_vision_tower": "openai/clip-vit-large-patch14", "mm_hidden_size": 1024,
    "mm_use_im_start_end": True, "mm_vision_select_layer": -2,
    "tokenizer_model_max_length": 2048,
}
CONFIGS = {
    "llava_15_7b": LLAVA_15_7B_CONFIG,
    "llava_mpt": LLAVA_MPT_CONFIG,
    "mpt_multiquery": dict(LLAVA_MPT_CONFIG, attn_config={"attn_type": "multiquery_attention",
                                                          "alibi": True}),
    "rope_linear": dict(LLAVA_15_7B_CONFIG, rope_scaling={"type": "linear", "factor": 4.0}),
    "rope_dynamic": dict(LLAVA_15_7B_CONFIG,
                         rope_scaling={"rope_type": "dynamic", "factor": 2.0}),
    "rope_unsupported": dict(LLAVA_15_7B_CONFIG,
                             rope_scaling={"rope_type": "llama3", "factor": 8.0}),
    "tokenizer_max_length": dict(LLAVA_15_7B_CONFIG, tokenizer_model_max_length=4096),
    "mm_vision_config": dict(LLAVA_15_7B_CONFIG, mm_vision_config=dataclasses.asdict(
        tiny_llava_config().vision)),
    "no_tower_name": {k: v for k, v in LLAVA_15_7B_CONFIG.items() if k != "mm_vision_tower"},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_parsers_match_jax(tmp_path, name):
    d = CONFIGS[name]
    (tmp_path / "config.json").write_text(json.dumps(d))
    if name == "rope_unsupported":
        with pytest.warns(UserWarning, match="llama3"):
            got = hf_import.llava_config_from_hf_dir(tmp_path)
        with pytest.warns(UserWarning, match="llama3"):
            want = jax_hf.llava_config_from_hf_dir(tmp_path)
    else:
        got = hf_import.llava_config_from_hf_dir(tmp_path)
        want = jax_hf.llava_config_from_hf_dir(tmp_path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if "d_model" in d:
        assert (dataclasses.asdict(hf_import.mpt_config_from_hf(d))
                == dataclasses.asdict(jax_hf.mpt_config_from_hf(d)))
    else:
        assert (dataclasses.asdict(hf_import.llama_config_from_hf(d))
                == dataclasses.asdict(jax_hf.llama_config_from_hf(d)))
    assert builder._context_len(tmp_path) == jax_builder._context_len(tmp_path)


def test_clip_config_parser_matches_jax():
    from transformers import CLIPConfig, CLIPVisionConfig

    for d in (CLIPConfig().to_dict(), CLIPVisionConfig(image_size=336).to_dict()):
        assert (dataclasses.asdict(hf_import.clip_config_from_hf(d))
                == dataclasses.asdict(jax_hf.clip_config_from_hf(d)))


# -- the four load paths -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama", "mpt"])
def test_full_llava_checkpoint_matches_jax(tmp_path, arch, dtype):
    """Path 3: one directory with everything (the port's export of the JAX
    package's tiny init); f32 loads also give the JAX package's logits."""
    mpt_arch = arch == "mpt"
    jcfg = jax_tiny_mpt_config() if mpt_arch else jax_tiny_config()
    cfg = tiny_llava_mpt_config() if mpt_arch else tiny_llava_config()
    jp = _jax_init(jcfg)
    path = _export(jp, cfg, tmp_path / f"llava-tiny-{arch}")
    got, want = _both_load(path, dtype=dtype)
    _assert_same_load(got, want)
    assert got[0].__class__.__name__ == "DebugTokenizer"
    if dtype == "float32":
        logits, jlogits = _llava_logits_both(got[1], want[1], got[2], want[2])
        np.testing.assert_allclose(logits, jlogits, **TOL)
        # and the loaded tree is the exported one
        assert_trees_equal(got[1], jp)


def test_full_checkpoint_without_tower_keys_fails_as_in_jax(tmp_path):
    jp = _jax_init(jax_tiny_config())
    no_tower = dict(jp, vision_tower={})
    _export(no_tower, tiny_llava_config(), tmp_path / "llava-no-tower")
    with pytest.raises(KeyError):
        jax_builder.load_pretrained_model(str(tmp_path / "llava-no-tower"))
    with pytest.raises(KeyError):
        builder.load_pretrained_model(str(tmp_path / "llava-no-tower"))


def _stage1_dir(tmp_path, jp):
    """A stage-1 output: config.json with the projector's settings and a
    ``mm_projector.bin``; its tower is named, not present."""
    out = tmp_path / "llava-stage1"
    ckpt.export_mm_projector_bin(from_numpy(jp, "cpu"), out / "mm_projector.bin")
    (out / "config.json").write_text(json.dumps({
        "mm_projector_type": "mlp2x_gelu", "mm_hidden_size": 32,
        "image_aspect_ratio": "pad",
        "mm_vision_tower": str(tmp_path / "no-such-tower")}))
    return out


@pytest.fixture(scope="module")
def hf_base(tmp_path_factory):
    """A plain LLaMA (HF ``save_pretrained``): the base of paths 1 and 2,
    and path 4 itself."""
    path = tmp_path_factory.mktemp("base") / "vicuna-tiny"
    model = _hf_llama()
    model.save_pretrained(str(path))
    return path, model


def test_base_plus_projector_matches_jax(tmp_path, hf_base):
    """Path 2: the base LM, the projector from ``mm_projector.bin``; the
    named tower is missing, so both packages make it random (CLIP-L/336,
    the config's default) with a warning: shapes and dtypes only there."""
    base, _ = hf_base
    jp = _jax_init(jax_tiny_config(hidden_size=64))
    path = _stage1_dir(tmp_path, jp)
    with pytest.warns(UserWarning, match="not found locally"):
        got = builder.load_pretrained_model(str(path), str(base), dtype="bfloat16")
    want = jax_builder.load_pretrained_model(str(path), str(base), dtype="bfloat16")
    _assert_same_load(got, want, skip=("/vision_tower",))
    np.testing.assert_array_equal(
        got[1]["mm_projector"]["layers"][0]["w"].float().numpy(),
        np.asarray(jnp.asarray(jp["mm_projector"]["layers"][0]["w"], jnp.bfloat16),
                   np.float32))


def _jax_adapter_dir(tmp_path, jp, hf_base_model):
    """A LoRA output as the JAX trainer writes it: ``adapter_config.json``
    naming the JAX leaves (wq, ...), the adapters, the projector as
    ``non_lora_trainables.bin`` and the nested ``LlavaConfig``."""
    from llava_plus_tpu.models.configs import LlamaConfig as JLlama

    out = tmp_path / "llava-lora-jax"
    rng = np.random.default_rng(3)
    text = hf_import.llama_config_from_hf(hf_base_model.config.to_dict())
    L = text.num_hidden_layers
    adapters = {}
    for path in jax_lora.LLAMA_TARGETS:
        w = jp["language_model"]
        for p in path:
            w = w[p]
        _, d_in, d_out = w.shape
        adapters["/".join(path)] = {
            "a": (rng.normal(size=(L, d_in, 4)) * 0.1).astype(np.float32),
            "b": (rng.normal(size=(L, 4, d_out)) * 0.1).astype(np.float32)}
    from llava_plus_tpu.train import checkpoint as jax_ckpt

    extra = jax_ckpt.projector_state_dict_from_params(jp["mm_projector"])
    jax_lora.save_peft_adapter(adapters, jax_lora.LoraConfig(r=4, alpha=8), out,
                               extra_trainables={"base_model.model." + k: v
                                                 for k, v in extra.items()})
    jcfg = dataclasses.replace(jax_tiny_config(), text=JLlama(**dataclasses.asdict(text)))
    jcfg.save(out / "config.json")
    assert "wq" in json.loads((out / "adapter_config.json").read_text())["target_modules"]
    return out


def _peft_adapter_dir(tmp_path, jp, hf_base_model):
    """A LoRA output as ``peft`` writes it (HF module names), with the
    projector's ``non_lora_trainables.bin`` and a flat HF config."""
    from peft import LoraConfig as PeftLoraConfig
    from peft import get_peft_model

    out = tmp_path / "llava-lora-peft"
    model = get_peft_model(_hf_llama(), PeftLoraConfig(
        r=4, lora_alpha=8, lora_dropout=0.0,
        target_modules=["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                        "down_proj"]))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "lora_B" in name:
                p.normal_(0, 0.1, generator=torch.Generator().manual_seed(len(name)))
    model.save_pretrained(str(out))
    sd = ckpt.projector_state_dict_from_params(from_numpy(jp, "cpu")["mm_projector"])
    torch.save({"base_model.model." + k: v for k, v in sd.items()},
               str(out / "non_lora_trainables.bin"))
    d = hf_base_model.config.to_dict()
    d.update(mm_projector_type="mlp2x_gelu", mm_hidden_size=32, image_aspect_ratio="pad",
             mm_vision_tower=str(tmp_path / "no-such-tower"))
    (out / "config.json").write_text(json.dumps(d))
    assert "q_proj" in json.loads((out / "adapter_config.json").read_text())["target_modules"]
    return out


@pytest.mark.parametrize("writer", ["jax", "peft"])
def test_lora_checkpoint_matches_jax(tmp_path, hf_base, writer):
    """Path 1: the adapters merged into the base (``merge_lora_checkpoint``),
    the projector from ``non_lora_trainables.bin``; the tower is random in
    both packages (no local tower): shapes and dtypes only there."""
    base, model = hf_base
    jp = _jax_init(jax_tiny_config(hidden_size=64))
    make = _jax_adapter_dir if writer == "jax" else _peft_adapter_dir
    path = make(tmp_path, jp, model)
    dtype = "float32" if writer == "jax" else "bfloat16"   # the flat config's tower is CLIP-L
    with pytest.warns(UserWarning, match="not found locally"):
        got = builder.load_pretrained_model(str(path), str(base), dtype=dtype)
    want = jax_builder.load_pretrained_model(str(path), str(base), dtype=dtype)
    _assert_same_load(got, want, skip=("/vision_tower",), merged=MERGED)
    # the merge changed every target
    sd = {k: v.float() for k, v in model.state_dict().items()}
    merged = got[1]["language_model"]["layers"]["attn"]["wq"][0].float()
    assert not torch.equal(merged, sd["model.layers.0.self_attn.q_proj.weight"].T)


def test_plain_lm_matches_jax_and_hf(hf_base):
    """Path 4: a text-only LLaMA (no tower, no projector, no processor);
    its logits match the JAX package's and HF's."""
    base, model = hf_base
    got, want = _both_load(base)
    _assert_same_load(got, want)
    params, cfg = got[1], got[2]
    assert cfg.mm_projector_type == "identity" and got[3] is None
    ids = np.random.default_rng(0).integers(0, 512, size=(2, 9))
    with torch.no_grad():
        ours, _ = llama.forward(params["language_model"], cfg.text, torch.from_numpy(ids))
        ref = model(torch.from_numpy(ids)).logits.numpy()
    from llava_plus_tpu.models import llama as jax_llama

    theirs, _ = jax_llama.forward(want[1]["language_model"], want[2].text, jnp.asarray(ids),
                                  attn_impl="xla")
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=2e-3)


# -- HF parity ---------------------------------------------------------------------

@pytest.mark.parametrize("rope", [None, {"type": "linear", "factor": 2.0}])
def test_llama_logits_match_hf_llama(tmp_path, rope):
    """The port's LLaMA on weights that ``LlamaForCausalLM.save_pretrained``
    wrote, against HF's logits (with linear rope scaling past the trained
    context too)."""
    kw = {} if rope is None else dict(max_position_embeddings=16, rope_scaling=rope)
    model = _hf_llama(seed=1, **kw)
    model.save_pretrained(str(tmp_path))
    cfg = hf_import.llama_config_from_hf(json.loads((tmp_path / "config.json").read_text()))
    params = hf_import.llama_params_from_state_dict(hf_import.load_state_dict_dir(tmp_path),
                                                    cfg, dtype="float32")
    ids = np.random.default_rng(2).integers(0, 512, size=(2, 24))
    with torch.no_grad():
        ours, _ = llama.forward(params, cfg, torch.from_numpy(ids))
        ref = model(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-4, rtol=2e-3)


def test_mpt_logits_match_hf_mpt(tmp_path):
    model = _hf_mpt()
    model.save_pretrained(str(tmp_path))
    cfg = hf_import.mpt_config_from_hf(json.loads((tmp_path / "config.json").read_text()))
    params = hf_import.mpt_params_from_state_dict(hf_import.load_state_dict_dir(tmp_path),
                                                  cfg, dtype="float32")
    ids = np.random.default_rng(0).integers(0, 128, size=(2, 7))
    with torch.no_grad():
        ours, _ = mpt.forward(params, cfg, torch.from_numpy(ids))
        ref = model(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(ours.numpy(), ref, atol=3e-4, rtol=2e-3)


# -- the tower, tokenizer files, names -----------------------------------------------

def test_local_vision_tower_matches_jax(tmp_path):
    """A CLIP tower that ``mm_vision_tower`` names as a local directory
    (``CLIPVisionModel.save_pretrained``) loads as in the JAX package."""
    from transformers import CLIPVisionConfig, CLIPVisionModel

    vis = tiny_llava_config().vision
    torch.manual_seed(0)
    CLIPVisionModel(CLIPVisionConfig(
        hidden_size=vis.hidden_size, intermediate_size=vis.intermediate_size,
        num_hidden_layers=vis.num_hidden_layers, num_attention_heads=vis.num_attention_heads,
        image_size=vis.image_size, patch_size=vis.patch_size)).save_pretrained(
            str(tmp_path / "tower"))
    d = {"mm_vision_tower": str(tmp_path / "tower")}
    got = builder._load_vision_tower(d, tiny_llava_config(), "float32")
    want = jax_builder._load_vision_tower(d, jax_tiny_config(), "float32")
    assert_trees_equal(got, want)


def test_random_tower_fallback_is_seeded_and_warns():
    cfg = tiny_llava_config()
    with pytest.warns(UserWarning, match="not found locally"):
        a = builder._load_vision_tower({"mm_vision_tower": "/no/such/tower"}, cfg, "float32")
    with pytest.warns(UserWarning):
        b = builder._load_vision_tower({}, cfg, "float32")
    for (pa, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y), pa


def _fast_tokenizer(path):
    """A word-level fast tokenizer written with ``save_pretrained`` (no
    download): the directory then has tokenizer files."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {w: i for i, w in enumerate(["<unk>", "<s>", "</s>", "a", "cat", "on", "mat"])}
    core = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    core.pre_tokenizer = pre_tokenizers.Whitespace()
    tok = PreTrainedTokenizerFast(tokenizer_object=core, unk_token="<unk>", bos_token="<s>",
                                  eos_token="</s>")
    tok.save_pretrained(str(path))
    return tok


def test_tokenizer_files_load_through_transformers(tmp_path):
    jp = _jax_init(jax_tiny_config())
    path = _export(jp, tiny_llava_config(), tmp_path / "llava-tok")
    _fast_tokenizer(path)
    got, want = builder.load_tokenizer(str(path)), jax_builder.load_tokenizer(str(path))
    assert type(got) is type(want) and type(got).__name__ != "DebugTokenizer"
    assert got("a cat on a mat").input_ids == want("a cat on a mat").input_ids


@pytest.mark.parametrize("path", ["/x/llava-v1.5-7b", "/x/llava-v1.5-7b/",
                                  "runs/llava-lora/checkpoint-1200", "vicuna"])
def test_model_name_from_path_matches_jax(path):
    assert mm_utils.get_model_name_from_path(path) == jax_mm_utils.get_model_name_from_path(path)


# -- LoRA merge alone ---------------------------------------------------------------

def test_merge_lora_checkpoint_matches_jax_without_the_builder(tmp_path, hf_base):
    base, model = hf_base
    jp = _jax_init(jax_tiny_config(hidden_size=64))
    path = _jax_adapter_dir(tmp_path, jp, model)
    with pytest.warns(UserWarning):
        tok, params, cfg = lora.merge_lora_checkpoint(path, base, "float32")
    jtok, jparams, jcfg = jax_lora.merge_lora_checkpoint(path, base, "float32")
    assert_trees_equal(params, jax.tree.map(np.asarray, jparams), skip=("/vision_tower",),
                       merged=MERGED)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


# -- models/utils and the delta CLIs --------------------------------------------------

def test_resize_and_vision_tokenizer_match_jax(tmp_path):
    jp = _jax_init(jax_tiny_config())["language_model"]
    tp = from_numpy(jp, "cpu")
    for n in (300, 512, 513, 600):
        got = port_utils.resize_token_embeddings(tp, n)
        want = jax_utils.resize_token_embeddings(jax.tree.map(jnp.asarray, jp), n)
        for k in ("embed_tokens", "lm_head"):
            assert tuple(got[k].shape) == tuple(want[k].shape), (n, k)
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{n} {k}")
    for flags in (dict(mm_use_im_patch_token=True), dict(mm_use_im_start_end=True),
                  dict(mm_use_im_patch_token=True, mm_use_im_start_end=True), {}):
        tok, jtok = _fast_tokenizer(tmp_path / "a"), _fast_tokenizer(tmp_path / "b")
        got, n_got = port_utils.initialize_vision_tokenizer(tp, tok, **flags)
        want, n_want = jax_utils.initialize_vision_tokenizer(jax.tree.map(jnp.asarray, jp),
                                                             jtok, **flags)
        assert n_got == n_want and len(tok) == len(jtok)
        assert tuple(got["embed_tokens"].shape) == tuple(want["embed_tokens"].shape)


def test_auto_upgrade_matches_jax(tmp_path):
    for d in ({"_name_or_path": "liuhaotian/llava-13b-v0", "model_type": "llama"},
              {"_name_or_path": "vicuna", "model_type": "llama"}):
        for sub, fn in (("port", port_utils.auto_upgrade), ("jax", jax_utils.auto_upgrade)):
            (tmp_path / sub).mkdir(exist_ok=True)
            (tmp_path / sub / "config.json").write_text(json.dumps(d))
            fn(tmp_path / sub)
        assert ((tmp_path / "port" / "config.json").read_text()
                == (tmp_path / "jax" / "config.json").read_text())


def _safetensors(path):
    from safetensors.torch import load_file

    return load_file(str(path / "model.safetensors"))


def test_consolidate_and_delta_clis_match_jax(tmp_path, monkeypatch):
    """``consolidate_ckpt``, ``make_delta`` and ``apply_delta`` on the same
    files as the JAX package's CLIs: every tensor equal but
    ``lm_head.weight``, which the JAX exporter writes from a transposed
    view's raw buffer (ROADMAP Queue 3); the round trip gives the target
    back."""
    import sys

    from llava_plus_tpu.models import apply_delta as jax_apply
    from llava_plus_tpu.models import make_delta as jax_make
    from llava_plus_torch.models import apply_delta, make_delta

    cfg = tiny_llava_config()
    base = _export(_jax_init(jax_tiny_config(), seed=1), cfg, tmp_path / "llava-base")
    target = _export(_jax_init(jax_tiny_config(), seed=2), cfg, tmp_path / "llava-target")

    def run_jax(mod, argv):
        monkeypatch.setattr(sys, "argv", ["x", *argv])
        mod.main()

    port_utils.main(["--src", str(target), "--dst", str(tmp_path / "llava-cons-port")])
    run_jax(jax_utils, ["--src", str(target), "--dst", str(tmp_path / "llava-cons-jax")])
    make_delta.main(["--base", str(base), "--target", str(target),
                     "--delta", str(tmp_path / "llava-delta-port")])
    run_jax(jax_make, ["--base", str(base), "--target", str(target),
                       "--delta", str(tmp_path / "llava-delta-jax")])
    apply_delta.main(["--base", str(base), "--delta", str(tmp_path / "llava-delta-port"),
                      "--target", str(tmp_path / "llava-back-port")])
    run_jax(jax_apply, ["--base", str(base), "--delta", str(tmp_path / "llava-delta-jax"),
                        "--target", str(tmp_path / "llava-back-jax")])
    for kind in ("cons", "delta", "back"):
        mine = _safetensors(tmp_path / f"llava-{kind}-port")
        theirs = _safetensors(tmp_path / f"llava-{kind}-jax")
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            if k != "lm_head.weight":
                assert torch.equal(mine[k], theirs[k]), (kind, k)
        assert ((tmp_path / f"llava-{kind}-port" / "config.json").read_text()
                == (tmp_path / f"llava-{kind}-jax" / "config.json").read_text())
    # both packages' CLIs load the f32 delta as bf16, so the round trip
    # gives the target back to within that rounding
    back = _flat(builder.load_pretrained_model(str(tmp_path / "llava-back-port"))[1])
    want = _flat(builder.load_pretrained_model(str(target))[1])
    for k in want:
        np.testing.assert_allclose(back[k], want[k], rtol=0, atol=1e-3, err_msg=k)


def test_loaded_tree_serves_with_llava_config_default_dtype(tmp_path):
    """The default load is bf16 host tensors (the caller moves them)."""
    jp = _jax_init(jax_tiny_config())
    path = _export(jp, tiny_llava_config(), tmp_path / "llava-tiny")
    _, params, cfg, _, _ = builder.load_pretrained_model(str(path))
    assert isinstance(cfg, LlavaConfig)
    assert {x.dtype for _, x in _leaves(params)} == {torch.bfloat16}
    assert {x.device.type for _, x in _leaves(params)} == {"cpu"}
