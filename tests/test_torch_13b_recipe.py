"""LLaVA-1.5-13B's recipe chain from a base language model, on the CPU, at
13B's head count and FFN ratio (40 heads of 8, hidden 320, FFN 864, 3
layers, as ``tests/test_torch_13b.py``).

B is a plain HF LLaMA directory and V an HF CLIP tower directory whose own
``image_size`` is 42 (9 image tokens), so the trainer must size the tower
and its image processor from V's config, as it must for CLIP-L/336. Both
are written as ``chip_smoke.py`` phase 28 writes B13 and V336
(``_write_base``, ``_write_tower``: a state dict streamed into one
safetensors file) from random weights. Both run through the port's ``train.main`` with the
launchers' flags (``chip_smoke._script_argv``, f32 on the CPU):

(a) ``scripts/v1_5/pretrain.sh`` from B and V: the first step's loss
    against the JAX step on the tree the port built (rtol 1e-4), the
    projector's gradients against JAX's (the tolerances of
    ``tests/test_torch_train_from_base.py``'s one-step test), ``grad_norm``
    their norm, only the projector moved, and ``mm_projector.bin`` read
    back bit for bit;
(b) ``scripts/v1_5/finetune_lora.sh`` from B and V over (a)'s file
    (``--pretrain-mm-mlp-adapter``), without and with ``--bits 4``: the
    starting projector (a)'s bit for bit, and the LoRA steps' losses and
    grad_norms (the first step's and two more, as
    ``test_lora_train_matches_jax_train_at_40_heads`` runs three) and the
    saved adapters against the JAX trainer's own LoRA step run on the tree
    the port built (``tests/test_torch_lora.py``'s tolerances, JAX's initial
    adapters in both). The JAX trainer cannot build that tree: its
    ``build_model`` drops ``--vision-tower`` and ``--mm-projector-type``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from llava_plus_tpu.data.debug_tokenizer import DebugTokenizer as JaxDebugTokenizer
from llava_plus_tpu.models.configs import LlavaConfig as JaxLlavaConfig
from llava_plus_tpu.models.llava import MultimodalBatch as JaxBatch
from llava_plus_tpu.train import lora as jax_lora
from llava_plus_tpu.train import step as jax_step
from llava_plus_tpu.train import train as jax_train
from llava_plus_torch.models import clip_vit, llama
from llava_plus_torch.models.configs import ClipVisionConfig, LlamaConfig
from llava_plus_torch.models.convert import to_numpy
from llava_plus_torch.train import step as step_lib
from llava_plus_torch.train.train import ModelArguments, build_model, main

from .test_torch_lora import _port_adapters

torch.set_num_threads(1)
TEXT = LlamaConfig(vocab_size=512, hidden_size=320, intermediate_size=864, num_hidden_layers=3,
                   num_attention_heads=40, num_key_value_heads=40, max_position_embeddings=2048)
TOWER_SIZE, TOWER_TOKENS = 42, 9
VISION = ClipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=2, image_size=TOWER_SIZE, patch_size=14)
ROWS = 4                 # the recipes' 32 and 16 rows a device, cut for the CPU
STAGE1_LR = 1e-3         # pretrain.sh's
LORA_LR = 2e-4           # finetune_lora.sh's
# finetune_lora.sh's r 128 / alpha 256 cut to the 40-head test's r 4 / alpha
# 8 (test_torch_13b.py), whose 3 steps and tolerance on the adapters (1% of
# the steps' lr) this test keeps
LORA_R, LORA_STEPS = 4, 3
RTOL = 1e-4


def _leaves(tree):
    return list(chip_smoke._leaves(tree))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """B (seed 0), V (seed 1) and the two corpora: 8 image captions, 8 image
    conversations (v1 turns), as PNGs of 50 px."""
    root = tmp_path_factory.mktemp("recipe")
    base, tower = root / "vicuna-tiny-13b-shape", root / "clip-tiny-42"
    chip_smoke._write_base(str(base), llama.init_params(
        TEXT, torch.Generator().manual_seed(0), "cpu", torch.float32), TEXT)
    chip_smoke._write_tower(str(tower), clip_vit.init_params(
        VISION, torch.Generator().manual_seed(1), "cpu", torch.float32), VISION)
    rng = np.random.default_rng(24)

    def words(n):
        return " ".join(f"w{int(j)}" for j in rng.integers(0, 300, n))

    caps = chip_smoke._write_corpus(str(root / "caps"), 8, rng, 50, lambda i: [
        {"from": "human", "value": "<image>\n"},
        {"from": "gpt", "value": words(int(rng.integers(4, 12)))}])
    chats = chip_smoke._write_corpus(str(root / "chats"), 8, rng, 50, lambda i: [
        {"from": "human", "value": "<image>\n" + words(int(rng.integers(3, 8))) + "?"},
        {"from": "gpt", "value": words(int(rng.integers(4, 14))) + "."},
        {"from": "human", "value": words(int(rng.integers(3, 8))) + "?"},
        {"from": "gpt", "value": words(int(rng.integers(4, 14))) + "."}])
    return root, base, tower, caps, chats


def _flags(name, steps, **flags):
    return chip_smoke._script_argv(name, bf16="false", device="cpu",
                                   per_device_train_batch_size=ROWS, max_steps=steps, **flags)


def _recording(built):
    """A ``build_model`` hook: the trainer's own, a copy of its tree kept
    (the trainer updates the tree in place)."""
    def hook(model_args, dtype, device, seed):
        params, cfg, tok = build_model(model_args, dtype, device, seed)
        built.update(params=jax.tree.map(np.copy, to_numpy(params)), cfg=cfg)
        return params, cfg, tok
    return hook


@pytest.fixture(scope="module")
def stage1(dirs):
    """``pretrain.sh``'s flags through ``main`` from B and V, one step, with
    the trainer's gradients observed (``step.grads_and_metrics``)."""
    root, base, tower, caps, _ = dirs
    out = root / "stage1"
    argv, env = _flags(chip_smoke.PRETRAIN_13B_SCRIPT, 1, model_name_or_path=base,
                       data_path=caps, image_folder=os.path.dirname(caps), vision_tower=tower,
                       output_dir=out)
    assert env == {}
    built, steps, seen = {}, [], []
    real = step_lib.grads_and_metrics

    def observed(loss_of, params, batch, accum_steps=1, keys=("language_model", "mm_projector")):
        grads, metrics = real(loss_of, params, batch, accum_steps, keys)
        seen.append((tuple(keys), {k: to_numpy(grads[k]) for k in keys}))
        return grads, metrics

    step_lib.grads_and_metrics = observed
    try:
        params, cfg = main(argv, build_model=_recording(built),
                           on_step=lambda s, m, dt, a: steps.append((m, a)))
    finally:
        step_lib.grads_and_metrics = real
    return {"out": out, "params": params, "cfg": cfg, "built": built, "steps": steps,
            "seen": seen}


def test_pretrain_from_a_base_matches_the_jax_step(dirs, stage1):
    """(a) The tower and projector the trainer built follow V (42 px, 9
    tokens) and the script (mlp2x_gelu, select layer -2). Step 1's loss and
    the projector's gradients against JAX's on the same tree and batch; the
    port differentiates the projector alone and reports its norm; only the
    projector moved; ``mm_projector.bin`` holds the trained projector and
    reads back through ``--pretrain-mm-mlp-adapter`` bit for bit."""
    cfg, built, params = stage1["cfg"], stage1["built"], stage1["params"]
    assert (cfg.vision.image_size, cfg.num_image_tokens, cfg.mm_projector_type,
            cfg.vision.select_layer, cfg.text.num_attention_heads) == (
        TOWER_SIZE, TOWER_TOKENS, "mlp2x_gelu", -2, 40)
    (m, arrays), = stage1["steps"]
    (keys, grads), = stage1["seen"]
    assert keys == ("mm_projector",)

    jp = jax.tree.map(jnp.asarray, built["params"])
    jcfg = JaxLlavaConfig.from_json(cfg.to_json())
    batch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})

    def loss_of(proj):
        return jax_step.loss_fn(dict(jp, mm_projector=proj), jcfg, batch, remat=True)

    (loss, jm), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        jp["mm_projector"])
    np.testing.assert_allclose(m["loss"], float(loss), rtol=RTOL)
    assert m["tokens"] == float(jm["tokens"]) > 0
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=RTOL,
                                                         atol=1e-3 * STAGE1_LR),
                 grads["mm_projector"], jax.tree.map(np.asarray, jgrads))
    np.testing.assert_allclose(m["grad_norm"], float(optax.global_norm(jgrads)), rtol=RTOL)

    got = to_numpy(params)
    for key in ("language_model", "vision_tower"):
        jax.tree.map(np.testing.assert_array_equal, got[key], built["params"][key])
    for a, b in zip(jax.tree.leaves(got["mm_projector"]),
                    jax.tree.leaves(built["params"]["mm_projector"])):
        assert not np.array_equal(a, b)

    path = stage1["out"] / "mm_projector.bin"
    sd = torch.load(path, weights_only=True)
    assert chip_smoke._projector_matches(sd, params["mm_projector"])
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "model.mm_projector.0.weight": (320, 32), "model.mm_projector.0.bias": (320,),
        "model.mm_projector.2.weight": (320, 320), "model.mm_projector.2.bias": (320,)}
    _, base, tower, _, _ = dirs
    for dtype in (torch.float32, torch.bfloat16):
        back = build_model(ModelArguments(
            model_name_or_path=str(base), vision_tower=str(tower),
            mm_projector_type="mlp2x_gelu", mm_vision_select_layer=-2,
            pretrain_mm_mlp_adapter=str(path)), dtype, "cpu")[0]["mm_projector"]
        for a, b in zip(_leaves(back), _leaves(params["mm_projector"])):
            assert a.dtype == dtype and torch.equal(a, b.to(dtype))


@pytest.mark.parametrize("bits", [None, 4], ids=["lora", "qlora4"])
def test_lora_over_the_stage1_projector_matches_the_jax_lora_step(dirs, stage1, tmp_path,
                                                                   monkeypatch, bits):
    """(b) ``finetune_lora.sh``'s flags (v1, pad, modality-grouped batches,
    remat; r and alpha cut to LORA_R and twice it) from B and V with
    ``--pretrain-mm-mlp-adapter`` (a)'s file: the starting projector is
    (a)'s trained one bit for bit; three steps against the JAX trainer's
    ``lora_step`` on the tree the port built (its ``build_model`` patched to
    return that tree, its ``--bits`` quantizing it as the port's does),
    JAX's initial adapters in both: loss, tokens, accuracy and grad_norm at
    rtol 1e-4, the saved adapters and ``non_lora_trainables.bin``."""
    root, base, tower, _, chats = dirs
    extra = {"bits": bits} if bits else {}
    argv, env = _flags(chip_smoke.LORA_13B_SCRIPT, LORA_STEPS, model_name_or_path=base,
                       vision_tower=tower, lora_r=LORA_R, lora_alpha=2 * LORA_R,
                       pretrain_mm_mlp_adapter=stage1["out"] / "mm_projector.bin",
                       data_path=chats, image_folder=os.path.dirname(chats),
                       output_dir=tmp_path / "port", **extra)
    assert env == {}
    flag = {argv[i][2:]: argv[i + 1] for i in range(0, len(argv), 2)}
    r, alpha = int(flag["lora-r"]), int(flag["lora-alpha"])
    assert (r, alpha, float(flag["learning-rate"]), flag["group-by-modality-length"]) == (
        LORA_R, 2 * LORA_R, LORA_LR, "true")

    # the port: the trainer's own build, JAX's initial adapters
    built, got, bases = {}, [], []
    jad = {}

    def init_lora(lm, lora_cfg, generator):
        bases.append(lm)
        # JAX's adapters are made on JAX's base (quantized alike with --bits)
        jlm = built["jax_lm"]
        jad["ad"] = jax.tree.map(np.asarray, jax_lora.init_lora_params(
            jlm, jax_lora.LoraConfig(r=r, alpha=alpha), jax.random.PRNGKey(1)))
        return _port_adapters(jad["ad"])

    hook = _recording(built)

    def building(model_args, dtype, device, seed):
        params, cfg, tok = hook(model_args, dtype, device, seed)
        jlm = jax.tree.map(jnp.asarray, built["params"]["language_model"])
        if bits:
            from llava_plus_tpu.ops.quant import quantize_llava_params

            jlm = quantize_llava_params({"language_model": jlm}, bits=bits)["language_model"]
        built["jax_lm"] = jlm
        return params, cfg, tok

    main(argv, build_model=building, init_lora=init_lora,
         on_step=lambda s, m, dt, a: got.append(m))
    jax.tree.map(np.testing.assert_array_equal, built["params"]["mm_projector"],
                 to_numpy(stage1["params"])["mm_projector"])
    wq = bases[0]["layers"]["attn"]["wq"]
    assert (isinstance(wq, dict) and "qvalue4" in wq) == bool(bits)

    # JAX: its trainer's LoRA step on the same tree, batches and flags
    cfg = built["cfg"]
    jcfg = JaxLlavaConfig.from_json(cfg.to_json())
    jtree = jax.tree.map(jnp.asarray, built["params"])
    monkeypatch.setattr(jax_train, "build_model", lambda model_args, dtype: (
        jtree, jcfg, JaxDebugTokenizer(vocab_size=TEXT.vocab_size)))
    seen, real_jit = [], jax.jit

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

    class EpochSampler(jax_train.LengthGroupedSampler):
        """The JAX sampler drawing each epoch's own order, as the port's
        loop has it draw (``set_epoch`` every epoch; the JAX loop repeats
        epoch 0's order): step 3 starts the second epoch."""

        def __iter__(self):
            order = super().__iter__()
            self.set_epoch(self._epoch + 1)
            return order

    monkeypatch.setattr(jax_train, "LengthGroupedSampler", EpochSampler)
    jax_train.train(
        jax_train.ModelArguments(version=flag["version"]),
        jax_train.DataArguments(data_path=chats, image_folder=os.path.dirname(chats),
                                image_aspect_ratio=flag["image-aspect-ratio"]),
        jax_train.TrainingArguments(
            output_dir=str(tmp_path / "jax"), per_device_train_batch_size=ROWS,
            model_max_length=int(flag["model-max-length"]), max_steps=LORA_STEPS,
            save_steps=100,
            bf16=False, gradient_checkpointing=True, lora_enable=True, lora_r=r,
            lora_alpha=alpha, learning_rate=LORA_LR, bits=bits or 16,
            group_by_modality_length=True, dp=1, fsdp_axis=1, tp=1))
    monkeypatch.setattr(jax, "jit", real_jit)
    assert len(got) == len(seen) == LORA_STEPS
    for i, (m, jm) in enumerate(zip(got, seen)):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=RTOL, err_msg=f"step {i + 1}")
        assert m["tokens"] == jm["tokens"] > 0
        assert m["accuracy"] == pytest.approx(jm["accuracy"])
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=RTOL)

    from safetensors.numpy import load_file

    want = load_file(str(tmp_path / "jax" / "adapter_model.safetensors"))
    have = load_file(str(tmp_path / "port" / "adapter_model.safetensors"))
    assert sorted(have) == sorted(want) and len(have) == 2 * 7 * TEXT.num_hidden_layers
    # an element whose gradient is near 0 moves by up to lr a step, in a
    # direction the f32 summation order decides: 1% of the steps' lr
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=RTOL,
                                   atol=1e-2 * LORA_STEPS * LORA_LR, err_msg=k)
    nlt = [torch.load(tmp_path / side / "non_lora_trainables.bin", weights_only=True)
           for side in ("port", "jax")]
    assert sorted(nlt[0]) == sorted(nlt[1])
    for k in nlt[1]:
        torch.testing.assert_close(nlt[0][k], nlt[1][k], rtol=0, atol=0)
    assert chip_smoke._projector_matches(nlt[0], stage1["params"]["mm_projector"])
    assert json.loads((tmp_path / "port" / "adapter_config.json").read_text())["r"] == r
