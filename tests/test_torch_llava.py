"""The port's multimodal model and generator against the JAX package, on the
CPU, in fp32: CLIP encode, the projectors, the image splice with dropped
positions, sampling, and the whole slice (``Generator.stream``) with bf16
and int8 KV caches, where the greedy tokens must be identical."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llava_plus_tpu import generate as jax_generate
from llava_plus_tpu.data.debug_tokenizer import DebugTokenizer as JaxDebugTokenizer
from llava_plus_tpu.models import clip_vit as jax_clip
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models import projector as jax_projector
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny_config
from llava_plus_torch import generate
from llava_plus_torch.data import DebugTokenizer
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.models import clip_vit, llava, projector
from llava_plus_torch.models.convert import from_numpy

torch.set_num_threads(1)
CFG = tiny_llava_config()
JCFG = jax_tiny_config()  # the same config, the JAX package's own
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def params():
    p = jax_llava.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return p, from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _images(n, seed=0):
    s = CFG.vision.image_size
    return np.random.default_rng(seed).normal(size=(n, s, s, 3)).astype(np.float32)


def test_clip_encode_matches_jax(params):
    jp, tp = params
    imgs = _images(2)
    want = jax_clip.encode(jp["vision_tower"], JCFG.vision, jnp.asarray(imgs))
    got = clip_vit.encode(tp["vision_tower"], CFG.vision, torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.shape == (2, CFG.vision.num_patches, CFG.vision.hidden_size)


@pytest.mark.parametrize("kind", ["linear", "mlp2x_gelu", "mlp3x_gelu", "identity"])
def test_projector_matches_jax(kind):
    jp = jax_projector.init_params(kind, 32, 64, jax.random.PRNGKey(1), jnp.float32)
    tp = from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(1).normal(size=(2, 4, 32 if kind != "identity" else 64))
    x = x.astype(np.float32)
    want = jax_projector.apply(jp, kind, jnp.asarray(x))
    got = projector.apply(tp, kind, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fuse_matches_jax_with_dropped_image_positions(params):
    """Row 0 is truncated mid image span (positions >= T are dropped); row 1
    is text only (its pad image drops entirely)."""
    jp, tp = params
    tok = DebugTokenizer(vocab_size=CFG.text.vocab_size)
    jtok = JaxDebugTokenizer(vocab_size=CFG.text.vocab_size)
    prompts = ["hello <image>\nwhat is it", "just some words here"]
    batch_j, plan = jax_generate.prepare_multimodal_request(
        JCFG, jtok, prompts, [_images(1), None], max_seq_len=5, prefill_bucket=1)
    batch_t, _ = generate.prepare_multimodal_request(
        CFG, tok, prompts, [_images(1), None], max_seq_len=5, prefill_bucket=1,
        device="cpu")
    assert (plan.image_pos >= batch_t.tokens.shape[1]).any()
    for name in ("tokens", "positions", "segment_ids", "images", "image_pos"):
        np.testing.assert_array_equal(getattr(batch_t, name).numpy(),
                                      np.asarray(getattr(batch_j, name)))
    want = jax_llava.fuse(jp, JCFG, batch_j)
    got = llava.fuse(tp, CFG, batch_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sample_token_greedy_matches_jax():
    logits = np.random.default_rng(2).normal(size=(4, 512)).astype(np.float32)
    want = jax_generate.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                                     jnp.float32(0.0), jnp.float32(1.0))
    got = generate.sample_token(torch.from_numpy(logits), torch.Generator(), 0.0, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.99])
def test_top_p_support_matches_jax(top_p):
    """Same logits: the tokens nucleus sampling can draw are the top-p
    nucleus that the JAX ``sample_token`` is written to keep (exclusive
    cumulative mass below top_p). The JAX function's own cutoff takes the
    largest kept logit, so its draws are only ever the argmax (ROADMAP
    Queue 3); they lie inside the port's support."""
    logits = np.array([[0.0, 5.0, 1.0, -2.0, 4.5, 3.0, 2.0, -1.0]], np.float32)
    gen = torch.Generator().manual_seed(0)
    got = {int(generate.sample_token(torch.from_numpy(logits), gen, 1.0, top_p)[0])
           for _ in range(2000)}
    p = np.exp(logits[0].astype(np.float64) - logits.max())
    p /= p.sum()
    order = np.argsort(-p)
    nucleus = {int(order[i]) for i in range(len(p)) if p[order[:i]].sum() < top_p}
    assert got == nucleus
    want = {int(jax_generate.sample_token(jnp.asarray(logits), jax.random.PRNGKey(i),
                                          jnp.float32(1.0), jnp.float32(top_p))[0])
            for i in range(50)}
    assert want <= got


@pytest.fixture(scope="module")
def generators(params):
    jp, tp = params
    tok = DebugTokenizer(vocab_size=CFG.text.vocab_size)
    jtok = JaxDebugTokenizer(vocab_size=CFG.text.vocab_size)
    out = {}
    for kv, jdt, tdt in (("bf16", jnp.bfloat16, torch.bfloat16),
                         ("int8", jnp.int8, torch.int8)):
        out[kv] = (
            jax_generate.Generator(jp, JCFG, jtok, max_seq_len=128, prefill_bucket=32,
                                   cache_dtype=jdt),
            generate.Generator(tp, CFG, tok, device="cpu", max_seq_len=128,
                               prefill_bucket=32, cache_dtype=tdt),
        )
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("prompt,with_image", [
    ("tell me a story about the sea", False),
    ("<image>\nwhat is in this picture", True),
])
def test_generator_stream_matches_jax(generators, kv, prompt, with_image):
    """The whole slice: 16 greedy tokens, identical ids and streamed text."""
    jg, tg = generators[kv]
    img = _images(1, seed=3) if with_image else None
    want = list(jg.stream(prompt, img, max_new_tokens=16))
    got = list(tg.stream(prompt, img, max_new_tokens=16))
    assert tg._last_output_ids == jg._last_output_ids
    assert len(tg._last_output_ids) == 16
    assert got == want
    assert tg._last_prompt_len == jg._last_prompt_len


def test_decode_chunk_and_stop_string_match_jax(generators):
    jg, tg = generators["bf16"]
    ref = list(tg.stream("hello there", max_new_tokens=12, decode_chunk=1))
    for chunk in (3, 32):
        assert list(tg.stream("hello there", max_new_tokens=12, decode_chunk=chunk)) == ref
    stop = ref[4].split(" ")[-1]
    want = list(jg.stream("hello there", max_new_tokens=12, stop_strings=[stop],
                          decode_chunk=4))
    got = list(tg.stream("hello there", max_new_tokens=12, stop_strings=[stop],
                         decode_chunk=4))
    assert got == want
