"""The port's ``Generator.beam_search`` and ``Generator.generate``
(``llava_plus_torch/generate.py``) against the JAX package's, on the CPU in
fp32 with f32 caches: the same parameters (drawn with numpy from a seed,
through the converter) and the same prompts go through both.

- beam ids and text equal JAX's for 1-4 beams, text and image prompts, on
  the tiny LLaMA and the tiny MPT; one beam is greedy ``generate``;
- beams that finish (an EOS planted near a likely token): the frozen
  candidates and the length-normalised pick equal JAX's;
- a planted tie (two head columns equal, so the first step's top two
  log-probs are equal) is taken lower index first, as ``jax.lax.top_k``;
- the port's beam search equals a cache-free oracle with the same
  expansion rules (the counterpart of ``tests/test_generate.py:180``);
- :func:`reorder_beams` over a slot range equals a whole-cache gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llava_plus_tpu import generate as jax_generate
from llava_plus_tpu.data.debug_tokenizer import DebugTokenizer as JaxDebugTokenizer
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny
from llava_plus_tpu.models.configs import tiny_llava_mpt_config as jax_tiny_mpt
from llava_plus_torch import generate
from llava_plus_torch.data import DebugTokenizer
from llava_plus_torch.models import llama, llava
from llava_plus_torch.models.configs import tiny_llava_config, tiny_llava_mpt_config
from llava_plus_torch.models.convert import from_numpy

torch.set_num_threads(1)
V = 512
TEXT = "tell me a story about the sea"
IMAGE = "<image>\nwhat is in this picture"
EOS = 2


def numpy_params(arch, seed=0):
    """The JAX init's tree with every leaf redrawn by numpy from ``seed``
    at the leaf's own scale (constant leaves, the norms, kept)."""
    jcfg = jax_tiny() if arch == "llama" else jax_tiny_mpt()
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x, np.float32)
        s = float(x.std())
        return x if s == 0 else (rng.standard_normal(x.shape) * s).astype(np.float32)

    return jax.tree.map(draw, jax_llava.init_params(jcfg, jax.random.PRNGKey(0),
                                                    dtype=jnp.float32))


def head_rows(arch, p):
    """The output head as a writable [V, D] view (MPT ties it to ``wte``)."""
    lm = p["language_model"]
    return lm["lm_head"].T if arch == "llama" else lm["wte"]


def generators(arch, p):
    jcfg = jax_tiny() if arch == "llama" else jax_tiny_mpt()
    cfg = tiny_llava_config() if arch == "llama" else tiny_llava_mpt_config()
    jg = jax_generate.Generator(jax.tree.map(jnp.asarray, p), jcfg,
                                JaxDebugTokenizer(vocab_size=V), max_seq_len=128,
                                prefill_bucket=32, cache_dtype=jnp.float32)
    tg = generate.Generator(from_numpy(p, "cpu"), cfg, DebugTokenizer(vocab_size=V),
                            device="cpu", max_seq_len=128, prefill_bucket=32,
                            cache_dtype=torch.float32)
    return jg, tg


@pytest.fixture(scope="module", params=["llama", "mpt"])
def pair(request):
    return request.param, generators(request.param, numpy_params(request.param))


def _image(seed=3):
    return np.random.default_rng(seed).normal(size=(1, 28, 28, 3)).astype(np.float32)


def _same(a, b):
    assert b.output_ids == a.output_ids
    assert b.text == a.text
    assert (b.prompt_tokens, b.completion_tokens) == (a.prompt_tokens, a.completion_tokens)


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["text", "image"])
def test_beam_search_matches_jax(pair, nb, kind):
    _, (jg, tg) = pair
    prompt, img = (TEXT, None) if kind == "text" else (IMAGE, _image())
    want = jg.beam_search(prompt, img, num_beams=nb, max_new_tokens=8)
    got = tg.beam_search(prompt, img, num_beams=nb, max_new_tokens=8)
    _same(want, got)
    assert len(got.output_ids) == 8
    assert tg._last_output_ids == got.output_ids
    assert tg._last_prompt_len == jg._last_prompt_len == got.prompt_tokens
    if nb == 1:
        _same(tg.generate(prompt, img, max_new_tokens=8, temperature=0.0), got)


@pytest.mark.parametrize("kind", ["text", "image"])
def test_generate_matches_jax(pair, kind):
    """``generate`` (32-token decode chunks) equals JAX's, stop strings too."""
    _, (jg, tg) = pair
    prompt, img = (TEXT, None) if kind == "text" else (IMAGE, _image())
    want = jg.generate(prompt, img, max_new_tokens=12)
    got = tg.generate(prompt, img, max_new_tokens=12)
    _same(want, got)
    stop = got.text.split(" ")[3]
    _same(jg.generate(prompt, img, max_new_tokens=12, stop_strings=[stop]),
          tg.generate(prompt, img, max_new_tokens=12, stop_strings=[stop]))


# The EOS head row set to a likely token's row times ``scale``: EOS then
# outscores that token wherever it would be picked, so beams finish at
# different steps (each case was seen to finish at least one beam).
EOS_PLANTS = [("llama", 464, 1.02, 3), ("llama", 64, 1.01, 2), ("mpt", 266, 1.02, 4),
              ("mpt", 415, 1.01, 3)]


@pytest.mark.parametrize("arch,k,scale,nb", EOS_PLANTS)
def test_finished_beams_match_jax(arch, k, scale, nb):
    """Frozen beams, the length-normalised pick (``length_penalty`` 0.8) and
    a stop string cut at finalisation, as JAX's."""
    p = numpy_params(arch)
    rows = head_rows(arch, p)
    rows[EOS] = rows[k] * scale
    jg, tg = generators(arch, p)
    want = jg.beam_search(TEXT, None, num_beams=nb, max_new_tokens=8, length_penalty=0.8)
    got = tg.beam_search(TEXT, None, num_beams=nb, max_new_tokens=8, length_penalty=0.8)
    _same(want, got)
    assert len(got.output_ids) < 8   # a finished beam won, its EOS dropped
    if len(got.output_ids) > 1:
        stop = [got.text.split(" ")[1]]
        _same(jg.beam_search(TEXT, None, num_beams=nb, max_new_tokens=8, stop_strings=stop),
              tg.beam_search(TEXT, None, num_beams=nb, max_new_tokens=8, stop_strings=stop))


@pytest.mark.parametrize("arch", ["llama", "mpt"])
@pytest.mark.parametrize("side", [-1, 1])
def test_planted_tie_order_matches_jax(arch, side):
    """Two head rows equal: the first step's top two candidates of beam 0
    have the same log-prob. Two beams and one token give the lower id, as
    JAX's ``lax.top_k`` orders them."""
    p = numpy_params(arch)
    _, tg = generators(arch, p)
    a = tg.generate(TEXT, max_new_tokens=1).output_ids[0]
    b = a + side
    rows = head_rows(arch, p)
    rows[b] = rows[a]
    jg, tg = generators(arch, p)
    batch, _ = tg.prepare_batch([TEXT])
    cache = llama.KVCache.create(llava.backbone(tg.cfg)[1], 1, 128, torch.float32,
                                 device="cpu")
    logp = torch.log_softmax(tg._prefill(cache, batch)[0], dim=-1)
    assert logp[a] == logp[b] == logp.max()
    want = jg.beam_search(TEXT, None, num_beams=2, max_new_tokens=1)
    got = tg.beam_search(TEXT, None, num_beams=2, max_new_tokens=1)
    _same(want, got)
    assert got.output_ids == [min(a, b)]


def _oracle(tg, prompt_ids, nb, n_new, length_penalty=1.0):
    """Cache-free beam search: a full forward over each beam's whole
    sequence every step, the same expansion rules (top ``nb`` of each live
    beam, finished beams carried as they are, a stable sort by score)."""
    lm, lm_cfg = llava.backbone(tg.cfg)
    lm_params = tg.params["language_model"]

    def next_logp(ids):
        logits, _ = lm.forward(lm_params, lm_cfg, torch.tensor([ids]))
        return torch.log_softmax(logits[0, -1].float(), dim=-1).numpy()

    beams = [(np.float32(0.0), list(prompt_ids), False)]
    for _ in range(n_new):
        cands = []
        for score, ids, done in beams:
            if done:
                cands.append((score, ids, True))
                continue
            lp = next_logp(ids)
            for v in np.argsort(-lp, kind="stable")[:nb]:
                cands.append((np.float32(score + lp[v]), ids + [int(v)], int(v) == EOS))
        cands.sort(key=lambda c: -c[0])
        beams = cands[:nb]
        if all(d for _, _, d in beams):
            break
    n0 = len(prompt_ids)
    finished = [(s / len(i[n0:]) ** length_penalty, i) for s, i, d in beams if d]
    if finished:
        return max(finished, key=lambda f: f[0])[1][n0:-1]
    return max(beams, key=lambda b: b[0])[1][n0:]


@pytest.mark.parametrize("arch,plant", [("llama", None), ("mpt", None),
                                        ("llama", (464, 1.02)), ("mpt", (415, 1.01))])
def test_beam_search_matches_cache_free_oracle(arch, plant):
    p = numpy_params(arch)
    if plant:
        rows = head_rows(arch, p)
        rows[EOS] = rows[plant[0]] * plant[1]
    _, tg = generators(arch, p)
    prompt_ids = list(tg.tokenizer(TEXT).input_ids)
    got = tg.beam_search(TEXT, num_beams=3, max_new_tokens=5)
    assert got.output_ids == _oracle(tg, prompt_ids, 3, 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_reorder_beams_equals_whole_cache_gather(dtype):
    """Moving slots [start, end) by parent equals JAX's whole-cache take
    where the rows agree outside that range (the cloned prompt)."""
    cfg = tiny_llava_config().text
    cache = llama.KVCache.create(cfg, 4, 16, dtype, device="cpu")
    g = torch.Generator().manual_seed(0)
    for buf in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if buf is None:
            continue
        fill = torch.randint(-100, 100, buf.shape, generator=g).to(buf.dtype)
        fill[:, :, :5] = fill[:, :1, :5]   # the prompt, cloned in every row
        buf.copy_(fill)
    cache.seg.copy_(torch.randint(0, 2, cache.seg.shape, generator=g))
    cache.seg[:, :5] = 1
    parent = [2, 0, 0, 3]
    want = {n: getattr(cache, n)[:, parent].clone() for n in ("k", "v", "k_scale", "v_scale")
            if getattr(cache, n) is not None}
    want_seg = cache.seg[parent].clone()
    generate.reorder_beams(cache, parent, 5, 16)
    for n, w in want.items():
        assert torch.equal(getattr(cache, n), w), n
    assert torch.equal(cache.seg, want_seg)
    before = cache.k.clone()
    generate.reorder_beams(cache, [0, 1, 2, 3], 5, 16)   # nothing moves
    assert torch.equal(cache.k, before)
