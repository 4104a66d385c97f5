"""The port's own copies of the JAX package's training-data modules give what
the originals give on the same inputs: the conversation templates
(``conversation.py``), per-template tokenization and label masking
(``data/preprocess.py``), the dataset, collator and length-grouped sampler
(``data/dataset.py``), packing (``data/packing.py``) and the tool-use turn
format (``mm_utils.py``). Arrays are compared exactly."""

import copy
import json

import numpy as np
import pytest
from PIL import Image

from llava_plus_tpu import conversation as jax_conv
from llava_plus_tpu import mm_utils as jax_mm_utils
from llava_plus_tpu.data import dataset as jax_dataset
from llava_plus_tpu.data import packing as jax_packing
from llava_plus_tpu.data import preprocess as jax_pre
from llava_plus_tpu.data.image_processing import ClipImageProcessor as JaxProc
from llava_plus_torch import conversation, mm_utils
from llava_plus_torch.data import dataset, packing, preprocess
from llava_plus_torch.data.image_processing import ClipImageProcessor

from .test_preprocess import SpLikeTokenizer

TURNS = [
    [("<image>\nwhat is shown here", "a cat on a mat"), ("and its colour", "orange")],
    [("compute 2 plus 2", "4"), ("times 3", "12"), ("minus 1", "11")],
]


def _sources(turns):
    src = []
    for q, a in turns:
        src += [{"from": "human", "value": q}, {"from": "gpt", "value": a}]
    return src


def _assert_same(a, b):
    assert type(a) is type(b) or isinstance(a, np.ndarray)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _prompt(mod, name, turns):
    """The template's prompt for ``turns`` and an open last turn, or the
    type of what rendering raised."""
    conv = mod.conv_templates[name].copy()
    for q, a in turns:
        conv.append_message(conv.roles[0], q)
        conv.append_message(conv.roles[1], a)
    conv.append_message(conv.roles[0], "one more")
    conv.append_message(conv.roles[1], None)
    try:
        return conv.get_prompt()
    except Exception as e:  # the same failure from both counts as the same
        return type(e)


def test_template_registry_and_prompts_match():
    assert list(conversation.conv_templates) == list(jax_conv.conv_templates)
    assert conversation.default_conversation.version == jax_conv.default_conversation.version
    rendered = 0
    for name in conversation.conv_templates:
        for turns in TURNS:
            mine = _prompt(conversation, name, turns)
            assert mine == _prompt(jax_conv, name, turns), name
            rendered += isinstance(mine, str)
    assert rendered >= 2 * len(conversation.conv_templates) - 4


@pytest.mark.parametrize("name,has_image", [
    (name, img) for name in ("v1", "plain", "llava_llama_2", "mpt", "v0", "llava_v1")
    for img in (True, False) if img or name != "plain"])   # plain pairs need an image
def test_preprocess_matches(name, has_image):
    turns = TURNS[0] if has_image else TURNS[1]
    if name == "plain":
        turns = turns[:1]
    srcs = [_sources(turns)]
    out = []
    for mod, conv_mod in ((preprocess, conversation), (jax_pre, jax_conv)):
        s = copy.deepcopy(srcs)
        if has_image:
            s = mod.preprocess_multimodal(s, is_multimodal=True, mm_use_im_start_end=False,
                                          version=name)
        out.append(mod.preprocess(s, SpLikeTokenizer(), has_image=has_image,
                                  conv=conv_mod.conv_templates[name]))
    _assert_same(out[0], out[1])
    assert (np.asarray(out[0]["labels"][0]) == -100).any()


def test_tool_use_turns_match():
    src = [{"from": "human", "value": "find the dog"},
           {"from": "gpt", "thoughts": "use the detector",
            "actions": [{"API_name": "grounding_dino", "API_params": {"caption": "dog"}}],
            "value": "I will look"}]
    assert (mm_utils.reorganize_source_for_tool_use(copy.deepcopy(src))
            == jax_mm_utils.reorganize_source_for_tool_use(copy.deepcopy(src)))
    kw = dict(has_image=False)
    _assert_same(preprocess.preprocess([copy.deepcopy(src)], SpLikeTokenizer(),
                                       conv=conversation.conv_templates["v1"], **kw),
                 jax_pre.preprocess([copy.deepcopy(src)], SpLikeTokenizer(),
                                    conv=jax_conv.conv_templates["v1"], **kw))


@pytest.fixture()
def corpus(tmp_path):
    rng = np.random.default_rng(3)
    records = []
    for i in range(12):
        rec = {"conversations": _sources(TURNS[i % 2][: 1 + i % 3])}
        if i % 2 == 0:
            name = f"img{i}.png"
            Image.fromarray(rng.integers(0, 255, (30 + i, 50, 3), dtype=np.uint8)).save(
                tmp_path / name)
            rec["image"] = name
        records.append(rec)
    path = tmp_path / "data.json"
    path.write_text(json.dumps(records))
    return path


@pytest.mark.parametrize("aspect", [None, "pad"])
def test_dataset_collate_and_sampler_match(corpus, aspect):
    tok = SpLikeTokenizer()
    sets = []
    for mod, proc, conv_mod in ((dataset, ClipImageProcessor, conversation),
                                (jax_dataset, JaxProc, jax_conv)):
        cfg = mod.DataConfig(data_path=str(corpus), image_folder=str(corpus.parent),
                             image_aspect_ratio=aspect)
        sets.append(mod.make_supervised_dataset(tok, cfg, proc(shortest_edge=28, crop_size=28),
                                                conv_mod.conv_templates["v1"]))
    mine, theirs = sets
    assert len(mine) == len(theirs) == 12
    assert mine.lengths == theirs.lengths
    assert mine.modality_lengths == theirs.modality_lengths
    items = [mine[i] for i in range(12)]
    for i, item in enumerate(items):
        _assert_same(item, theirs[i])
    kw = dict(num_patches=4, max_len=48, image_size=28)
    _assert_same(dataset.collate_batch(items[:5], **kw),
                 jax_dataset.collate_batch([theirs[i] for i in range(5)], **kw))
    for by_modality in (False, True):
        for seed in (0, 7):
            a = dataset.LengthGroupedSampler(4, 1, mine.modality_lengths, by_modality, seed)
            b = jax_dataset.LengthGroupedSampler(4, 1, theirs.modality_lengths, by_modality,
                                                 seed)
            assert list(iter(a)) == list(iter(b))


@pytest.mark.parametrize("rows,max_images", [(2, 2), (3, 1)])
def test_packing_matches(corpus, rows, max_images):
    tok = SpLikeTokenizer()
    cfg = dataset.DataConfig(data_path=str(corpus), image_folder=str(corpus.parent))
    ds = dataset.make_supervised_dataset(tok, cfg, ClipImageProcessor(shortest_edge=28,
                                                                      crop_size=28),
                                         conversation.conv_templates["v1"])
    items = [ds[i] for i in range(12)]
    kw = dict(rows=rows, max_len=64, num_patches=4, image_size=28,
              max_images_per_row=max_images)
    start = 0
    while start < len(items):
        got, n = packing.pack_instances(items[start:], **kw)
        want, m = jax_packing.pack_instances(items[start:], **kw)
        assert n == m
        _assert_same(got, want)
        if n == 0:
            break
        start += n
    assert start == len(items)
