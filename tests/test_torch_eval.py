"""The port's eval harness (``llava_plus_torch/eval``) against the JAX
package's (``llava_plus_tpu/eval``), on the CPU.

- The runners: ``EvalSession`` over the port's ``Generator`` (the
  ``generator=`` seam) writes the answers that JAX's ``EvalSession`` over
  the JAX ``Generator`` writes, for the same fp32 weights (drawn with numpy
  from a seed), question files and images built here: ``model_vqa_loader``
  (whole, chunked, and with three beams), ``model_vqa_science`` (and its
  answer prompter), ``model_vqa_mmbench`` (all rounds),
  ``model_vqa_qbench``, ``model_qa`` and ``run_llava``; answer ids aside.
- ``answer_many`` through the port's engine equals serial answers, in order.
- Every scorer gives what JAX's gives on the same fixtures; the GPT-judge
  scripts run in fresh interpreters against a stub ``openai`` module.
- The whole path from a tiny checkpoint: ``python -m
  llava_plus_torch.eval.model_vqa_loader --device cpu`` loads nothing of
  JAX and answers as the in-process session does; ``--engine-slots`` gives
  the same answers, ``--num_beams`` the beam search's.
- ``--device cuda`` (the default) without a card raises: no quiet fallback
  to the CPU.
"""

import base64
import importlib
import io
import json
import os
import random
import runpy
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from llava_plus_tpu import generate as jax_generate
from llava_plus_tpu.data.debug_tokenizer import DebugTokenizer as JaxDebugTokenizer
from llava_plus_tpu.data.image_processing import ClipImageProcessor as JaxClipImageProcessor
from llava_plus_tpu.models import llava as jax_llava
from llava_plus_tpu.models.configs import tiny_llava_config as jax_tiny
from llava_plus_torch import generate
from llava_plus_torch.data import ClipImageProcessor, DebugTokenizer
from llava_plus_torch.models.configs import tiny_llava_config
from llava_plus_torch.models.convert import from_numpy

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PKGS = ("llava_plus_tpu", "llava_plus_torch")
FOREIGN = ("jax", "jaxlib", "triton", "llava_plus_tpu")
SIZE = 28


def ev(pkg, name):
    return importlib.import_module(f"{pkg}.eval.{name}")


def id_tokenizer(base):
    """``base`` (either package's DebugTokenizer) decoding every id as
    "#id", so two answers compare token for token."""

    class IdTokenizer(base):
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(f"#{int(i)}" for i in ids
                            if not (skip_special_tokens and int(i) < self._RESERVED))

    return IdTokenizer(vocab_size=512)


@pytest.fixture(scope="module")
def sessions():
    """Per package, a factory of ``EvalSession``s over that package's
    ``Generator`` on the same numpy-drawn fp32 weights."""
    jcfg, cfg = jax_tiny(), tiny_llava_config()
    rng = np.random.default_rng(0)

    def draw(x):
        x = np.asarray(x, np.float32)
        s = float(x.std())
        return x if s == 0 else (rng.standard_normal(x.shape) * s).astype(np.float32)

    p = jax.tree.map(draw, jax_llava.init_params(jcfg, jax.random.PRNGKey(0),
                                                 dtype=jnp.float32))
    gens = {
        "llava_plus_tpu": jax_generate.Generator(
            jax.tree.map(jnp.asarray, p), jcfg, id_tokenizer(JaxDebugTokenizer),
            JaxClipImageProcessor(shortest_edge=SIZE, crop_size=SIZE), max_seq_len=128,
            prefill_bucket=32, cache_dtype=jnp.float32),
        "llava_plus_torch": generate.Generator(
            from_numpy(p, "cpu"), cfg, id_tokenizer(DebugTokenizer),
            ClipImageProcessor(shortest_edge=SIZE, crop_size=SIZE), device="cpu",
            max_seq_len=128, prefill_bucket=32, cache_dtype=torch.float32),
    }

    def make(pkg, **kw):
        gen = gens[pkg]
        s = ev(pkg, "common").EvalSession(None, generator=gen, **kw)
        s.cfg, s.image_processor = gen.cfg, gen.image_processor
        return s

    make.gens = gens
    return make


def _images(root, n):
    root.mkdir(exist_ok=True)
    rng = np.random.default_rng(7)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (20 + 4 * i, 24, 3), dtype=np.uint8)).save(
            root / f"{i}.png")


def _rows(path):
    rows = [json.loads(line) for line in open(path)]
    for r in rows:
        assert len(r.pop("answer_id")) == 22
    return rows


def _loader(tmp, pkg, chunk=(1, 0)):
    _images(tmp / "imgs", 3)
    q = tmp / "q.jsonl"
    q.write_text("\n".join(json.dumps({"question_id": i, "image": f"{i}.png",
                                       "text": f"What is in image {i}?"}) for i in range(3)))
    return types.SimpleNamespace(
        model_path="fake/llava-test", model_base=None, image_folder=str(tmp / "imgs"),
        question_file=str(q), answers_file=str(tmp / f"{pkg}-{chunk[1]}.jsonl"),
        conv_mode="llava_v1", num_chunks=chunk[0], chunk_idx=chunk[1], temperature=0.0,
        top_p=1.0, max_new_tokens=6)


def _science(tmp, pkg, prompter):
    _images(tmp / "imgs", 1)
    q = tmp / "sqa.json"
    q.write_text(json.dumps([
        {"id": "q0", "image": "0.png", "conversations": [
            {"from": "human", "value": "<image>\nWhich color?\nA. red\nB. blue"}]},
        {"id": "q1", "conversations": [{"from": "human", "value": "What is 2+2?"}]},
    ]))
    return types.SimpleNamespace(
        model_path="m", model_base=None, image_folder=str(tmp / "imgs"),
        question_file=str(q), answers_file=str(tmp / f"{pkg}.jsonl"), conv_mode="llava_v1",
        num_chunks=1, chunk_idx=0, temperature=0.0, single_pred_prompt=not prompter,
        answer_prompter=prompter)


def _mmbench(tmp, pkg):
    import pandas as pd

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (24, 24, 3), dtype=np.uint8)
                    ).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    q = tmp / "mmb.tsv"
    pd.DataFrame([
        {"index": 7, "question": "Which animal?", "hint": "A pet.", "image": b64,
         "A": "cat", "B": "dog", "C": "fox", "D": None},
        {"index": 8, "question": "Which number?", "hint": float("nan"), "image": b64,
         "A": "one", "B": "two", "C": None, "D": None},
    ]).to_csv(q, sep="\t", index=False)
    return types.SimpleNamespace(
        model_path="m", model_base=None, question_file=str(q),
        answers_file=str(tmp / f"{pkg}.jsonl"), conv_mode="llava_v1", num_chunks=1,
        chunk_idx=0, temperature=0.0, all_rounds=True, single_pred_prompt=True, lang="en")


def _qbench(tmp, pkg):
    _images(tmp / "imgs", 2)
    q = tmp / "qb.json"
    q.write_text(json.dumps([{"img_path": f"{i}.png", "question": f"How clear is {i}?",
                              "candidates": ["high", "low", "medium"]} for i in range(2)]))
    return types.SimpleNamespace(
        model_path="m", model_base=None, image_folder=str(tmp / "imgs"),
        questions_file=str(q), answers_file=str(tmp / f"{pkg}.json"), conv_mode="llava_v1",
        lang="en")


def _qa(tmp, pkg):
    q = tmp / "qa.jsonl"
    q.write_text("\n".join(json.dumps({"question_id": i, "text": t})
                           for i, t in enumerate(["Name a color.", "Count to three."])))
    return types.SimpleNamespace(model_path="m", question_file=str(q),
                                 answers_file=str(tmp / f"{pkg}.jsonl"), conv_mode="v1")


RUNNERS = ["loader", "loader_chunked", "loader_beams", "science", "science_prompter",
           "mmbench", "qbench", "qa"]


@pytest.mark.parametrize("runner", RUNNERS)
def test_runner_answers_match_jax(sessions, runner, tmp_path):
    got = {}
    for pkg in PKGS:
        kw = {"num_beams": 3} if runner == "loader_beams" else {}
        session = sessions(pkg, max_new_tokens=6, **kw)
        if runner.startswith("loader"):
            chunks = [(2, 0), (2, 1)] if runner == "loader_chunked" else [(1, 0)]
            rows = []
            for chunk in chunks:
                args = _loader(tmp_path, pkg, chunk)
                ev(pkg, "model_vqa_loader").eval_model(args, session=session)
                rows += _rows(args.answers_file)
            assert [r["question_id"] for r in rows] == [0, 1, 2]
        elif runner.startswith("science"):
            args = _science(tmp_path, pkg, runner == "science_prompter")
            ev(pkg, "model_vqa_science").eval_model(args, session=session)
            rows = _rows(args.answers_file)
        elif runner == "mmbench":
            args = _mmbench(tmp_path, pkg)
            ev(pkg, "model_vqa_mmbench").eval_model(args, session=session)
            rows = _rows(args.answers_file)
            assert [(r["question_id"], r["round_id"]) for r in rows] == [
                (7, 0), (7, 1), (7, 2), (8, 0), (8, 1)]
        elif runner == "qbench":
            args = _qbench(tmp_path, pkg)
            ev(pkg, "model_vqa_qbench").eval_model(args, session=session)
            rows = json.load(open(args.answers_file))
        else:
            args = _qa(tmp_path, pkg)
            ev(pkg, "model_qa").eval_model(args, session=session)
            rows = _rows(args.answers_file)
        got[pkg] = rows
    assert got["llava_plus_torch"] == got["llava_plus_tpu"]
    texts = [r.get("text", r.get("response")) for r in got["llava_plus_torch"]]
    assert all(t.startswith("#") for t in texts), texts


def test_run_llava_matches_jax(sessions, tmp_path, capsys):
    _images(tmp_path, 2)
    outs = []
    for pkg in PKGS:
        args = types.SimpleNamespace(
            model_path="llava-v1.5-tiny", model_base=None,
            query="<image-placeholder> what is here?", conv_mode=None, sep=",",
            image_file=f"{tmp_path / '0.png'},{tmp_path / '1.png'}", temperature=0.0,
            top_p=None, max_new_tokens=6, mm_use_im_start_end=False)
        outs.append(ev(pkg, "run_llava").eval_model(
            args, session=sessions(pkg, max_new_tokens=6)))
    assert outs[0] == outs[1] and outs[1].startswith("#")
    assert capsys.readouterr().out.split("\n")[:2] == outs


def test_answer_many_engine_equals_serial(sessions):
    """``answer_many`` through the port's dense engine (2 slots: a window of
    4 < 5 prompts) gives the serial single-stream answers, in order."""
    from llava_plus_torch.eval.common import EvalSession
    from llava_plus_torch.serve.engine import BatchedEngine

    gen = sessions.gens["llava_plus_torch"]
    engine = BatchedEngine(gen.params, gen.cfg, gen.tokenizer, max_slots=2, max_seq_len=128,
                           prefill_bucket=32, cache_dtype=torch.float32)
    try:
        session = EvalSession(None, engine=engine, max_new_tokens=5)
        session.cfg, session.image_processor = gen.cfg, gen.image_processor
        serial = sessions("llava_plus_torch", max_new_tokens=5)
        img = Image.fromarray(np.full((20, 30, 3), 90, np.uint8))
        items = [("hello there", None), ("<image>\nwhat is it", img), ("abab", None),
                 ("<image>\nand this", img), ("zz top", None)]
        want = [serial.answer(p, i) for p, i in items]
        assert list(session.answer_many(iter(items))) == want
        assert all(w.startswith("#") for w in want)
    finally:
        engine.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_engine_slots_with_beams_raises(pkg):
    with pytest.raises(ValueError, match="num_beams 1"):
        ev(pkg, "common").EvalSession(None, engine_slots=4, num_beams=2)


@pytest.mark.parametrize("pkg", PKGS)
def test_chunking_and_jsonl(pkg, tmp_path):
    common = ev(pkg, "common")
    lst = list(range(10))
    assert sum(common.split_list(lst, 3), []) == lst
    assert common.get_chunk(lst, 3, 0) == [0, 1, 2, 3]
    assert common.get_chunk(lst, 20, 15) == []
    common.write_jsonl(tmp_path / "a" / "x.jsonl", [{"a": 1}, {"b": [2]}])
    common.write_jsonl(tmp_path / "a" / "x.jsonl", [{"c": None}], mode="a")
    assert common.load_jsonl(tmp_path / "a" / "x.jsonl") == [{"a": 1}, {"b": [2]}, {"c": None}]
    assert len(common.short_uuid()) == 22


# -- scorers -------------------------------------------------------------------

def _run(pkg, name, argv, capsys, monkeypatch):
    """``python -m <pkg>.eval.<name> argv`` in this process; its stdout (the
    ScienceQA scorers draw a random letter for an unparsed answer)."""
    monkeypatch.setattr(sys, "argv", [name, *map(str, argv)])
    random.seed(0)
    capsys.readouterr()
    runpy.run_module(f"{pkg}.eval.{name}", run_name="__main__", alter_sys=True)
    return capsys.readouterr().out


def _both(name, make_argv, capsys, monkeypatch, outputs=()):
    """Each package's run of scorer ``name``: (stdout, output files)."""
    res = []
    for pkg in PKGS:
        argv = make_argv(pkg)
        out = _run(pkg, name, argv, capsys, monkeypatch).replace(pkg, "PKG")
        files = [Path(a).read_text() for a in argv if str(a).endswith(tuple(outputs))
                 and pkg in str(a)]
        res.append((out, files))
    assert res[0] == res[1]
    return res[1]


def test_m4c_evaluators_match_jax():
    rng = np.random.default_rng(0)
    words = ["A Dog!", "  two ", "isnt", "the answer", "1,000", "cat", "dog's", "3.5",
             "won't", "an apple.", "ten", "Yes", "no", "fish", "a", "100%", "x/y"]
    jm, tm = ev("llava_plus_tpu", "m4c_evaluator"), ev("llava_plus_torch", "m4c_evaluator")
    jp, tp = jm.EvalAIAnswerProcessor(), tm.EvalAIAnswerProcessor()
    assert [tp(w) for w in words] == [jp(w) for w in words]
    preds = [{"pred_answer": str(rng.choice(words)),
              "gt_answers": [str(w) for w in rng.choice(words, 10)]} for _ in range(40)]
    for cls in ("TextVQAAccuracyEvaluator", "STVQAAccuracyEvaluator"):
        assert getattr(tm, cls)().eval_pred_list(preds) == \
            getattr(jm, cls)().eval_pred_list(preds), cls


def test_textvqa_scorer_matches_jax(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(1)
    ann = {"data": [{"image_id": f"im{i}", "question": f"What is {i}?",
                     "answers": [str(x) for x in rng.choice(["cat", "dog", "two"], 10)]}
                    for i in range(6)]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    res = tmp_path / "res"
    res.mkdir()
    for k in range(2):
        (res / f"run{k}.jsonl").write_text("\n".join(json.dumps(
            {"question_id": f"im{i}", "prompt": f"What is {i}?\nAnswer briefly.",
             "text": str(rng.choice(["Cat", "dog.", "2"]))}) for i in range(6)))
    (res / "notes.txt").write_text("skip me")
    out, _ = _both("eval_textvqa", lambda pkg: ["--annotation-file", tmp_path / "ann.json",
                                                "--result-dir", res], capsys, monkeypatch)
    assert out.count("Accuracy") == 2 and "Skipping notes.txt" in out


def test_pope_scorer_matches_jax(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(2)
    ann = tmp_path / "ann"
    ann.mkdir()
    qs, answers = [], []
    for c, cat in enumerate(["adversarial", "popular", "random"]):
        labels = []
        for i in range(8):
            qid = c * 100 + i
            labels.append({"question_id": qid, "label": str(rng.choice(["yes", "no"]))})
            qs.append({"question_id": qid, "category": cat})
            answers.append({"question_id": qid,
                            "text": str(rng.choice(["Yes, it is.", "No.", "no there is not",
                                                    "Yes"]))})
        (ann / f"coco_pope_{cat}.json").write_text("\n".join(map(json.dumps, labels)))
    (tmp_path / "q.jsonl").write_text("\n".join(map(json.dumps, qs)))
    (tmp_path / "a.jsonl").write_text("\n".join(map(json.dumps, answers)))
    out, _ = _both("eval_pope", lambda pkg: ["--annotation-dir", ann, "--question-file",
                                             tmp_path / "q.jsonl", "--result-file",
                                             tmp_path / "a.jsonl"], capsys, monkeypatch)
    assert out.count("Category:") == 3
    stats = [ev(pkg, "eval_pope").eval_pope([dict(a) for a in answers[:8]],
                                            str(ann / "coco_pope_adversarial.json"))
             for pkg in PKGS]
    assert stats[0] == stats[1]


def _sqa_fixture(tmp_path):
    rng = np.random.default_rng(3)
    problems, ours, requery, gpt4 = {}, [], [], {}
    for i in range(12):
        pid = str(i)
        n = int(rng.integers(2, 5))
        problems[pid] = {"choices": [f"c{j}" for j in range(n)],
                         "answer": int(rng.integers(0, n)), "image": "x.png" if i % 2 else None,
                         "question": f"q{i}"}
        letter = "ABCDE"[int(rng.integers(0, n + 1))]
        ours.append({"question_id": pid, "prompt": f"q{i}",
                     "text": [letter, f"{letter}. c0", f"The answer is {letter}.", "dunno"][i % 4]})
        requery.append({"question_id": pid, "text": f"The answer is {'ABCDE'[i % n]}."})
        gpt4[pid] = f"The answer is {'ABCDE'[(i + 1) % n]}." if i % 3 else "no idea"
    base = tmp_path / "sqa"
    base.mkdir()
    (base / "pid_splits.json").write_text(json.dumps({"test": list(problems)}))
    (base / "problems.json").write_text(json.dumps(problems))
    (tmp_path / "ours.jsonl").write_text("\n".join(map(json.dumps, ours)))
    (tmp_path / "requery.jsonl").write_text("\n".join(map(json.dumps, requery[:-2])))
    (tmp_path / "gpt4.json").write_text(json.dumps({"outputs": gpt4}))
    return base


def test_science_qa_scorers_match_jax(tmp_path, capsys, monkeypatch):
    base = _sqa_fixture(tmp_path)
    out, files = _both("eval_science_qa", lambda pkg: [
        "--base-dir", base, "--result-file", tmp_path / "ours.jsonl", "--output-file",
        tmp_path / f"{pkg}-out.jsonl", "--output-result", tmp_path / f"{pkg}-res.json"],
        capsys, monkeypatch, outputs=(".json", ".jsonl"))
    assert "Total: 12" in out and len(files) == 2
    out, _ = _both("eval_science_qa_gpt4", lambda pkg: [
        "--base-dir", base, "--our-result", tmp_path / "ours.jsonl", "--gpt4-result",
        tmp_path / "gpt4.json"], capsys, monkeypatch)
    assert out
    out, files = _both("eval_science_qa_gpt4_requery", lambda pkg: [
        "--base-dir", base, "--our-result", tmp_path / "ours.jsonl", "--gpt4-result",
        tmp_path / "gpt4.json", "--requery-result", tmp_path / "requery.jsonl",
        "--output-result", tmp_path / f"{pkg}-rq.json"],
        capsys, monkeypatch, outputs=(".json",))
    assert "Requery" in out and len(files) == 1


def test_summarize_and_webpage_match_jax(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(4)
    reviews = tmp_path / "reviews"
    reviews.mkdir()
    for name in ("reviews_a", "reviews_b", "other"):
        (reviews / f"{name}.jsonl").write_text("\n".join(json.dumps(
            {"question_id": i, "category": ["conv", "detail", "complex"][i % 3],
             "tuple": [float(x) for x in rng.integers(1, 11, 2)]}) for i in range(9)))
    out, _ = _both("summarize_gpt_review", lambda pkg: ["-d", reviews, "-i", "3"],
                   capsys, monkeypatch)
    assert "all" in out and out.count("reviews_") == 2

    table = tmp_path / "table"
    (table / "answer").mkdir(parents=True)
    (table / "review").mkdir()
    for name in ("question.jsonl",):
        (table / name).write_bytes((ROOT / "llava_plus_torch/eval/table" / name).read_bytes())
    qids = [json.loads(line)["question_id"] for line in open(table / "question.jsonl")]
    for m in ("vicuna-13b", "tiny"):
        (table / "answer" / f"answer_{m}.jsonl").write_text("\n".join(json.dumps(
            {"question_id": q, "text": f"{m} says {q}"}) for q in qids))
    (table / "review" / "review_tiny_vicuna-13b.jsonl").write_text(json.dumps(
        {"question_id": qids[0], "tuple": [7.0, 8.0], "content": "7 8\nfine"}))
    _both("generate_webpage_data_from_table", lambda pkg: [
        "--table-dir", table, "--output", tmp_path / f"{pkg}-web" / "data.json"],
        capsys, monkeypatch)
    pages = [json.loads((tmp_path / f"{pkg}-web" / "data.json").read_text()) for pkg in PKGS]
    assert pages[0] == pages[1] and pages[1]["models"] == ["tiny", "vicuna-13b"]


def test_table_assets_equal_the_originals():
    ours = ROOT / "llava_plus_torch/eval/table"
    names = sorted(p.name for p in ours.iterdir())
    assert names == ["model.jsonl", "prompt.jsonl", "question.jsonl", "reviewer.jsonl",
                     "rule.json"]
    for n in names:
        assert (ours / n).read_bytes() == (ROOT / "llava_plus_tpu/eval/table" / n).read_bytes()


# -- the GPT-judge scripts, against a stub client --------------------------------

STUB_OPENAI = '''
import json, os, types

def _create(model, messages, **kw):
    with open(os.environ["OPENAI_STUB_LOG"], "a") as f:
        f.write(json.dumps({"model": model, "messages": messages, **kw}) + "\\n")
    text = "8 6\\nstub review of " + str(len(messages[-1]["content"]))
    return types.SimpleNamespace(choices=[types.SimpleNamespace(
        message=types.SimpleNamespace(content=text))])

chat = types.SimpleNamespace(completions=types.SimpleNamespace(create=_create))
'''


def _gpt_fixture(tmp_path):
    table = ROOT / "llava_plus_torch/eval/table"
    q = [json.loads(line) for line in open(table / "question.jsonl")][:3]
    for i, row in enumerate(q):
        row["image"] = f"im{i}.jpg"
        row["category"] = ["conv", "detail", "complex"][i]
    (tmp_path / "q.jsonl").write_text("\n".join(map(json.dumps, q)))
    for k in (1, 2):
        (tmp_path / f"a{k}.jsonl").write_text("\n".join(json.dumps(
            {"question_id": r["question_id"], "answer_id": f"a{k}-{i}",
             "text": f"answer {k} to {r['text'][:20]}"}) for i, r in enumerate(q)))
    (tmp_path / "ctx.jsonl").write_text("\n".join(json.dumps(
        {"image": f"im{i}.jpg", "caption": [f"a photo {i}", "of things"],
         "captions": [f"a photo {i}"], "boxes": [{"label": "cat", "bbox": [0.1, 0.2, 0.5, 0.9]}]})
        for i in range(3)))
    return q


RULE = ROOT / "llava_plus_torch/eval/table/rule.json"
GPT_SCRIPTS = {
    "eval_gpt_review": lambda t, o: ["-q", t / "q.jsonl", "-a", t / "a1.jsonl", t / "a2.jsonl",
                                     "-r", RULE, "-o", o],
    "eval_gpt_review_bench": lambda t, o: ["-q", t / "q.jsonl", "-c", t / "ctx.jsonl", "-a",
                                           t / "a1.jsonl", t / "a2.jsonl", "-r", RULE, "-o", o],
    "eval_gpt_review_visual": lambda t, o: ["-q", t / "q.jsonl", "-c", t / "ctx.jsonl", "-a",
                                            t / "a1.jsonl", t / "a2.jsonl", "-r", RULE, "-o", o],
    "qa_baseline_gpt35": lambda t, o: ["-q", t / "q.jsonl", "-o", o],
}


@pytest.mark.parametrize("name", sorted(GPT_SCRIPTS))
def test_gpt_scripts_with_a_stub_client_match_jax(name, tmp_path):
    """Each package's script as ``python -m`` with a stub ``openai`` first on
    ``PYTHONPATH``: the same reviews (or answers) written, the same
    requests sent; the port's loads nothing of JAX."""
    stub = tmp_path / "stub"
    (stub / "openai").mkdir(parents=True)
    (stub / "openai" / "__init__.py").write_text(STUB_OPENAI)
    q = _gpt_fixture(tmp_path)
    outs = {}
    for pkg in PKGS:
        out, log = tmp_path / f"{pkg}-out.jsonl", tmp_path / f"{pkg}-log.jsonl"
        env = {k: v for k, v in os.environ.items() if k != "LLAVA_GPT_REVIEW_STUB"}
        env.update(PYTHONPATH=f"{stub}{os.pathsep}{ROOT}", OPENAI_STUB_LOG=str(log))
        code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
                f"runpy.run_module({pkg + '.eval.' + name!r}, run_name='__main__', "
                "alter_sys=True); "
                f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FOREIGN!r}); "
                "print('FOREIGN', bad)")
        r = subprocess.run([sys.executable, "-c", code, name,
                            *map(str, GPT_SCRIPTS[name](tmp_path, out))],
                           cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-3000:]
        rows = [json.loads(line) for line in open(out)]
        if name == "qa_baseline_gpt35":
            for row in rows:
                assert len(row.pop("answer_id")) == 22   # random
        outs[pkg] = (rows, [json.loads(line) for line in open(log)])
        if pkg == "llava_plus_torch":
            assert "FOREIGN []" in r.stdout
    assert outs["llava_plus_torch"] == outs["llava_plus_tpu"]
    rows, calls = outs["llava_plus_torch"]
    assert len(rows) == len(calls) == len(q)
    if name != "qa_baseline_gpt35":
        assert all(row["tuple"] == [8.0, 6.0] for row in rows)


# -- the whole path from a checkpoint, and the device ------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny LLaVA-1.5 checkpoint (random f32 weights, seed 0) with a
    word-level tokenizer that names every id, two images and a question
    file."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    from llava_plus_torch.models import llava
    from llava_plus_torch.train import checkpoint as ckpt

    root = tmp_path_factory.mktemp("evalckpt")
    cfg = tiny_llava_config()
    vocab = {"<unk>": 0, **{f"w{i}": i for i in range(1, cfg.text.vocab_size)}}
    core = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    core.pre_tokenizer = pre_tokenizers.Whitespace()
    tok = PreTrainedTokenizerFast(tokenizer_object=core, unk_token="<unk>", eos_token="</s>")
    params = llava.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    path = ckpt.export_hf_llava(params, cfg, root / "llava-v1.5-tiny", tok)
    _images(root / "imgs", 2)
    (root / "q.jsonl").write_text("\n".join(json.dumps(
        {"question_id": i, "image": f"{i}.png", "text": f"w{5 + i} w17 w99"}) for i in range(2)))
    return root, path


def _loader_argv(root, path, out, *extra):
    return ["--model-path", str(path), "--image-folder", str(root / "imgs"),
            "--question-file", str(root / "q.jsonl"), "--answers-file", str(out),
            "--max-new-tokens", "5", *extra]


def test_vqa_loader_from_a_checkpoint_on_the_cpu(checkpoint, tmp_path):
    """``python -m llava_plus_torch.eval.model_vqa_loader --device cpu`` in a
    fresh interpreter: the answers of an in-process session over the same
    checkpoint, nothing of JAX loaded; ``--engine-slots 2`` gives the same
    answers and ``--num_beams 2`` the beam search's."""
    from llava_plus_torch.eval import common, model_vqa_loader

    root, path = checkpoint
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            "runpy.run_module('llava_plus_torch.eval.model_vqa_loader', run_name='__main__', "
            "alter_sys=True); "
            f"print('FOREIGN', sorted(m for m in sys.modules if m.split('.')[0] in {FOREIGN!r}))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code, "model_vqa_loader",
                        *_loader_argv(root, path, tmp_path / "cli.jsonl", "--device", "cpu")],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOREIGN []" in r.stdout
    cli = _rows(tmp_path / "cli.jsonl")

    session = common.EvalSession(str(path), max_new_tokens=5, device="cpu")
    assert session.generator.device == torch.device("cpu")
    prompts = [model_vqa_loader.build_prompt(f"w{5 + i} w17 w99", "llava_v1") for i in range(2)]
    images = [Image.open(root / "imgs" / f"{i}.png").convert("RGB") for i in range(2)]
    want = [session.answer(p, im, stop_strings=["</s>"]) for p, im in zip(prompts, images)]
    assert [row["text"] for row in cli] == want
    assert all(len(t.split()) == 5 for t in want)
    assert cli[0]["model_id"] == "llava-v1.5-tiny"

    model_vqa_loader.main(_loader_argv(root, path, tmp_path / "eng.jsonl", "--device", "cpu",
                                       "--engine-slots", "2"))
    assert [row["text"] for row in _rows(tmp_path / "eng.jsonl")] == want

    model_vqa_loader.main(_loader_argv(root, path, tmp_path / "beam.jsonl", "--device", "cpu",
                                       "--num_beams", "2"))
    beams = [session.generator.beam_search(p, images=session._pixels(im), num_beams=2,
                                           max_new_tokens=5, stop_strings=["</s>"]).text.strip()
             for p, im in zip(prompts, images)]
    assert [row["text"] for row in _rows(tmp_path / "beam.jsonl")] == beams


RUNNER_ARGV = {
    "model_vqa_loader": lambda t: ["--question-file", t / "q.jsonl", "--answers-file",
                                   t / "a.jsonl"],
    "model_vqa_science": lambda t: ["--question-file", t / "q.json", "--answers-file",
                                    t / "a.jsonl"],
    "model_vqa_mmbench": lambda t: ["--question-file", t / "q.tsv", "--answers-file",
                                    t / "a.jsonl"],
    "model_vqa_qbench": lambda t: ["--questions-file", t / "q.json", "--answers-file",
                                   t / "a.json"],
    "model_qa": lambda t: ["--question-file", t / "q.jsonl", "--answers-file", t / "a.jsonl"],
    "run_llava": lambda t: ["--image-file", t / "0.png", "--query", "hi"],
}


@pytest.mark.parametrize("name", sorted(RUNNER_ARGV))
def test_runners_default_to_cuda_and_raise_without_a_card(checkpoint, name, tmp_path,
                                                          monkeypatch):
    """Every runner answers on ``cuda`` unless told otherwise; with no card
    it raises before loading anything, never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, path = checkpoint
    (tmp_path / "q.jsonl").write_text(json.dumps({"question_id": 0, "image": "0.png",
                                                  "text": "hi"}))
    (tmp_path / "q.json").write_text(json.dumps([{"id": "q0", "conversations": [
        {"from": "human", "value": "hi"}]}]))
    (tmp_path / "q.tsv").write_text("index\tquestion\thint\timage\tA\n0\thi\tnan\tx\ty\n")
    _images(tmp_path, 1)
    argv = ["--model-path", str(path), *map(str, RUNNER_ARGV[name](tmp_path))]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ev("llava_plus_torch", name).main(argv)
    from llava_plus_torch.eval.common import EvalSession

    with pytest.raises(RuntimeError, match="--device cuda:0: no CUDA device"):
        EvalSession(str(path), device="cuda:0")
