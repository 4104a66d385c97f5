"""The port's LLaVA-Plus control plane against the JAX package's, function by
function, on the same inputs made from a seed with numpy: the wire
protocol, the controller's registry and dispatch, the COCO RLE codecs and
overlays, the orchestrator's tool-call surgery and folding, the web
server's sessions and image modes, the demo images, the serving utilities,
the grounding-data generator and the tool workers' helpers. Every module of
the port is its own copy (no import of JAX or of the JAX package); each case
here feeds both copies and compares what they give."""

import asyncio
import base64
import dataclasses
import importlib
import io
import json
import random
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(1)


def both(name):
    """The JAX package's module ``name`` and the port's."""
    return (importlib.import_module(f"llava_plus_tpu.{name}"),
            importlib.import_module(f"llava_plus_torch.{name}"))


def _image(seed, w=100, h=80):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def _pixels(img):
    return None if img is None else (img.size, img.mode, np.asarray(img).tobytes())


# -- serve/protocol ----------------------------------------------------------

class _AsyncContent:
    def __init__(self, parts):
        self.parts = parts

    async def iter_chunks(self):
        for p in self.parts:
            yield p, False


class _Resp:
    """An aiohttp-like (``content.iter_chunks``) and requests-like
    (``iter_lines``) response over fixed byte parts."""

    def __init__(self, parts):
        self.content = _AsyncContent(parts)
        self.data = b"".join(parts)

    def iter_lines(self, decode_unicode=False, delimiter=None):
        yield from self.data.split(delimiter)


def _payloads(seed):
    rng = np.random.default_rng(seed)
    return [{"text": "".join(chr(c) for c in rng.integers(32, 0x2FF, size=int(n))),
             "error_code": int(rng.integers(0, 4))} for n in rng.integers(0, 40, size=6)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_protocol_framing_and_streams(seed):
    jp, tp = both("serve.protocol")
    payloads = _payloads(seed)
    data = b"".join(tp.encode_chunk(p) for p in payloads)
    assert data == b"".join(jp.encode_chunk(p) for p in payloads)
    assert list(tp.decode_stream(data)) == list(jp.decode_stream(data)) == payloads
    # split the stream at random byte offsets, as a socket delivers it
    cuts = sorted(np.random.default_rng(seed).integers(0, len(data), size=7).tolist())
    parts = [data[a:b] for a, b in zip([0] + cuts, cuts + [len(data)])]

    async def collect(mod):
        return [c async for c in mod.iter_chunks(_Resp(parts))]

    assert asyncio.run(collect(tp)) == asyncio.run(collect(jp)) == payloads
    assert (list(tp.iter_chunks_requests(_Resp(parts)))
            == list(jp.iter_chunks_requests(_Resp(parts))) == payloads)


def test_protocol_types():
    jp, tp = both("serve.protocol")
    assert {e.name: int(e) for e in tp.ErrorCode} == {e.name: int(e) for e in jp.ErrorCode}
    assert ([f.name for f in dataclasses.fields(tp.WorkerInfo)]
            == [f.name for f in dataclasses.fields(jp.WorkerInfo)])
    assert tp.DELIMITER == jp.DELIMITER


# -- serve/controller --------------------------------------------------------

def _registry(c):
    return {k: dataclasses.asdict(v) for k, v in c.worker_info.items()}


def _script(seed, method):
    """A seeded sequence of controller operations."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(5):
        ops.append(("register", f"http://w{i}", bool(rng.integers(0, 2)), {
            "model_names": [f"m{j}" for j in range(int(rng.integers(1, 3)))],
            "speed": int(rng.integers(1 if method == "shortest_queue" else 0, 4)),
            "queue_length": int(rng.integers(0, 6))}))
    for _ in range(12):
        kind = rng.integers(0, 3)
        if kind == 0:
            ops.append(("dispatch", f"m{int(rng.integers(0, 3))}"))
        elif kind == 1:
            ops.append(("beat", f"http://w{int(rng.integers(0, 6))}", int(rng.integers(0, 5))))
        else:
            ops.append(("remove", f"http://w{int(rng.integers(0, 6))}"))
    return ops


def _run(mod, ops, method, seed):
    c = mod.Controller(method, start_expiration_thread=False)
    c.get_worker_status = lambda name: None      # no worker answers over HTTP here
    np.random.seed(seed)
    out = []
    for op in ops:
        if op[0] == "register":
            out.append(c.register_worker(op[1], op[2], dict(op[3])))
        elif op[0] == "dispatch":
            out.append(c.get_worker_address(op[1]))
        elif op[0] == "beat":
            out.append(c.receive_heart_beat(op[1], op[2]))
        else:
            c.remove_worker(op[1])
        out.append(sorted(c.list_models()))
    reg = _registry(c)
    for v in reg.values():
        v.pop("last_heart_beat")
    return out, reg


@pytest.mark.parametrize("method", ["lottery", "shortest_queue"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_controller_registry_and_dispatch(method, seed):
    jc, tc = both("serve.controller")
    ops = _script(seed, method)
    assert _run(tc, ops, method, seed) == _run(jc, ops, method, seed)


def test_controller_expiration_and_refresh():
    jc, tc = both("serve.controller")
    got = []
    for mod in (jc, tc):
        c = mod.Controller("shortest_queue", heartbeat_expiration=0.2,
                           start_expiration_thread=False)
        c.get_worker_status = lambda name: (
            {"model_names": ["m"], "speed": 1, "queue_length": 7} if name == "http://a" else None)
        c.register_worker("http://a", True, {"model_names": ["m"], "speed": 1, "queue_length": 0})
        c.register_worker("http://b", True, {"model_names": ["n"], "speed": 1, "queue_length": 0})
        c.register_worker("http://c", False, None)     # status from the (stub) probe: none
        c.register_worker("http://d", False, {"model_names": ["n"], "speed": 2, "queue_length": 1})
        time.sleep(0.25)
        c.receive_heart_beat("http://b", 2)
        c.remove_stale_workers_by_expiration()
        first = sorted(c.worker_info)
        c.refresh_all_workers()        # re-probes every worker: only a answers
        got.append((first, _registry_q(c), c.receive_heart_beat("http://a", 1),
                    c.receive_heart_beat("http://zz", 1)))
        c.stop()
    assert got[0] == got[1]
    assert got[1][0] == ["http://b", "http://d"]


def _registry_q(c):
    return {k: (v.model_names, v.speed, v.queue_length, v.check_heart_beat)
            for k, v in c.worker_info.items()}


def test_controller_status_sums_workers():
    jc, tc = both("serve.controller")
    statuses = {"http://a": {"model_names": ["x"], "speed": 2, "queue_length": 3},
                "http://b": {"model_names": ["x", "y"], "speed": 1, "queue_length": 1},
                "http://c": None}
    got = []
    for mod in (jc, tc):
        c = mod.Controller("lottery", start_expiration_thread=False, probe_on_dispatch=True)
        c.get_worker_status = statuses.get
        for name in statuses:
            c.register_worker(name, False, {"model_names": ["x"], "speed": 1, "queue_length": 0})
        s = c.worker_api_get_status()
        np.random.seed(5)
        picks = [c.get_worker_address("x") for _ in range(6)]
        got.append((sorted(s["model_names"]), s["speed"], s["queue_length"], picks,
                    sorted(c.worker_info)))
    assert got[0] == got[1]
    with pytest.raises(ValueError):
        tc.DispatchMethod.from_str("round_robin")


# -- serve/annotation --------------------------------------------------------

def _coco_compress(counts):
    """pycocotools' rleToString: LEB128-like 5-bit groups, offset 48, each
    count after the second stored as a difference from the one two back."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _masks(seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(3, 40, size=2))
    return [rng.random((h, w)) < p for p in (0.0, 0.1, 0.5, 0.9, 1.0)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_round_trips_and_compressed_counts(seed):
    ja, ta = both("serve.annotation")
    for mask in _masks(seed):
        rle = ta.mask_to_rle(mask)
        assert rle == ja.mask_to_rle(mask)
        np.testing.assert_array_equal(ta.rle_to_mask(rle), mask.astype(np.uint8))
        np.testing.assert_array_equal(ta.rle_to_mask(rle), ja.rle_to_mask(rle))
        packed = _coco_compress(rle["counts"])
        for counts in (packed, packed.encode()):
            comp = {"size": rle["size"], "counts": counts}
            np.testing.assert_array_equal(ta.rle_to_mask(comp), mask.astype(np.uint8))
            np.testing.assert_array_equal(ta.rle_to_mask(comp), ja.rle_to_mask(comp))
        assert (ta._decode_coco_compressed(packed, *rle["size"])
                == ja._decode_coco_compressed(packed, *rle["size"]))
        assert ta.mask_to_bbox(mask) == ja.mask_to_bbox(mask)


@pytest.mark.parametrize("seed", [0, 1])
def test_overlays_pixels_equal(seed):
    ja, ta = both("serve.annotation")
    rng = np.random.default_rng(seed)
    img = _image(seed)
    xy = rng.random((7, 2)) * [60, 50]
    boxes = np.concatenate([xy, xy + rng.random((7, 2)) * 30 + 1], axis=1).round(2).tolist()
    labels = [f"obj{i}" for i in range(5)]
    points = rng.random((8, 2)).tolist()
    masks = [rng.random((80, 100)) < 0.3 for _ in range(7)]
    for kw in (dict(), dict(normalized=True, width=1)):
        norm = (np.asarray(boxes) / [100, 80, 100, 80]).tolist() if kw else boxes
        assert (_pixels(ta.draw_boxes(img, norm, labels, **kw))
                == _pixels(ja.draw_boxes(img, norm, labels, **kw)))
    assert _pixels(ta.draw_masks(img, masks)) == _pixels(ja.draw_masks(img, masks))
    assert (_pixels(ta.draw_masks(img, masks, alpha=0.2))
            == _pixels(ja.draw_masks(img, masks, alpha=0.2)))
    for kw in (dict(), dict(normalized=False, radius=3)):
        pts = (np.asarray(points) * [100, 80]).tolist() if kw else points
        assert _pixels(ta.draw_points(img, pts, **kw)) == _pixels(ja.draw_points(img, pts, **kw))


# -- serve/orchestrator ------------------------------------------------------

def _tool_texts():
    jconv, tconv = both("conversation")
    actions = [{"API_name": "grounding_dino", "API_params": {"caption": "a cat"}}]
    body = tconv.serialize_tool_turn(thoughts="t", actions=actions, value="v")
    assert body == jconv.serialize_tool_turn(thoughts="t", actions=actions, value="v")
    return [body, body.replace('"API_name"', "'API_name'"), "no grammar here",
            body.replace('"actions🚀" [', '"actions🚀" [[['), body + body,
            tconv.serialize_tool_turn(thoughts="x", actions=[], value="y")]


def test_parse_tool_cfg():
    jo, to = both("serve.orchestrator")
    for text in _tool_texts():
        assert to.parse_tool_cfg(text) == jo.parse_tool_cfg(text)


API_NAMES = ["grounding_dino", "sam", "grounding_dino+sam", "grounded_sam", "ram",
             "ram+grounding_dino", "blip2", "blip2+grounding_dino", "retrieval", "clip", "ocr",
             "easyocr", "stable-diffusion", "sd", "instruct-pix2pix", "ip2p", "inpainting",
             "seem", "semantic-sam", "controlnet", "openseed"]


def _session(mod, seed):
    rng = np.random.default_rng(seed)
    return mod.ToolSession(mask_rle={"size": [2, 2], "counts": rng.integers(0, 4, 2).tolist()},
                           image_seg=f"SEG{seed}", reference_image=f"REF{seed}",
                           reference_mask=f"REFMASK{seed}")


@pytest.mark.parametrize("api", API_NAMES)
def test_prepare_tool_call_every_branch(api):
    jo, to = both("serve.orchestrator")
    cfg = [{"API_name": api, "API_params": {"caption": "cat", "image": "DROPPED",
                                            "box_threshold": 0.5}}]
    for image in ("IMG64", None):
        want = jo.prepare_tool_call(json.loads(json.dumps(cfg)), image, _session(jo, 1))
        assert to.prepare_tool_call(json.loads(json.dumps(cfg)), image, _session(to, 1)) == want
    with pytest.raises(AssertionError):
        to.prepare_tool_call(cfg * 2, None, to.ToolSession())


@pytest.mark.parametrize("api", [a for a in API_NAMES if a != "openseed"])
def test_fold_and_annotate_the_fake_tools_responses(api):
    """The fake tool worker's canned response for ``api`` (equal in both
    copies), folded, quoted into the round-2 message and drawn on the
    image: every step equal."""
    jo, to = both("serve.orchestrator")
    jf, tf = both("serve.tool_workers.fake_tool_worker")
    img = _image(3)
    raw = tf._canned(api, img)
    assert raw == jf._canned(api, img)
    results = []
    for o in (jo, to):
        session = o.ToolSession()
        try:
            folded, artifacts = o.fold_tool_response(api, raw, session)
        except TypeError as e:
            results.append(("TypeError", str(e)))
            continue
        msg = o.build_round2_message(api, folded, "  <image>find the cat ")
        annotated = o.annotate_result(img, folded, artifacts)
        results.append((folded, artifacts, dataclasses.asdict(session), msg,
                        _pixels(annotated)))
    if api not in ("ocr", "easyocr"):
        assert results[0] == results[1]
        return
    # the OCR schema's polygon boxes fail the JAX copy's rounding; the port
    # rounds at any depth and drops easyocr's boxes and scores first
    assert results[0][0] == "TypeError"
    folded, artifacts, _, msg, annotated = results[1]
    assert folded["texts"] == ["HELLO"] and artifacts == {}
    assert "HELLO" in msg and msg.startswith(f"{api} model outputs:")
    if api == "easyocr":
        assert set(folded) == {"texts"} and annotated is None
    else:
        assert folded["boxes"] == [[[0.0, 0.0], [100.0, 0.0], [100.0, 20.0], [0.0, 20.0]]]
        assert folded["scores"] == [0.99]
        assert annotated is not None and annotated[0] == img.size
        assert annotated[2] != _pixels(img)[2]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_rounding_and_mask_bbox(seed):
    jo, to = both("serve.orchestrator")
    rng = np.random.default_rng(seed)
    resp = {"boxes": rng.random((3, 4)).tolist(), "logits": rng.random(3).tolist(),
            "scores": rng.random(3).tolist(), "size": [8, 9],
            "retrieval_results": [{"caption": "c", "similarity": float(s)}
                                  for s in rng.random(2)],
            "masks_rle": [{"size": [2, 2], "counts": [4]}], "points": rng.random((2, 2)).tolist()}
    outs = []
    for o in (jo, to):
        s = o.ToolSession()
        outs.append((o.fold_tool_response("easyocr" if seed == 2 else "x", resp, s),
                     dataclasses.asdict(s)))
    assert outs[0] == outs[1]
    mask = np.zeros((40, 50, 4), np.uint8)
    y0, x0 = rng.integers(0, 20, 2)
    mask[y0:y0 + 10, x0:x0 + 15] = 255
    for m in (Image.fromarray(mask, mode="RGBA"), Image.fromarray(mask[..., 0]),
              Image.fromarray(np.zeros((4, 4), np.uint8))):
        assert to.get_mask_bbox(m) == jo.get_mask_bbox(m)


# -- serve/web_server --------------------------------------------------------

def test_session_store_ttl_and_eviction(monkeypatch):
    jw, tw = both("serve.web_server")
    got = []
    for mod in (jw, tw):
        clock = [1000.0]
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
        store = mod.SessionStore(ttl_s=10, cap=3)
        trace = []
        a = store.get("a")
        a.mask_rle = {"counts": [1]}
        for step, sid in enumerate(["b", "c", "a", "d", "e", "a", "b"]):
            clock[0] += 2.0
            trace.append((sid, store.get(sid) is a, sorted(store._sessions)))
        clock[0] += 11.0       # every session but the next one expires
        trace.append(("late", store.get("a") is a, sorted(store._sessions)))
        store.reset("a")
        trace.append(("reset", sorted(store._sessions)))
        got.append(trace)
    assert got[0] == got[1]


@pytest.mark.parametrize("mode", ["Default", "Raw+Processor", None, "Pad", "Crop", "Resize"])
def test_apply_process_mode(mode):
    jw, tw = both("serve.web_server")
    for seed, (w, h) in enumerate([(100, 80), (60, 90), (50, 50)]):
        img = _image(seed, w, h)
        assert (_pixels(tw._apply_process_mode(img, mode))
                == _pixels(jw._apply_process_mode(img, mode)))
    assert tw._apply_process_mode(None, mode) is None
    with pytest.raises(ValueError):
        tw._apply_process_mode(_image(0), "Stretch")


def test_example_prompts_equal():
    jw, tw = both("serve.web_server")
    assert tw._example_prompts() == jw._example_prompts()


# -- utils -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["unusual", "waterview", "logo", "cat"])
def test_demo_images_bytes_equal(name, tmp_path):
    jd, td = both("utils.demo_assets")
    assert td.demo_image_b64(name) == jd.demo_image_b64(name)
    assert td.demo_image_b64(name, "JPEG") == jd.demo_image_b64(name, "JPEG")
    if name == "cat":
        paths = td.write_demo_images(str(tmp_path / "port"))
        jpaths = jd.write_demo_images(str(tmp_path / "jax"))
        for a, b in zip(paths, jpaths):
            assert open(a, "rb").read() == open(b, "rb").read()


def test_misc_functions(monkeypatch, tmp_path):
    jm, tm = both("utils.misc")
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    assert tm.violates_moderation("anything") is jm.violates_moderation("anything") is False
    rng = random.Random(0)
    for _ in range(50):
        out = "".join(rng.choice("ab#<") for _ in range(rng.randint(0, 6)))
        stop = "".join(rng.choice("ab#<") for _ in range(rng.randint(1, 4)))
        assert tm.is_partial_stop(out, stop) == jm.is_partial_stop(out, stop)
    for text in ["hello", "你好 world", "", "ﾃｽﾄ", "mixed 中"]:
        assert tm.detect_language(text) == jm.detect_language(text)
    # no CUDA device here: None, as the JAX function gives without memory stats
    assert tm.get_device_memory() is None and jm.get_device_memory() is None

    async def agen(n):
        for i in range(n):
            await asyncio.sleep(0)
            yield i * i

    assert list(tm.iter_over_async(agen(5))) == list(jm.iter_over_async(agen(5)))
    creds = tmp_path / "auth.txt"
    creds.write_text("alice:pw1\n\n bob:p:w2 \nnocolon\n")
    assert tm.parse_gradio_auth_creds(str(creds)) == jm.parse_gradio_auth_creds(str(creds))
    (tmp_path / "empty.txt").write_text("\n")
    assert tm.parse_gradio_auth_creds(str(tmp_path / "empty.txt")) is None


def test_logging_messages_equal():
    jl, tl = both("utils.logging")
    assert (tl.moderation_msg, tl.server_error_msg) == (jl.moderation_msg, jl.server_error_msg)


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_grounding_data_rows_equal(seed, tmp_path, monkeypatch):
    jg, tg = both("tools.generate_grounding_data")
    rng = np.random.default_rng(seed)
    rows = [{"id": i, "image": f"{i}.jpg",
             "boxes": [{"label": f"thing{j}", "bbox": rng.random(4).tolist()}
                       for j in range(int(rng.integers(0, 3)))]} for i in range(6)]
    a, b = random.Random(seed), random.Random(seed)
    good = [r for r in rows if r["boxes"]]
    assert ([tg.make_sample(r, a) for r in good] == [jg.make_sample(r, b) for r in good])
    (tmp_path / "q.json").write_text(json.dumps(rows))
    outs = []
    for mod, name in ((tg, "port.json"), (jg, "jax.json")):
        monkeypatch.setattr(sys, "argv", ["gen", "--question-file", str(tmp_path / "q.json"),
                                          "--output-file", str(tmp_path / name),
                                          "--num-samples", "9", "--seed", str(seed)])
        mod.main()
        outs.append(json.loads((tmp_path / name).read_text()))
    assert outs[0] == outs[1] and len(outs[0]) == 9


# -- tool workers --------------------------------------------------------------

THIN = ["blip2_worker", "blip2grounding_worker", "clip_retrieval_worker",
        "grounded_sam_worker", "grounding_dino_worker", "inpainting_worker",
        "instructpix2pix_worker", "ocr_worker", "openseed_controlnet_worker",
        "ram_grounding_worker", "ram_worker", "sam_worker", "seem_worker",
        "semantic_sam_worker", "stablediffusion_worker"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_equal(seed):
    jd, td = both("serve.tool_workers.grounding_dino_worker")
    rng = np.random.default_rng(seed)
    xy = rng.random((30, 2)) * 100
    boxes = np.concatenate([xy, xy + rng.random((30, 2)) * 40 + 1], axis=1)
    scores = rng.random(30)
    for iou in (0.3, 0.5, 0.8):
        assert td.nms_xyxy(boxes, scores, iou) == jd.nms_xyxy(boxes, scores, iou)


def _parser_view(parser):
    return sorted((a.dest, tuple(a.option_strings), repr(a.default), a.type and a.type.__name__)
                  for a in parser._actions)


@pytest.mark.parametrize("name", THIN)
def test_thin_tool_workers_flags_equal(name):
    import argparse

    jt, tt = both(f"serve.tool_workers.{name}")
    views = []
    for mod in (jt, tt):
        parser = argparse.ArgumentParser()
        mod._extra(parser)
        views.append(_parser_view(parser))
    assert views[0] == views[1]
    jclasses = sorted(n for n, v in vars(jt).items() if isinstance(v, type)
                      and v.__module__ == jt.__name__)
    assert jclasses == sorted(n for n, v in vars(tt).items() if isinstance(v, type)
                              and v.__module__ == tt.__name__)


class _Reader:
    def readtext(self, image):
        h, w = image.shape[:2]
        return [([[0, 0], [w, 0], [w, 9.5], [0, 9.5]], "HELLO", 0.987654),
                ([[1, 2], [3, 4], [5, 6], [7, 8]], "x", 0.5)]


class _Stub:
    def __init__(self, out):
        self.out = out

    def generate(self, params):
        return dict(self.out, seen=sorted(params))


def test_tool_workers_generate_with_stubbed_models():
    """The thin clients' own logic around their models (OCR formatting, the
    chained workers' merging), with each model stubbed the same way."""
    got = []
    for pkg in ("llava_plus_tpu", "llava_plus_torch"):
        tw = f"{pkg}.serve.tool_workers"
        ocr = importlib.import_module(f"{tw}.ocr_worker").OcrWorker(
            "", "http://x", ["ocr"], no_register=True)
        ocr.reader = _Reader()
        base = importlib.import_module(f"{tw}.base")
        img64 = base.image_to_b64(_image(4))
        out = [ocr.generate({"image": img64})]
        for mod, cls, attrs in (
                ("ram_grounding_worker", "RamGroundingWorker",
                 {"ram": {"tags": "cat | sofa"}, "dino": {"boxes": [[1, 2, 3, 4]]}}),
                ("blip2grounding_worker", "Blip2GroundingWorker",
                 {"blip2": {"caption": "a cat"}, "dino": {"phrases": ["cat"]}})):
            w = object.__new__(getattr(importlib.import_module(f"{tw}.{mod}"), cls))
            for k, v in attrs.items():
                setattr(w, k, _Stub(v))
            out.append(w.generate({"image": img64}))
        gen = base.ToolWorker("", "http://x", ["t"], no_register=True)
        out.append(gen.generate_gate({}))      # NotImplementedError: internal error
        gen.generate = lambda p: (_ for _ in ()).throw(ValueError("bad"))
        out.append(gen.generate_gate({}))
        out.append((gen.get_status(), base.load_image(None), np.asarray(
            base.load_image(img64)).tobytes() == np.asarray(_image(4)).tobytes()))
        got.append(json.loads(json.dumps(out, default=int)))
    assert got[0] == got[1]


def test_fake_tool_worker_and_clients_equal():
    jf, tf = both("serve.tool_workers.fake_tool_worker")
    jt, tt = both("serve.tool_workers.test_message")
    jc, tc = both("serve.tool_workers.constants")
    img64 = tf.image_to_b64(_image(5))
    for api in API_NAMES[:-1] + ["nope"]:
        outs = []
        for mod in (jf, tf):
            w = mod.FakeToolWorker("", "http://x", [api], no_register=True)
            outs.append(w.generate_gate({"image": img64, "mode": "controlnet"}))
            outs.append(w.generate_gate({}))
        assert json.loads(json.dumps(outs[:2])) == json.loads(json.dumps(outs[2:]))
    assert tt.CANNED_PARAMS == jt.CANNED_PARAMS
    # every constant equal but the heartbeat, which the port beats inside
    # the controller's expiry (test_tool_worker_heartbeat_inside_expiry)
    names = [n for n in vars(jc) if n.isupper() and n != "WORKER_HEART_BEAT_INTERVAL"]
    assert {n: getattr(tc, n) for n in names} == {n: getattr(jc, n) for n in names}
    assert {e.name: int(e) for e in tc.ErrorCode} == {e.name: int(e) for e in jc.ErrorCode}
    assert (jc.WORKER_HEART_BEAT_INTERVAL, tc.WORKER_HEART_BEAT_INTERVAL) == (45, 15)


def test_tool_worker_heartbeat_inside_expiry(monkeypatch):
    """A tool worker stays registered with the port's controller. The JAX
    copy's tool workers beat every 45 s against its controller's 30 s
    expiry (kept there); the port's beat at its LLM workers' 15 s. Live,
    scaled down: a controller that expires a worker after ``E`` seconds and
    a tool worker beating at the port's default ratio keep the tool in
    ``/list_models`` at every poll across four expiry windows."""
    import threading

    from aiohttp import web

    jconst, tconst = both("constants")
    jc, tc = both("serve.tool_workers.constants")
    assert jc.WORKER_HEART_BEAT_INTERVAL > jconst.CONTROLLER_HEART_BEAT_EXPIRATION
    assert tc.WORKER_HEART_BEAT_INTERVAL < tconst.CONTROLLER_HEART_BEAT_EXPIRATION
    ctrl = importlib.import_module("llava_plus_torch.serve.controller")
    base = importlib.import_module("llava_plus_torch.serve.tool_workers.base")
    fake = importlib.import_module("llava_plus_torch.serve.tool_workers.fake_tool_worker")
    import requests

    E = 0.8
    controller = ctrl.Controller("shortest_queue", heartbeat_expiration=E)
    assert controller.heartbeat_expiration == E
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(ctrl.build_app(controller))
    started = threading.Event()
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(10)
    url = f"http://127.0.0.1:{port}"
    assert base.WORKER_HEART_BEAT_INTERVAL == tc.WORKER_HEART_BEAT_INTERVAL
    monkeypatch.setattr(base, "WORKER_HEART_BEAT_INTERVAL", tc.WORKER_HEART_BEAT_INTERVAL * E
                        / tconst.CONTROLLER_HEART_BEAT_EXPIRATION)
    worker = fake.FakeToolWorker(url, "http://127.0.0.1:9", ["ocr"])
    try:
        seen = []
        t_end = time.time() + 4 * E
        while time.time() < t_end:
            seen.append(requests.post(url + "/list_models", timeout=5).json()["models"])
            time.sleep(0.05)
        assert len(seen) > 20 and all(m == ["ocr"] for m in seen), seen
    finally:
        worker._stop.set()
        controller.stop()
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)


def test_tool_test_message_encodes_equal(tmp_path):
    jt, tt = both("serve.tool_workers.test_message")
    for i, size in enumerate([(100, 80), (1200, 500)]):
        path = tmp_path / f"{i}.png"
        _image(i, *size).save(path)
        assert tt.encode_image(str(path)) == jt.encode_image(str(path))
    big = Image.open(io.BytesIO(base64.b64decode(tt.encode_image(str(tmp_path / "1.png")))))
    assert big.size == (800, 333)
