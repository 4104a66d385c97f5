"""The harness on the CPU: seeded traffic, the percentile and window rules,
operation and byte counts on hand-worked shapes, cells found by name, the
result line, and which modules each part loads."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from portbench import counts, measure, run, traffic
from portbench.tests import tiny

ROOT = tiny.ROOT


def test_same_seed_same_traffic_other_seed_other_order():
    mix = traffic.load_mix("describe")
    a = traffic.requests(mix, 50000, 2 ** 31 + 3, 3)
    b = traffic.requests(mix, 50000, 2 ** 31 + 3, 3)
    c = traffic.requests(mix, 50000, 2 ** 31 + 4, 3)
    assert a == b
    assert [s.question for s in a] != [s.question for s in c]
    assert [s.max_new_tokens for s in a] != [s.max_new_tokens for s in c]
    # every block holds the same set of shapes, whatever the seed
    for blk in range(3):
        sl = slice(blk * mix["block"], (blk + 1) * mix["block"])
        assert sorted((len(s.question), s.max_new_tokens) for s in a[sl]) == \
            sorted((len(s.question), s.max_new_tokens) for s in c[sl])
    assert all(mix["output_tokens"]["lo"] <= s.max_new_tokens <= mix["output_tokens"]["hi"]
               for s in a)


def test_open_loop_gaps_keep_their_set_and_mean():
    mix = dict(tiny.MIX, loop="open", rate=4.0, block=64,
               arrivals={"dist": "gamma", "cv": 2.0})
    a = traffic.requests(mix, 500, 1, 2)
    b = traffic.requests(mix, 500, 2, 2)
    gaps = lambda s: sorted(round(y.due - x.due, 9) for x, y in zip(s[:64], s[1:65]))
    assert len(gaps(a)) == 64 and a[0].due == 0.0
    assert a[64].due == pytest.approx(b[64].due)  # a block's gaps sum alike
    assert a[64].due == pytest.approx(sum(traffic.shape_set(mix)["gap"]))


def test_images_are_seeded():
    mix = dict(tiny.MIX)
    one, again, two = (traffic.images(mix, 28, s) for s in (1, 1, 2))
    assert all((x == y).all() for x, y in zip(one, again))
    assert any((x != y).any() for x, y in zip(one, two))


def test_quantile_is_linear_between_order_statistics():
    assert measure.quantile([4, 1, 3, 2], 0.5) == 2.5
    assert measure.quantile(list(range(101)), 0.95) == 95.0
    assert measure.quantile([1, 2], 0.95) == pytest.approx(1.95)
    assert measure.quantile([7], 0.95) == 7


def test_tokens_are_counted_inside_the_window_only():
    r = SimpleNamespace(times=[0.5, 1.0, 2.0, 3.5, 4.0], fused_len=10, due=0.0, ok=True)
    out = {"records": [r], "w0": 1.0, "w1": 3.5}
    assert [j for _, j in measure.window_tokens(out)] == [1, 2, 3]
    assert measure.decode_positions(out) == [10, 11, 12]
    assert measure.window_prefills(out) == []
    reader = run.reader("serve.output_tokens_per_s")
    assert reader(SimpleNamespace(out=dict(out, window_s=2.5))) == pytest.approx(3 / 2.5)


def test_counts_on_hand_worked_shapes():
    mpt = json.loads((ROOT / "portbench/configs/llava-mpt-7b.json").read_text())
    D, F, L, V = 4096, 16384, 32, 50432
    assert counts.layer_macs(mpt) == D * 3 * D + D * D + D * F + F * D
    assert counts.int8_weight_bytes(mpt) == L * (D * 3 * D + 4 * 3 * D + D * D + 4 * D
                                                 + D * F + 4 * F + F * D + 4 * D)
    # 32 layers x (k and v) x 32 heads x (128 int8 values + one f32 scale)
    assert counts.kv_entry_bytes(mpt) == 32 * 2 * 32 * 132
    assert counts.attention_flops(mpt, 9) == 4 * 32 * 128 * 10 * 32
    assert counts.prefill_attention_flops(mpt, 3) == 2 * 32 * 128 * 3 * 4 * 32
    assert counts.decode_token_flops(mpt, 0) == 2 * (counts.layer_macs(mpt) * L + D * V) \
        + counts.attention_flops(mpt, 0)
    # CLIP-L/224: 23 layers of 257 tokens, the patch embedding, a linear projector
    T = 257
    per = 2 * T * (4 * 1024 * 1024 + 2 * 1024 * 4096) + 4 * T * T * 1024
    assert counts.vision_flops(mpt) == 23 * per + 2 * 256 * 588 * 1024 + 2 * 256 * 1024 * D
    mistral = json.loads((ROOT / "portbench/configs/llava-mistral-7b.json").read_text())
    assert counts.layer_matrices(mistral) == [(4096, 6144), (4096, 4096), (4096, 28672),
                                              (14336, 4096)]
    assert counts.kv_entry_bytes(mistral) == 32 * 2 * 8 * 132
    assert counts.num_patches(mistral) == 576


def test_a_cell_added_as_files_is_found(tmp_path):
    root = tiny.make(tmp_path, ("tiny-mpt",))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert run.find_cell(bench, "tiny-mpt.describe")["config"] == "tiny-mpt"
    e2e = [m["name"] for m in run.cell_metrics(bench, "tiny-mpt.describe", False)]
    assert e2e == ["serve.output_tokens_per_s", "setup_s"]
    layer = [m["name"] for m in run.cell_metrics(bench, "tiny-mpt.describe", True)]
    assert "engine.step_ms.tokens" in layer and "mfu.tokens" in layer
    # nothing that was there changed
    for name in ("run.py", "serve.py", "traffic/describe.json", "cells/mpt7b.describe.json"):
        assert (root / "portbench" / name).read_bytes() == (ROOT / "portbench" / name).read_bytes()


def test_a_cell_kind_and_a_generator_added_as_files_are_found(tmp_path):
    root = tiny.make(tmp_path, ("tiny-mpt",))
    bench_dir = root / "portbench"
    (bench_dir / "replay.py").write_text(
        "def run(*a, **k):\n    return {}\n\n\ndef check(*a, **k):\n    return {}\n\n\n"
        "def load_summary(out):\n    return {}\n")
    kind = run.driver("replay", bench_dir)
    assert all(callable(getattr(kind, f)) for f in ("run", "check", "load_summary"))
    assert callable(run.driver("serve", bench_dir).run)
    with pytest.raises(SystemExit):
        run.driver("nothing", bench_dir)
    (bench_dir / "generators").mkdir()
    (bench_dir / "generators" / "one.py").write_text(
        "from portbench.traffic import Spec\n\n\n"
        "def requests(mix, vocab_words, seed, n_blocks):\n"
        "    return [Spec(index=0, question=[40], max_new_tokens=3, image=0)]\n")
    gen = traffic.generator(dict(tiny.MIX, generator="one"), bench_dir)
    assert [s.max_new_tokens for s in gen(tiny.MIX, 500, 1, 1)] == [3]
    assert traffic.generator(tiny.MIX) is traffic.requests


def test_device_metrics_read_the_profiled_window_and_the_rest_the_measured_one():
    r = SimpleNamespace(times=[0.5, 1.5, 2.5, 5.5, 6.5], fused_len=10, due=0.0, ok=True)
    out = {"records": [r], "w0": 1.0, "w1": 3.0, "window_s": 2.0,
           "counters": {"decode_steps": 2},
           "trace": {"w0": 5.0, "w1": 7.0, "window_s": 2.0, "counters": {"decode_steps": 8}}}
    seen = run.views(out)
    assert seen["host_clock"] is out and seen["program_counter"] is out
    assert measure.decode_positions(seen["device_trace"]) == [12, 13]
    assert seen["device_trace"]["counters"] == {"decode_steps": 8}
    assert run.views(dict(out, trace=None))["device_trace"] is None
    step = run.reader("engine.step_ms.tokens")
    assert step(SimpleNamespace(out=seen["program_counter"])) == pytest.approx(1e3)


def test_the_idle_share_is_the_measured_windows_work_at_the_profiled_device_time():
    cfg = json.loads((ROOT / "portbench/configs/llava-mpt-7b.json").read_text())
    # one request decoding at positions 101 on: 4 tokens in the measured window
    # (1 s), 2 in the profiled one (2 s, the host slowed), each of 0.01 device s
    r = SimpleNamespace(times=[0.0, 0.2, 0.4, 0.6, 0.8, 2.0, 3.0], fused_len=101, due=0.0, ok=True)
    out = {"records": [r], "w0": 0.1, "w1": 1.1, "window_s": 1.0, "counters": {},
           "trace": {"w0": 1.5, "w1": 3.5, "window_s": 2.0, "counters": {}, "busy_s": 0.02}}
    traced = run.views(out)["device_trace"]
    per_token = [counts.decode_token_flops(cfg, p) for p in range(101, 107)]
    busy_per_flop = 0.02 / sum(per_token[4:])
    want = 100.0 * (1.0 - busy_per_flop * sum(per_token[:4]) / 1.0)
    idle = run.reader("device.idle_share.tokens")
    assert idle(SimpleNamespace(out=traced, cfg=cfg)) == pytest.approx(want)
    assert 95.0 < want < 97.0  # about 4 x 0.01 device s in 1 s; the profiled window's own: 99


def test_a_per_layer_metric_lists_its_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert all(m["workloads"] for m in bench["per_layer"])
    bench["per_layer"] = [dict(bench["per_layer"][0])]
    del bench["per_layer"][0]["workloads"]
    with pytest.raises(KeyError):
        run.cell_metrics(bench, "mpt7b.describe", True)


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(run.reader(m["name"]))
    for w in bench["workloads"]:
        assert (ROOT / "portbench/cells" / f"{w['name']}.json").exists()
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").exists()


@pytest.mark.parametrize("cell,trace", [("describe", 0), ("describe", 1), ("vqa", 0)])
def test_a_run_prints_the_five_keys(tmp_path, cell, trace):
    root = tiny.make(tmp_path, ("tiny-mpt",))
    args = run.parse(["--workload", f"tiny-mpt.{cell}", "--seed", str(2 ** 31 + 77),
                      "--seconds", "1", "--trace", str(trace)])
    res = run.execute(args, "cpu", root=root, bench_dir=root / "portbench")
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    if trace:
        assert "engine.step_ms.tokens" in res["metrics"] and "breakdown" in res
    elif cell == "describe":
        assert set(res["metrics"]) == {"serve.output_tokens_per_s", "setup_s"}
    else:
        assert set(res["metrics"]) == {"serve.ttft_p95_ms", "serve.tpot_p95_ms", "setup_s"}


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    mods = _loaded("import portbench.run as r, portbench.serve, portbench.trace, portbench.shares\n"
                   "from portbench import port; port.llava_config(r.load_json(r.ROOT / "
                   "'portbench/configs/llava-mpt-7b.json'))\n"
                   "import llava_plus_torch.serve.model_worker")
    assert not mods & {"jax", "jaxlib", "flax", "llava_plus_tpu"}
    assert "llava_plus_torch" in mods


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import portbench.reference.model, portbench.weights, portbench.tokenizer")
    assert not mods & {"jax", "jaxlib", "flax", "llava_plus_tpu", "llava_plus_torch"}


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mpt7b.describe",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
