"""``llava_plus_torch/tools/train_resume.py`` on the CPU: its dry run
(``--device cpu --tiny``) of both points, the one-process run and the run
over 4 gloo ranks at (1, 4, 1), each cut after its save and resumed by
fresh processes, with every check it makes; and its checks refusing a
resumed run that is not the run that was never cut."""

import copy
import json

import pytest
import torch

from llava_plus_torch.tools import train_resume

torch.set_num_threads(1)


def test_the_tools_dry_run_passes_every_check(monkeypatch, tmp_path):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "lines.jsonl"
    train_resume.main(["--device", "cpu", "--tiny", "--work", str(tmp_path / "work"),
                       "--out", str(out)])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    results = [line for line in lines if "checks" in line]
    assert [r["point"] for r in results] == [1, 2]
    assert all(r["ok"] and all(r["checks"].values()) for r in results)
    procs = [line for line in lines if "role" in line]
    assert sorted((p["point"], p["role"], p["rank"]) for p in procs) == sorted(
        [(1, "A", 0), (1, "B", 0)] + [(2, role, r) for role in "AB" for r in range(4)])
    for p in procs:
        assert list(p["steps"]) == (["1", "2", "3", "4"] if p["role"] == "A" else ["3", "4"])
        assert p["cut"] is not None and p["card"].startswith("cpu")
    for point, world in ((1, 1), (2, 4)):
        for r in range(world):
            a, b = (next(p for p in procs if (p["point"], p["role"], p["rank"]) == (point, x, r))
                    for x in "AB")
            # the samples of steps 1-2, in epoch 0's order
            assert a["save"]["position"] == {"epoch": 0,
                                             "index": 2 * a["rows"] * a["accum"] * a["world"]}
            assert b["restore"]["position"] == {"step": 2, **a["save"]["position"]}
            assert b["steps"]["3"]["sample_ids"] == a["steps"]["3"]["sample_ids"]
    assert not (tmp_path / "work").exists()


def _records():
    """A pair of records as ``cut_run`` gives them, A's and B's agreeing."""
    digest = {"count": 2, "params": "p2", "mu": "m2", "nu": "n2"}
    after = {"count": 4, "params": "p4", "mu": "m4", "nu": "n4"}

    def step(i):
        return {"loss": 1.0 + i, "grad_norm": 0.5 + i, "non_pad_tokens": 100 + i,
                "sample_ids": [2 * i, 2 * i + 1], "epoch": 0}

    a = {"cut": "cut at step 4", "steps": {str(i): step(i) for i in range(1, 5)},
         "digests": {"2": digest, "4": after}, "save": {"step": 2}, "restore": None}
    b = {"cut": "cut at step 4", "steps": {str(i): step(i) for i in range(3, 5)},
         "digests": {"4": dict(after)}, "save": None,
         "restore": {"checkpoint": "checkpoint-2", "digest": dict(digest)}}
    return a, b


def _breaks(name, b):
    if name == "loss":
        b["steps"]["3"]["loss"] += 1e-7
    elif name == "sample_ids":
        b["steps"]["4"]["sample_ids"] = [0, 1]
    elif name == "restored":
        b["restore"]["digest"]["mu"] = "other"
    elif name == "after_step_4":
        b["digests"]["4"]["params"] = "other"
    elif name == "not_cut":
        b["cut"] = None
    elif name == "restarted":
        b["restore"]["checkpoint"] = "checkpoint-4"


@pytest.mark.parametrize("fault", ["loss", "sample_ids", "restored", "after_step_4",
                                   "not_cut", "restarted"])
def test_pair_checks_refuse_a_resumed_run_that_differs(fault):
    a, b = _records()
    assert all(train_resume.pair_checks(a, b).values())
    b = copy.deepcopy(b)
    _breaks(fault, b)
    assert not all(train_resume.pair_checks(a, b).values())


def _frame(path, line, name):
    return {"filename": path, "line": line, "name": name}


def test_peak_parts_reads_the_blocks_live_at_the_traces_peak():
    port = _frame("/src/llava_plus_torch/models/llama.py", 10, "mlp")
    torch_fn = _frame("/lib/site-packages/torch/nn/functional.py", 5, "silu")
    trace = [
        {"action": "alloc", "addr": 1, "size": 10 << 20, "frames": [port]},
        {"action": "alloc", "addr": 2, "size": 20 << 20, "frames": []},
        {"action": "free_requested", "addr": 1, "size": 10 << 20},
        {"action": "free_completed", "addr": 1, "size": 10 << 20},
        {"action": "alloc", "addr": 3, "size": 30 << 20, "frames": [torch_fn, port]},
        {"action": "alloc", "addr": 4, "size": 30 << 20, "frames": [torch_fn, port]},
        {"action": "free_requested", "addr": 4, "size": 30 << 20},   # the peak was before
        {"action": "free_requested", "addr": 9, "size": 5 << 20},    # allocated before the trace
        {"action": "alloc", "addr": 5, "size": 1 << 20, "frames": [port]},
    ]
    got = train_resume.peak_parts(trace, base_bytes=1 << 30, top=2)
    assert got["in_trace_gib"] == got["live_in_trace_gib"] == 80 / 1024
    assert got["peak_gib"] == 1 + 80 / 1024 and got["base_gib"] == 1
    assert got["groups"] == [
        {"where": "models/llama.py:10 mlp -> torch/nn/functional.py:5 silu",
         "block_mib": 30.0, "count": 2, "gib": 60 / 1024},
        {"where": "(no Python frame)", "block_mib": 20.0, "count": 1, "gib": 20 / 1024}]
    assert got["rest_gib"] == 0


@pytest.mark.parametrize("accum", [1, 4])
def test_the_bound_holds_the_summed_gradients_beside_the_head_under_accumulation(accum):
    from llava_plus_torch.tools import train_13b_mesh as mesh_tool

    cfg = mesh_tool.run_config(True)
    b = mesh_tool.bound(cfg, 2, cfg.max_sequence_length, None, accum)
    base = b["kept"] + b["saved"] + b["gathered"]
    if accum == 1:
        assert b["total"] == base + max(b["head"], b["grads"] + b["layer"])
    else:
        assert b["total"] == base + b["grads"] + max(b["head"], b["layer"])
    assert b == {**mesh_tool.bound(cfg, 2, cfg.max_sequence_length, None), "total": b["total"]}
