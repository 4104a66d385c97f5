"""A run with the timed path broken underneath, on the CPU (the look for a
card skipped): the check has to read ``correct`` false. The faults a served
cell can have: a token altered where the engine produces it (in a decode
step, or the first token from the prefill), and an answer cut short."""

import pytest

from portbench import run
from portbench.tests import tiny


def _run(tmp_path, seed=2 ** 31 + 91):
    root = tiny.make(tmp_path, ("tiny-mpt",))
    args = run.parse(["--workload", "tiny-mpt.describe", "--seed", str(seed),
                      "--seconds", "1", "--trace", "0"])
    return run.execute(args, "cpu", root=root, bench_dir=root / "portbench")


def test_sound_run_is_correct(tmp_path):
    assert _run(tmp_path)["correct"] is True


@pytest.mark.parametrize("where", ["decode", "first"])
def test_an_altered_token_is_caught(tmp_path, monkeypatch, where):
    from llava_plus_torch.serve import engine

    if where == "decode":
        orig = engine.BatchedEngine._op_decode

        def broken(self, *a, **k):
            toks = orig(self, *a, **k)
            return (toks + 1) % 400
        monkeypatch.setattr(engine.BatchedEngine, "_op_decode", broken)
    else:
        orig = engine.BatchedEngine._sample_first

        def broken(self, *a, **k):
            return (orig(self, *a, **k) + 1) % 400
        monkeypatch.setattr(engine.BatchedEngine, "_sample_first", broken)
    res = _run(tmp_path)
    assert res["correct"] is False
    assert res["checks"]["served_logit_gap"]["value"] > res["checks"]["served_logit_gap"]["limit"]


def test_an_answer_cut_short_is_caught(tmp_path, monkeypatch):
    from llava_plus_torch.serve.model_worker import TorchBackend

    orig = TorchBackend.generate_stream

    def cut(self, params):
        params = dict(params, max_new_tokens=max(1, params["max_new_tokens"] // 2))
        return orig(self, params)
    monkeypatch.setattr(TorchBackend, "generate_stream", cut)
    res = _run(tmp_path)
    assert res["correct"] is False and res["failed"] > 0
