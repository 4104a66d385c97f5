"""The check's control on the card, at a narrow size: the port's int4 path
(the precision below the int8 the configurations state) has to read a
served-token gap at least three times the int8 program's widest, on three
seeds, or the check could not tell the two apart. At the cells' own sizes
the readings are in PERF.md; this keeps the property under test."""

import json

import pytest

from portbench import run
from portbench.tests import tiny


@pytest.mark.card
@pytest.mark.parametrize("name", ["narrow-mpt", "narrow-llama"])
def test_int4_reads_three_times_the_int8_gap(tmp_path, name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check's control runs the port's card kernels")
    root = tiny.make(tmp_path, (name,))
    for cell in ("describe", "vqa"):
        (root / "portbench/cells" / f"{name}.{cell}.json").write_text(json.dumps(tiny.NARROW_CELL))
    program, control = [], []
    for seed in (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203):
        for quant, into in ((None, program), ("int4", control)):
            argv = ["--workload", f"{name}.describe", "--seed", str(seed), "--seconds", "2",
                    "--trace", "0"] + (["--quantize", quant] if quant else [])
            res = run.execute(run.parse(argv), "cuda:0", root=root, bench_dir=root / "portbench")
            assert res["failed"] == 0
            into.append(res["checks"]["served_logit_gap"]["value"])
    print(name, "int8", program, "int4", control)
    assert min(control) >= 3 * max(program)
