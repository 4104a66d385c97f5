#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``llava_plus_torch``. The cell is an
entry of ``BENCHMARK.json``'s ``workloads``; its configuration, traffic mix,
settings and metric readers are files found by name under ``portbench/``
(``configs/``, ``traffic/``, ``cells/``, ``metrics/``). With ``--trace 0`` the
last line of standard output holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics: those of the counters and the host clock
from the measured window, those of the device from a ``torch.profiler``
trace (CUDA activity) of a second window that follows it. ``--quantize int4`` serves through the port's int4 path (the check's
control) and ``--rate`` offers an open loop another rate (the sweep that
sets a mix's rate): neither is a benchmark run.

It needs a CUDA device (as many as the cell's ``chips``), and exits with 2
and no result without one, or if a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "llava_plus_tpu")
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import host  # noqa: E402


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: the end-to-end ones that list it
    or list no cells; with ``trace``, the per-layer ones that list it."""
    if not trace:
        return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: Path = HERE):
    """``metrics/<name>.py``'s ``read``."""
    return _load(bench_dir / "metrics" / f"{name}.py",
                 "portbench_metric_" + name.replace(".", "_")).read


def driver(kind: str, bench_dir: Path = HERE):
    """The module that runs cells of ``kind`` (``<kind>.py`` beside this
    file): ``run``, ``check`` and ``load_summary``."""
    path = bench_dir / f"{kind}.py"
    if not path.exists():
        raise SystemExit(f"no driver {path.name} for cells of kind {kind!r}")
    return _load(path, "portbench_kind_" + kind.replace(".", "_"))


def views(out: dict) -> dict:
    """What each source's readers read: the measured window, and for
    ``device_trace`` the profiled window that followed it (its bounds and
    counters in place of the measured window's, the measured one beside)."""
    t = out.get("trace")
    traced = (dict(out, w0=t["w0"], w1=t["w1"], window_s=t["window_s"],
                   counters=t["counters"], measured=out) if t else None)
    return {"device_trace": traced, "host_clock": out, "program_counter": out,
            "program_span": out}


def jax_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_power() -> str:
    try:
        cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        return subprocess.run(cmd, capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(args, device, root: Path = ROOT, bench_dir: Path = HERE, log=sys.stderr,
            host_speed_ms=None) -> dict:
    """The run after the look for a card: set-up, window, the checks and the
    metric readers. Returns the result line's object."""
    import torch

    from portbench import counts

    bench = load_json(root / "BENCHMARK.json")
    work = find_cell(bench, args.workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    cfg = load_json(root / cfg_entry["file"])
    cell = load_json(bench_dir / "cells" / f"{args.workload}.json")
    mix = load_json(bench_dir / "traffic" / f"{work['traffic']}.json")
    if args.rate:
        mix["rate"] = args.rate
    trace = bool(args.trace)
    kind = driver(cell["kind"], bench_dir)
    out = kind.run(cell, cfg, mix, args.seed, args.seconds, trace, device, T_START,
                   quantize=args.quantize)
    verdict = kind.check(cell, cfg, args.seed, out, device)
    leaked = jax_modules()
    if leaked:
        print(f"JAX modules loaded in the measured process: {leaked}", file=log)
        raise SystemExit(2)

    on_card = torch.device(device).type == "cuda"
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    peak = counts.peaks(name if on_card else "NVIDIA H100", bench_dir)
    seen = views(out)
    metrics = {}
    for m in cell_metrics(bench, args.workload, trace):
        if seen[m["source"]] is None:
            continue
        run = SimpleNamespace(out=seen[m["source"]], cfg=cfg, cell=cell, peak=peak)
        value = reader(m["name"], bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": name,
                   "count": work["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": verdict["correct"], "attempted": verdict["attempted"],
              "failed": verdict["failed"], "metrics": metrics, "device": device_info}
    if trace:
        t = out["trace"]
        device_info["busy_s"] = t["busy_s"]
        device_info["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["load"] = dict(kind.load_summary(out), host_speed_ms=host_speed_ms)
    result["card"] = card_power() if on_card else "cpu"
    result["checks"] = verdict["checks"]
    for k, v in verdict["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=log)
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--quantize", choices=("int4",), default=None,
                   help="serve through the port's int4 path (the check's control)")
    p.add_argument("--rate", type=float, default=None,
                   help="an open loop's offered rate in place of the mix's (the sweep "
                        "that sets it)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    speed = host.speed_ms()
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    chips = find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    # one process, few threads: the load's own CPU work is small, and pool
    # threads would take cores from the engine's thread, which paces decode
    torch.set_num_threads(1)
    result = execute(args, "cuda:0", host_speed_ms=speed)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
