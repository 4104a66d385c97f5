"""What the port's measurement tools and ``chip_smoke.py`` share: the device
line, seeded inputs, the check of a kernel against its plain version,
CUDA-event timing, a launcher's trainer flags, HF directories written a
tensor at a time, the process's write and memory counters, and device time
by kernel class from a profile.

A kernel passes when its error against an f64 truth, relative to the
largest output, is at most ``max(2.5 * plain error, 2e-3)``: the criterion
``chip_smoke.py`` holds every kernel to."""

from __future__ import annotations

import json
import os
import re
import resource
import shlex
import subprocess
import time
from pathlib import Path

import numpy as np
import torch


class Disagrees(RuntimeError):
    """A kernel's output is further from the f64 truth than its plain
    version allows."""


def describe_device(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or a
    note that the plain versions run on the host."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"{dev.type}: the kernels' plain versions, host clock"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def inputs(K: int, N: int, R: int, device: str, rng: np.random.Generator):
    """An f32 weight [K, N] of scale 0.02 and a bf16 x [R, K], from ``rng``."""
    w = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32) * 0.02).to(device)
    x = torch.from_numpy(rng.standard_normal((R, K), dtype=np.float32)).to(device)
    return w, x.bfloat16()


def parse_shape(text: str):
    K, N = (int(v) for v in text.lower().split("x"))
    return K, N


def check(name: str, kernel, plain, x: torch.Tensor, *args, **kwargs) -> float:
    """Run ``kernel`` and ``plain`` once on the same inputs, measure both
    against ``plain`` in f64, and raise :class:`Disagrees` on a miss.
    Returns the kernel's relative error."""
    out = kernel(x, *args, **kwargs)
    p_out = plain(x, *args, **kwargs)
    truth = plain(x.double(), *args, **kwargs)
    top = truth.abs().max().item()
    k_err = (out.double() - truth).abs().max().item() / top
    r_err = (p_out.double() - truth).abs().max().item() / top
    if out.shape != truth.shape or not k_err <= max(2.5 * r_err, 2e-3):
        raise Disagrees(f"{name}: shape {tuple(out.shape)}, rel err {k_err:.3e} "
                        f"(plain {r_err:.3e})")
    return k_err


def time_ms(fn, device: str, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms over ``iters`` back-to-back calls after
    ``warmup``: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def script_argv(name: str, **flags):
    """The trainer's flags in the port's launcher ``llava_plus_torch/
    scripts/<name>`` (its shell variables expanded), each of ``flags``
    (``model_name_or_path=...``) put in place of the launcher's value or
    added after its flags; and the environment the launcher exports."""
    text = (Path(__file__).resolve().parent.parent / "scripts" / name).read_text()
    variables, env = {}, {}
    for m in re.finditer(r"^(export )?(\w+)=(\S+)$", text, flags=re.M):
        (env if m.group(1) else variables)[m.group(2)] = m.group(3).strip("\"'")
    joined = re.sub(r"\\\n", " ", text)
    cmd = next(line.strip() for line in joined.splitlines()
               if line.strip().startswith("python -m llava_plus_torch.train.train"))
    cmd = re.sub(r"\$\{?(\w+)\}?", lambda m: variables[m.group(1)], cmd)
    argv = shlex.split(cmd)[3:]
    for key, value in flags.items():
        flag = "--" + key.replace("_", "-")
        if flag in argv:
            argv[argv.index(flag) + 1] = str(value)
        else:
            argv += [flag, str(value)]
    return argv, env


_SAFETENSORS_DTYPES = {"torch.bfloat16": "BF16", "torch.float16": "F16",
                       "torch.float32": "F32", "torch.int8": "I8", "torch.int32": "I32",
                       "torch.int64": "I64"}


def save_safetensors(sd, path, metadata=None) -> int:
    """``sd`` (name -> contiguous host tensor) as one safetensors file,
    written a tensor at a time, each dropped from ``sd`` once written: the
    host holds no second copy of the state dict (the safetensors package
    serializes the whole dict first on some versions: 58.7 GB resident for
    a 26 GB base). Returns the bytes written."""
    header, offset = {"__metadata__": dict(metadata or {})}, 0
    for name, x in sd.items():
        n = x.numel() * x.element_size()
        header[name] = {"dtype": _SAFETENSORS_DTYPES[str(x.dtype)], "shape": list(x.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)   # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in list(sd):
            x = sd.pop(name)
            f.write(memoryview(x.reshape(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + offset


def write_tower(path, tower, vision_cfg):
    """An HF ``CLIPVisionModel`` directory of the tower params ``tower``
    (``vision_model.*`` keys and its ``config.json``): (bytes, seconds)."""
    from llava_plus_torch.train import checkpoint

    t0 = time.perf_counter()
    os.makedirs(path, exist_ok=True)
    save_safetensors(checkpoint.clip_state_dict_from_params(tower, vision_cfg,
                                                            prefix="vision_model."),
                     os.path.join(path, "model.safetensors"), {"format": "pt"})
    config = {"architectures": ["CLIPVisionModel"], "model_type": "clip_vision_model",
              "hidden_size": vision_cfg.hidden_size,
              "intermediate_size": vision_cfg.intermediate_size,
              "num_hidden_layers": vision_cfg.num_hidden_layers,
              "num_attention_heads": vision_cfg.num_attention_heads,
              "image_size": vision_cfg.image_size, "patch_size": vision_cfg.patch_size,
              "layer_norm_eps": vision_cfg.layer_norm_eps, "hidden_act": "quick_gelu",
              "num_channels": 3, "projection_dim": 768, "torch_dtype": "bfloat16"}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return os.path.getsize(os.path.join(path, "model.safetensors")), time.perf_counter() - t0


def written_gb() -> float:
    """GB this process has passed to ``write()`` (``/proc/self/io``'s
    ``wchar``: files, and its few pipe and log lines; the card's machine
    reports no ``write_bytes``): the machine ends a call that writes more
    than 45 GiB to its disk, deleted files included."""
    try:
        with open("/proc/self/io") as f:
            return next(int(line.split()[1]) for line in f
                        if line.startswith("wchar")) / 1e9
    except (OSError, StopIteration):
        return float("nan")


def host_peak_gb() -> float:
    """This process's peak resident memory so far, in GB (``ru_maxrss``,
    KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


GEMM_KEYS = ("gemm", "gemv", "cutlass", "nvjet", "xmma", "splitk", "cublas")
KERNEL_CLASSES = ("gemm", "flash", "nccl", "other")


def kernel_class(name: str) -> str:
    """A device kernel's class by its name: nccl, flash, gemm or other."""
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if "flash" in low:
        return "flash"
    if any(k in low for k in GEMM_KEYS):
        return "gemm"
    return "other"


def device_ms_by_class(prof) -> dict:
    """A ``torch.profiler`` profile's device kernels: ms and launches by
    :func:`kernel_class`, and [launches, ms] by kernel name (cut to 90
    characters), most launched first."""
    ms = dict.fromkeys(KERNEL_CLASSES, 0.0)
    launches = dict.fromkeys(KERNEL_CLASSES, 0)
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            label = kernel_class(e.key)
            ms[label] += e.self_device_time_total / 1e3
            launches[label] += e.count
            kernels[e.key[:90]] = [e.count, e.self_device_time_total / 1e3]
    return {"ms": ms, "launches": launches,
            "by_kernel": dict(sorted(kernels.items(), key=lambda kv: -kv[1][0]))}
