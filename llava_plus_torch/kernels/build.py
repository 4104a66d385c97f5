"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all started
together, into an object (``csrc/*.cuh`` are headers they include); one
more ``nvcc`` links them into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds),
loaded with ``ctypes``. The build runs at first use, into
``llava_plus_torch/build/``; the library's file name carries a hash of the
sources and flags, so an edit to any source rebuilds and an unchanged tree
reuses the library.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0, since a refused launch never runs
and a later ``synchronize`` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C signatures of the entry points (pointers and the stream as void*).
SIGNATURES = {
    "flash_fwd_bf16": [P] * 8 + [I] * 11 + [F, P],
    "flash_bwd_dkv_bf16": [P] * 12 + [I] * 15 + [F, P],
    "flash_bwd_dq_bf16": [P] * 10 + [I] * 14 + [F, P],
    "decode_attention_fwd": [P] * 11 + [I] * 17 + [F, P],
    "quant_matmul_weight_map": [P, I, I, I, P],
    # x and out lead, so that a wrapper can keep the rest of a launch's arguments
    "quant_matmul_int8_stream": [P] * 5 + [I, P] + [I] * 7 + [P],
    "quant_matmul_int8_wgmma": [P] * 5 + [I, P] + [I] * 8 + [P],
    "quant_matmul_int4_stream": [P] * 5 + [I, P] + [I] * 7 + [P],
    "quant_matmul_int4_wgmma": [P] * 5 + [I, P] + [I] * 8 + [P],
    "quant_matmul_int4n_stream": [P] * 5 + [I, P] + [I] * 7 + [P],
    "quant_matmul_int4n_wgmma": [P] * 5 + [I, P] + [I] * 8 + [P],
    "paged_decode1_fwd": [P] * 11 + [I, P] + [I] * 17 + [F, P],
    "paged_attention_fwd": [P] * 11 + [I, P] + [I] * 17 + [F, P],
    "w8a8_quantize_rows": [P, I, I, I, I, P, P, P, P],
    "w8a8_epilogue": [P] * 4 + [I] * 4 + [P],
}

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()


def count_launch(wrapper, *counters: str) -> None:
    """Add one to each ``wrapper.<counter>`` (``launches`` when none is
    named; ``alibi_launches`` for a kernel's ALiBi variant). The serving
    engine launches kernels from its prefill and decode threads, and ``+=``
    on an attribute is not atomic across threads."""
    with _count_lock:
        for counter in counters or ("launches",):
            setattr(wrapper, counter, getattr(wrapper, counter) + 1)


_scratch = {}
_scratch_lock = threading.Lock()
_sms = {}


def scratch(name: str, device, stream: int, n: int, dtype, zeroed: bool = False):
    """A buffer of at least ``n`` elements that a kernel's wrapper keeps for
    launches on this device and stream (a workspace of partial sums, or
    counters that the kernel leaves zero), made once and grown, at least
    twofold, when a launch needs more: no allocation or fill on the launch
    path. Launches on one stream run in order, so they can share it. A
    caller that keeps the buffer's address keeps the buffer too: a grown
    one replaces it here but not there."""
    import torch

    key = (name, device.index, stream)
    with _scratch_lock:
        buf = _scratch.get(key)
        if buf is None or buf.numel() < n:
            n = n if buf is None else max(n, 2 * buf.numel())
            buf = (torch.zeros if zeroed else torch.empty)(n, dtype=dtype, device=device)
            _scratch[key] = buf
    return buf


def sm_count(device) -> int:
    """The card's streaming multiprocessors (the kernels' split plans)."""
    import torch

    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libllava_kernels_{h.hexdigest()[:16]}.so"


def build(extra_flags=()) -> Path:
    """Compile the library if it is not built yet; return its path.

    ``extra_flags`` (e.g. ``["-Xptxas", "-v"]``) only apply to a fresh build.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{text}")
        elif text.strip():
            print(f"{name}:\n{text}", flush=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def int32_offsets(x) -> bool:
    """Whether every element offset of ``x`` fits the kernels' 32-bit ints."""
    return sum((n - 1) * s for n, s in zip(x.shape, x.stride())) < 2 ** 31


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
