"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

All ``csrc/*.cu`` files compile with ``nvcc`` into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. The build runs at first use, into ``llava_plus_torch/build/``;
the library's file name carries a hash of the sources and flags, so an edit
to any source rebuilds and an unchanged tree reuses the library.

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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C signatures of the entry points (pointers and the stream as void*).
SIGNATURES = {
    "flash_fwd_bf16": [P, P, P, P, P, P, P] + [I] * 11 + [F, P],
    "flash_bwd_dkv_bf16": [P] * 10 + [I] * 14 + [F, P],
    "flash_bwd_dq_bf16": [P] * 9 + [I] * 14 + [F, P],
    "decode_attention_fwd": [P] * 8 + [I] * 14 + [F, P],
    "quant_matmul_int8": [P] * 4 + [I] * 5 + [P],
    "quant_matmul_int4": [P] * 4 + [I] * 5 + [P],
    "paged_decode1_fwd": [P] * 9 + [I] * 15 + [F, P],
    "paged_attention_fwd": [P] * 9 + [I] * 15 + [F, P],
}

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``. The serving engine launches kernels
    from its prefill and decode threads, and ``+=`` on an attribute is not
    atomic across threads."""
    with _count_lock:
        wrapper.launches += 1


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
    for src in _sources():
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
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           *[str(s) for s in _sources()]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if proc.stderr.strip() or proc.stdout.strip():
        print(proc.stdout + proc.stderr, flush=True)
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
