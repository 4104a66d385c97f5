"""Build the hand-written CUDA kernels under ``csrc/`` and load them.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all started
together, into an object; one more ``nvcc`` links them into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
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
    "flash_bwd_dkv_bf16": [P] * 11 + [I] * 14 + [F, P],
    "flash_bwd_dq_bf16": [P] * 10 + [I] * 14 + [F, P],
    "decode_attention_fwd": [P] * 9 + [I] * 14 + [F, P],
    "quant_matmul_int8": [P] * 4 + [I] * 5 + [P],
    "quant_matmul_int4": [P] * 4 + [I] * 5 + [P],
    "quant_matmul_int4_native": [P] * 4 + [I] * 4 + [P],
    "paged_decode1_fwd": [P] * 10 + [I] * 15 + [F, P],
    "paged_attention_fwd": [P] * 10 + [I] * 15 + [F, P],
}

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()


def count_launch(wrapper, counter: str = "launches") -> None:
    """Add one to ``wrapper.<counter>`` (``launches``, or ``alibi_launches``
    for a kernel's ALiBi variant). The serving engine launches kernels from
    its prefill and decode threads, and ``+=`` on an attribute is not atomic
    across threads."""
    with _count_lock:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


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
