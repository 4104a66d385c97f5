"""ctypes bindings for the native image-preprocessing library.

Counterpart of ``llava_plus_tpu/data/native.py``, with the same public
names and signatures, over the port's own copy of the C++ source
(``llava_plus_torch/native/llava_img.cpp``). The library is built at first
use with ``g++`` (or ``$CXX``) into ``llava_plus_torch/build/``; its file
name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one reuses the library. A compiler or load
failure raises with the compiler's output: there is no fallback here, and
the port's image processor (``data/image_processing.py``) does not call
this module. A compiler that cannot link OpenMP (no ``libgomp``) builds
the library without ``-fopenmp``, with a warning: the pragmas compile out,
and a batch runs on one thread with the same results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG / "native" / "llava_img.cpp"
BUILD = PKG / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17"]

_LIB: Optional[ctypes.CDLL] = None
_OPENMP: Optional[bool] = None
_lock = threading.Lock()


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"no C++ compiler {cxx!r} on PATH (set CXX)")
    return found


def openmp() -> bool:
    """Whether the compiler links OpenMP: a one-line library built with
    ``-fopenmp`` (once a process)."""
    global _OPENMP
    if _OPENMP is None:
        BUILD.mkdir(parents=True, exist_ok=True)
        probe = BUILD / f"openmp_probe.{os.getpid()}.so"
        proc = subprocess.run([_compiler(), "-fopenmp", "-fPIC", "-shared", "-x", "c++", "-",
                               "-o", str(probe)], input="int probe() { return 0; }\n",
                              capture_output=True, text=True)
        probe.unlink(missing_ok=True)
        _OPENMP = proc.returncode == 0
        if not _OPENMP:
            warnings.warn(f"{_compiler()} cannot link OpenMP; building {SOURCE.name} without "
                          f"-fopenmp (a batch runs on one thread): {proc.stderr.strip()}")
    return _OPENMP


def flags():
    """The compiler flags of the build: ``CXX_FLAGS``, without ``-fopenmp``
    where the compiler cannot link it."""
    return CXX_FLAGS if openmp() else [f for f in CXX_FLAGS if f != "-fopenmp"]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(flags()).encode())
    h.update(SOURCE.read_bytes())
    return BUILD / f"libllava_img_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *flags(), "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.clip_preprocess.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p,
        ]
        lib.clip_preprocess.restype = ctypes.c_int
        lib.clip_preprocess_batch.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, f32p, f32p, f32p,
        ]
        lib.clip_preprocess_batch.restype = ctypes.c_int
        lib.expand2square_u8.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, u8p, u8p,
        ]
        lib.expand2square_u8.restype = ctypes.c_int
        _LIB = lib
        return lib


def native_available() -> bool:
    """True once the library is built and loaded (a failure raises)."""
    return load_library() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} returned {rc}")


def _rgb(a: np.ndarray, ndim: int) -> np.ndarray:
    """``a`` as contiguous uint8 with ``ndim`` dims, RGB last: the layout
    the C functions read through their pointers."""
    a = np.ascontiguousarray(a, dtype=np.uint8)
    if a.ndim != ndim or a.shape[-1] != 3 or 0 in a.shape:
        raise ValueError(f"expected a non-empty uint8 array of {ndim} dims with 3 channels "
                         f"last, got shape {a.shape}")
    return a


def _triple(values, dtype) -> np.ndarray:
    a = np.ascontiguousarray(values, dtype=dtype)
    if a.shape != (3,):
        raise ValueError(f"expected 3 values (one a channel), got {values!r}")
    return a


def clip_preprocess(
    image: np.ndarray,  # uint8 [H, W, 3]
    shortest_edge: int = 336,
    crop: int = 336,
    mean: Sequence[float] = (0.48145466, 0.4578275, 0.40821073),
    std: Sequence[float] = (0.26862954, 0.26130258, 0.27577711),
) -> np.ndarray:
    """Resize the shortest edge (bicubic), center-crop and normalize:
    float32 [crop, crop, 3]."""
    lib = load_library()
    image = _rgb(image, 3)
    h, w = image.shape[:2]
    out = np.empty((crop, crop, 3), np.float32)
    mean_a, std_a = _triple(mean, np.float32), _triple(std, np.float32)
    _check(lib.clip_preprocess(
        _u8p(image), h, w, shortest_edge, crop,
        _f32p(mean_a), _f32p(std_a), _f32p(out),
    ), "clip_preprocess")
    return out


def clip_preprocess_batch(
    images: np.ndarray,  # uint8 [N, H, W, 3], same dims
    shortest_edge: int = 336,
    crop: int = 336,
    mean: Sequence[float] = (0.48145466, 0.4578275, 0.40821073),
    std: Sequence[float] = (0.26862954, 0.26130258, 0.27577711),
) -> np.ndarray:
    """:func:`clip_preprocess` over images of one size, OpenMP-parallel
    across them: float32 [N, crop, crop, 3]."""
    lib = load_library()
    images = _rgb(images, 4)
    n, h, w = images.shape[:3]
    out = np.empty((n, crop, crop, 3), np.float32)
    mean_a, std_a = _triple(mean, np.float32), _triple(std, np.float32)
    _check(lib.clip_preprocess_batch(
        _u8p(images), n, h, w, shortest_edge, crop,
        _f32p(mean_a), _f32p(std_a), _f32p(out),
    ), "clip_preprocess_batch")
    return out


def expand2square(image: np.ndarray, background: Sequence[int]) -> np.ndarray:
    """Pad to a square of side max(H, W) with ``background``, the image
    centered (``mm_utils.expand2square``'s placement): uint8 [S, S, 3]."""
    lib = load_library()
    image = _rgb(image, 3)
    h, w = image.shape[:2]
    side = max(h, w)
    out = np.empty((side, side, 3), np.uint8)
    bg = _triple(background, np.uint8)
    side_written = lib.expand2square_u8(_u8p(image), h, w, _u8p(bg), _u8p(out))
    if side_written != side:
        raise RuntimeError(f"expand2square_u8 returned {side_written}, not the side {side}")
    return out
