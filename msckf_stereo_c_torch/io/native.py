"""ctypes bindings of the native dataset runtime (``native/euroc_runtime.cpp``):
CSV parsing, one-image PNG decode, and a multi-threaded prefetching decode
stream.

The library is built from the repository's source with ``native/Makefile``'s
flags the first time it is asked for (never at import) into
``build/native_runtime/``, under a name hashed from the source and the
flags, so a changed source rebuilds.  The committed
``native/libmsckf_runtime.so`` is not loaded.  The build needs ``g++`` and
libpng's headers; where it fails, ``available()`` is False,
``build_error()`` says why, and ``io/euroc.py:ImageSource`` decodes with
``io/png.py`` instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "euroc_runtime.cpp"
BUILD_DIR = _ROOT / "build" / "native_runtime"
# native/Makefile's CXXFLAGS and LDFLAGS.
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")
_LDFLAGS = ("-shared", "-lpng", "-lz", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _lib_path() -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_CXXFLAGS + _LDFLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmsckf_runtime-{h[:16]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"no C++ compiler ({cxx!r} not found)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *_CXXFLAGS, str(_SOURCE), "-o", str(tmp), *_LDFLAGS],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed (rc={r.returncode}): {r.stderr.strip()[-600:]}")
    os.replace(tmp, out)


def load_library() -> Optional[ctypes.CDLL]:
    """The runtime, built on the first call; None when it cannot be built
    (the reason is in ``build_error()``; the build is not retried)."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    path = _lib_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        _error = str(e)
        return None
    P, I = ctypes.POINTER, ctypes.c_int
    lib.mr_load_imu_csv.restype = I
    lib.mr_load_imu_csv.argtypes = [
        ctypes.c_char_p, P(ctypes.c_int64), P(ctypes.c_double), P(ctypes.c_double), I,
    ]
    lib.mr_load_cam_csv.restype = I
    lib.mr_load_cam_csv.argtypes = [ctypes.c_char_p, P(ctypes.c_int64), ctypes.c_char_p, I, I]
    lib.mr_decode_png.restype = I
    lib.mr_decode_png.argtypes = [ctypes.c_char_p, P(ctypes.c_uint8), I, I, P(I), P(I)]
    lib.mr_stream_open.restype = ctypes.c_void_p
    lib.mr_stream_open.argtypes = [ctypes.c_char_p, I, I, I, I, I]
    lib.mr_stream_next.restype = I
    lib.mr_stream_next.argtypes = [ctypes.c_void_p, P(ctypes.c_uint8), I]
    lib.mr_stream_errors.restype = I
    lib.mr_stream_errors.argtypes = [ctypes.c_void_p]
    lib.mr_stream_close.restype = None
    lib.mr_stream_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def build_error() -> Optional[str]:
    """Why the runtime could not be built (None when it was, or before the
    first attempt)."""
    return _error


def _require() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"the native runtime could not be built: {_error}")
    return lib


def load_imu_csv(path: str, max_n: int = 2_000_000):
    """(t seconds, gyro (N, 3), acc (N, 3)) of an EuRoC ``imu0/data.csv``."""
    lib = _require()
    t = np.empty(max_n, np.int64)
    gyro = np.empty((max_n, 3), np.float64)
    acc = np.empty((max_n, 3), np.float64)
    n = lib.mr_load_imu_csv(
        path.encode(),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        gyro.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        acc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_n,
    )
    if n < 0:
        raise IOError(f"mr_load_imu_csv failed for {path}")
    return t[:n] * 1e-9, gyro[:n], acc[:n]


def decode_png(path: str, width: int, height: int) -> np.ndarray:
    """One PNG as (h, w) uint8, at most ``width`` x ``height``."""
    lib = _require()
    out = np.empty((height, width), np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.mr_decode_png(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), width, height,
        ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        raise IOError(f"mr_decode_png({path}) -> {rc}")
    return out.reshape(-1)[: w.value * h.value].reshape(h.value, w.value)


class ImageStream:
    """Bounded multi-threaded prefetching decoder over a file list."""

    def __init__(self, files: List[str], width: int, height: int, queue_depth: int = 64, threads: int = 4):
        self._handle = None
        self._lib = _require()
        self._w, self._h = width, height
        self._joined = b"\0".join(f.encode() for f in files) + b"\0"
        self._handle = self._lib.mr_stream_open(self._joined, len(files), width, height, queue_depth, threads)
        self._remaining = len(files)

    def next_batch(self, count: int) -> np.ndarray:
        count = min(count, self._remaining)
        out = np.empty((count, self._h, self._w), np.uint8)
        got = self._lib.mr_stream_next(self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), count)
        self._remaining -= got
        return out[:got]

    @property
    def errors(self) -> int:
        return self._lib.mr_stream_errors(self._handle)

    def close(self):
        if self._handle:
            self._lib.mr_stream_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
