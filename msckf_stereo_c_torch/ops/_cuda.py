"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Libraries
go to ``build/torch_kernels/`` at the root of the checkout, named by a hash
of the source and the flags, so a changed source rebuilds and an unchanged
one is reused.  Nothing is built when a module is imported: the first
launch (or an explicit ``build_kernels()``) builds every source, with all
``nvcc`` processes started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types.  Every entry returns the
# cudaError_t of its launch as an int.
_SIGNATURES = {
    "extract_windows": (_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_longlong, _P),
    "lk_corr_iterate": (
        _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, ctypes.c_float, ctypes.c_float, _P,
    ),
    "lk_corr_iterate_gain": (
        _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, ctypes.c_float, ctypes.c_float, _P,
    ),
}

_loaded: Dict[str, ctypes.CDLL] = {}

# Launches per kernel, counted by each wrapper where it launches (plain
# integers; ``reset_launch_counts`` zeroes them before a measured run).
launch_counts: Dict[str, int] = {name: 0 for name in _SIGNATURES}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{h[:16]}.so"


def build_kernels() -> Dict[str, str]:
    """Compile every kernel source whose library is missing, in parallel.
    Returns {source name: compiler output} for the sources it compiled
    (``-Xptxas=-v`` reports registers, shared memory and spills)."""
    todo = [(s, _lib_path(s)) for s in sorted(_CSRC.glob("*.cu")) if not _lib_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for src, out, tmp, p in procs:
        text, _ = p.communicate()
        logs[src.name] = text
        if p.returncode != 0:
            failed.append(f"{src.name} (rc={p.returncode}):\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def kernel_function(name: str):
    """The C entry ``name`` from ``csrc/<name>.cu``, with its argument and
    return types declared; builds the kernels on first use."""
    if name not in _loaded:
        src = _CSRC / f"{name}.cu"
        path = _lib_path(src)
        if not path.exists():
            build_kernels()
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = list(_SIGNATURES[name])
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return getattr(_loaded[name], name)


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {rc})")
