"""Build ``csrc/*.cu`` with ``nvcc`` at first use and load it with ``ctypes``.

The sources expose a plain C interface (pointers, ints, the CUDA stream),
so the build needs no PyTorch headers and takes seconds. The library is
cached under ``_build/`` keyed by a hash of the sources and flags, so an
edited source is rebuilt and a stale library is never loaded. There is no
fallback: without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# --fmad=false keeps every multiply and add separately rounded, as the plain
# PyTorch version computes them; -Xptxas -v reports registers and spills.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
]

_c_void_p, _c_int, _c_uint32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_SIGNATURES = {
    # pose_in, pose_out, stats, planes, unf_idx, scalars, rel_idx, rel_p,
    # ang_idx, ang_p, clr_idx, clr_p, n_rel, n_ang, n_clr, n, n_chains, seed,
    # iterations, first_chain, parity, track_off, adapt, stream
    "mh_fused_run": [_c_void_p] * 12 + [_c_int] * 5 + [_c_uint32] + [_c_int] * 5 + [_c_void_p],
    # out, seed, counter, first_chain, n_chains, stream
    "mh_uniform_block": [_c_void_p, _c_uint32, _c_uint32, _c_int, _c_int, _c_void_p],
}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then the default toolkit, then PATH."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmh_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the kernels if needed: ``(library, seconds, compiler output)``."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())],
            capture_output=True, text=True,
        )
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.cache
def load() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature declared."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mh_error_string.argtypes = [ctypes.c_int]
    lib.mh_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return f"{err} ({load().mh_error_string(err).decode()})"
