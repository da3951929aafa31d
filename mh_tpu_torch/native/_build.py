"""Build the port's native C ABI with ``g++`` at first use.

``libmh_tpu_torch.so`` (``kernel_wrapper.cpp`` + ``ref_compat.cpp``) embeds
the interpreter running this module: its include and link flags come from
``sysconfig`` (what ``python3-config --includes`` and ``--ldflags --embed``
print for it), and the repo root and the interpreter's path are baked in
(``-DMH_TPU_PYROOT``, ``-DMH_TPU_PYTHON``), so a C host starts the Python
that has torch. The port's two C hosts (``test_wrapper``,
``test_ref_compat``) are built beside it. Everything goes to
``_build/<hash>/``, keyed by a hash of the sources, the headers and the
flags, and is moved there in one rename, so processes that build at once
never see half a build. There is no fallback: a failed build raises.

    python -m mh_tpu_torch.native._build   # build, print the library's path
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "_build"
REPO_ROOT = HERE.parents[1]
LIBRARY = "libmh_tpu_torch.so"
SOURCES = ("kernel_wrapper.cpp", "ref_compat.cpp")
HEADERS = ("wire.h", "ref_compat.h", "ref_layout_asserts.h")
HOSTS = ("test_wrapper", "test_ref_compat")  # each built from <name>.c

_c_void_p, _i64 = ctypes.c_void_p, ctypes.c_int64


def compiler(name: str) -> str:
    """Path of ``g++`` / ``gcc``; raises where there is none."""
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"{name} not found: the native C ABI cannot be built")
    return path


def python_flags() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) that embed this interpreter."""
    cv = sysconfig.get_config_var
    paths = sysconfig.get_paths()
    includes = list(dict.fromkeys([paths["include"], paths["platinclude"]]))
    libdir = cv("LIBDIR") if cv("Py_ENABLE_SHARED") else cv("LIBPL")
    link = [f"-L{libdir}", f"-lpython{cv('LDVERSION')}", *cv("LIBS").split(),
            *cv("SYSLIBS").split(), f"-Wl,-rpath,{libdir}"]
    return [f"-I{d}" for d in includes], link


def library_flags() -> list[str]:
    inc, link = python_flags()
    return ["-O2", "-Wall", "-shared", "-fPIC", f"-Wl,-soname,{LIBRARY}", *inc,
            f'-DMH_TPU_PYROOT="{REPO_ROOT}"', f'-DMH_TPU_PYTHON="{sys.executable}"', *link]


def host_flags(include_dir: Path, lib_dir: Path, rpath: str = "$ORIGIN") -> list[str]:
    """A C host compiled against the headers in ``include_dir`` and linked
    to the library in ``lib_dir``."""
    return ["-O2", "-Wall", f"-I{include_dir}", f"-L{lib_dir}", "-lmh_tpu_torch", "-lm",
            f"-Wl,-rpath,{rpath}"]


@dataclasses.dataclass(frozen=True)
class Built:
    directory: Path
    seconds: float  # 0.0 where the build was found ready
    log: str

    @property
    def library(self) -> Path:
        return self.directory / LIBRARY

    def host(self, name: str) -> Path:
        return self.directory / name


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(library_flags() + host_flags(HERE, HERE)).encode())
    for name in SOURCES + HEADERS + tuple(f"{host}.c" for host in HOSTS):
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


@functools.cache
def build() -> Built:
    """Compile the library and the C hosts if needed."""
    out = build_dir()
    if (out / LIBRARY).exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp"))
    tmp.chmod(0o755)
    t0 = time.perf_counter()
    try:
        log = _run([compiler("g++"), *(str(HERE / s) for s in SOURCES), "-o",
                    str(tmp / LIBRARY), *library_flags()])
        for name in HOSTS:
            log += _run([compiler("gcc"), str(HERE / f"{name}.c"), "-o", str(tmp / name),
                         *host_flags(HERE, tmp)])
        try:
            os.replace(tmp, out)
        except OSError:  # another process finished the same build first
            if not (out / LIBRARY).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Built(out, time.perf_counter() - t0, log)


@functools.cache
def load() -> ctypes.CDLL:
    """The library, with its four entry points' signatures declared. A
    call through it drops the interpreter lock, which the library takes
    again around its own calls into Python."""
    lib = ctypes.CDLL(str(build().library))
    lib.MHKernelWrapper.argtypes = [_c_void_p] * 10
    lib.MHKernelWrapper.restype = _i64
    lib.MHDeviceReport.argtypes = [ctypes.c_char_p, _i64]
    lib.MHDeviceReport.restype = _i64
    lib.KernelWrapper.argtypes = [_c_void_p] * 9
    lib.KernelWrapper.restype = _c_void_p
    lib.KernelWrapperFree.argtypes = [_c_void_p]
    lib.KernelWrapperFree.restype = None
    return lib


if __name__ == "__main__":
    print(build().library)
