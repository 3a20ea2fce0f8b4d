"""Build and load the hand-written CUDA kernels (ops/csrc/*.cu).

nvcc compiles the sources for sm_90a into one shared library with a plain
C interface, loaded with ctypes. The library lands in
guacamole_tpu_torch/_build/ (git-ignored), named by a hash of the sources
and flags, so an edited source rebuilds on first use and an unchanged one
loads at once. Nothing here runs at import time: this module imports on a
host without nvcc or a GPU, and only load_kernels() needs them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("csr_screen.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildInfo(NamedTuple):
    path: str  # the shared library
    seconds: float  # nvcc wall time; 0.0 when an up-to-date build was reused
    log: str  # nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "guacamole_tpu_torch are built from source on first use"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels unless a build of the current sources exists."""
    path = os.path.join(BUILD_DIR, f"libguac_kernels_{_source_hash()}.so")
    if os.path.exists(path):
        return BuildInfo(path, 0.0, "")
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), *NVCC_FLAGS, "-o", tmp,
        *(os.path.join(CSRC_DIR, name) for name in SOURCES),
    ]
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return BuildInfo(path, seconds, log)


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises when it cannot be
    built or loaded: on a CUDA tensor there is no fallback."""
    lib = ctypes.CDLL(build().path)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.guac_csr_count_screen.argtypes = [
        ptr, ptr, ptr, i64, i32, i32, ptr, ptr, ptr,
    ]
    lib.guac_csr_count_screen.restype = i32
    lib.guac_csr_compact.argtypes = [ptr, ptr, i64, i32, i32, ptr, ptr]
    lib.guac_csr_compact.restype = i32
    return lib
