"""Build and load the hand-written CUDA kernels (ops/csrc/*.cu).

nvcc compiles each source for sm_90a into a shared library of its own with
a plain C interface, loaded with ctypes; the sources compile side by side
(one nvcc each, all started together). The libraries land in
guacamole_tpu_torch/_build/ (git-ignored), each named by a hash of its
source and the flags, so an edited source rebuilds on first use and an
unchanged one loads at once. Nothing here runs at import time: this module
imports on a host without nvcc or a GPU, and only load_kernels() needs
them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from types import SimpleNamespace
from typing import List, NamedTuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("csr_screen.cu", "ll_screen.cu", "stats_ll.cu")
# No --use_fast_math: the likelihood screen's flags come out of f32
# comparisons and need the precise powf/logf/expf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildInfo(NamedTuple):
    source: str  # file name under ops/csrc
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


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC_DIR, name), "rb") as fh:
        h.update(name.encode() + b"\0" + fh.read())
    stem = os.path.splitext(name)[0]
    return os.path.join(BUILD_DIR, f"libguac_{stem}_{h.hexdigest()[:16]}.so")


def build() -> List[BuildInfo]:
    """Compile every source that has no build of its current text, all at
    once, and wait for them."""
    running, infos = [], []
    for name in SOURCES:
        path = _library_path(name)
        if os.path.exists(path):
            infos.append(BuildInfo(name, path, 0.0, ""))
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name)]
        os.makedirs(BUILD_DIR, exist_ok=True)
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, path, tmp, cmd, proc, time.perf_counter()))
    failures = []
    for name, path, tmp, cmd, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
            )
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        infos.append(BuildInfo(name, path, seconds, log))
    if failures:
        raise RuntimeError("\n".join(failures))
    return infos


@functools.lru_cache(maxsize=None)
def load_kernels() -> SimpleNamespace:
    """The kernels' C entry points, built on first use. Raises when a
    library cannot be built or loaded: on a CUDA tensor there is no
    fallback."""
    libs = {info.source: ctypes.CDLL(info.path) for info in build()}
    ptr, i64, i32, f32 = (
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
    )
    csr, ll = libs["csr_screen.cu"], libs["ll_screen.cu"]
    stats = libs["stats_ll.cu"]
    csr.guac_csr_count_screen.argtypes = [
        ptr, i64, ptr, ptr, i64, i32, i32, ptr, ptr, ptr,
    ]
    csr.guac_csr_count_screen.restype = i32
    csr.guac_csr_compact.argtypes = [
        ptr, ptr, i64, i32, i32, ptr, ptr, ptr,
    ]
    csr.guac_csr_compact.restype = i32
    ll.guac_ll_screen.argtypes = [
        ptr, i32, ptr, ptr, i32, ptr, i64, i64, i32, f32, f32, ptr, ptr,
    ]
    ll.guac_ll_screen.restype = i32
    stats.guac_stats_ll.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32,
        ptr, ptr, ptr, ptr, ptr, ptr,
    ]
    stats.guac_stats_ll.restype = i32
    return SimpleNamespace(
        guac_csr_count_screen=csr.guac_csr_count_screen,
        guac_csr_compact=csr.guac_csr_compact,
        guac_ll_screen=ll.guac_ll_screen,
        guac_stats_ll=stats.guac_stats_ll,
    )
