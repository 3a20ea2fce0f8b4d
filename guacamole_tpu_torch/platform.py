"""Device selection and host allocator tuning for the port (cf.
guacamole_tpu/platform.py).

There is no global default device: the CLI asks device() once and passes
the result down explicitly. An entry point runs on the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def device(requested: Optional[str] = None) -> torch.device:
    """The device to run on: "cuda" (also the default, requested=None) or,
    only when asked for, "cpu". Raises when CUDA is wanted and absent:
    nothing falls back to the CPU silently."""
    if requested not in (None, "cuda", "cpu"):
        raise ValueError(f"unknown device {requested!r}: expected cuda or cpu")
    if requested == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the CPU"
        )
    return torch.device("cuda")


def tune_allocator() -> None:
    """Keep glibc from mmap/munmap-cycling the pipeline's large buffers.

    The streaming callers allocate and free hundreds of MB of decode and
    pack buffers per task; glibc's default policy mmaps every allocation
    over 128 KB and munmaps it on free, so each task re-faults its whole
    working set (~1M minor faults per 20 Mbp shard) and every munmap
    broadcasts TLB-shootdown IPIs that stall OTHER cores' processes —
    measured on the 2-core bench host: two concurrent 20 Mbp
    germline-standard runs spend 9-11.5 s/process in system time, vs
    5-7.7 s with this tuning (docs/MULTIHOST.md). Raising the mmap/trim
    thresholds makes freed task buffers stay on the heap and be REUSED by
    the next task — no re-fault, no shootdown. Peak RSS is unchanged (the
    heap high-water is one task's working set; gated by the bench's
    memory_scaling section). GUAC_NO_MALLOC_TUNING=1 disables."""
    if os.environ.get("GUAC_NO_MALLOC_TUNING", "") == "1":
        return
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        one_gb = 1 << 30
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_MMAP_MAX = -1, -3, -4
        libc.mallopt(M_TRIM_THRESHOLD, one_gb)
        libc.mallopt(M_MMAP_THRESHOLD, one_gb)
        libc.mallopt(M_MMAP_MAX, 0)
    except Exception:
        pass  # non-glibc platform: default allocator behavior
