"""Wrappers of the hand-written CUDA kernels (ops/csrc/csr_screen.cu).

Port of guacamole_tpu/ops/pallas_kernels.py:247-367 (_lane_cumsum,
_csr_prefix_kernel, pallas_csr_screen) plus the compaction that the JAX
package left to XLA (kernels.py::tile_stats_csr_compact).

A tensor on the CPU takes the kernel's plain twin in ops/kernels.py. A
tensor on a CUDA device launches the kernel, on the current stream, or
raises: there is no fallback. LAUNCHES counts the kernel launches of each
wrapper (plain-twin calls are not counted), so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from guacamole_tpu_torch.ops import kernels
from guacamole_tpu_torch.ops.build import load_kernels

LAUNCHES = {"csr_count_screen": 0, "csr_compact": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}"
        )


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError(
            f"inputs on different devices: {[str(t.device) for t in tensors]}"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def csr_count_screen(
    blob: torch.Tensor,  # [B] uint8, two 4-bit allele ids per byte
    row_off: torch.Tensor,  # [L+1] int32 byte offsets, inside the blob
    variant_words: torch.Tensor,  # [L] uint16 variant bitmasks
    max_alleles: int,
    threshold_percent: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row allele counts ([L, K] int16) and candidate flags ([L] bool)
    over a CSR nibble blob. The contract of pallas_csr_screen and
    kernels.tile_stats_csr. The caller guarantees that the offsets are
    ascending and lie inside the blob (the dispatch builds them from the
    host arrays and checks that before it stages them)."""
    _check(blob, "blob", torch.uint8, 1)
    _check(row_off, "row_off", torch.int32, 1)
    _check(variant_words, "variant_words", torch.uint16, 1)
    L = row_off.numel() - 1
    if L < 0 or variant_words.numel() != L:
        raise ValueError(
            f"row_off has {row_off.numel()} entries, variant_words "
            f"{variant_words.numel()}: expected L+1 and L"
        )
    kernels.check_alleles(max_alleles)
    if threshold_percent is not None and threshold_percent < 0:
        raise ValueError(f"threshold_percent must be >= 0, got {threshold_percent}")
    dev = _device_of(blob, row_off, variant_words)
    if dev.type == "cpu":
        return kernels.csr_count_screen(
            blob, row_off, variant_words, max_alleles, threshold_percent
        )
    counts = torch.empty((L, max_alleles), dtype=torch.int16, device=dev)
    flags = torch.empty(L, dtype=torch.bool, device=dev)
    if L == 0:
        return counts, flags
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.guac_csr_count_screen(
            blob.data_ptr(), row_off.data_ptr(), variant_words.data_ptr(),
            L, max_alleles,
            -1 if threshold_percent is None else int(threshold_percent),
            counts.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "csr_count_screen")
    LAUNCHES["csr_count_screen"] += 1
    return counts, flags


def csr_compact(
    candidates: torch.Tensor,  # [L] bool
    counts: torch.Tensor,  # [L, K] int16
    cap: int,
) -> torch.Tensor:
    """[cap+1, K+1] int32: candidate rows ascending with their counts,
    -1/0 in unused body rows, the candidate total in [cap, 0]. The
    compaction of tile_stats_csr_compact, without a host sync."""
    _check(candidates, "candidates", torch.bool, 1)
    _check(counts, "counts", torch.int16, 2)
    L, K = counts.shape
    if candidates.numel() != L:
        raise ValueError(
            f"candidates has {candidates.numel()} rows, counts {L}"
        )
    kernels.check_alleles(K)
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    dev = _device_of(candidates, counts)
    if dev.type == "cpu":
        return kernels.compact_candidates(candidates, counts, cap)
    out = torch.empty((cap + 1, K + 1), dtype=torch.int32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.guac_csr_compact(
            candidates.data_ptr(), counts.data_ptr(), L, K, cap,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "csr_compact")
    LAUNCHES["csr_compact"] += 1
    return out

