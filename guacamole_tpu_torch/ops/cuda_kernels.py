"""Wrappers of the hand-written CUDA kernels (ops/csrc/*.cu).

Port of guacamole_tpu/ops/pallas_kernels.py:247-367 (_lane_cumsum,
_csr_prefix_kernel, pallas_csr_screen), the compaction that the JAX
package left to XLA (kernels.py::tile_stats_csr_compact),
pallas_kernels.py:370-579 (_ll_screen_kernel, pallas_likelihood_screen) and
pallas_kernels.py:31-234 (_stats_ll_kernel, fused_tile_stats_ll).

A tensor on the CPU takes the kernel's plain twin in ops/kernels.py. A
tensor on a CUDA device launches the kernel, on the current stream, or
raises: there is no fallback. LAUNCHES counts the kernel launches of each
wrapper (plain-twin calls are not counted), so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from guacamole_tpu_torch.ops import kernels
from guacamole_tpu_torch.ops.build import load_kernels

LAUNCHES = {
    "csr_count_screen": 0, "csr_compact": 0, "ll_screen": 0, "stats_ll": 0,
}
# The launches of ll_screen by form: germline or tumor (a MAPQ plane), uint16
# or uint8 (a qual dictionary). They add up to LAUNCHES["ll_screen"].
LL_FORM_LAUNCHES = {
    "germline_u16": 0, "germline_u8": 0, "tumor_u16": 0, "tumor_u8": 0,
}


# The shapes of the launches since the last reset (the newest 4096 of each
# kernel), from the wrappers' arguments: (rows, blob bytes), (rows, cap),
# (rows, D, form) and (rows, D, with likelihoods). A run can say from these
# at which shapes its main path really launches.
LAUNCH_SHAPES = {name: collections.deque(maxlen=4096) for name in LAUNCHES}

# The counting kernel addresses the blob in int32, with room for 16 bytes of
# alignment.
MAX_BLOB_BYTES = 2**31 - 17


# The most blocks csr_compact launches (kCompactMaxBlocks in
# ops/csrc/csr_screen.cu): one int32 of scratch each.
COMPACT_MAX_BLOCKS = 1024


def reset_launches() -> None:
    for table in (LAUNCHES, LL_FORM_LAUNCHES):
        for name in table:
            table[name] = 0
    for shapes in LAUNCH_SHAPES.values():
        shapes.clear()


def ll_step(depth_slots: int) -> int:
    """The elements of a row that the ll_screen kernel reads at once (16
    where D allows, else 8, 4 or 1): step_of in ops/csrc/ll_screen.cu."""
    return next((e for e in (16, 8, 4) if depth_slots % e == 0), 1)


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
    if blob.numel() > MAX_BLOB_BYTES:
        raise ValueError(
            f"blob has {blob.numel()} bytes: the counting screen takes at "
            f"most 2^31 - 17 = {MAX_BLOB_BYTES} (int32 offsets); split it "
            f"into slabs"
        )
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
            blob.data_ptr(), blob.numel(), row_off.data_ptr(),
            variant_words.data_ptr(), L, max_alleles,
            -1 if threshold_percent is None else int(threshold_percent),
            counts.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "csr_count_screen")
    LAUNCHES["csr_count_screen"] += 1
    LAUNCH_SHAPES["csr_count_screen"].append((L, blob.numel()))
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
    # The block totals of the kernel's two passes. From the caching
    # allocator, so a call on another stream gets another buffer.
    scratch = torch.empty(COMPACT_MAX_BLOCKS, dtype=torch.int32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.guac_csr_compact(
            candidates.data_ptr(), counts.data_ptr(), L, K, cap,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            scratch.data_ptr(),
        )
    _raise_on(rc, "csr_compact")
    LAUNCHES["csr_compact"] += 1
    LAUNCH_SHAPES["csr_compact"].append((L, cap))
    return out


def ll_screen(
    ll_pack: torch.Tensor,  # [L, D] uint16, or uint8 with ll_qvals
    flag_words: torch.Tensor,  # [L] int32 holding the uint32 flag words
    max_alleles: int,
    margin: float = 0.5,
    min_phred: float = 0.0,
    ll_qvals=None,  # [Q <= 16] uint8 phred values, on the HOST
    ll_mapq: Optional[torch.Tensor] = None,  # [L, D] uint8: the tumor form
) -> torch.Tensor:
    """Genotype-likelihood candidate flags ([L] bool) over a dense tile:
    the contract of pallas_likelihood_screen and of kernels.ll_screen, in
    all four forms (germline or tumor, uint16 or uint8 qual-dictionary).
    The flag words stay packed (is_variant bits 0..14, is_standard_alt
    bits 16..30) and are unpacked inside the kernel. ll_qvals is a launch
    parameter like margin: at most 16 bytes, read on the host. The GQ
    gate (min_phred > 0) applies to the germline form only."""
    if ll_pack.dtype == torch.uint8:
        if ll_qvals is None:
            raise ValueError("a uint8 ll_pack needs its qual dictionary")
        qvals = np.ascontiguousarray(
            ll_qvals.cpu().numpy() if isinstance(ll_qvals, torch.Tensor)
            else ll_qvals, dtype=np.uint8,
        )
        if qvals.ndim != 1 or qvals.size > 16:
            raise ValueError(
                f"ll_qvals: expected at most 16 phred values, got shape "
                f"{qvals.shape}"
            )
    elif ll_pack.dtype == torch.uint16:
        if ll_qvals is not None:
            raise ValueError("a uint16 ll_pack takes no qual dictionary")
        qvals = None
    else:
        raise ValueError(f"ll_pack: expected uint8 or uint16, got {ll_pack.dtype}")
    _check(ll_pack, "ll_pack", ll_pack.dtype, 2)
    _check(flag_words, "flag_words", torch.int32, 1)
    L, D = ll_pack.shape
    if flag_words.numel() != L:
        raise ValueError(f"flag_words has {flag_words.numel()} rows, ll_pack {L}")
    tensors = [ll_pack, flag_words]
    if ll_mapq is not None:
        _check(ll_mapq, "ll_mapq", torch.uint8, 2)
        if ll_mapq.shape != ll_pack.shape:
            raise ValueError(
                f"ll_mapq {tuple(ll_mapq.shape)} != ll_pack {tuple(ll_pack.shape)}"
            )
        tensors.append(ll_mapq)
    kernels.check_alleles(max_alleles)
    if D < 1:
        raise ValueError("ll_pack needs at least one depth slot")
    # The kernel reads a row in steps of ll_step(D) elements, each with one
    # or two vector loads: a plane must be aligned to a step's bytes (at
    # most 16). Tensors that torch allocated are; a view that starts inside
    # a row is not.
    for name, plane in (("ll_pack", ll_pack), ("ll_mapq", ll_mapq)):
        if plane is None:
            continue
        align = min(16, ll_step(D) * plane.element_size())
        if plane.data_ptr() % align:
            raise ValueError(
                f"{name}: [L, {D}] {plane.dtype} must start at a multiple of "
                f"{align} bytes, got address {plane.data_ptr():#x}"
            )
    dev = _device_of(*tensors)
    if dev.type == "cpu":
        return kernels.ll_screen(
            ll_pack, flag_words, max_alleles, margin, min_phred,
            None if qvals is None else torch.from_numpy(qvals), ll_mapq,
        )
    out = torch.empty(L, dtype=torch.bool, device=dev)
    if L == 0:
        return out
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.guac_ll_screen(
            ll_pack.data_ptr(), ll_pack.element_size(),
            None if ll_mapq is None else ll_mapq.data_ptr(),
            None if qvals is None else qvals.ctypes.data_as(ctypes.c_void_p),
            0 if qvals is None else int(qvals.size),
            flag_words.data_ptr(), L, D, max_alleles,
            float(margin), float(min_phred), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "ll_screen")
    form = ("germline" if ll_mapq is None else "tumor") + (
        "_u16" if qvals is None else "_u8"
    )
    LAUNCHES["ll_screen"] += 1
    LL_FORM_LAUNCHES[form] += 1
    LAUNCH_SHAPES["ll_screen"].append((L, D, form))
    return out


# The most alleles the stats_ll kernel takes (its per-row sums of 3K + 1
# floats lie in shared memory).
MAX_DENSE_ALLELES = 256


def stats_ll(
    allele_id: torch.Tensor,  # [L, D] int16, outside 0..K-1 = no allele
    qual: Optional[torch.Tensor],  # [L, D] int16; None without likelihoods
    mapq: Optional[torch.Tensor],  # [L, D] int16; None without alignment
    strand: torch.Tensor,  # [L, D] bool
    valid: torch.Tensor,  # [L, D] bool
    is_variant: torch.Tensor,  # [L, K] bool
    max_alleles: int,
    include_alignment: bool = False,
    threshold_percent: Optional[int] = None,
    with_likelihoods: bool = True,
) -> kernels.TileStatsLL:
    """One pass over a dense tile in its own types: allele counts and
    forward-strand counts ([L, K] int32), depth ([L] int32), the candidate
    flag ([L] bool; any variant allele with an element, or the exact
    threshold rule) and, unless with_likelihoods is False, the
    log-likelihood of all K(K+1)/2 diploid genotypes ([L, P] f32). The
    contract of fused_tile_stats_ll and of kernels.stats_ll_math. Without
    likelihoods qual and mapq are not read and may be None; mapq is read
    only with include_alignment."""
    _check(allele_id, "allele_id", torch.int16, 2)
    L, D = allele_id.shape
    planes = [("strand", strand, torch.bool), ("valid", valid, torch.bool)]
    if with_likelihoods:
        planes.append(("qual", qual, torch.int16))
        if include_alignment:
            planes.append(("mapq", mapq, torch.int16))
    for name, t, dtype in planes:
        if t is None:
            raise ValueError(f"{name} is needed here and was not given")
        _check(t, name, dtype, 2)
        if t.shape != allele_id.shape:
            raise ValueError(
                f"{name} {tuple(t.shape)} != allele_id {tuple(allele_id.shape)}"
            )
    _check(is_variant, "is_variant", torch.bool, 2)
    K = int(max_alleles)
    if not 1 <= K <= MAX_DENSE_ALLELES:
        raise ValueError(
            f"stats_ll takes 1..{MAX_DENSE_ALLELES} alleles, got {K}"
        )
    if tuple(is_variant.shape) != (L, K):
        raise ValueError(
            f"is_variant {tuple(is_variant.shape)}: expected ({L}, {K})"
        )
    if D < 1:
        raise ValueError("a dense tile needs at least one depth slot")
    if threshold_percent is not None and threshold_percent < 0:
        raise ValueError(f"threshold_percent must be >= 0, got {threshold_percent}")
    dev = _device_of(allele_id, is_variant, *(t for _n, t, _d in planes))
    if dev.type == "cpu":
        return kernels.stats_ll_math(
            allele_id, qual, mapq, strand, valid, is_variant, K,
            include_alignment, threshold_percent, with_likelihoods,
        )
    counts = torch.empty((L, K), dtype=torch.int32, device=dev)
    fwd = torch.empty((L, K), dtype=torch.int32, device=dev)
    depth = torch.empty(L, dtype=torch.int32, device=dev)
    cand = torch.empty(L, dtype=torch.bool, device=dev)
    ll = (
        torch.empty((L, K * (K + 1) // 2), dtype=torch.float32, device=dev)
        if with_likelihoods else None
    )
    if L == 0:
        return kernels.TileStatsLL(counts, fwd, depth, cand, ll)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.guac_stats_ll(
            allele_id.data_ptr(),
            qual.data_ptr() if with_likelihoods else None,
            mapq.data_ptr() if with_likelihoods and include_alignment else None,
            strand.data_ptr(), valid.data_ptr(), is_variant.data_ptr(),
            L, D, K, int(bool(include_alignment)),
            -1 if threshold_percent is None else int(threshold_percent),
            counts.data_ptr(), fwd.data_ptr(), depth.data_ptr(),
            cand.data_ptr(), None if ll is None else ll.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "stats_ll")
    LAUNCHES["stats_ll"] += 1
    LAUNCH_SHAPES["stats_ll"].append((L, D, bool(with_likelihoods)))
    return kernels.TileStatsLL(counts, fwd, depth, cand, ll)
