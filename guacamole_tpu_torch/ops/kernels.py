"""Plain PyTorch forms of the counting-screen math.

Ports guacamole_tpu/ops/kernels.py:143-259 (counts_candidates,
csr_screen_math, tile_stats_csr, tile_stats_csr_compact) and the row-
metadata wire form of guacamole_tpu/ops/dispatch.py:787-817
(pack_variant_words16, _unpack_variant_words, _unpack_csr_meta as
row_offsets + unpack_variant_words).

Every output is an integer, so each function here is bit-equal to its JAX
counterpart on the same inputs. They are the plain twins of the CUDA
kernels in ops/cuda_kernels.py: the CPU path runs them, and chip_smoke.py
holds the kernels against them on the card. Shifts and masks on the uint16
wire words happen after widening to int32 (torch has no >> for uint16 on
the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

MAX_CSR_ALLELES = 15  # 4-bit ids; 0xF marks a pad nibble


def counts_candidates(
    counts: torch.Tensor,  # [L, K] int32
    depth: torch.Tensor,  # [L] int32
    is_variant: torch.Tensor,  # [L, K] bool
    threshold_percent: Optional[int],
) -> torch.Tensor:
    """THE candidate rule (guacamole_tpu/ops/kernels.py::counts_candidates).

    Without a threshold, a locus is a candidate if any variant allele has
    reads. With threshold_percent, an allele passes when count * 100 //
    depth > threshold, written division-free as count * 100 >= depth *
    (threshold + 1) for positive counts; candidates are loci where a
    variant allele passes, or where two reference alleles pass (the
    mixed-N corner that classify_locus must still see)."""
    if threshold_percent is None:
        return ((counts > 0) & is_variant).any(dim=1)
    passing = (counts > 0) & (
        counts * 100 >= depth[:, None] * (threshold_percent + 1)
    )
    return (passing & is_variant).any(dim=1) | (
        (passing & ~is_variant).sum(dim=1) >= 2
    )


def csr_screen_math(
    packed: torch.Tensor,  # [B] uint8 nibble pairs, rows byte-aligned
    row_off: torch.Tensor,  # [L+1] int32 byte offsets
    is_variant: torch.Tensor,  # [L, K] bool
    max_alleles: int,
    threshold_percent: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, K] int32 counts and [L] bool candidates from a CSR nibble blob:
    a per-byte one-hot prefix sum differenced at the row offsets, depth as
    the row sum of the counts (guacamole_tpu/ops/kernels.py::
    csr_screen_math). The planes are laid out [K, B] so each prefix sum
    runs along contiguous memory (a scan down the columns of [B, K] took
    seconds per megatile on the GPU)."""
    b = packed.to(torch.int32)
    k_range = torch.arange(max_alleles, dtype=torch.int32, device=b.device)
    one_hot = ((b & 0xF)[None, :] == k_range[:, None]).to(torch.int32) + (
        (b >> 4)[None, :] == k_range[:, None]
    ).to(torch.int32)  # [K, B]
    prefix = torch.cat(
        [
            torch.zeros((max_alleles, 1), dtype=torch.int32, device=b.device),
            torch.cumsum(one_hot, dim=1, dtype=torch.int32),
        ],
        dim=1,
    )  # [K, B+1]
    off = row_off.long()
    counts = (prefix[:, off[1:]] - prefix[:, off[:-1]]).t().contiguous()
    candidates = counts_candidates(
        counts, counts.sum(dim=1, dtype=torch.int32), is_variant,
        threshold_percent,
    )
    return counts, candidates


def tile_stats_csr(
    packed: torch.Tensor,
    row_off: torch.Tensor,
    is_variant: torch.Tensor,
    max_alleles: int,
    threshold_percent: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int16 counts [L, K], bool candidates [L]): the contract of
    guacamole_tpu/ops/kernels.py::tile_stats_csr and of the Pallas
    pallas_csr_screen. int16 halves the device-to-host copy; values wrap
    only on rows deeper than 32767 reads, which the packer flags as
    overflow rows whose counts are never read."""
    check_alleles(max_alleles)
    counts, candidates = csr_screen_math(
        packed, row_off, is_variant, max_alleles, threshold_percent
    )
    return counts.to(torch.int16), candidates


def compact_candidates(
    candidates: torch.Tensor,  # [L] bool
    counts: torch.Tensor,  # [L, K] integer
    cap: int,
) -> torch.Tensor:
    """[cap+1, K+1] int32: the candidate rows ascending, each followed by
    its counts; -1 and zeros in unused body rows; the true candidate total
    in [cap, 0], so a total above cap shows the overflow. The plain twin
    of the csr_compact CUDA kernel."""
    K = counts.shape[1]
    idx = torch.nonzero(candidates).flatten()
    total = int(idx.numel())
    n = min(total, cap)
    out = torch.zeros((cap + 1, K + 1), dtype=torch.int32, device=counts.device)
    out[:cap, 0] = -1
    out[:n, 0] = idx[:n].to(torch.int32)
    out[:n, 1:] = counts[idx[:n]].to(torch.int32)
    out[cap, 0] = total
    return out


def tile_stats_csr_compact(
    packed: torch.Tensor,
    row_off: torch.Tensor,
    is_variant: torch.Tensor,
    max_alleles: int,
    threshold_percent: Optional[int] = None,
    cap: int = 512,
) -> torch.Tensor:
    """guacamole_tpu/ops/kernels.py::tile_stats_csr_compact: the CSR
    screen with its candidates compacted into one [cap+1, K+1] int32
    array."""
    check_alleles(max_alleles)
    counts, candidates = csr_screen_math(
        packed, row_off, is_variant, max_alleles, threshold_percent
    )
    return compact_candidates(candidates, counts, cap)


def pack_variant_words16(is_variant) -> np.ndarray:
    """[L, K <= 15] bool -> [L] uint16 bitmask, the host side of the wire
    form (unpacked on the device by unpack_variant_words)."""
    iv = np.asarray(is_variant, dtype=bool)
    w = np.arange(iv.shape[1], dtype=np.uint16)
    return (iv.astype(np.uint16) << w).sum(axis=1, dtype=np.uint16)


def unpack_variant_words(
    variant_words: torch.Tensor, max_alleles: int
) -> torch.Tensor:
    """[L] uint16 -> [L, K] bool."""
    k = torch.arange(max_alleles, dtype=torch.int32, device=variant_words.device)
    return ((variant_words.to(torch.int32)[:, None] >> k) & 1) > 0


def row_offsets(nibble_bytes: torch.Tensor) -> torch.Tensor:
    """[L] uint16 per-row byte counts -> [L+1] int32 offsets (exact
    integer cumsum): the offset half of guacamole_tpu's _unpack_csr_meta.
    The CUDA path runs it as plain torch on the device too, as JAX left it
    to XLA; the flag half (unpack_variant_words) is fused into the
    counting kernel."""
    return torch.cat(
        [
            torch.zeros(1, dtype=torch.int32, device=nibble_bytes.device),
            torch.cumsum(nibble_bytes.to(torch.int32), dim=0, dtype=torch.int32),
        ]
    )


def csr_count_screen(
    blob: torch.Tensor,  # [B] uint8
    row_off: torch.Tensor,  # [L+1] int32
    variant_words: torch.Tensor,  # [L] uint16
    max_alleles: int,
    threshold_percent: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the csr_count_screen CUDA kernel: the same wire form
    in (variant flags still packed in their uint16 words), int16 counts and
    bool candidates out."""
    return tile_stats_csr(
        blob, row_off, unpack_variant_words(variant_words, max_alleles),
        max_alleles, threshold_percent,
    )


def check_alleles(max_alleles: int) -> None:
    if not 1 <= max_alleles <= MAX_CSR_ALLELES:
        raise ValueError(
            f"CSR screens take 1..{MAX_CSR_ALLELES} alleles (4-bit ids, 0xF "
            f"is the pad), got {max_alleles}"
        )
