"""Plain PyTorch forms of the counting-screen, likelihood-screen and
dense-tile math.

Ports guacamole_tpu/ops/kernels.py:143-259 (counts_candidates,
csr_screen_math, tile_stats_csr, tile_stats_csr_compact) and the row-
metadata wire form of guacamole_tpu/ops/dispatch.py:787-817
(pack_variant_words16, _unpack_variant_words, _unpack_csr_meta as
row_offsets + unpack_variant_words).

Every counting output is an integer, so each counting function here is
bit-equal to its JAX counterpart on the same inputs. They are the plain
twins of the CUDA kernels in ops/cuda_kernels.py: the CPU path runs them,
and chip_smoke.py holds the kernels against them on the card. Shifts and
masks on the uint16 wire words happen after widening to int32 (torch has
no >> for uint16 on the CPU).

The likelihood screens (guacamole_tpu/ops/kernels.py:262-434, 487-571:
genotype_pairs, _screen_from_allele_sums, germline_screen_math[8],
tumor_screen_math[8]) are f32 on any device, the plain versions of the
ll_screen CUDA kernel. Their flags come from f32 sums and so are not
integers underneath: they are held to the JAX flags on pinned seeds and to
the superset-of-f64 contract, not to bit-equality on every input.

The dense-tile forms at the end (guacamole_tpu/ops/kernels.py:44-140,
574-609, and the plain version of the fused stats_ll kernel) work on full
per-element [L, D] planes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


# --- likelihood screens ------------------------------------------------------


def genotype_pairs(max_alleles: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unordered diploid genotype index pairs (i <= j) over K alleles, in
    the same enumeration order as the reference (i outer, j inner)."""
    pairs = [
        (i, j) for i in range(max_alleles) for j in range(i, max_alleles)
    ]
    i_idx = np.array([p[0] for p in pairs], dtype=np.int64)
    j_idx = np.array([p[1] for p in pairs], dtype=np.int64)
    return i_idx, j_idx


class ScreenParts(NamedTuple):
    """What the candidate decision is made from, per row (chip_smoke.py
    reads the decision's slack from these)."""

    has_var: torch.Tensor  # [L] bool: some standard variant allele
    best_variant: torch.Tensor  # [L] f32
    best_ref: torch.Tensor  # [L] f32
    gq: Optional[torch.Tensor]  # [L] f32 when min_phred > 0
    smax_finite: Optional[torch.Tensor]  # [L] bool when min_phred > 0


def screen_parts(
    c: torch.Tensor,  # [L, K] per-allele sum of m=0 log terms
    g: torch.Tensor,  # [L, K] per-allele sum of m=2 log terms
    is_variant: torch.Tensor,  # [L, K] bool
    is_standard_alt: torch.Tensor,  # [L, K] bool
    max_alleles: int,
    min_phred: float = 0.0,
) -> ScreenParts:
    """Pair scores from per-allele sums (score(i,j) = -c_i - c_j for
    i != j, score(i,i) = -c_i + g_i; the all-elements term cancels from
    the comparison), the best variant and best reference genotype over
    pairs of standard alleles, and, with min_phred > 0, the genotype
    quality of the best genotype in runner/total form (1 - p computes as
    runner_sum / total, never as 1 - p, so there is no cancellation)."""
    i_np, j_np = genotype_pairs(max_alleles)
    i_idx = torch.as_tensor(i_np, device=c.device)
    j_idx = torch.as_tensor(j_np, device=c.device)
    het = (i_idx != j_idx)[None, :]
    score = -c[:, i_idx] + torch.where(het, -c[:, j_idx], g[:, i_idx])
    pair_exists = is_standard_alt[:, i_idx] & is_standard_alt[:, j_idx]
    pair_variant = is_variant[:, i_idx] | is_variant[:, j_idx]
    neg_inf = torch.tensor(float("-inf"), dtype=c.dtype, device=c.device)
    best_variant = torch.where(
        pair_exists & pair_variant, score, neg_inf
    ).amax(dim=1)
    best_ref = torch.where(
        pair_exists & ~pair_variant, score, neg_inf
    ).amax(dim=1)
    has_var = (pair_exists & pair_variant).any(dim=1)
    if not min_phred > 0:
        return ScreenParts(has_var, best_variant, best_ref, None, None)
    smax = torch.maximum(best_variant, best_ref)
    # Masked BEFORE exp: -inf - -inf is NaN where every score is -inf.
    rel = torch.where(pair_exists, score - smax[:, None], neg_inf)
    total = torch.exp(rel).sum(dim=1)  # the best pair contributes exactly 1
    runner = total - 1.0
    one_minus = runner.clamp_min(0.0) / total.clamp_min(1.0) + 1e-10
    gq = -10.0 * torch.log10(one_minus)
    return ScreenParts(
        has_var, best_variant, best_ref, gq, torch.isfinite(smax)
    )


# The 2-phred safety band of the f32 GQ gate (the native f64 form uses 1).
GQ_SAFETY_BAND = 2.0


def screen_from_allele_sums(
    c: torch.Tensor,
    g: torch.Tensor,
    is_variant: torch.Tensor,
    is_standard_alt: torch.Tensor,
    max_alleles: int,
    margin: float,
    min_phred: float = 0.0,
) -> torch.Tensor:
    """Shared tail of the likelihood screens
    (guacamole_tpu/ops/kernels.py::_screen_from_allele_sums): flag loci
    where the best variant genotype comes within `margin` of the best
    reference genotype.

    Rows with no standard variant allele can never emit; the has_var guard
    also keeps every implementation identical when all scores are -inf
    (IEEE -inf >= -inf is true).

    min_phred > 0 additionally drops candidates whose best-genotype
    normalized probability cannot reach that phred score, with a 2-phred
    safety band so the drop stays a strict superset filter; rows whose
    best score is not finite are kept. This GQ gate has four
    implementations that must stay in sync: guacamole_tpu/ops/kernels.py
    (_screen_from_allele_sums), guacamole_tpu/ops/pallas_kernels.py
    (_ll_screen_kernel), native/guac_pack.cpp and its copy in
    runtime/csrc/ (ll_candidates, f64, 1-phred band), and this one with
    its CUDA form in ops/csrc/ll_screen.cu."""
    parts = screen_parts(
        c, g, is_variant, is_standard_alt, max_alleles, min_phred
    )
    like = dict(dtype=c.dtype, device=c.device)
    cand = parts.has_var & (
        parts.best_variant >= parts.best_ref - torch.tensor(margin, **like)
    )
    if parts.gq is not None:
        floor = torch.tensor(min_phred - GQ_SAFETY_BAND, **like)
        cand = cand & (~parts.smax_finite | (parts.gq >= floor))
    return cand


def _phred_error(q: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.pow(10.0, q.to(dtype) / -10.0)


def _pad16(tab: torch.Tensor) -> torch.Tensor:
    """Pad a qual-dictionary table to 16 entries so that the empty-slot
    index 0xF is in range (its slots are masked by `valid` anyway)."""
    pad = 16 - tab.shape[0]
    if pad < 0:
        raise ValueError(f"a qual dictionary has at most 16 entries, got {tab.shape[0]}")
    return torch.cat([tab, tab.new_zeros(pad)]) if pad else tab


def allele_sums(
    aid: torch.Tensor,  # [L, D] integer allele ids (0xF when empty)
    valid: torch.Tensor,  # [L, D] bool
    x: torch.Tensor,  # [L, D] f32 m=0 terms
    y: torch.Tensor,  # [L, D] f32 m=2 terms
    max_alleles: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, K] per-allele sums of x and y over each row's valid elements.
    One masked row sum per allele: the temporaries stay [L, D], where the
    JAX form materializes a [L, D, K] one-hot."""
    zero = x.new_zeros(())
    cs, gs = [], []
    for k in range(max_alleles):
        hit = (aid == k) & valid
        cs.append(torch.where(hit, x, zero).sum(dim=1))
        gs.append(torch.where(hit, y, zero).sum(dim=1))
    return torch.stack(cs, dim=1), torch.stack(gs, dim=1)


def _decode16(ll_pack: torch.Tensor):
    p = ll_pack.to(torch.int32)
    return p & 0xF, p >> 4, p != 0xFFFF


def _decode8(ll_pack8: torch.Tensor):
    p = ll_pack8.to(torch.int32)
    return p & 0xF, (p >> 4).long(), p != 0xFF


def germline_terms(
    q: torch.Tensor, dtype=torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log 2err, log(2 - 2err)) for phred q: the m=0 and m=2 log terms.
    The second is -inf at q == 0."""
    err = _phred_error(q, dtype)
    return torch.log(2.0 * err), torch.log(2.0 - 2.0 * err)


def tumor_terms(
    err_q: torch.Tensor, ll_mapq: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log 2(1-pc), log 2pc) with alignment-included correctness
    pc = (1-err_q)(1-err_m) and the stable complement."""
    err_m = _phred_error(ll_mapq, err_q.dtype)
    pc = (1.0 - err_q) * (1.0 - err_m)
    one_minus_pc = err_q + err_m - err_q * err_m
    return torch.log(2.0 * one_minus_pc), torch.log(2.0 * pc)


def ll_allele_sums(
    ll_pack: torch.Tensor,  # [L, D] uint16, or uint8 with ll_qvals
    max_alleles: int,
    ll_qvals: Optional[torch.Tensor] = None,  # [Q <= 16] uint8
    ll_mapq: Optional[torch.Tensor] = None,  # [L, D] uint8: the tumor form
    dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(c [L, K], g [L, K], any_valid [L]) of any of the four forms. The
    screens run in f32; dtype=torch.float64 gives the exact evaluation the
    f32 flags are held to as a superset."""
    if ll_qvals is None:
        aid, q, valid = _decode16(ll_pack)
        if ll_mapq is None:
            x, y = germline_terms(q, dtype)
        else:
            x, y = tumor_terms(_phred_error(q, dtype), ll_mapq)
    else:
        aid, qidx, valid = _decode8(ll_pack)
        qvals = ll_qvals.to(ll_pack.device)
        if ll_mapq is None:
            # The per-qual terms pretabulate over the dictionary: the same
            # values the uint16 form computes per element.
            x_tab, y_tab = germline_terms(qvals, dtype)
            x, y = _pad16(x_tab)[qidx], _pad16(y_tab)[qidx]
        else:
            x, y = tumor_terms(
                _pad16(_phred_error(qvals, dtype))[qidx], ll_mapq
            )
    c, g = allele_sums(aid, valid, x, y, max_alleles)
    return c, g, valid.any(dim=1)


def germline_screen_math(
    ll_pack: torch.Tensor,  # [L, D] uint16: allele_id | qual << 4
    is_variant: torch.Tensor,  # [L, K] bool
    is_standard_alt: torch.Tensor,  # [L, K] bool (genotype-eligible alleles)
    max_alleles: int,
    margin: float = 0.5,
    min_phred: float = 0.0,
) -> torch.Tensor:
    """Candidate loci for the Bayesian germline caller: [L] bool
    (guacamole_tpu/ops/kernels.py::germline_screen_math). For an element
    with allele a and error err = 10^(-q/10), p_i + p_j = m + (2 - 2m)err
    with m = [i==a] + [j==a]; the m=1 term is log 1 = 0, so each pair's
    log-likelihood factors into per-allele sums C_k (of log 2err) and G_k
    (of log(2 - 2err)). With f32 row error far below margin, the flags are
    a superset of the loci whose exact f64 argmax genotype is variant."""
    c, g, any_valid = ll_allele_sums(ll_pack, max_alleles)
    return screen_from_allele_sums(
        c, g, is_variant, is_standard_alt, max_alleles, margin, min_phred
    ) & any_valid


def germline_screen_math8(
    ll_pack8: torch.Tensor,  # [L, D] uint8: allele_id | qual_index << 4
    ll_qvals: torch.Tensor,  # [Q <= 16] uint8 phred values
    is_variant: torch.Tensor,
    is_standard_alt: torch.Tensor,
    max_alleles: int,
    margin: float = 0.5,
    min_phred: float = 0.0,
) -> torch.Tensor:
    """germline_screen_math over the qual-dictionary byte encoding: half
    the bytes, identical flags."""
    c, g, any_valid = ll_allele_sums(ll_pack8, max_alleles, ll_qvals)
    return screen_from_allele_sums(
        c, g, is_variant, is_standard_alt, max_alleles, margin, min_phred
    ) & any_valid


def tumor_screen_math(
    ll_pack: torch.Tensor,  # [L, D] uint16
    ll_mapq: torch.Tensor,  # [L, D] uint8 per-element read MAPQ
    is_variant: torch.Tensor,
    is_standard_alt: torch.Tensor,
    max_alleles: int,
    margin: float = 0.5,
) -> torch.Tensor:
    """Somatic tumor candidate screen: [L] bool
    (guacamole_tpu/ops/kernels.py::tumor_screen_math), the same factored
    form with alignment-included correctness."""
    c, g, any_valid = ll_allele_sums(ll_pack, max_alleles, None, ll_mapq)
    return screen_from_allele_sums(
        c, g, is_variant, is_standard_alt, max_alleles, margin
    ) & any_valid


def tumor_screen_math8(
    ll_pack8: torch.Tensor,  # [L, D] uint8
    ll_qvals: torch.Tensor,  # [Q <= 16] uint8
    ll_mapq: torch.Tensor,  # [L, D] uint8
    is_variant: torch.Tensor,
    is_standard_alt: torch.Tensor,
    max_alleles: int,
    margin: float = 0.5,
) -> torch.Tensor:
    """tumor_screen_math over the qual-dictionary byte encoding."""
    c, g, any_valid = ll_allele_sums(ll_pack8, max_alleles, ll_qvals, ll_mapq)
    return screen_from_allele_sums(
        c, g, is_variant, is_standard_alt, max_alleles, margin
    ) & any_valid


def unpack_flag_words(
    flag_words: torch.Tensor, max_alleles: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L] int32 flag words (is_variant bits 0..14, is_standard_alt bits
    16..30; bit 31 is never set, so the int32 holds the uint32 wire word)
    -> ([L, K] bool, [L, K] bool)."""
    k = torch.arange(max_alleles, dtype=torch.int32, device=flag_words.device)
    w = flag_words[:, None]
    return ((w >> k) & 1) > 0, ((w >> (k + 16)) & 1) > 0


def ll_screen(
    ll_pack: torch.Tensor,
    flag_words: torch.Tensor,
    max_alleles: int,
    margin: float = 0.5,
    min_phred: float = 0.0,
    ll_qvals: Optional[torch.Tensor] = None,
    ll_mapq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the ll_screen CUDA kernel: the same wire form in
    (flags still packed in their words), [L] bool out. The tumor form
    (ll_mapq given) has no GQ gate."""
    is_variant, is_standard_alt = unpack_flag_words(flag_words, max_alleles)
    c, g, any_valid = ll_allele_sums(ll_pack, max_alleles, ll_qvals, ll_mapq)
    return screen_from_allele_sums(
        c, g, is_variant, is_standard_alt, max_alleles, margin,
        0.0 if ll_mapq is not None else min_phred,
    ) & any_valid


# --- dense tiles -------------------------------------------------------------
#
# The per-element [L, D] forms (guacamole_tpu/ops/kernels.py:44-140, 574-609):
# counting, per-element correctness and the genotype log-likelihoods over all
# K(K+1)/2 pairs, and stats_ll_math, the plain version of the stats_ll CUDA
# kernel (guacamole_tpu/ops/pallas_kernels.py::_stats_ll_kernel). f32 unless
# a dtype is asked for; they run where their inputs lie.

LOG2 = float(np.log(2.0))


def phred_to_success(phred: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return 1.0 - torch.pow(10.0, phred.to(dtype) / -10.0)


def allele_counts(
    allele_id: torch.Tensor,  # [L, D] int
    strand: torch.Tensor,  # [L, D] bool
    valid: torch.Tensor,  # [L, D] bool
    max_alleles: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-locus allele counts and forward-strand counts: [L, K] int32. One
    masked row sum per allele, so the temporaries stay [L, D] (the JAX form
    sums a [L, D, K] one-hot)."""
    counts, fwd = [], []
    for k in range(max_alleles):
        hit = (allele_id == k) & valid
        counts.append(hit.sum(dim=1, dtype=torch.int32))
        fwd.append((hit & strand).sum(dim=1, dtype=torch.int32))
    return torch.stack(counts, dim=1), torch.stack(fwd, dim=1)


def probability_correct(
    qual: torch.Tensor,  # [L, D] int
    mapq: torch.Tensor,  # [L, D] int
    valid: torch.Tensor,  # [L, D] bool
    include_alignment: bool = False,
    dtype=torch.float32,
) -> torch.Tensor:
    """P(sequenced bases correct) per element, 0 outside valid slots."""
    pc = phred_to_success(qual, dtype)
    if include_alignment:
        pc = pc * phred_to_success(mapq, dtype)
    return torch.where(valid, pc, pc.new_zeros(()))


def genotype_log_likelihoods(
    allele_id: torch.Tensor,  # [L, D] int
    pc: torch.Tensor,  # [L, D] probability-correct
    valid: torch.Tensor,  # [L, D] bool
    max_alleles: int,
) -> torch.Tensor:
    """log L(g) for all K(K+1)/2 diploid genotypes per locus: [L, P], in
    the dtype of pc.

    log L(i,j) = sum_d log(p(i,d) + p(j,d)) - depth * log 2
    with p(a,d) = pc(d) if element d carries allele a else 1 - pc(d). One
    [L, D] pass per pair, where the JAX form builds [L, D, P]."""
    i_idx, j_idx = genotype_pairs(max_alleles)
    one_minus = 1.0 - pc
    p_allele = [
        torch.where(allele_id == k, pc, one_minus) for k in range(max_alleles)
    ]
    zero = pc.new_zeros(())
    depth = valid.sum(dim=1).to(pc.dtype)
    out = [
        torch.where(
            valid, torch.log(p_allele[int(i)] + p_allele[int(j)]), zero
        ).sum(dim=1)
        for i, j in zip(i_idx, j_idx)
    ]
    return torch.stack(out, dim=1) - depth[:, None] * LOG2


class PackedScreen(NamedTuple):
    counts: torch.Tensor  # [L, K] allele counts (int32)
    candidates: torch.Tensor  # [L] bool


def tile_stats_nibble(
    packed: torch.Tensor,  # [L, ceil(D/2)] uint8, two 4-bit allele ids/byte
    is_variant: torch.Tensor,  # [L, K] bool
    max_alleles: int,
    threshold_percent: Optional[int] = None,
) -> PackedScreen:
    """Counting + candidate screen over nibble-packed allele ids (0xF =
    empty slot; low nibble = even depth slot, high nibble = odd). The same
    counts and the same candidate rule as tile_stats on the unpacked
    arrays. The dispatch reads such rows as CSR rows of equal length into
    csr_count_screen; this is the form they are held against."""
    check_alleles(max_alleles)
    b = packed.to(torch.int32)
    lo, hi = b & 0xF, b >> 4
    counts = torch.stack(
        [
            (lo == k).sum(dim=1, dtype=torch.int32)
            + (hi == k).sum(dim=1, dtype=torch.int32)
            for k in range(max_alleles)
        ],
        dim=1,
    )
    depth = (lo != 0xF).sum(dim=1, dtype=torch.int32) + (hi != 0xF).sum(
        dim=1, dtype=torch.int32
    )
    return PackedScreen(
        counts, counts_candidates(counts, depth, is_variant, threshold_percent)
    )


class TileStats(NamedTuple):
    counts: torch.Tensor  # [L, K] allele counts
    forward_counts: torch.Tensor  # [L, K]
    depth: torch.Tensor  # [L] valid-slot depth
    forward_depth: torch.Tensor  # [L]
    variant_evidence: torch.Tensor  # [L] bool: the candidate rule


def tile_stats(
    allele_id: torch.Tensor,
    strand: torch.Tensor,
    valid: torch.Tensor,
    is_variant: torch.Tensor,  # [L, K] bool
    max_alleles: int,
    threshold_percent: Optional[int] = None,
) -> TileStats:
    """Fused counting + candidate screening for one dense tile
    (guacamole_tpu/ops/kernels.py::tile_stats); any number of alleles."""
    counts, fwd = allele_counts(allele_id, strand, valid, max_alleles)
    depth = valid.sum(dim=1, dtype=torch.int32)
    forward_depth = (valid & strand).sum(dim=1, dtype=torch.int32)
    return TileStats(
        counts, fwd, depth, forward_depth,
        counts_candidates(counts, depth, is_variant, threshold_percent),
    )


class TileStatsLL(NamedTuple):
    """The five outputs of the fused dense kernel (the JAX package's
    PallasTileStats)."""

    counts: torch.Tensor  # [L, K] int32
    forward_counts: torch.Tensor  # [L, K] int32
    depth: torch.Tensor  # [L] int32
    candidates: torch.Tensor  # [L] bool
    log_likelihoods: Optional[torch.Tensor]  # [L, P] f32, None when skipped


def stats_ll_math(
    allele_id: torch.Tensor,  # [L, D] int, anything outside 0..K-1 = no allele
    qual: Optional[torch.Tensor],  # [L, D] int
    mapq: Optional[torch.Tensor],  # [L, D] int
    strand: torch.Tensor,  # [L, D] bool
    valid: torch.Tensor,  # [L, D] bool
    is_variant: torch.Tensor,  # [L, K] bool
    max_alleles: int,
    include_alignment: bool = False,
    threshold_percent: Optional[int] = None,
    with_likelihoods: bool = True,
    dtype=torch.float32,
) -> TileStatsLL:
    """Plain version of the stats_ll CUDA kernel, written as the TPU kernel
    is (guacamole_tpu/ops/pallas_kernels.py::_stats_ll_kernel): counts,
    forward counts, depth, the candidate rule, and one log per element and
    pair for the likelihoods, with pc = 1 - 10^(q * -0.1). The CUDA kernel
    takes three logs per element and factors the pairs; the two agree to
    rounding. dtype=torch.float64 gives the evaluation both are held to."""
    stats = tile_stats(
        allele_id, strand, valid, is_variant, max_alleles, threshold_percent
    )
    ll = None
    if with_likelihoods:
        pc = 1.0 - torch.pow(10.0, qual.to(dtype) * -0.1)
        if include_alignment:
            pc = pc * (1.0 - torch.pow(10.0, mapq.to(dtype) * -0.1))
        ll = genotype_log_likelihoods(allele_id, pc, valid, max_alleles)
    return TileStatsLL(
        stats.counts, stats.forward_counts, stats.depth,
        stats.variant_evidence, ll,
    )


def tile_stats_ll(
    allele_id, qual, mapq, strand, valid, is_variant, max_alleles: int,
    include_alignment: bool = False,
    threshold_percent: Optional[int] = None,
    with_likelihoods: bool = True,
) -> TileStatsLL:
    """The fused dense-tile statistics where the tensors lie: the stats_ll
    CUDA kernel on a GPU (it launches or raises), stats_ll_math on the
    CPU."""
    from guacamole_tpu_torch.ops.cuda_kernels import stats_ll

    return stats_ll(
        allele_id, qual, mapq, strand, valid, is_variant, max_alleles,
        include_alignment=include_alignment,
        threshold_percent=threshold_percent,
        with_likelihoods=with_likelihoods,
    )
