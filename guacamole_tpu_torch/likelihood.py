"""Diploid genotype likelihoods (host, exact float64 path).

For each genotype {a1, a2} over pileup elements e:

  log L(g) = sum_e log(p(a1, e) + p(a2, e)) + log(prior(g)) - depth * log(2)

  p(a, e) = probability_correct(e)      if e.allele == a
            1 - probability_correct(e)  otherwise

Numerical parity contract (stated precisely — see DEVIATIONS.md):
this implementation reproduces the reference's float64 operation ORDER
exactly (the per-genotype sum over elements is accumulated right-to-left,
matching Colt's aggregate; cf. reference
.../likelihood/Likelihood.scala:149-201), so for any given pileup the
likelihood VALUES are bit-identical f64s to what the reference's formula
produces — pinned by the ported LikelihoodSuite closed-form cases and
fuzz tests against the scalar oracle. The resulting end-to-end claim is
record-level: identical CHROM/POS/REF/ALT/GT (and likelihood-derived
fields) on the bundled fixtures. It is NOT a byte-level VCF claim — the
container header differs from ADAM 0.16's by design (DEVIATIONS.md #4),
and no JVM exists in this environment to diff an actual reference run;
concordance.compare_vcf_records is the comparator to use the day a
reference-generated VCF is available.

On device, the same math runs as a vectorized f32 screening kernel over
whole loci tiles (see guacamole_tpu_torch.ops); this host path is then applied
only at surviving candidate loci, keeping exactness off the hot path.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from guacamole_tpu_torch.pileup.element import PileupElement
from guacamole_tpu_torch.pileup.pileup import Pileup
from guacamole_tpu_torch.utils import bases as Bases
from guacamole_tpu_torch.utils.phred import phred_to_success_probability
from guacamole_tpu_torch.variants.allele import Allele, Genotype


def uniform_prior(genotype: Genotype) -> float:
    """Uniform (unnormalized) prior: plain probability, not a log prob."""
    return 1.0


def probability_correct_ignoring_alignment(element: PileupElement) -> float:
    """P(sequenced bases correct) from base quality only."""
    return phred_to_success_probability(element.quality_score)


def probability_correct_including_alignment(element: PileupElement) -> float:
    """P(correct) from base quality and the read's alignment quality."""
    return (
        phred_to_success_probability(element.quality_score)
        * element.read.alignment_likelihood
    )


def likelihoods_of_genotypes(
    elements: Sequence[PileupElement],
    genotypes: Sequence[Genotype],
    probability_correct: Callable[
        [PileupElement], float
    ] = probability_correct_ignoring_alignment,
    prior: Callable[[Genotype], float] = uniform_prior,
    log_space: bool = False,
    normalize: bool = False,
) -> List[float]:
    """Likelihoods of a collection of diploid genotypes over shared elements."""
    alleles = sorted(set(a for g in genotypes for a in g.alleles))
    allele_to_index = {a: i for i, a in enumerate(alleles)}
    depth = len(elements)

    # probabilities[allele index][element index] = p(allele, element)
    success = [probability_correct(e) for e in elements]
    element_alleles = [e.allele for e in elements]
    probabilities = [
        [
            success[j] if allele == element_alleles[j] else 1.0 - success[j]
            for j in range(depth)
        ]
        for allele in alleles
    ]

    log2 = math.log(2)
    log_likelihoods: List[float] = []
    for genotype in genotypes:
        assert genotype.ploidy == 2, "Non-diploid genotype not supported"
        row1 = probabilities[allele_to_index[genotype.alleles[0]]]
        row2 = probabilities[allele_to_index[genotype.alleles[1]]]
        # Right-to-left accumulation (parity with Colt aggregate order).
        # Zero probabilities (base quality 0, or MAPQ 0 in the
        # alignment-included model) follow JVM semantics: Math.log(0.0)
        # is -Infinity, not an error (Likelihood.scala:181-188).
        acc = 0.0
        if depth > 0:
            acc = _log_or_neg_inf(row1[depth - 1] + row2[depth - 1])
            for j in range(depth - 2, -1, -1):
                acc = _log_or_neg_inf(row1[j] + row2[j]) + acc
        log_likelihoods.append(
            acc + _log_or_neg_inf(prior(genotype)) - log2 * depth
        )

    if normalize:
        log_total = _normalization_log_total(log_likelihoods)
        log_likelihoods = [ll - log_total for ll in log_likelihoods]
    if log_space:
        return log_likelihoods
    return [math.exp(ll) for ll in log_likelihoods]


_LOG_MEMO: dict = {}
_SUCCESS_LUT = np.empty(0)


def _exact_logs(values: np.ndarray) -> np.ndarray:
    """Elementwise math.log via unique-value memoization.

    np.log's SIMD implementation differs from libm's math.log by one ulp
    on ~1% of inputs, which would break bit-identity with the scalar
    oracle path; the log domain here (sums of phred-derived
    probabilities) is tiny and repeats across loci, so memoized scalar
    logs cost almost nothing."""
    u, inv = np.unique(values, return_inverse=True)
    logs = np.empty(len(u))
    memo = _LOG_MEMO
    if len(memo) > 1_000_000:  # bound resident memory on genome-scale runs
        memo.clear()
    for i in range(len(u)):
        v = float(u[i])
        lv = memo.get(v)
        if lv is None:
            lv = _log_or_neg_inf(v)
            memo[v] = lv
        logs[i] = lv
    return logs[inv].reshape(values.shape)


def success_probabilities_of_quals(quals: np.ndarray) -> np.ndarray:
    """phred_to_success_probability per element via an int LUT computed
    with the scalar formula (bit-identical to the oracle's per-element
    call; the numpy vectorized power can differ by an ulp)."""
    global _SUCCESS_LUT
    if quals.size == 0:
        return np.empty(0)
    m = int(quals.max())
    if len(_SUCCESS_LUT) <= m:
        _SUCCESS_LUT = np.array(
            [phred_to_success_probability(q) for q in range(m + 1)]
        )
    return _SUCCESS_LUT[quals]


def log_likelihoods_of_genotype_pairs(
    element_allele_ids: np.ndarray,
    success: np.ndarray,
    genotype_id_pairs: Sequence[Tuple[int, int]],
    normalize: bool = False,
) -> np.ndarray:
    """Vectorized exact-float64 genotype log-likelihoods at one locus.

    element_allele_ids: [d] dense per-locus allele id of each element, in
      pileup element order.
    success: [d] float64 P(element correct) — the oracle's scalar values
      (see success_probabilities_of_quals; multiply by the alignment
      likelihood first for the alignment-included model).
    genotype_id_pairs: (a1, a2) dense allele-id pairs, in the oracle's
      genotype enumeration order.

    Bit-identical to likelihoods_of_genotypes(log_space=True) with a
    uniform prior: IEEE-754 addition is commutative, np.cumsum
    accumulates strictly sequentially (so the reversed cumsum reproduces
    the right-to-left Colt aggregate order, Likelihood.scala:181-188),
    logs go through math.log (_exact_logs), and normalization repeats the
    oracle's sequential exp-sum. Pinned bitwise against the scalar path
    in tests/test_likelihood.py."""
    depth = len(element_allele_ids)
    ids = np.asarray(
        [i for pair in genotype_id_pairs for i in pair]
    ).reshape(len(genotype_id_pairs), 2)
    # [G, 2, d] per-allele probabilities: success where the element carries
    # the allele, 1 - success otherwise (same operands/order as the oracle).
    carries = element_allele_ids[None, None, :] == ids[:, :, None]
    probs = np.where(carries, success[None, None, :], 1.0 - success[None, None, :])
    terms = _exact_logs(probs[:, 0, :] + probs[:, 1, :])  # [G, d]
    if depth > 0:
        acc = np.cumsum(terms[:, ::-1], axis=1)[:, -1]
    else:
        acc = np.zeros(len(ids))
    log2 = math.log(2)
    lls = (acc + math.log(1.0)) - log2 * depth
    if normalize:
        lls = lls - _normalization_log_total(lls)
    return lls


_PAIR_PATTERNS: dict = {}
_TERM_LUT_Q: np.ndarray = np.zeros((1, 3))
_TERM_LUT_QM: dict = {}


def _log_or_neg_inf(v: float) -> float:
    """math.log with JVM semantics at 0 (the reference's Math.log(0.0)
    returns -Infinity rather than raising; Likelihood.scala:181-188)."""
    return math.log(v) if v > 0.0 else float("-inf")


# exp() below this loses precision (results approach the f64 denormal
# range, ~1e-308); -700 keeps a ~3.5-decimal-digit safety margin.
_EXP_PRECISION_FLOOR = -700.0


def _normalization_log_total(log_likelihoods) -> float:
    """log(sum(exp(lls))) with the reference's exact sequential summation
    order — plus a logsumexp-shifted fallback for the deep-pileup regime.

    The reference normalizes with an UNSHIFTED log(sum(exp(...)))
    (Likelihood.scala:191-196). Past depth ~1300 at typical base quals
    that breaks in two stages: first every exp(logL) lands in the f64
    subnormal range, where the handful of remaining mantissa bits make
    the "normalized" likelihoods wrong by large factors (observed: a
    probability of 1.47); a little deeper every exp underflows to 0, the
    log-total is -Infinity, and every likelihood becomes +Infinity/NaN —
    which Java's non-throwing NaN arithmetic silently turns into dropped
    calls or GQ-0 records, and which crashes Python's throwing math
    functions. So: whenever the max log-likelihood is above
    _EXP_PRECISION_FLOOR the reference's exact sequential total is used
    (bit-parity for the entire fixture/chrM regime); below it we
    renormalize shifted by the max (standard logsumexp) — the same
    normalization computed stably, finite and accurate at any depth.
    (DEVIATIONS.md #11.)"""
    m = max((float(ll) for ll in log_likelihoods), default=float("-inf"))
    if m > _EXP_PRECISION_FLOOR:
        total = 0.0
        for ll in log_likelihoods:
            total += math.exp(ll)
        return _log_or_neg_inf(total)
    if not math.isfinite(m):
        return float("-inf")
    shifted = 0.0
    for ll in log_likelihoods:
        shifted += math.exp(ll - m)
    return m + math.log(shifted)


def _term_rows(successes: np.ndarray) -> np.ndarray:
    """[n, 3] log-term table: for each success probability s, the exact
    oracle term log(p1 + p2) for carry count 0/1/2 — p is s for a carried
    allele and 1.0 - s otherwise, composed with the oracle's operand
    order, so every float is bit-identical to the scalar path."""
    out = np.empty((len(successes), 3))
    for i, s in enumerate(successes):
        s = float(s)
        ns = 1.0 - s
        out[i, 0] = _log_or_neg_inf(ns + ns)
        out[i, 1] = _log_or_neg_inf(s + ns)
        out[i, 2] = _log_or_neg_inf(s + s)
    return out


def _term_lut_qual(max_q: int) -> np.ndarray:
    """[max_q + 2, 3] table; row 0 is the padded-slot row (exact 0.0
    terms), row q + 1 covers base quality q."""
    global _TERM_LUT_Q
    if _TERM_LUT_Q.shape[0] < max_q + 2:
        succ = success_probabilities_of_quals(np.arange(max_q + 1))
        _TERM_LUT_Q = np.vstack([np.zeros((1, 3)), _term_rows(succ)])
    return _TERM_LUT_Q


def _term_lut_qual_mapq(max_q: int, max_m: int) -> Tuple[np.ndarray, int]:
    """Like _term_lut_qual for the alignment-included model: success is
    s_qual * s_mapq (the oracle's multiply), addressed by
    1 + q * (max_m + 1) + m, row 0 padded. Returns (table, width)."""
    key = (max_q, max_m)
    cached = _TERM_LUT_QM.get(key)
    if cached is None:
        sq = success_probabilities_of_quals(np.arange(max_q + 1))
        sm = success_probabilities_of_quals(np.arange(max_m + 1))
        combined = (sq[:, None] * sm[None, :]).reshape(-1)
        cached = np.vstack([np.zeros((1, 3)), _term_rows(combined)])
        _TERM_LUT_QM.clear()  # keep only the widest-seen table
        _TERM_LUT_QM[key] = cached
    return cached, max_m + 1


def _pairs_of_id_mask(mask_code: int) -> Tuple[np.ndarray, np.ndarray]:
    """(a1s, a2s) dense-id arrays for all unordered pairs over the set ids
    encoded in mask_code (bit k set = dense id k present), in the oracle's
    enumeration order (ids ascending; (i, j) with i <= j)."""
    cached = _PAIR_PATTERNS.get(mask_code)
    if cached is None:
        ids = [k for k in range(mask_code.bit_length()) if mask_code >> k & 1]
        a1s = np.asarray(
            [ids[i] for i in range(len(ids)) for _ in range(i, len(ids))],
            dtype=np.int64,
        )
        a2s = np.asarray(
            [ids[j] for i in range(len(ids)) for j in range(i, len(ids))],
            dtype=np.int64,
        )
        cached = (a1s, a2s)
        _PAIR_PATTERNS[mask_code] = cached
    return cached


def genotype_probs_for_rows(
    allele_ids: np.ndarray,
    quals: np.ndarray,
    keeps: np.ndarray,
    std_alt_flags: np.ndarray,
    mapqs: Optional[np.ndarray] = None,
    log_space: bool = False,
    max_chunk_terms: int = 4_000_000,
) -> List[Tuple[List[Tuple[int, int]], List[float]]]:
    """Batched genotype_probs_for_row over R tile rows at once.

    allele_ids/quals/mapqs: [R, D] per-slot tensors (slot order = pileup
      element order); keeps: [R, D] bool element filter per row;
      std_alt_flags: [R, K] per-dense-id standard-alt flags per row.

    Returns a list of (pairs, lls) per row, bit-identical to calling
    genotype_probs_for_row(aid[keep], quals[keep], ...) row by row
    (pinned by tests/test_likelihood.py::test_genotype_probs_rows_bitwise):
    non-kept slots contribute an exact +0.0 term (LUT row 0), and IEEE-754
    addition of +0.0 is an exact identity (no partial sum here is -0.0:
    log never returns -0.0 and zero-valued partial sums of +0.0 terms are
    +0.0), so the sequential right-to-left per-genotype accumulation over
    kept elements is unchanged.
    """
    allele_ids = np.asarray(allele_ids)
    R, D = allele_ids.shape
    results: List[Tuple[List[Tuple[int, int]], List[float]]] = [
        ([], []) for _ in range(R)
    ]
    if R == 0:
        return results
    keeps = np.asarray(keeps, dtype=bool)
    std_alt_flags = np.asarray(std_alt_flags, dtype=bool)
    K = std_alt_flags.shape[1]
    aid = np.where(keeps, allele_ids, -1)

    # presence[r, k] = row r has a kept element carrying dense id k
    presence = np.zeros((R, K), dtype=bool)
    rr, cc = np.nonzero(aid >= 0)
    presence[rr, aid[rr, cc]] = True
    present_std = presence & std_alt_flags
    mask_codes = present_std @ (1 << np.arange(K, dtype=np.int64))

    # Flattened (row, a1, a2) pair lists in per-row enumeration order.
    row_patterns = [_pairs_of_id_mask(int(c)) for c in mask_codes]
    counts = np.asarray([len(p[0]) for p in row_patterns], dtype=np.int64)
    P = int(counts.sum())
    if P == 0:
        return results
    pair_row = np.repeat(np.arange(R, dtype=np.int64), counts)
    a1 = np.concatenate([p[0] for p in row_patterns])
    a2 = np.concatenate([p[1] for p in row_patterns])

    # Each log term depends only on (base quality[, MAPQ], carry count):
    # log(p1 + p2) with p = s for a carried allele, 1 - s otherwise. A
    # tiny LUT of exact scalar-path floats replaces per-element logs;
    # padded slots address row 0 (exact +0.0 terms — see docstring).
    q = np.where(keeps, quals, 0).astype(np.int64)
    if mapqs is None:
        lut = _term_lut_qual(int(q.max()))
        code = np.where(keeps, q + 1, 0)
    else:
        m = np.where(keeps, mapqs, 0).astype(np.int64)
        lut, width = _term_lut_qual_mapq(int(q.max()), int(m.max()))
        code = np.where(keeps, q * width + m + 1, 0)
    depths = keeps.sum(axis=1).astype(np.float64)
    log2 = math.log(2)

    acc = np.empty(P)
    chunk = max(1, max_chunk_terms // max(D, 1))
    for lo in range(0, P, chunk):
        hi = min(lo + chunk, P)
        pr = pair_row[lo:hi]
        ids = aid[pr]
        ncarry = (ids == a1[lo:hi, None]).astype(np.int8) + (
            ids == a2[lo:hi, None]
        )
        terms = lut[code[pr], ncarry]
        # cumsum is a strictly sequential accumulation; reversed it equals
        # the oracle's right-to-left Colt aggregate order.
        acc[lo:hi] = np.cumsum(terms[:, ::-1], axis=1)[:, -1]
    lls = (acc + math.log(1.0)) - log2 * depths[pair_row]

    # Sequential per-row normalization in enumeration order (oracle
    # parity). The native form runs the identical scalar math (same libm
    # exp/log Python's math module calls, same order) over all rows in
    # one pass; the Python loop is the fallback and the definition.
    from guacamole_tpu_torch.runtime.native import normalize_ll_rows_native

    row_off = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(counts, out=row_off[1:])
    lls = np.ascontiguousarray(lls, dtype=np.float64)
    normalized = normalize_ll_rows_native(lls, row_off)

    off = 0
    for r in range(R):
        n = int(counts[r])
        if not n:
            continue
        row_lls = lls[off : off + n]
        if not normalized:
            row_lls = row_lls - _normalization_log_total(row_lls)
        a1s, a2s = row_patterns[r]
        pairs = [(int(a1s[i]), int(a2s[i])) for i in range(n)]
        if log_space:
            # Already an f64 ndarray slice; consumers argmax/index it
            # (a per-row Python float list cost ~1 s of re-wrapping at
            # 137k candidate rows).
            results[r] = (pairs, row_lls)
        else:
            results[r] = (
                pairs,
                np.asarray([math.exp(float(ll)) for ll in row_lls]),
            )
        off += n
    return results


def genotype_probs_for_row(
    element_allele_ids: np.ndarray,
    quals: np.ndarray,
    std_alt_flags: np.ndarray,
    mapqs: Optional[np.ndarray] = None,
    log_space: bool = False,
) -> Tuple[List[Tuple[int, int]], List[float]]:
    """(dense-id genotype pairs, likelihoods) over the possible genotypes
    of one filtered tile row — the array form of
    likelihoods_of_all_possible_genotypes_from_pileup(normalize=True),
    shared by the germline and somatic vectorized confirms.

    element_allele_ids/quals: per kept element, in pileup element order.
    std_alt_flags: [K] per-dense-id standard-alt-bases flag (empty alts
      pass vacuously, matching possible_genotypes_of_pileup).
    mapqs: per kept element read MAPQ for the alignment-included model
      (probability_correct_including_alignment), or None to ignore
      alignment.
    """
    distinct = np.unique(element_allele_ids)
    std_ids = [int(k) for k in distinct if std_alt_flags[int(k)]]
    if not std_ids:
        return [], []
    pairs = [
        (std_ids[i], std_ids[j])
        for i in range(len(std_ids))
        for j in range(i, len(std_ids))
    ]
    success = success_probabilities_of_quals(quals)
    if mapqs is not None:
        success = success * success_probabilities_of_quals(mapqs)
    lls = log_likelihoods_of_genotype_pairs(
        element_allele_ids, success, pairs, normalize=True
    )
    if log_space:
        return pairs, [float(ll) for ll in lls]
    return pairs, [math.exp(float(ll)) for ll in lls]


def likelihood_of_genotype(
    elements: Sequence[PileupElement],
    genotype: Genotype,
    probability_correct=probability_correct_ignoring_alignment,
    prior=uniform_prior,
    log_space: bool = False,
) -> float:
    result = likelihoods_of_genotypes(
        elements, [genotype], probability_correct, prior, log_space, normalize=False
    )
    assert len(result) == 1
    return result[0]


def possible_genotypes_of_pileup(pileup: Pileup) -> List[Genotype]:
    """All unordered diploid genotypes over the pileup's distinct alleles
    whose alt bases are all standard (empty alts pass vacuously, matching
    Likelihood.scala:106)."""
    alleles = [
        a
        for a in pileup.distinct_alleles
        if all(Bases.is_standard_base(b) for b in a.alt_bases)
    ]
    return [
        Genotype.of(alleles[i], alleles[j])
        for i in range(len(alleles))
        for j in range(i, len(alleles))
    ]


def likelihoods_of_all_possible_genotypes_from_pileup(
    pileup: Pileup,
    probability_correct=probability_correct_ignoring_alignment,
    prior=uniform_prior,
    log_space: bool = False,
    normalize: bool = False,
) -> List[Tuple[Genotype, float]]:
    """(genotype, likelihood) for every genotype with any pileup evidence."""
    genotypes = possible_genotypes_of_pileup(pileup)
    if not genotypes:
        return []
    likelihoods = likelihoods_of_genotypes(
        pileup.elements, genotypes, probability_correct, prior, log_space, normalize
    )
    return list(zip(genotypes, likelihoods))
