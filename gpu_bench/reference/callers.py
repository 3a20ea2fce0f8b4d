"""The three callers, plain, from the generated reads: germline-threshold,
germline-standard and somatic-standard as Guacamole defines them, each
returning the data lines of the VCF it would write.

Every locus is screened with arrays first, and only loci that could give a
call are worked out element by element:

- germline-threshold: per-locus allele counts (all elements); a locus is
  looked at when some allele other than the reference passes the rule, or
  an indel allele is there.
- germline-standard and somatic-standard: per-locus sums of each allele's
  likelihood terms give every genotype's log likelihood in a few array
  operations (in another order of addition than the exact one); a locus is
  looked at when a genotype with a variant allele comes within SCREEN_MARGIN
  of the best, or an indel allele is there. The exact pass then adds the
  terms one by one in file order (reference/likelihood.py).
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from reference.likelihood import (
    Arith,
    TermTable,
    genotype_log_likelihoods,
    success_probability_to_phred,
)
from reference.pileup import (
    BASES,
    base_code,
    columns_at,
    indel_elements,
    plain_block,
)

# Natural-log distance within which a variant genotype sends its locus to
# the exact pass. The screen's own rounding is some 1e-10 at 1000x; float32
# control runs stray by 1e-4 at most.
SCREEN_MARGIN = 0.05
STANDARD = frozenset(BASES)


def _is_standard(alt: bytes) -> bool:
    return all(b in STANDARD for b in alt)


# --- germline-threshold ---------------------------------------------------


class LocusSums:
    """Per-locus sums over the base elements (plain reads, and the aligned
    bases of indel reads) with MAPQ >= keep_mapq: `depth` [C] counts them,
    `w` [m, C] sums their weights (lut: m tables by quality * 64 + MAPQ);
    `nonref_*` hold the elements whose base is not the reference's, one
    by one (locus, base code, weights). Chunks of reads are summed on
    THREADS threads (numpy lets go of the interpreter lock inside)."""

    THREADS = 8

    def __init__(self, rs, ref, indels, keep_mapq: int = 0, lut=None):
        c = len(ref)
        luts = [] if lut is None else [np.ascontiguousarray(t) for t in lut]
        ref_code = base_code(ref)

        def part(loci, codes, quals, mapqs):
            lo = int(loci.min()) if len(loci) else 0
            hi = int(loci.max()) + 1 if len(loci) else 0
            rel = loci - lo
            depth = np.bincount(rel, minlength=hi - lo)
            ws, sums = [], []
            if luts:
                idx = quals * 64 + np.minimum(mapqs, 63)
                for t in luts:
                    ws.append(np.take(t, idx))
                    sums.append(np.bincount(rel, weights=ws[-1],
                                            minlength=hi - lo))
            nr = np.flatnonzero(codes != np.take(ref_code, loci))
            return (lo, depth, sums, loci[nr], codes[nr],
                    np.stack([x[nr] for x in ws], axis=1) if ws
                    else np.zeros((len(nr), 0)))

        def plain_part(rows):
            rows, loci, codes, quals = plain_block(rs, rows)
            mq = np.repeat(rs.mapq[rows].astype(np.int64), loci.shape[1])
            return part(loci.reshape(-1), codes.reshape(-1),
                        quals.reshape(-1), mq)

        self.depth = np.zeros(c, dtype=np.int64)
        self.w = np.zeros((len(luts), c))
        nr_loc, nr_code, nr_w = [], [], []

        def gather(res):
            lo, depth, sums, loc, code, w = res
            self.depth[lo: lo + len(depth)] += depth
            for i, x in enumerate(sums):
                self.w[i, lo: lo + len(x)] += x
            nr_loc.append(loc)
            nr_code.append(code)
            nr_w.append(w)

        plain = (rs.kind == 0) & (rs.mapq >= keep_mapq)
        with ThreadPoolExecutor(self.THREADS) as pool:
            sel = np.flatnonzero(plain)
            blocks = [sel[i: i + 20_000] for i in range(0, len(sel), 20_000)]
            for res in pool.map(plain_part, blocks):
                gather(res)
        i_loc, _, i_code, _, i_qual, i_mapq = indels
        ok = (i_code >= 0) & (i_mapq >= keep_mapq)
        gather(part(i_loc[ok], i_code[ok], i_qual[ok], i_mapq[ok]))
        self.nonref_locus = np.concatenate(nr_loc)
        self.nonref_code = np.concatenate(nr_code)
        self.nonref_w = np.concatenate(nr_w)


def _special_loci(indels) -> np.ndarray:
    i_loc, _, _, i_special, *_ = indels
    mask = np.asarray([sp is not None for sp in i_special], dtype=bool)
    return np.unique(i_loc[mask]) if mask.any() else np.empty(0, np.int64)


def germline_threshold(sample, reads: str, threshold: int,
                       floor_percent: bool = True) -> List[str]:
    """VCF lines of germline-threshold --threshold T (no --emit-ref, no
    --emit-no-call). floor_percent=False is the control: the share
    compared as a real number, not as the integer percent."""
    rs = sample.reads[reads]
    ref = sample.reference
    indels = indel_elements(rs, ref)
    sums = LocusSums(rs, ref, indels)
    # Non-reference base counts, at the loci that have any.
    loci, inv = np.unique(sums.nonref_locus, return_inverse=True)
    counts = np.zeros((len(loci), 4), dtype=np.int64)
    np.add.at(counts, (inv, sums.nonref_code), 1)
    depth = sums.depth[loci][:, None]
    if floor_percent:
        passing = counts * 100 // depth > threshold
    else:
        passing = counts * 100 / depth > threshold
    look = loci[(passing & (counts > 0)).any(axis=1)]
    look = np.union1d(look, _special_loci(indels)).astype(np.int64)
    columns = columns_at(rs, ref, look, indels)
    lines = []
    for locus in look.tolist():
        col = columns[locus]
        if not col.alleles:
            continue
        tally: Dict[tuple, int] = {}
        for a in col.alleles:
            tally[a] = tally.get(a, 0) + 1
        lines.extend(_classify(sorted(tally.items()), len(col.alleles),
                               sample.contig, locus, threshold,
                               floor_percent))
    return lines


def _classify(alleles_and_counts, total, contig, locus, threshold,
              floor_percent) -> List[str]:
    """classify_locus of germline_threshold.py without --emit-ref and
    --emit-no-call: the VCF lines of one locus."""
    if floor_percent:
        passing = [(a, c) for a, c in alleles_and_counts
                   if c * 100 // total > threshold]
    else:
        passing = [(a, c) for a, c in alleles_and_counts
                   if c * 100 / total > threshold]
    passing.sort(key=lambda pair: (-pair[1], pair[0]))

    def line(allele, gt):
        return _vcf_line(contig, locus, allele, "GT", gt)

    def variant(a):
        return a[0] != a[1]

    if not passing:
        return []
    if len(passing) == 1:
        a = passing[0][0]
        return [line(a, "1/1")] if variant(a) else []
    (a1, _), (a2, _) = passing[0], passing[1]
    if (not variant(a1) or not variant(a2)) and (
            (a1[1] == b"") != (a2[1] == b"")):
        return []  # a heterozygous deletion is not called
    if variant(a1) != variant(a2):
        return [line(a1 if variant(a1) else a2, "0/1")]
    if variant(a1) and variant(a2):
        return [line(a1, "1/2"), line(a2, "1/2")]
    if a1[0] == b"N" or a2[0] == b"N":
        return []
    raise ValueError(f"two reference alleles at {contig}:{locus}")


def _vcf_line(contig, locus, allele, fmt, value) -> str:
    return "\t".join([contig, str(locus + 1), ".", allele[0].decode(),
                      allele[1].decode(), ".", ".", ".", fmt, value])


# --- the likelihood screen --------------------------------------------------


def _screen(rs, ref, min_mapq: int, table: TermTable, indels) -> np.ndarray:
    """Loci where a variant genotype comes within SCREEN_MARGIN of the best
    genotype, over elements with MAPQ >= min_mapq, or an indel allele is."""
    f64 = TermTable(Arith("f64"), table.with_mapq)
    # Per (quality, MAPQ): T1 - T0 and T2 - T0, the terms a genotype's
    # allele adds over an element that carries neither allele.
    lut = np.zeros((2, 64 * 64))
    for q in range(64):
        for m in range(64):
            t0, t1, t2 = f64.row(q, m if table.with_mapq else 0)
            lut[:, q * 64 + m] = (t1 - t0, t2 - t0)
    sums = LocusSums(rs, ref, indels, min_mapq, lut)
    loci, inv = np.unique(sums.nonref_locus, return_inverse=True)
    # Per allele at those loci: presence, A1 = sum(T1 - T0), A2 = sum(T2 -
    # T0); the reference allele's from the locus totals less the others.
    n = np.zeros((len(loci), 4))
    a1 = np.zeros((len(loci), 4))
    a2 = np.zeros((len(loci), 4))
    np.add.at(n, (inv, sums.nonref_code), 1)
    np.add.at(a1, (inv, sums.nonref_code), sums.nonref_w[:, 0])
    np.add.at(a2, (inv, sums.nonref_code), sums.nonref_w[:, 1])
    rc = base_code(ref[loci])
    rows = np.arange(len(loci))
    n[rows, rc] = sums.depth[loci] - n.sum(axis=1)
    a1[rows, rc] = sums.w[0, loci] - a1.sum(axis=1)
    a2[rows, rc] = sums.w[1, loci] - a2.sum(axis=1)
    present = n > 0.5
    neg = -np.inf
    is_ref = np.arange(4)[None, :] == rc[:, None]
    best_var = np.where(present & ~is_ref, a2, neg).max(axis=1)
    for x in range(4):
        for y in range(x + 1, 4):
            both = present[:, x] & present[:, y]
            best_var = np.maximum(best_var,
                                  np.where(both, a1[:, x] + a1[:, y], neg))
    ref_present = present[rows, rc]
    ref_val = np.where(ref_present, a2[rows, rc], neg)
    look = (~ref_present) | (best_var >= ref_val - SCREEN_MARGIN)
    return np.union1d(loci[look], _special_loci(indels)).astype(np.int64)


def _genotypes(arith, table, column, keep, with_mapq):
    """(sorted alleles of the kept elements, genotypes, their normalised
    log likelihoods) at one column."""
    kept = [a for a, k in zip(column.alleles, keep) if k]
    alleles = sorted(set(kept))
    index = {a: i for i, a in enumerate(alleles)}
    std = [_is_standard(a[1]) for a in alleles]
    # Genotypes are over standard alleles; an element of another allele
    # still adds its term (carried by neither allele).
    ids = np.asarray([index[a] if std[index[a]] else -1 for a in kept],
                     dtype=np.int64)
    terms = table.matrix(column.quals[keep],
                         column.mapqs[keep] if with_mapq else
                         np.zeros(len(kept), np.int64))
    pairs, lls = genotype_log_likelihoods(arith, ids, terms)
    return alleles, pairs, lls


# --- germline-standard -------------------------------------------------------


def germline_standard(sample, reads: str, min_mapq: int = 1,
                      dtype: str = "f64") -> List[str]:
    """VCF lines of germline-standard with its default filters."""
    rs = sample.reads[reads]
    ref = sample.reference
    arith = Arith(dtype)
    table = TermTable(arith, with_mapq=False)
    indels = indel_elements(rs, ref)
    look = _screen(rs, ref, min_mapq, table, indels)
    columns = columns_at(rs, ref, look, indels)
    lines = []
    for locus in look.tolist():
        col = columns[locus]
        if not col.alleles:
            continue
        keep = col.mapqs >= min_mapq
        if not keep.any():
            continue
        alleles, pairs, lls = _genotypes(arith, table, col, keep, False)
        if not pairs:
            continue
        best = int(np.argmax(lls))
        g = [alleles[pairs[best][0]], alleles[pairs[best][1]]]
        emit = [a for a in g if a[0] != a[1]]
        if not emit:
            continue
        probability = float(arith.exp(lls[best]))
        gq = success_probability_to_phred(probability - 1e-10)
        for a in emit:
            dp = len(col.alleles)
            ad = sum(1 for x in col.alleles if x == a)
            lines.append(_vcf_line(sample.contig, locus, a, "GT:AD:DP:GQ",
                                   f"0/1:{dp - ad},{ad}:{dp}:{gq}"))
    return lines


# --- somatic-standard --------------------------------------------------------


def somatic_standard(sample, tumor: str, normal: str, odds: int = 20,
                     min_mapq: int = 1, dtype: str = "f64") -> List[str]:
    """VCF lines of somatic-standard --odds N with its default filters."""
    tumor, normal = sample.reads[tumor], sample.reads[normal]
    ref = sample.reference
    arith = Arith(dtype)
    t_table = TermTable(arith, with_mapq=True)
    n_table = TermTable(arith, with_mapq=False)
    t_indels = indel_elements(tumor, ref)
    look = _screen(tumor, ref, min_mapq, t_table, t_indels)
    t_cols = columns_at(tumor, ref, look, t_indels)
    n_cols = columns_at(normal, ref, look)
    lines = []
    for locus in look.tolist():
        line = _somatic_locus(arith, t_table, n_table, t_cols[locus],
                              n_cols[locus], odds, min_mapq, sample.contig)
        if line is not None:
            lines.append(line)
    return lines


def _somatic_locus(arith, t_table, n_table, tc, nc, odds, min_mapq,
                   contig) -> Optional[str]:
    t_keep = tc.mapqs >= min_mapq
    n_keep = nc.mapqs >= min_mapq
    if not t_keep.any() or not n_keep.any():
        return None
    kept_t = [a for a, k in zip(tc.alleles, t_keep) if k]
    if all(a[0] == a[1] and a[0] for a in kept_t):
        return None  # only reference support in the tumor
    t_alleles, t_pairs, t_lls = _genotypes(arith, t_table, tc, t_keep, True)
    if not t_pairs:
        return None
    t_probs = np.asarray([arith.exp(x) for x in t_lls], dtype=arith.np)
    best = int(np.argmax(t_probs))
    best_pair = t_pairs[best]
    best_likelihood = t_probs[best]
    if not any(t_alleles[i][0] != t_alleles[i][1] for i in best_pair):
        return None
    n_alleles, n_pairs, n_lls = _genotypes(arith, n_table, nc, n_keep, False)
    total = arith.np(0.0)
    for (x, y), ll in zip(n_pairs, n_lls):
        if n_alleles[x][0] != n_alleles[x][1] or (
                n_alleles[y][0] != n_alleles[y][1]):
            total = total + arith.exp(ll)
    with np.errstate(all="ignore"):  # float32 controls reach inf and nan
        somatic_odds = (best_likelihood / total if total != 0
                        else float("inf"))
    if somatic_odds * 100 < odds:
        return None
    allele = next((t_alleles[i] for i in best_pair
                   if t_alleles[i][0] != t_alleles[i][1] and t_alleles[i][1]),
                  None)
    if allele is None:
        return None
    # The filters that apply at their defaults: log odds > 0, VAF > 0, and
    # a mean MAPQ on both sides (none where the normal has no reads of the
    # reference allele).
    if not math.log(somatic_odds) > 0:
        return None
    normal_ref = (allele[0], allele[0])
    if not any(a == normal_ref for a, k in zip(nc.alleles, n_keep) if k):
        return None
    dp = len(kept_t)
    ad = sum(1 for a in kept_t if a == allele)
    normal_likelihood = 1 - float(total)
    gq = success_probability_to_phred(
        float(best_likelihood) * normal_likelihood - 1e-10)
    if gq < 0:
        return None
    return _vcf_line(contig, tc.locus, allele, "GT:AD:DP:GQ",
                     f"0/1:{dp - ad},{ad}:{dp}:{gq}")
