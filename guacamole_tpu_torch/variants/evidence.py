"""AlleleEvidence: per-sample read statistics supporting a called allele.

(cf. reference .../variants/AlleleEvidence.scala:41-102)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

from guacamole_tpu_torch.utils.phred import success_probability_to_phred


def _median(values: List[float]) -> float:
    n = len(values)
    if n == 0:
        return float("nan")
    s = sorted(values)
    if n % 2 == 1:
        return float(s[n // 2])
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def _mean(values: List[float]) -> float:
    if not values:
        return float("nan")
    return sum(values) / len(values)


@dataclass(frozen=True)
class AlleleEvidence:
    """Pileup/read statistics in support of a given allele.

    likelihood: probability of the genotype
    read_depth / allele_read_depth: total reads / reads carrying the allele
    forward_depth / allele_forward_depth: same restricted to forward strand
    mean/median MAPQ & base quality over allele-supporting elements,
    median mismatch count of allele-supporting reads.
    """

    likelihood: float
    read_depth: int
    allele_read_depth: int
    forward_depth: int
    allele_forward_depth: int
    mean_mapping_quality: float
    median_mapping_quality: float
    mean_base_quality: float
    median_base_quality: float
    median_mismatches_per_read: float

    @property
    def phred_scaled_likelihood(self) -> int:
        # subtract a small delta to prevent p = 1 (AlleleEvidence.scala:52)
        return success_probability_to_phred(self.likelihood - 1e-10)

    @property
    def variant_allele_frequency(self) -> float:
        return self.allele_read_depth / self.read_depth

    @staticmethod
    def from_arrays(
        likelihood: float,
        read_depth: int,
        allele_read_depth: int,
        forward_depth: int,
        allele_forward_depth: int,
        mapqs,
        quals,
        mismatches,
    ) -> "AlleleEvidence":
        """Array form of from_pileup over packed tile rows (allele-element
        stats passed as numpy slices in pileup element order). Bit-identical:
        the sequential cumsum reproduces Python sum()'s left-to-right float64
        accumulation and the median expression is repeated verbatim."""
        import numpy as np

        def mean(a):
            a = np.asarray(a, dtype=np.float64)
            if a.size == 0:
                return float("nan")
            return float(np.cumsum(a)[-1]) / len(a)

        def median(a):
            a = np.asarray(a, dtype=np.float64)
            n = a.size
            if n == 0:
                return float("nan")
            s = np.sort(a)
            if n % 2 == 1:
                return float(s[n // 2])
            return 0.5 * (float(s[n // 2 - 1]) + float(s[n // 2]))

        return AlleleEvidence(
            likelihood=likelihood,
            read_depth=read_depth,
            allele_read_depth=allele_read_depth,
            forward_depth=forward_depth,
            allele_forward_depth=allele_forward_depth,
            mean_mapping_quality=mean(mapqs),
            median_mapping_quality=median(mapqs),
            mean_base_quality=mean(quals),
            median_base_quality=median(quals),
            median_mismatches_per_read=median(mismatches),
        )

    @staticmethod
    def stats_batch(mask, mapqs, quals, mismatches):
        """Masked row-wise evidence statistics for R rows at once:
        (mean_mapq, median_mapq, mean_qual, median_qual, median_mismatch),
        each a float64 [R] array (nan where a row's mask is empty).

        Bit-identical to from_arrays per row: masked-out slots contribute
        exact +0.0 terms to the left-to-right cumsum (x + 0.0 == x for the
        non-negative quality values), and medians index the row sort with
        +inf padding, selecting the same order statistics."""
        import numpy as np

        mask = np.asarray(mask, dtype=bool)
        R, D = mask.shape
        cnt = mask.sum(axis=1)
        has = cnt > 0
        safe_cnt = np.maximum(cnt, 1)

        def mean_of(field):
            vals = np.where(mask, np.asarray(field, dtype=np.float64), 0.0)
            if D == 0:
                return np.full(R, np.nan)
            sums = np.cumsum(vals, axis=1)[:, -1]
            return np.where(has, sums / safe_cnt, np.nan)

        def median_of(field):
            if D == 0:
                return np.full(R, np.nan)
            vals = np.where(mask, np.asarray(field, dtype=np.float64), np.inf)
            s = np.sort(vals, axis=1)
            rows = np.arange(R)
            hi = s[rows, np.minimum(cnt // 2, D - 1)]
            lo = s[rows, np.maximum(safe_cnt - 1, 0) // 2]
            med = np.where(cnt % 2 == 1, hi, 0.5 * (lo + hi))
            return np.where(has, med, np.nan)

        return (
            mean_of(mapqs),
            median_of(mapqs),
            mean_of(quals),
            median_of(quals),
            median_of(mismatches),
        )

    @staticmethod
    def from_pileup(likelihood: float, allele, pileup) -> "AlleleEvidence":
        allele_read_depth, allele_forward_depth = (
            pileup.allele_read_depth_and_positive_depth(allele)
        )
        allele_elements = [e for e in pileup.elements if e.allele == allele]
        mapqs = [float(e.read.alignment_quality) for e in allele_elements]
        quals = [float(e.quality_score) for e in allele_elements]
        mismatches = [
            # Reads without an MD tag count as 0 mismatches (the packers'
            # convention; cf. DEVIATIONS.md #3 — the reference throws).
            float(e.read.mdtag.count_of_mismatches) if e.read.mdtag else 0.0
            for e in allele_elements
        ]
        return AlleleEvidence(
            likelihood=likelihood,
            read_depth=pileup.depth,
            allele_read_depth=allele_read_depth,
            forward_depth=pileup.positive_depth,
            allele_forward_depth=allele_forward_depth,
            mean_mapping_quality=_mean(mapqs),
            median_mapping_quality=_median(mapqs),
            mean_base_quality=_mean(quals),
            median_base_quality=_median(quals),
            median_mismatches_per_read=_median(mismatches),
        )
