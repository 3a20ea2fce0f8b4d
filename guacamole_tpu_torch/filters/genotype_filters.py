"""Germline genotype filters (post-calling record pruning).

(cf. reference .../filters/GenotypeFilter.scala:30-174)
"""

from __future__ import annotations

from typing import List, Sequence

from guacamole_tpu_torch.utils.progress import progress
from guacamole_tpu_torch.variants.called import CalledAllele
from guacamole_tpu_torch.variants.evidence import AlleleEvidence


def print_filter_progress(filtered: Sequence) -> None:
    """(cf. GenotypeFilter.scala:116-119, behind --debug-genotype-filters)"""
    progress("Filtered genotypes down to %d genotypes" % len(filtered))


def within_read_depth_range(
    evidence: AlleleEvidence, min_read_depth: int, max_read_depth: int
) -> bool:
    return min_read_depth <= evidence.read_depth < max_read_depth


def has_minimum_alternate_read_depth(
    evidence: AlleleEvidence, min_alternate_read_depth: int
) -> bool:
    return evidence.allele_read_depth >= min_alternate_read_depth


def has_minimum_likelihood(evidence: AlleleEvidence, min_likelihood: int) -> bool:
    return evidence.phred_scaled_likelihood >= min_likelihood


def apply_genotype_filters(
    genotypes: Sequence[CalledAllele],
    min_read_depth: int = 0,
    max_read_depth: int = 2**31 - 1,
    min_alternate_read_depth: int = 0,
    min_likelihood: int = 0,
    debug: bool = False,
) -> List[CalledAllele]:
    """The full germline filter chain in the reference's order
    (GenotypeFilter.scala:140-154); `debug` prints the genotype count after
    each step (--debug-genotype-filters)."""
    out = [
        g
        for g in genotypes
        if within_read_depth_range(g.evidence, min_read_depth, max_read_depth)
    ]
    if debug:
        print_filter_progress(out)
    if min_alternate_read_depth > 0:
        out = [
            g
            for g in out
            if has_minimum_alternate_read_depth(g.evidence, min_alternate_read_depth)
        ]
        if debug:
            print_filter_progress(out)
    if min_likelihood > 0:
        out = [g for g in out if has_minimum_likelihood(g.evidence, min_likelihood)]
        if debug:
            print_filter_progress(out)
    return out
