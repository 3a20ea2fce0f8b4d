"""Somatic genotype filters.

(cf. reference .../filters/SomaticGenotypeFilter.scala:30-337)
"""

from __future__ import annotations

import math
from typing import List, Sequence

from guacamole_tpu_torch.filters.genotype_filters import print_filter_progress
from guacamole_tpu_torch.variants.called import CalledSomaticAllele


def somatic_within_read_depth_range(
    g: CalledSomaticAllele,
    min_tumor_read_depth: int,
    max_tumor_read_depth: int,
    min_normal_read_depth: int,
) -> bool:
    return (
        min_tumor_read_depth
        <= g.tumor_variant_evidence.read_depth
        < max_tumor_read_depth
    ) and g.normal_reference_evidence.read_depth >= min_normal_read_depth


def somatic_minimum_alternate_read_depth(
    g: CalledSomaticAllele, min_alternate_read_depth: int
) -> bool:
    return g.tumor_variant_evidence.allele_read_depth >= min_alternate_read_depth


def somatic_minimum_likelihood(g: CalledSomaticAllele, min_likelihood: int) -> bool:
    return g.phred_scaled_somatic_likelihood >= min_likelihood


def somatic_minimum_vaf(g: CalledSomaticAllele, min_vaf: int) -> bool:
    return g.tumor_variant_evidence.variant_allele_frequency * 100.0 > min_vaf


def somatic_minimum_log_odds(g: CalledSomaticAllele, min_log_odds: int) -> bool:
    return g.somatic_log_odds > min_log_odds


def somatic_minimum_average_mapping_quality(
    g: CalledSomaticAllele, min_average_mapping_quality: int
) -> bool:
    return (
        g.tumor_variant_evidence.mean_mapping_quality >= min_average_mapping_quality
        and g.normal_reference_evidence.mean_mapping_quality
        >= min_average_mapping_quality
    )


def somatic_minimum_average_base_quality(
    g: CalledSomaticAllele, min_average_base_quality: int
) -> bool:
    # NOTE: parity with the reference, which (apparently unintentionally)
    # tests meanMappingQuality here too (SomaticGenotypeFilter.scala:191-196).
    return (
        g.tumor_variant_evidence.mean_mapping_quality >= min_average_base_quality
        and g.normal_reference_evidence.mean_mapping_quality
        >= min_average_base_quality
    )


def somatic_maximum_median_mismatch(
    g: CalledSomaticAllele, maximum_median_mismatches: int
) -> bool:
    return (
        g.tumor_variant_evidence.median_mismatches_per_read
        <= maximum_median_mismatches
    )


def apply_somatic_filters(
    genotypes: Sequence[CalledSomaticAllele],
    min_tumor_read_depth: int = 0,
    max_tumor_read_depth: int = 2**31 - 1,
    min_normal_read_depth: int = 0,
    min_tumor_alternate_read_depth: int = 0,
    min_log_odds: int = 0,
    min_likelihood: int = 0,
    min_vaf: int = 0,
    min_average_mapping_quality: int = 0,
    min_average_base_quality: int = 0,
    maximum_median_mismatches: int = 2**31 - 1,
    debug: bool = False,
) -> List[CalledSomaticAllele]:
    """The full somatic filter chain in the reference's fixed order
    (SomaticGenotypeFilter.scala:285-307); `debug` prints the genotype
    count after each step (--debug-genotype-filters)."""

    def step(filtered: List[CalledSomaticAllele]) -> List[CalledSomaticAllele]:
        if debug:
            print_filter_progress(filtered)
        return filtered

    out = step([
        g
        for g in genotypes
        if somatic_within_read_depth_range(
            g, min_tumor_read_depth, max_tumor_read_depth, min_normal_read_depth
        )
    ])
    if min_tumor_alternate_read_depth > 0:
        out = step([
            g
            for g in out
            if somatic_minimum_alternate_read_depth(
                g, min_tumor_alternate_read_depth
            )
        ])
    out = step([g for g in out if somatic_minimum_log_odds(g, min_log_odds)])
    out = step([g for g in out if somatic_minimum_likelihood(g, min_likelihood)])
    out = step([g for g in out if somatic_minimum_vaf(g, min_vaf)])
    out = step([
        g
        for g in out
        if somatic_minimum_average_mapping_quality(g, min_average_mapping_quality)
    ])
    out = step([
        g
        for g in out
        if somatic_minimum_average_base_quality(g, min_average_base_quality)
    ])
    out = step([
        g
        for g in out
        if somatic_maximum_median_mismatch(g, maximum_median_mismatches)
    ])
    return out
