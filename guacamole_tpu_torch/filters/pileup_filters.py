"""Pileup-level filters (element pruning before likelihood computation).

(cf. reference .../filters/PileupFilter.scala:29-90 and
PileupElementsFilter.scala:25-51)
"""

from __future__ import annotations

from typing import List, Sequence

from guacamole_tpu_torch.pileup.element import PileupElement
from guacamole_tpu_torch.pileup.pileup import Pileup


def quality_aligned_reads_filter(
    elements: Sequence[PileupElement], min_alignment_quality: int
) -> List[PileupElement]:
    """Keep elements whose read MAPQ >= min."""
    return [e for e in elements if e.read.alignment_quality >= min_alignment_quality]


def edge_base_filter(
    elements: Sequence[PileupElement], min_distance: int
) -> List[PileupElement]:
    """Keep elements at least min_distance from the sequencing end."""
    return [e for e in elements if e.distance_from_sequencing_end >= min_distance]


def multi_allelic_filter(
    elements: Sequence[PileupElement], max_ploidy: int = 2
) -> List[PileupElement]:
    """Drop ALL elements at loci with more than max_ploidy distinct alleles."""
    if len({e.allele for e in elements}) > max_ploidy:
        return []
    return list(elements)


def filter_pileup(
    pileup: Pileup,
    filter_multi_allelic: bool,
    min_alignment_quality: int,
    min_edge_distance: int,
) -> Pileup:
    """Composite pileup filter, applied in the reference's order."""
    elements = pileup.elements
    if filter_multi_allelic:
        elements = multi_allelic_filter(elements)
    if min_alignment_quality > 0:
        elements = quality_aligned_reads_filter(elements, min_alignment_quality)
    if min_edge_distance > 0:
        elements = edge_base_filter(elements, min_edge_distance)
    return Pileup(pileup.reference_name, pileup.locus, pileup.reference_base, elements)
