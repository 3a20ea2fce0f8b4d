"""Pileup: the column of reads overlapping one reference locus.

Host oracle implementation (cf. reference .../pileup/Pileup.scala:37-187).
On the device path, pileups never exist as objects — reads are scattered
directly into dense per-locus-tile tensors (see guacamole_tpu_torch.pack) — but
this class defines the exact semantics those tensors must reproduce.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from guacamole_tpu_torch.pileup.element import PileupElement
from guacamole_tpu_torch.reads.read import MappedRead
from guacamole_tpu_torch.utils import bases as Bases
from guacamole_tpu_torch.variants.allele import Allele


class Pileup:
    __slots__ = ("reference_name", "locus", "reference_base", "elements")

    def __init__(
        self,
        reference_name: str,
        locus: int,
        reference_base: int,
        elements: Sequence[PileupElement],
    ):
        self.reference_name = reference_name
        self.locus = locus
        self.reference_base = reference_base
        self.elements = list(elements)
        for e in self.elements:
            assert e.read.reference_contig == reference_name, (
                f"Pileup reference name '{reference_name}' does not match "
                f"read reference name {e.read.reference_contig}"
            )
            assert e.locus == locus, "Reads in pileup have mismatching loci"

    # --- construction ---

    @staticmethod
    def reference_base_at_locus(reads: Sequence[MappedRead], locus: int) -> int:
        """Reference base from the first read with a standard base at locus
        (cf. Pileup.scala:157-165)."""
        for read in reads:
            base = read.get_reference_base_at_locus(locus)
            if Bases.is_standard_base(base):
                return base
        return Bases.N

    @staticmethod
    def from_reads(
        reads: Sequence[MappedRead],
        reference_name: str,
        locus: int,
        reference_base: Optional[int] = None,
    ) -> "Pileup":
        overlapping = [r for r in reads if r.overlaps_locus(locus)]
        if reference_base is None:
            reference_base = Pileup.reference_base_at_locus(overlapping, locus)
        elements = [
            PileupElement.at_locus(r, locus, reference_base) for r in overlapping
        ]
        return Pileup(reference_name, locus, reference_base, elements)

    # --- stats ---

    @property
    def depth(self) -> int:
        return len(self.elements)

    @property
    def positive_depth(self) -> int:
        return sum(1 for e in self.elements if e.read.is_positive_strand)

    @property
    def reference_elements(self) -> List[PileupElement]:
        return [e for e in self.elements if e.is_match]

    @property
    def reference_depth(self) -> int:
        return len(self.reference_elements)

    @property
    def distinct_alleles(self) -> List[Allele]:
        seen = dict.fromkeys(e.allele for e in self.elements)
        return sorted(seen)

    @property
    def sample_name(self) -> str:
        return self.elements[0].read.sample_name

    def by_sample(self) -> Dict[str, "Pileup"]:
        groups: Dict[str, List[PileupElement]] = {}
        for e in self.elements:
            groups.setdefault(e.read.sample_name or "default", []).append(e)
        return {
            sample: Pileup(self.reference_name, self.locus, self.reference_base, elems)
            for sample, elems in groups.items()
        }

    def by_token(self) -> Dict[int, "Pileup"]:
        groups: Dict[int, List[PileupElement]] = {}
        for e in self.elements:
            groups.setdefault(e.read.token, []).append(e)
        return {
            token: Pileup(self.reference_name, self.locus, self.reference_base, elems)
            for token, elems in groups.items()
        }

    def allele_read_depth_and_positive_depth(self, allele: Allele) -> Tuple[int, int]:
        allele_elements = [e for e in self.elements if e.allele == allele]
        positive = sum(1 for e in allele_elements if e.read.is_positive_strand)
        return len(allele_elements), positive

    # --- advancing ---

    def at_greater_locus(
        self,
        new_locus: int,
        new_reference_base: int,
        new_reads: Iterable[MappedRead],
    ) -> "Pileup":
        """Move the pileup forward, reusing elements of surviving reads
        (cf. Pileup.scala:103-132)."""
        assert not self.elements or new_locus > self.locus, (
            f"New locus ({new_locus}) not greater than current ({self.locus})"
        )
        new_reads = list(new_reads)
        if not self.elements and not new_reads:
            return Pileup(self.reference_name, new_locus, new_reference_base, [])
        elements = [
            e.advance_to_locus(new_locus, new_reference_base)
            for e in self.elements
            if e.read.overlaps_locus(new_locus)
        ]
        elements.extend(
            PileupElement.at_locus(read, new_locus, new_reference_base)
            for read in new_reads
        )
        return Pileup(self.reference_name, new_locus, new_reference_base, elements)

    def __repr__(self) -> str:
        return (
            f"Pileup({self.reference_name}:{self.locus}, depth={self.depth})"
        )
