"""Allele and Genotype models.

(cf. reference .../variants/Allele.scala:26-43, Genotype.scala:38-85)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering
from typing import List, Sequence, Tuple

from guacamole_tpu_torch.utils import bases as Bases


@total_ordering
@dataclass(frozen=True)
class Allele:
    """A (reference bases, sequenced/alt bases) pair at a locus.

    Ordered lexicographically by (ref string, alt string), matching the
    reference's BasesOrdering so distinct-allele enumeration (and therefore
    genotype order, argmax tie-breaks and output order) is identical.
    """

    ref_bases: bytes
    alt_bases: bytes

    @staticmethod
    def from_strings(ref: str, alt: str) -> "Allele":
        return Allele(Bases.string_to_bases(ref), Bases.string_to_bases(alt))

    @property
    def is_variant(self) -> bool:
        return self.ref_bases != self.alt_bases

    def __lt__(self, other: "Allele") -> bool:
        return (self.ref_bases, self.alt_bases) < (other.ref_bases, other.alt_bases)

    def __str__(self) -> str:
        return "Allele(%s,%s)" % (
            Bases.bases_to_string(self.ref_bases),
            Bases.bases_to_string(self.alt_bases),
        )


@dataclass(frozen=True)
class Genotype:
    """A sequence of alleles of length equal to the organism's ploidy
    (diploid throughout, as in the reference)."""

    alleles: Tuple[Allele, ...]

    @staticmethod
    def of(*alleles: Allele) -> "Genotype":
        return Genotype(tuple(alleles))

    @property
    def ploidy(self) -> int:
        return len(self.alleles)

    @property
    def unique_alleles_count(self) -> int:
        return len(set(self.alleles))

    @property
    def non_reference_alleles(self) -> List[Allele]:
        return [a for a in self.alleles if a.is_variant]

    @property
    def number_of_variant_alleles(self) -> int:
        return len(self.non_reference_alleles)

    @property
    def has_variant_allele(self) -> bool:
        return self.number_of_variant_alleles > 0

    @property
    def genotype_allele_labels(self) -> Tuple[str, str]:
        """ADAM-style allele classification: Ref/Alt/OtherAlt
        (cf. Genotype.scala:70-82)."""
        assert self.ploidy == 2
        num_variants = self.number_of_variant_alleles
        if num_variants == 0:
            return ("Ref", "Ref")
        if num_variants > 0 and self.unique_alleles_count == 1:
            return ("Alt", "Alt")
        if num_variants >= 2 and self.unique_alleles_count > 1:
            return ("Alt", "OtherAlt")
        return ("Ref", "Alt")

    def __str__(self) -> str:
        return "Genotype(%s)" % ",".join(str(a) for a in self.alleles)
