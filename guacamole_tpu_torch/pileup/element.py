"""PileupElement: one read's contribution at one reference locus.

This is the exact-semantics host oracle for per-locus alignment
classification; the TPU tile packer is validated against it property-wise.
Classification rules (insertion/deletion anchoring, clipping, mid-deletion)
match the reference (cf. reference .../pileup/PileupElement.scala:40-285
and Alignment.scala:32-95):

 - Insertions anchor to the PRECEDING reference locus: a match followed by an
   insertion is emitted as one Insertion alignment at the match's locus, with
   sequencedBases = anchor base + inserted bases.
 - An insertion at the very start of a contig (locus 0) instead anchors to
   the FOLLOWING base.
 - Deletions anchor at the preceding locus too (VCF convention): the element
   at the last M base before a D run carries the full deleted reference
   sequence; loci inside the D run produce MidDeletion elements.
 - Loci inside N (splice) gaps produce Clipped elements.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

from guacamole_tpu_torch.reads.cigar import (
    CONSUMES_READ,
    CONSUMES_REF,
    OP_D,
    OP_EQ,
    OP_H,
    OP_I,
    OP_M,
    OP_N,
    OP_P,
    OP_S,
    OP_X,
)
from guacamole_tpu_torch.reads.read import MappedRead
from guacamole_tpu_torch.utils import bases as Bases
from guacamole_tpu_torch.variants.allele import Allele


class AlignmentKind(enum.Enum):
    MATCH = "Match"
    MISMATCH = "Mismatch"
    INSERTION = "Insertion"
    DELETION = "Deletion"
    MID_DELETION = "MidDeletion"
    CLIPPED = "Clipped"


@dataclass(frozen=True)
class Alignment:
    """The classified alignment of one read at one locus."""

    kind: AlignmentKind
    sequenced_bases: bytes
    reference_bases: bytes
    # base quality info: single qual for M/X/Deletion-anchor, per-base quals
    # for insertions; None for Clipped/MidDeletion.
    base_quality: Optional[int] = None
    insertion_qualities: Optional[bytes] = None

    @property
    def is_match(self) -> bool:
        return self.kind is AlignmentKind.MATCH

    def __str__(self) -> str:
        return "%s(%s,%s)" % (
            self.kind.value,
            Bases.bases_to_string(self.reference_bases),
            Bases.bases_to_string(self.sequenced_bases),
        )


class InvalidCigarElementError(ValueError):
    pass


class PileupElement:
    """A cursor into one read positioned at a reference locus.

    Cursor state: (read_position, cigar_element_index,
    index_within_cigar_element), advanced monotonically along the reference
    (cf. PileupElement.scala:40-47).
    """

    __slots__ = (
        "read",
        "locus",
        "reference_base",
        "read_position",
        "cigar_element_index",
        "cigar_element_locus",
        "index_within_cigar_element",
        "_alignment",
    )

    def __init__(
        self,
        read: MappedRead,
        locus: int,
        reference_base: int,
        read_position: int,
        cigar_element_index: int,
        cigar_element_locus: int,
        index_within_cigar_element: int,
    ):
        assert locus >= read.start
        assert locus < read.end
        self.read = read
        self.locus = locus
        self.reference_base = reference_base
        self.read_position = read_position
        self.cigar_element_index = cigar_element_index
        self.cigar_element_locus = cigar_element_locus
        self.index_within_cigar_element = index_within_cigar_element
        self._alignment: Optional[Alignment] = None

    # --- construction ---

    @staticmethod
    def at_locus(read: MappedRead, locus: int, reference_base: int) -> "PileupElement":
        """Create an element for `read` at `locus` (read must overlap it)."""
        elem = PileupElement(
            read=read,
            locus=read.start,
            reference_base=Bases.N,
            read_position=0,
            cigar_element_index=0,
            cigar_element_locus=read.start,
            index_within_cigar_element=0,
        )
        return elem.advance_to_locus(locus, reference_base)

    # --- cigar element helpers ---

    @property
    def cigar_element(self):
        return self.read.cigar[self.cigar_element_index]

    @property
    def next_cigar_element(self):
        if self.cigar_element_index + 1 < len(self.read.cigar):
            return self.read.cigar[self.cigar_element_index + 1]
        return None

    @property
    def cigar_element_reference_length(self) -> int:
        return self.cigar_element.reference_length

    @property
    def cigar_element_end_locus(self) -> int:
        return self.cigar_element_locus + self.cigar_element_reference_length

    # --- classification ---

    @property
    def alignment(self) -> Alignment:
        if self._alignment is None:
            self._alignment = self._classify()
        return self._alignment

    def _classify(self) -> Alignment:
        elem = self.cigar_element
        op = elem.op
        is_final_cigar_base = self.index_within_cigar_element == elem.length - 1
        next_elem = self.next_cigar_element if is_final_cigar_base else elem
        next_op = next_elem.op if next_elem is not None else None

        def make_insertion(insertion_elem) -> Alignment:
            n = insertion_elem.read_length
            seq = self.read.sequence[self.read_position : self.read_position + n + 1]
            quals = self.read.base_qualities[
                self.read_position : self.read_position + n + 1
            ]
            return Alignment(
                kind=AlignmentKind.INSERTION,
                sequenced_bases=seq,
                reference_bases=seq[:1],
                insertion_qualities=quals,
            )

        # Insertion anchored to the preceding locus.
        if op in (OP_M, OP_EQ) and next_op == OP_I:
            return make_insertion(self.next_cigar_element)
        # Insertion at the start of a contig anchors to the following base.
        if op == OP_I and next_elem is not None and self.cigar_element_locus == 0:
            return make_insertion(elem)
        if op == OP_I:
            raise InvalidCigarElementError(
                "PileupElement at non-reference-consuming insertion: locus "
                f"{self.locus}, read {self.read}"
            )
        # Deletion anchored at the last base before the D run.
        if op in (OP_M, OP_EQ, OP_X) and next_op == OP_D:
            ref_idx = self.locus  # absolute reference position of the anchor
            deleted = bytearray([self.reference_base])
            # Missing MD tag: N placeholder reference bases (the packers'
            # convention, cf. DEVIATIONS.md #3 — the reference throws).
            deletions = (
                self.read.mdtag.deletions if self.read.mdtag else {}
            )
            for offset in range(1, self.next_cigar_element.length + 1):
                deleted.append(deletions.get(ref_idx + offset, ord("N")))
            return Alignment(
                kind=AlignmentKind.DELETION,
                sequenced_bases=bytes(deleted[:1]),
                reference_bases=bytes(deleted),
                base_quality=self.read.base_qualities[self.read_position],
            )
        if op == OP_D:
            ref_base = (
                self.read.mdtag.deletions.get(self.locus, ord("N"))
                if self.read.mdtag
                else ord("N")
            )
            return Alignment(
                kind=AlignmentKind.MID_DELETION,
                sequenced_bases=b"",
                reference_bases=bytes([ref_base]),
            )
        if next_op == OP_D and op not in (OP_M, OP_EQ, OP_X):
            raise InvalidCigarElementError(
                f"Deletion preceded by cigar operator {elem.op_char} at locus "
                f"{self.locus}"
            )
        if op in (OP_M, OP_EQ, OP_X):
            base = self.read.sequence[self.read_position]
            quality = self.read.base_qualities[self.read_position]
            if base == self.reference_base:
                return Alignment(
                    kind=AlignmentKind.MATCH,
                    sequenced_bases=bytes([base]),
                    reference_bases=bytes([base]),
                    base_quality=quality,
                )
            return Alignment(
                kind=AlignmentKind.MISMATCH,
                sequenced_bases=bytes([base]),
                reference_bases=bytes([self.reference_base]),
                base_quality=quality,
            )
        if op in (OP_S, OP_N, OP_H):
            return Alignment(
                kind=AlignmentKind.CLIPPED, sequenced_bases=b"", reference_bases=b""
            )
        raise InvalidCigarElementError(f"Unexpected cigar operator: {elem.op_char}")

    # --- classification-derived properties ---

    @property
    def is_insertion(self) -> bool:
        return self.alignment.kind is AlignmentKind.INSERTION

    @property
    def is_deletion(self) -> bool:
        return self.alignment.kind is AlignmentKind.DELETION

    @property
    def is_mid_deletion(self) -> bool:
        return self.alignment.kind is AlignmentKind.MID_DELETION

    @property
    def is_mismatch(self) -> bool:
        return self.alignment.kind is AlignmentKind.MISMATCH

    @property
    def is_match(self) -> bool:
        return self.alignment.kind is AlignmentKind.MATCH

    @property
    def sequenced_bases(self) -> bytes:
        return self.alignment.sequenced_bases

    @property
    def reference_bases(self) -> bytes:
        return self.alignment.reference_bases

    @property
    def allele(self) -> Allele:
        return Allele(self.alignment.reference_bases, self.alignment.sequenced_bases)

    @property
    def quality_score(self) -> int:
        """Phred quality of this element: base qual for M/X, min insertion
        qual, anchor qual for deletions, MAPQ for clipped/mid-deletion
        (cf. PileupElement.scala:166-171)."""
        a = self.alignment
        if a.kind in (AlignmentKind.CLIPPED, AlignmentKind.MID_DELETION):
            return self.read.alignment_quality
        if a.kind is AlignmentKind.INSERTION:
            return min(a.insertion_qualities)
        return a.base_quality

    @property
    def distance_from_sequencing_end(self) -> int:
        """Distance from the sequencing (directional) end of the read."""
        if self.read.is_positive_strand:
            return self.read.end - self.locus
        return self.locus - self.read.start

    # --- advancing ---

    def _advance_to_next_cigar_element(self) -> "PileupElement":
        elem = self.cigar_element
        if CONSUMES_READ[elem.op]:
            read_position_offset = elem.length - self.index_within_cigar_element
        else:
            read_position_offset = 0
        next_locus = self.locus + (
            self.cigar_element_reference_length - self.index_within_cigar_element
        )
        return PileupElement(
            read=self.read,
            locus=next_locus,
            reference_base=Bases.N,  # placeholder until a proper locus
            read_position=self.read_position + read_position_offset,
            cigar_element_index=self.cigar_element_index + 1,
            cigar_element_locus=self.cigar_element_locus
            + self.cigar_element_reference_length,
            index_within_cigar_element=0,
        )

    def current_cigar_element_contains_locus(self, reference_locus: int) -> bool:
        return (
            self.cigar_element_locus
            <= reference_locus
            < self.cigar_element_end_locus
        )

    def advance_to_locus(
        self, new_locus: int, new_reference_base: int
    ) -> "PileupElement":
        """Return a new element at new_locus (must be >= current locus and
        before the read's end). Iterative version of the reference's
        tail-recursive advance (PileupElement.scala:220-248)."""
        assert new_locus >= self.locus, (
            f"Can't rewind to locus {new_locus} from {self.locus}. "
            "Pileups only advance."
        )
        assert new_locus < self.read.end, (
            f"This read stops at position {self.read.end}. "
            f"Can't advance to {new_locus}"
        )
        elem = self
        while True:
            if elem.current_cigar_element_contains_locus(new_locus):
                if CONSUMES_READ[elem.cigar_element.op]:
                    read_position_offset = (
                        new_locus
                        - elem.cigar_element_locus
                        - elem.index_within_cigar_element
                    )
                else:
                    read_position_offset = 0
                return PileupElement(
                    read=elem.read,
                    locus=new_locus,
                    reference_base=new_reference_base,
                    read_position=elem.read_position + read_position_offset,
                    cigar_element_index=elem.cigar_element_index,
                    cigar_element_locus=elem.cigar_element_locus,
                    index_within_cigar_element=new_locus - elem.cigar_element_locus,
                )
            if new_locus == 0 and elem.cigar_element.op == OP_I:
                # Insertion at the start of a contig: allow an element at a
                # non-reference-consuming cigar element.
                return elem
            elem = elem._advance_to_next_cigar_element()

    def __repr__(self) -> str:
        return (
            f"PileupElement({self.read.reference_contig}:{self.locus}, "
            f"{self.alignment})"
        )
