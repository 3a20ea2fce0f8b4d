"""Read model: mapped/unmapped/paired reads and input filters.

Re-designed equivalents of the reference's read layer
(cf. reference .../reads/Read.scala:42-152, MappedRead.scala:35-111,
UnmappedRead.scala, PairedRead.scala, PairedMappedRead.scala,
MateAlignmentProperties.scala). Sequences/qualities are stored as ``bytes``
so they map directly onto uint8 tensors for device packing.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import numpy as np

from guacamole_tpu_torch.reads.cigar import IS_CLIP, Cigar
from guacamole_tpu_torch.reads.mdtag import MdTag, get_reference
from guacamole_tpu_torch.utils import bases as Bases
from guacamole_tpu_torch.utils.phred import phred_to_success_probability


@dataclass(frozen=True)
class MappedRead:
    """An aligned read.

    start is the 0-based reference locus of the first aligned base; end is
    exclusive: start + cigar.padded_reference_length
    (cf. MappedRead.scala:87).
    """

    token: int
    sequence: bytes
    base_qualities: bytes  # phred values (not ascii-offset)
    is_duplicate: bool
    sample_name: str
    reference_contig: str
    alignment_quality: int
    start: int
    cigar: Cigar
    mdtag: Optional[MdTag]
    failed_vendor_quality_checks: bool
    is_positive_strand: bool
    is_paired: bool

    def __post_init__(self):
        assert len(self.base_qualities) == len(self.sequence), (
            f"Base qualities have length {len(self.base_qualities)} but "
            f"sequence has length {len(self.sequence)}"
        )

    # --- Read trait ---
    @property
    def is_mapped(self) -> bool:
        return True

    @property
    def as_mapped_read(self) -> Optional["MappedRead"]:
        return self

    @property
    def has_mdtag(self) -> bool:
        return self.mdtag is not None

    # --- genomic interval ---
    @property
    def end(self) -> int:
        """Exclusive end locus of the alignment."""
        return self.start + self.cigar.padded_reference_length

    @property
    def unclipped_start(self) -> int:
        pos = self.start
        for elem in self.cigar:
            if not IS_CLIP[elem.op]:
                break
            pos -= elem.length
        return pos

    @property
    def unclipped_end(self) -> int:
        pos = self.end
        for elem in reversed(self.cigar.elements):
            if not IS_CLIP[elem.op]:
                break
            pos += elem.length
        return pos

    def overlaps_locus(self, locus: int, half_window_size: int = 0) -> bool:
        return (
            self.start - half_window_size <= locus
            and self.end + half_window_size > locus
        )

    def overlaps_loci_set(self, loci, half_window_size: int = 0) -> bool:
        return loci.on_contig(self.reference_contig).intersects(
            max(0, self.start - half_window_size), self.end + half_window_size
        )

    # --- reference reconstruction ---
    @property
    def mdtag_reference_bases(self) -> bytes:
        if self.mdtag is None:
            raise ValueError(f"Read has no MD tag: {self}")
        return get_reference(self.mdtag, self.sequence, self.cigar, allow_n_base=True)

    def get_reference_base_at_locus(self, locus: int) -> int:
        assert self.start <= locus < self.end
        return self.mdtag_reference_bases[locus - self.start]

    @property
    def alignment_likelihood(self) -> float:
        return phred_to_success_probability(self.alignment_quality)

    def __str__(self) -> str:
        return "MappedRead(%s:%d, %s, %s)" % (
            self.reference_contig,
            self.start,
            self.cigar,
            Bases.bases_to_string(self.sequence),
        )


@dataclass(frozen=True)
class UnmappedRead:
    token: int
    sequence: bytes
    base_qualities: bytes
    is_duplicate: bool
    sample_name: str
    failed_vendor_quality_checks: bool
    is_paired: bool

    @property
    def is_mapped(self) -> bool:
        return False

    @property
    def as_mapped_read(self) -> Optional[MappedRead]:
        return None

    @property
    def has_mdtag(self) -> bool:
        return False


@dataclass(frozen=True)
class MateAlignmentProperties:
    reference_contig: str
    start: int  # 0-based
    inferred_insert_size: Optional[int]
    is_positive_strand: bool


@dataclass(frozen=True)
class PairedRead:
    """A read from a paired-end library, delegating to the inner read."""

    read: object  # MappedRead | UnmappedRead
    is_first_in_pair: bool
    mate_alignment_properties: Optional[MateAlignmentProperties]

    @property
    def is_mate_mapped(self) -> bool:
        return self.mate_alignment_properties is not None

    @property
    def token(self) -> int:
        return self.read.token

    @property
    def sequence(self) -> bytes:
        return self.read.sequence

    @property
    def base_qualities(self) -> bytes:
        return self.read.base_qualities

    @property
    def is_duplicate(self) -> bool:
        return self.read.is_duplicate

    @property
    def sample_name(self) -> str:
        return self.read.sample_name

    @property
    def failed_vendor_quality_checks(self) -> bool:
        return self.read.failed_vendor_quality_checks

    @property
    def is_paired(self) -> bool:
        return True

    @property
    def is_mapped(self) -> bool:
        return self.read.is_mapped

    @property
    def as_mapped_read(self) -> Optional[MappedRead]:
        return self.read.as_mapped_read

    @property
    def has_mdtag(self) -> bool:
        return self.read.has_mdtag


@dataclass(frozen=True)
class PairedMappedRead:
    """A fully-mapped pair with a known insert size
    (cf. PairedMappedRead.scala:7-52)."""

    read: MappedRead
    is_first_in_pair: bool
    inferred_insert_size: int
    mate: MateAlignmentProperties

    @staticmethod
    def from_paired_read(paired: PairedRead) -> Optional["PairedMappedRead"]:
        mate = paired.mate_alignment_properties
        if mate is None or mate.inferred_insert_size is None:
            return None
        return PairedMappedRead(
            paired.read, paired.is_first_in_pair, mate.inferred_insert_size, mate
        )

    @property
    def read_length(self) -> int:
        return len(self.read.sequence)

    @property
    def on_same_contig(self) -> bool:
        return self.read.reference_contig == self.mate.reference_contig

    @property
    def min_pos(self) -> int:
        return min(self.read.start, self.mate.start)

    @property
    def max_pos(self) -> int:
        return max(self.read.start, self.mate.start) + self.read_length

    @property
    def gap_length(self) -> int:
        return abs(self.read.start - self.mate.start) - self.read_length

    @property
    def insert_size(self) -> int:
        return self.max_pos - self.min_pos

    @property
    def starts_and_stops(self) -> Tuple[int, int, int, int]:
        """The four (sorted) alignment points: start/stop of each mate."""
        r, m, length = self.read, self.mate, self.read_length
        if r.start < m.start:
            return (r.start, r.start + length, m.start, m.start + length)
        return (m.start, m.start + length, r.start, r.start + length)


@dataclass(frozen=True)
class InputFilters:
    """Read-loading filters; reads must satisfy ALL set filters
    (cf. Read.scala:95-152)."""

    overlaps_loci: Optional[object] = None  # LociSetBuilder
    non_duplicate: bool = False
    passed_vendor_quality_checks: bool = False
    is_paired: bool = False
    has_mdtag: bool = False

    @staticmethod
    def create(
        mapped: bool = False,
        overlaps_loci=None,
        non_duplicate: bool = False,
        passed_vendor_quality_checks: bool = False,
        is_paired: bool = False,
        has_mdtag: bool = False,
    ) -> "InputFilters":
        from guacamole_tpu_torch.loci.lociset import LociSetBuilder

        if overlaps_loci is None and mapped:
            overlaps_loci = LociSetBuilder().put_all_contigs()
        return InputFilters(
            overlaps_loci=overlaps_loci,
            non_duplicate=non_duplicate,
            passed_vendor_quality_checks=passed_vendor_quality_checks,
            is_paired=is_paired,
            has_mdtag=has_mdtag,
        )

    def apply(self, reads, contig_lengths) -> list:
        """Filter a list of reads (post-load path, cf. Read.scala:131-151)."""
        result = reads
        if self.overlaps_loci is not None:
            loci = self.overlaps_loci.result(contig_lengths)
            result = [
                r
                for r in result
                if r.is_mapped and r.as_mapped_read.overlaps_loci_set(loci)
            ]
        if self.non_duplicate:
            result = [r for r in result if not r.is_duplicate]
        if self.passed_vendor_quality_checks:
            result = [r for r in result if not r.failed_vendor_quality_checks]
        if self.is_paired:
            result = [r for r in result if r.is_paired]
        if self.has_mdtag:
            result = [r for r in result if r.has_mdtag]
        return result


InputFilters.empty = InputFilters()


def base_quality_string_to_bytes(base_qualities: str, length: int) -> bytes:
    """Convert ascii-encoded (+33) base qualities to phred bytes; empty
    string -> all zeros (cf. Read.scala:201-209)."""
    if not base_qualities:
        return bytes(length)
    arr = np.frombuffer(base_qualities.encode("ascii"), dtype=np.uint8)
    if arr.size and int(arr.min()) < 33:
        # Phred+33: anything below '!' is corrupt; a silent uint8 wrap
        # would fabricate a huge base quality (e.g. ' ' -> 255).
        raise ValueError(
            "base quality character below '!' in %r" % base_qualities
        )
    return (arr - 33).tobytes()


def make_read(
    sequence: str,
    cigar_string: str = "",
    mdtag: Optional[str] = None,
    start: int = -1,
    token: int = 0,
    base_qualities: str = "",
    is_duplicate: bool = False,
    sample_name: str = "",
    reference_contig: str = "",
    alignment_quality: int = -1,
    failed_vendor_quality_checks: bool = False,
    is_positive_strand: bool = True,
    is_paired: bool = True,
) -> MappedRead:
    """Convenience constructor from unparsed values (test fixture maker,
    cf. Read.scala:157-191)."""
    seq = sequence.encode("ascii")
    quals = base_quality_string_to_bytes(base_qualities, len(seq))
    cigar = Cigar.from_string(cigar_string)
    md = MdTag(mdtag, start, cigar) if mdtag is not None else None
    return MappedRead(
        token=token,
        sequence=seq,
        base_qualities=quals,
        is_duplicate=is_duplicate,
        sample_name=sample_name,
        reference_contig=reference_contig,
        alignment_quality=alignment_quality,
        start=start,
        cigar=cigar,
        mdtag=md,
        failed_vendor_quality_checks=failed_vendor_quality_checks,
        is_positive_strand=is_positive_strand,
        is_paired=is_paired,
    )
