"""MD tag parsing and reference reconstruction.

The MD tag (SAM optional tag ``MD:Z:``) records, per read, where the read
differs from the reference, which lets us reconstruct the reference bases
under the read without a FASTA. Semantics match the ADAM MdTag + reference
MDTagUtils behavior relied on by the pileup engine
(cf. reference .../MDTagUtils.scala:23-150, MappedRead.scala:57-76).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from guacamole_tpu_torch.reads.cigar import (
    OP_D,
    OP_EQ,
    OP_M,
    OP_N,
    OP_X,
    Cigar,
)
from guacamole_tpu_torch.utils import bases as Bases

_MD_TOKEN = re.compile(r"(\d+)|(\^[A-Za-z]+)|([A-Za-z])")


class MdTagError(ValueError):
    pass


class MdTag:
    """Parsed MD tag, positioned on the reference.

    Attributes:
        start: 0-based reference start of the read's alignment.
        mismatches: absolute reference position -> reference base (int).
        deletions: absolute reference position -> deleted reference base.
    """

    __slots__ = ("tag", "start", "mismatches", "deletions")

    def __init__(self, tag: str, start: int, cigar: Cigar):
        self.tag = tag
        self.start = start
        self.mismatches: Dict[int, int] = {}
        self.deletions: Dict[int, int] = {}
        self._parse(tag, start, cigar)

    def _parse(self, tag: str, start: int, cigar: Cigar) -> None:
        # Tokenize the MD string into match-run lengths, mismatch bases, and
        # deletion runs, then walk the CIGAR to place them on the reference.
        tokens: List = []
        pos = 0
        for m in _MD_TOKEN.finditer(tag):
            if m.start() != pos:
                raise MdTagError(f"Malformed MD tag: {tag!r}")
            if m.group(1) is not None:
                tokens.append(int(m.group(1)))
            elif m.group(2) is not None:
                tokens.append(m.group(2)[1:].upper().encode("ascii"))
            else:
                tokens.append(m.group(3).upper())
            pos = m.end()
        if pos != len(tag):
            raise MdTagError(f"Malformed MD tag: {tag!r}")

        ti = 0  # token index
        run = 0  # remaining matched bases in the current numeric run
        if tokens and isinstance(tokens[0], int):
            run = tokens[0]
            ti = 1

        ref_pos = start
        for elem in cigar:
            if elem.op in (OP_M, OP_EQ, OP_X):
                remaining = elem.length
                while remaining > 0:
                    if run > 0:
                        step = min(run, remaining)
                        run -= step
                        remaining -= step
                        ref_pos += step
                    else:
                        if ti >= len(tokens):
                            raise MdTagError(
                                f"MD tag {tag!r} ended early for cigar {cigar}"
                            )
                        token = tokens[ti]
                        ti += 1
                        if isinstance(token, int):
                            run = token
                            # A 0-length run separates adjacent mismatches.
                        elif isinstance(token, str):
                            self.mismatches[ref_pos] = ord(token)
                            ref_pos += 1
                            remaining -= 1
                        else:
                            raise MdTagError(
                                f"Unexpected deletion token in match run: {tag!r}"
                            )
            elif elem.op == OP_D:
                # Consume any zero-length match runs before the deletion.
                while (
                    run == 0
                    and ti < len(tokens)
                    and isinstance(tokens[ti], int)
                    and tokens[ti] == 0
                ):
                    ti += 1
                if run > 0 or ti >= len(tokens) or not isinstance(tokens[ti], bytes):
                    raise MdTagError(
                        f"MD tag {tag!r} missing deletion for cigar {cigar}"
                    )
                deleted = tokens[ti]
                ti += 1
                if len(deleted) != elem.length:
                    raise MdTagError(
                        f"MD deletion length {len(deleted)} != cigar D length "
                        f"{elem.length} in {tag!r}"
                    )
                for i, b in enumerate(deleted):
                    self.deletions[ref_pos + i] = b
                ref_pos += elem.length
            elif elem.op == OP_N:
                # Reference skip: MD does not cover N gaps.
                ref_pos += elem.length
            else:
                # I/S/H/P consume no reference and no MD.
                pass

    @property
    def count_of_mismatches(self) -> int:
        return len(self.mismatches)

    def __str__(self) -> str:
        return self.tag

    def __repr__(self) -> str:
        return f"MdTag({self.tag!r}, start={self.start})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, MdTag)
            and self.tag == other.tag
            and self.start == other.start
        )

    def __hash__(self) -> int:
        return hash((self.tag, self.start))


def get_reference(
    mdtag: MdTag, read_sequence: bytes, cigar: Cigar, allow_n_base: bool
) -> bytes:
    """Reconstruct the reference bases overlapping a read from its MD tag.

    Returns one byte per reference position in [mdtag.start,
    mdtag.start + cigar.reference_length): read bases where the read matches,
    MD mismatch bases where it doesn't, deletion bases for D runs, and N for
    N (splice) gaps when allow_n_base.
    """
    out = bytearray()
    ref_pos = mdtag.start
    read_pos = 0
    for elem in cigar:
        if elem.op in (OP_M, OP_EQ, OP_X):
            for _ in range(elem.length):
                mismatch = mdtag.mismatches.get(ref_pos)
                out.append(mismatch if mismatch is not None else read_sequence[read_pos])
                read_pos += 1
                ref_pos += 1
        elif elem.op == OP_N:
            if not allow_n_base:
                raise MdTagError("Cannot reconstruct reference through N gap")
            out.extend(b"N" * elem.length)
            ref_pos += elem.length
        elif elem.op == OP_D:
            for _ in range(elem.length):
                base = mdtag.deletions.get(ref_pos)
                if base is None:
                    raise MdTagError(
                        f"Could not find deleted base at reference position {ref_pos}"
                    )
                out.append(base)
                ref_pos += 1
        else:
            if elem.consumes_read_bases:
                read_pos += elem.length
            if elem.consumes_reference_bases:
                raise MdTagError(f"Cannot handle operator: {elem.op_char}")
    return bytes(out)


def build_md_tag(read_sequence: bytes, reference_sequence: bytes, cigar: Cigar) -> str:
    """Generate an MD tag string for a read given the reference bases it
    aligns against (reference_sequence covers exactly the aligned span).

    Used to recompute MD tags from a FASTA
    (cf. reference .../ReferenceGenome.scala buildMdTag).
    """
    out: List[str] = []
    match_run = 0
    ref_pos = 0
    read_pos = 0
    for elem in cigar:
        if elem.op in (OP_M, OP_EQ, OP_X):
            for _ in range(elem.length):
                ref_base = reference_sequence[ref_pos]
                read_base = read_sequence[read_pos]
                if ref_base == read_base:
                    match_run += 1
                else:
                    out.append(str(match_run))
                    out.append(chr(ref_base))
                    match_run = 0
                ref_pos += 1
                read_pos += 1
        elif elem.op in (OP_D, OP_N):
            if elem.op == OP_D:
                out.append(str(match_run))
                match_run = 0
                out.append("^" + reference_sequence[ref_pos : ref_pos + elem.length].decode("ascii"))
            ref_pos += elem.length
        else:
            if elem.consumes_read_bases:
                read_pos += elem.length
    out.append(str(match_run))
    return "".join(out)


def reference_from_reads(
    sorted_reads, reference_start: int, reference_end: int
) -> bytes:
    """Rebuild a reference window from sorted overlapping reads, N-padding
    any gaps (cf. reference .../MDTagUtils.scala:99-150).

    ``sorted_reads`` are MappedReads sorted by start, each with an MD tag.
    """
    assert reference_start < reference_end, (
        f"Reference sequence coordinates invalid, {reference_end} <= {reference_start}"
    )
    length = reference_end - reference_start
    out = bytearray(b"N" * length)
    n_reads = len(sorted_reads)
    current_locus = reference_start
    last_read_start = 0
    for idx in range(n_reads):
        read = sorted_reads[idx]
        assert read.start >= last_read_start, "reads must be sorted by start"
        if current_locus < read.start:
            current_locus = min(reference_end, read.start)
        # Use this read only if the next read starts after the current locus
        # (i.e. it is the last read overlapping the current locus).
        if idx + 1 >= n_reads or current_locus < sorted_reads[idx + 1].start:
            ref_start = read.mdtag.start
            ref_seq = get_reference(read.mdtag, read.sequence, read.cigar, True)
            ref_end = min(ref_start + len(ref_seq), reference_end)
            for locus in range(current_locus, ref_end):
                out[locus - reference_start] = ref_seq[locus - ref_start]
            current_locus = max(current_locus, ref_end)
        last_read_start = read.start
    return bytes(out)
