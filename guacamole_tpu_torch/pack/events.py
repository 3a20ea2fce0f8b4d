"""Per-read pileup event streams.

One O(reference_length) pass over a read's CIGAR produces its pileup
contribution at EVERY locus it overlaps — replacing the reference's
per-locus PileupElement.advanceToLocus cursor walk
(cf. reference .../pileup/PileupElement.scala:220-248) with a form
that scatters directly into dense per-locus-tile tensors.

Event kinds and alignment-classification rules match PileupElement exactly
(validated property-wise in tests/test_pack.py against the oracle).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple

from guacamole_tpu_torch.reads.cigar import (
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


class EventKind(enum.IntEnum):
    BASE = 0  # single sequenced base; match/mismatch resolved per-locus
    INSERTION = 1  # anchor base + inserted bases
    DELETION = 2  # anchor of a deletion run
    MID_DELETION = 3  # inside a deletion run
    CLIPPED = 4  # inside an N gap


@dataclass
class ReadEvents:
    """The pileup contribution of one read at loci [start, end).

    Parallel per-locus arrays (index i = locus start+i):
      kinds[i]: EventKind
      quals[i]: phred quality under the element quality rules (base qual for
                BASE, min anchor+insertion qual for INSERTION, anchor base
                qual for DELETION, MAPQ for MID_DELETION/CLIPPED)
      bases[i]: for BASE the sequenced base (int); else 0
      seqs[i]:  for INSERTION the sequenced bytes (anchor + insertion);
                for DELETION the deleted reference tail (bytes, from MD);
                for MID_DELETION the single deleted reference base; else None
      md_ref[i]: this read's MD-reconstructed reference base at the locus
                 (N within gaps), used for per-locus reference resolution
    """

    read: MappedRead
    start: int
    kinds: List[int]
    quals: List[int]
    bases: List[int]
    seqs: List[Optional[bytes]]
    md_ref: bytes

    @property
    def end(self) -> int:
        return self.start + len(self.kinds)


def read_pileup_events(read: MappedRead) -> ReadEvents:
    """Walk the read's CIGAR once, emitting its pileup event at each locus."""
    span = read.end - read.start
    kinds = [EventKind.CLIPPED] * span
    quals = [read.alignment_quality] * span
    bases = [0] * span
    seqs: List[Optional[bytes]] = [None] * span
    md_ref = read.mdtag_reference_bases if read.mdtag is not None else b"N" * span

    seq = read.sequence
    read_quals = read.base_qualities
    elements = read.cigar.elements
    ref_offset = 0  # offset from read.start in reference coordinates
    read_pos = 0
    contig_start_insertion: Optional[Tuple[bytes, int]] = None

    for idx, elem in enumerate(elements):
        op = elem.op
        next_elem = elements[idx + 1] if idx + 1 < len(elements) else None
        if op in (OP_M, OP_EQ, OP_X):
            for k in range(elem.length):
                i = ref_offset + k
                kinds[i] = EventKind.BASE
                bases[i] = seq[read_pos + k]
                quals[i] = read_quals[read_pos + k]
            # Final base of this element may anchor an insertion or deletion.
            last = ref_offset + elem.length - 1
            last_read_pos = read_pos + elem.length - 1
            if next_elem is not None and next_elem.op == OP_I and op != OP_X:
                # Insertion anchored at the preceding (this) locus; X anchors
                # fall through to plain BASE, matching the oracle.
                n = next_elem.length
                kinds[last] = EventKind.INSERTION
                seqs[last] = bytes(seq[last_read_pos : last_read_pos + n + 1])
                quals[last] = min(
                    read_quals[last_read_pos : last_read_pos + n + 1]
                )
                bases[last] = 0
            elif next_elem is not None and next_elem.op == OP_D:
                # Deletion anchored at this locus; deleted tail from MD
                # (N placeholders when the read has no MD tag — the
                # reference would throw here, we degrade gracefully).
                abs_locus = read.start + last
                deletions = read.mdtag.deletions if read.mdtag else {}
                tail = bytes(
                    deletions.get(abs_locus + 1 + t, ord("N"))
                    for t in range(next_elem.length)
                )
                kinds[last] = EventKind.DELETION
                seqs[last] = tail
                quals[last] = read_quals[last_read_pos]
                bases[last] = 0
            read_pos += elem.length
            ref_offset += elem.length
        elif op == OP_D:
            deletions = read.mdtag.deletions if read.mdtag else {}
            for k in range(elem.length):
                i = ref_offset + k
                kinds[i] = EventKind.MID_DELETION
                seqs[i] = bytes([deletions.get(read.start + i, ord("N"))])
                quals[i] = read.alignment_quality
            ref_offset += elem.length
        elif op == OP_N:
            # loci inside splice gaps are CLIPPED with MAPQ quality (defaults)
            ref_offset += elem.length
        elif op == OP_P:
            ref_offset += elem.length
        elif op == OP_I:
            if (
                read.start + ref_offset == 0
                and next_elem is not None
                and span > 0
            ):
                # Insertion at the start of a contig anchors to the FOLLOWING
                # base (PileupElement.scala:99-103): emitted at locus 0,
                # winning over the following match event there.
                contig_start_insertion = (
                    bytes(seq[read_pos : read_pos + elem.length + 1]),
                    min(read_quals[read_pos : read_pos + elem.length + 1]),
                )
            read_pos += elem.length
        else:  # S, H consume no reference
            if op == OP_S:
                read_pos += elem.length

    if contig_start_insertion is not None:
        ins_seq, ins_qual = contig_start_insertion
        kinds[0] = EventKind.INSERTION
        seqs[0] = ins_seq
        quals[0] = ins_qual
        bases[0] = 0

    return ReadEvents(
        read=read,
        start=read.start,
        kinds=kinds,
        quals=quals,
        bases=bases,
        seqs=seqs,
        md_ref=md_ref,
    )


def event_allele(
    events: ReadEvents, locus: int, reference_base: int
) -> Tuple[bytes, bytes]:
    """Resolve the (ref_bases, alt_bases) allele of an event given the
    per-locus resolved reference base. Mirrors the Alignment ADT
    (cf. Alignment.scala:44-94)."""
    i = locus - events.start
    kind = events.kinds[i]
    if kind == EventKind.BASE:
        base = bytes([events.bases[i]])
        if events.bases[i] == reference_base:
            return base, base
        return bytes([reference_base]), base
    if kind == EventKind.INSERTION:
        seq = events.seqs[i]
        return seq[:1], seq
    if kind == EventKind.DELETION:
        ref = bytes([reference_base]) + events.seqs[i]
        return ref, ref[:1]
    if kind == EventKind.MID_DELETION:
        return events.seqs[i], b""
    return b"", b""
