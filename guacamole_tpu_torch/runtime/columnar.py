"""Columnar read storage: the production host-side representation.

Reads live as parallel numpy arrays (decoded by the native runtime or a
Python fallback), never as per-read objects on the hot path; object-model
MappedReads are materialized lazily only for the exact host confirmation at
candidate loci.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from guacamole_tpu_torch.gio import sam_flags as flags
from guacamole_tpu_torch.pack.events import EventKind
from guacamole_tpu_torch.reads.cigar import OPS, Cigar, CigarElement
from guacamole_tpu_torch.reads.mdtag import MdTag
from guacamole_tpu_torch.reads.read import MappedRead


@dataclass
class ColumnarReads:
    """Columnar mapped-read arrays for one BAM (or a filtered slice)."""

    ref_names: List[str]
    ref_lengths: List[int]
    samples: List[str]
    # per-read scalars
    ref_id: np.ndarray  # int32
    start: np.ndarray  # int64
    end: np.ndarray  # int64
    mapq: np.ndarray  # int32
    flags_: np.ndarray  # uint16
    mismatches: np.ndarray  # int32
    sample_id: np.ndarray  # int32
    # variable-length
    seq_off: np.ndarray
    seq: np.ndarray
    qual: np.ndarray
    cigar_off: np.ndarray
    cigar_len: np.ndarray
    cigar_op: np.ndarray
    md_off: np.ndarray
    md_text: np.ndarray
    # event arrays
    ev_off: np.ndarray
    ev_kind: np.ndarray
    ev_base: np.ndarray
    ev_qual: np.ndarray
    ev_mdref: np.ndarray
    # specials
    sp_read: np.ndarray
    sp_offset: np.ndarray
    sp_kind: np.ndarray
    sp_payload_offset: np.ndarray
    sp_payload_len: np.ndarray
    sp_qual: np.ndarray
    special_payload: np.ndarray
    # Filtered slices: the ragged data arrays above are SHARED with the
    # parent and each *_off becomes a length-n array of per-read start
    # offsets, with the matching end offsets here. None = unfiltered
    # (cumulative length-n+1 *_off).
    seq_end: Optional[np.ndarray] = None
    cigar_end: Optional[np.ndarray] = None
    md_end: Optional[np.ndarray] = None
    ev_end: Optional[np.ndarray] = None
    # Mate columns from the native decoders (None for object-built
    # columnar sets): feed the structural-variant caller's vectorized
    # discordant-pair stage.
    mate_ref_id: Optional[np.ndarray] = None  # int32, -1 = unmapped/*
    mate_start: Optional[np.ndarray] = None  # int64 0-based
    tlen: Optional[np.ndarray] = None  # int32 signed template length

    @property
    def n(self) -> int:
        return len(self.start)

    def _span(self, off: np.ndarray, end_arr: Optional[np.ndarray], i: int):
        if end_arr is not None:
            return int(off[i]), int(end_arr[i])
        return int(off[i]), int(off[i + 1])

    @property
    def md_lengths(self) -> np.ndarray:
        if self.md_end is not None:
            return self.md_end - self.md_off
        return self.md_off[1:] - self.md_off[:-1]

    @property
    def contig_lengths(self) -> Dict[str, int]:
        return dict(zip(self.ref_names, self.ref_lengths))

    @property
    def is_positive_strand(self) -> np.ndarray:
        return (self.flags_ & flags.REVERSE) == 0

    @property
    def is_mapped_mask(self) -> np.ndarray:
        return ((self.flags_ & flags.UNMAPPED) == 0) & (self.ref_id >= 0)

    def read_scan_window(self, contig_id: int, lo: int, hi: int):
        """[r_lo, r_hi) read-index window guaranteed to contain every read
        of contig_id overlapping loci [lo, hi], via binary search over the
        per-contig sorted-start block (computed once and cached). Returns
        None when reads aren't contiguously grouped by contig with
        nondecreasing starts — callers then scan everything. Without this,
        a whole-genome run pays an O(n_reads) scan per packed tile."""
        index = getattr(self, "_scan_index", "unset")
        if isinstance(index, str):
            index = self._build_scan_index()
            self._scan_index = index
        if index is None:
            return None
        block = index.get(int(contig_id))
        if block is None:
            return (self.n, self.n)  # no reads on this contig: empty window
        base, n, max_span = block
        starts = self.start[base : base + n]
        r_lo = base + int(
            np.searchsorted(starts, lo - max_span, side="left")
        )
        r_hi = base + int(np.searchsorted(starts, hi, side="right"))
        return (r_lo, r_hi)

    def _build_scan_index(self):
        if self.n == 0:
            return {}
        ref = np.asarray(self.ref_id)
        start = np.asarray(self.start)
        end = np.asarray(self.end)
        cuts = np.flatnonzero(np.diff(ref) != 0) + 1
        bounds = np.concatenate([[0], cuts, [len(ref)]])
        index = {}
        for b, e in zip(bounds[:-1], bounds[1:]):
            cid = int(ref[b])
            if cid in index:  # contig appears in two blocks: not grouped
                return None
            blk_start = start[b:e]
            if len(blk_start) > 1 and np.any(np.diff(blk_start) < 0):
                return None  # not start-sorted within the contig
            span = int((end[b:e] - blk_start).max()) if e > b else 0
            index[cid] = (int(b), int(e - b), span)
        return index

    def select(self, mask: np.ndarray) -> "ColumnarReads":
        """Subset reads by boolean mask (event/special tables re-indexed).

        An all-true mask returns self unchanged — a no-op filter over
        millions of reads would otherwise pay a full fancy-indexed rebuild
        of every per-read bounds array (~seconds at scale)."""
        if mask.all():
            return self
        idx = np.flatnonzero(mask)
        return self.take(idx)

    def take(self, idx: np.ndarray) -> "ColumnarReads":
        """Subset reads by index WITHOUT copying the ragged data: the data
        arrays are shared and only the per-read offset bounds are indexed
        (the packers address ragged sections by start offset only)."""
        old_to_new = np.full(self.n, -1, dtype=np.int64)
        old_to_new[idx] = np.arange(len(idx))

        def bounds_take(off, end_arr):
            if end_arr is not None:
                return off[idx], end_arr[idx]
            return off[:-1][idx], off[1:][idx]

        seq_s, seq_e = bounds_take(self.seq_off, self.seq_end)
        cig_s, cig_e = bounds_take(self.cigar_off, self.cigar_end)
        md_s, md_e = bounds_take(self.md_off, self.md_end)
        ev_s, ev_e = bounds_take(self.ev_off, self.ev_end)

        sp_mask = old_to_new[self.sp_read] >= 0
        return ColumnarReads(
            ref_names=self.ref_names,
            ref_lengths=self.ref_lengths,
            samples=self.samples,
            ref_id=self.ref_id[idx],
            start=self.start[idx],
            end=self.end[idx],
            mapq=self.mapq[idx],
            flags_=self.flags_[idx],
            mismatches=self.mismatches[idx],
            sample_id=self.sample_id[idx],
            seq_off=seq_s,
            seq=self.seq,
            qual=self.qual,
            cigar_off=cig_s,
            cigar_len=self.cigar_len,
            cigar_op=self.cigar_op,
            md_off=md_s,
            md_text=self.md_text,
            ev_off=ev_s,
            ev_kind=self.ev_kind,
            ev_base=self.ev_base,
            ev_qual=self.ev_qual,
            ev_mdref=self.ev_mdref,
            sp_read=old_to_new[self.sp_read[sp_mask]],
            sp_offset=self.sp_offset[sp_mask],
            sp_kind=self.sp_kind[sp_mask],
            sp_payload_offset=self.sp_payload_offset[sp_mask],
            sp_payload_len=self.sp_payload_len[sp_mask],
            sp_qual=self.sp_qual[sp_mask],
            special_payload=self.special_payload,
            seq_end=seq_e,
            cigar_end=cig_e,
            md_end=md_e,
            ev_end=ev_e,
            mate_ref_id=(
                self.mate_ref_id[idx] if self.mate_ref_id is not None else None
            ),
            mate_start=(
                self.mate_start[idx] if self.mate_start is not None else None
            ),
            tlen=self.tlen[idx] if self.tlen is not None else None,
        )

    def compact(self) -> "ColumnarReads":
        """Materialize a self-contained copy: cumulative offsets with the
        ragged data trimmed to this slice. Use before pickling/shipping a
        filtered view (which otherwise shares the parent's full arrays)."""
        if self.seq_end is None:
            return self

        def gather(s, e, *datas):
            lengths = (e - s).astype(np.int64)
            off = np.zeros(self.n + 1, dtype=np.int64)
            np.cumsum(lengths, out=off[1:])
            total = int(off[-1])
            if total == 0:
                return (off,) + tuple(d[:0] for d in datas)
            gidx = (
                np.repeat(s, lengths)
                + np.arange(total, dtype=np.int64)
                - np.repeat(off[:-1], lengths)
            )
            return (off,) + tuple(d[gidx] for d in datas)

        seq_off, seq, qual = gather(
            self.seq_off, self.seq_end, self.seq, self.qual
        )
        cigar_off, cigar_len, cigar_op = gather(
            self.cigar_off, self.cigar_end, self.cigar_len, self.cigar_op
        )
        md_off, md_text = gather(self.md_off, self.md_end, self.md_text)
        ev_off, ev_kind, ev_base, ev_qual, ev_mdref = gather(
            self.ev_off, self.ev_end,
            self.ev_kind, self.ev_base, self.ev_qual, self.ev_mdref,
        )
        # Trim the special payload blob to this slice's entries too.
        sp_lens = self.sp_payload_len
        sp_off = np.zeros(len(sp_lens) + 1, dtype=np.int64)
        np.cumsum(sp_lens, out=sp_off[1:])
        payload = np.concatenate(
            [
                self.special_payload[
                    self.sp_payload_offset[i] : self.sp_payload_offset[i]
                    + sp_lens[i]
                ]
                for i in range(len(sp_lens))
            ]
        ) if len(sp_lens) else self.special_payload[:0]
        from dataclasses import replace

        return replace(
            self,
            seq_off=seq_off, seq=seq, qual=qual,
            cigar_off=cigar_off, cigar_len=cigar_len, cigar_op=cigar_op,
            md_off=md_off, md_text=md_text,
            ev_off=ev_off, ev_kind=ev_kind, ev_base=ev_base,
            ev_qual=ev_qual, ev_mdref=ev_mdref,
            sp_payload_offset=sp_off[:-1], special_payload=payload,
            seq_end=None, cigar_end=None, md_end=None, ev_end=None,
        )

    def to_mapped_read(self, i: int, token: int = 0) -> MappedRead:
        """Materialize one read as an object (for exact host paths)."""
        cig_s, cig_e = self._span(self.cigar_off, self.cigar_end, i)
        elements = [
            CigarElement(int(l), int(o))
            for l, o in zip(
                self.cigar_len[cig_s:cig_e], self.cigar_op[cig_s:cig_e]
            )
        ]
        cigar = Cigar(elements)
        md_s, md_e = self._span(self.md_off, self.md_end, i)
        md_slice = self.md_text[md_s:md_e]
        mdtag = (
            MdTag(bytes(md_slice).decode(), int(self.start[i]), cigar)
            if len(md_slice)
            else None
        )
        f = int(self.flags_[i])
        seq_s, seq_e = self._span(self.seq_off, self.seq_end, i)
        return MappedRead(
            token=token,
            sequence=bytes(self.seq[seq_s:seq_e]),
            base_qualities=bytes(self.qual[seq_s:seq_e]),
            is_duplicate=bool(f & flags.DUPLICATE),
            sample_name=self.samples[int(self.sample_id[i])],
            reference_contig=self.ref_names[int(self.ref_id[i])],
            alignment_quality=int(self.mapq[i]),
            start=int(self.start[i]),
            cigar=cigar,
            mdtag=mdtag,
            failed_vendor_quality_checks=bool(f & flags.VENDOR_FAILED),
            is_positive_strand=not (f & flags.REVERSE),
            is_paired=bool(f & flags.PAIRED),
        )


def filter_columnar(
    cols: ColumnarReads,
    loci_set=None,
    non_duplicate: bool = False,
    passed_vendor_quality_checks: bool = False,
    has_mdtag: bool = False,
) -> ColumnarReads:
    """Vectorized InputFilters over columnar reads (cf. the object-path
    filters in gio/load.py)."""
    mask = np.ones(cols.n, dtype=bool)
    if loci_set is not None:
        mask &= cols.is_mapped_mask
        overlap = np.zeros(cols.n, dtype=bool)
        for contig_id, contig in enumerate(cols.ref_names):
            contig_mask = mask & (cols.ref_id == contig_id)
            if not contig_mask.any():
                continue
            contig_loci = loci_set.on_contig(contig)
            if contig_loci.is_empty:
                continue
            idx = np.flatnonzero(contig_mask)
            starts = cols.start[idx]
            ends = cols.end[idx]
            lo = np.searchsorted(contig_loci.ends, starts, side="right")
            hi = np.searchsorted(contig_loci.starts, ends, side="left")
            overlap[idx] = (hi > lo) & (ends > starts)
        mask &= overlap
    else:
        mask &= cols.is_mapped_mask
    if non_duplicate:
        mask &= (cols.flags_ & flags.DUPLICATE) == 0
    if passed_vendor_quality_checks:
        mask &= (cols.flags_ & flags.VENDOR_FAILED) == 0
    if has_mdtag:
        mask &= cols.md_lengths > 0
    return cols.select(mask)


def native_available() -> bool:
    from guacamole_tpu_torch.runtime.native import load_library

    return load_library() is not None


def decode_bam_columnar(
    path: str, threads: int = 0, chunks=None
) -> Optional[ColumnarReads]:
    """Decode a BAM into ColumnarReads with the native runtime (None if the
    native library is unavailable). chunks: optional BGZF virtual-offset
    ranges from a .bai query (region pushdown)."""
    from guacamole_tpu_torch.runtime.native import decode_bam_native

    raw = decode_bam_native(path, threads, chunks=chunks)
    return _columnar_from_raw(raw)


def decode_sam_columnar(path: str, threads: int = 0) -> Optional[ColumnarReads]:
    """Decode a SAM text file into ColumnarReads with the native runtime
    (None if unavailable) — the text-format twin of decode_bam_columnar,
    sharing the BAM decoder's event-building code."""
    from guacamole_tpu_torch.runtime.native import decode_sam_native

    raw = decode_sam_native(path, threads)
    return _columnar_from_raw(raw)


def _columnar_from_raw(raw) -> Optional[ColumnarReads]:
    if raw is None:
        return None
    return ColumnarReads(
        ref_names=raw["ref_names"],
        ref_lengths=raw["ref_lengths"],
        samples=raw["samples"] or ["default"],
        ref_id=raw["ref_id"],
        start=raw["start"],
        end=raw["end"],
        mapq=raw["mapq"],
        flags_=raw["flags"],
        mismatches=raw["mismatches"],
        sample_id=raw["sample_id"],
        seq_off=raw["seq_off"],
        seq=raw["seq"],
        qual=raw["qual"],
        cigar_off=raw["cigar_off"],
        cigar_len=raw["cigar_len"],
        cigar_op=raw["cigar_op"],
        md_off=raw["md_off"],
        md_text=raw["md_text"],
        ev_off=raw["ev_off"],
        ev_kind=raw["ev_kind"],
        ev_base=raw["ev_base"],
        ev_qual=raw["ev_qual"],
        ev_mdref=raw["ev_mdref"],
        sp_read=raw["sp_read"],
        sp_offset=raw["sp_offset"],
        sp_kind=raw["sp_kind"],
        sp_payload_offset=raw["sp_payload_offset"],
        sp_payload_len=raw["sp_payload_len"],
        sp_qual=raw["sp_qual"],
        special_payload=raw["special_payload"],
        mate_ref_id=raw.get("mate_ref_id"),
        mate_start=raw.get("mate_start"),
        tlen=raw.get("tlen"),
    )


def columnar_from_reads(
    reads: Sequence[MappedRead], native: bool = False
) -> ColumnarReads:
    """Build ColumnarReads from read objects.

    native=False (default) computes the event arrays in Python — this is
    the cross-check oracle for the native decoder and must stay pure.
    native=True assembles the cheap seq/qual/cigar/MD columns here and
    fills the expensive event arrays with the native runtime
    (guac_build_events — the same C++ the BAM decoder runs), the
    production ingest path for SAM / object-loaded reads; falls back to
    the Python form when the library is unavailable. The two forms are
    bit-identical (tests/test_runtime.py::test_build_events_native_matches_oracle).
    """
    if native:
        from guacamole_tpu_torch.runtime.native import load_library

        lib = load_library()
        native = lib is not None and hasattr(lib, "guac_build_events")

    from guacamole_tpu_torch.pack.fast import read_event_arrays

    ref_names: List[str] = []
    ref_index: Dict[str, int] = {}
    samples: List[str] = []
    sample_index: Dict[str, int] = {}

    n = len(reads)
    ref_id = np.zeros(n, dtype=np.int32)
    start = np.zeros(n, dtype=np.int64)
    end = np.zeros(n, dtype=np.int64)
    mapq = np.zeros(n, dtype=np.int32)
    flags_arr = np.zeros(n, dtype=np.uint16)
    mismatches = np.zeros(n, dtype=np.int32)
    sample_id = np.zeros(n, dtype=np.int32)
    seq_off = np.zeros(n + 1, dtype=np.int64)
    cigar_off = np.zeros(n + 1, dtype=np.int64)
    md_off = np.zeros(n + 1, dtype=np.int64)
    ev_off = np.zeros(n + 1, dtype=np.int64)
    seqs, quals, clens, cops, mds = [], [], [], [], []
    ev_kind, ev_base, ev_qual, ev_mdref = [], [], [], []
    sp_read, sp_offset, sp_kind, sp_poff, sp_plen, sp_qual = (
        [], [], [], [], [], [],
    )
    payload = bytearray()

    for i, read in enumerate(reads):
        contig = read.reference_contig
        if contig not in ref_index:
            ref_index[contig] = len(ref_names)
            ref_names.append(contig)
        sample = read.sample_name or "default"
        if sample not in sample_index:
            sample_index[sample] = len(samples)
            samples.append(sample)
        ref_id[i] = ref_index[contig]
        start[i] = read.start
        end[i] = read.end
        mapq[i] = read.alignment_quality
        f = 0
        if read.is_paired:
            f |= flags.PAIRED
        if not read.is_positive_strand:
            f |= flags.REVERSE
        if read.is_duplicate:
            f |= flags.DUPLICATE
        if read.failed_vendor_quality_checks:
            f |= flags.VENDOR_FAILED
        flags_arr[i] = f
        # 0 for cigar-inconsistent reads: the native decoders only count
        # mismatches via MD expansion on consistent reads (such reads pack
        # all-CLIPPED events and never reach a pileup, so the count is
        # unused either way)
        mismatches[i] = (
            read.mdtag.count_of_mismatches
            if read.mdtag and read.cigar.read_length == len(read.sequence)
            else 0
        )
        sample_id[i] = sample_index[sample]
        seqs.append(np.frombuffer(read.sequence, dtype=np.uint8))
        quals.append(np.frombuffer(read.base_qualities, dtype=np.uint8))
        seq_off[i + 1] = seq_off[i] + len(read.sequence)
        clens.append(
            np.array([e.length for e in read.cigar], dtype=np.uint32)
        )
        cops.append(np.array([e.op for e in read.cigar], dtype=np.uint8))
        cigar_off[i + 1] = cigar_off[i] + len(read.cigar)
        md = read.mdtag.tag.encode() if read.mdtag else b""
        mds.append(np.frombuffer(md, dtype=np.uint8))
        md_off[i + 1] = md_off[i] + len(md)
        span = read.end - read.start
        if native:
            pass  # events filled natively after the loop
        elif read.cigar.read_length == len(read.sequence):
            ev = read_event_arrays(read)
            ev_kind.append(ev.kinds)
            ev_base.append(ev.bases)
            ev_qual.append(ev.quals.astype(np.uint8))
            ev_mdref.append(ev.md_ref)
            for off, (kind, pl, q) in sorted(ev.specials.items()):
                sp_read.append(i)
                sp_offset.append(off)
                sp_kind.append(kind)
                sp_poff.append(len(payload))
                sp_plen.append(len(pl))
                sp_qual.append(q)
                payload.extend(pl)
        else:
            ev_kind.append(
                np.full(span, int(EventKind.CLIPPED), dtype=np.uint8)
            )
            ev_base.append(np.zeros(span, dtype=np.uint8))
            ev_qual.append(
                np.full(span, read.alignment_quality, dtype=np.uint8)
            )
            ev_mdref.append(np.full(span, ord("N"), dtype=np.uint8))
        ev_off[i + 1] = ev_off[i] + span

    def cat(parts, dtype):
        return (
            np.concatenate(parts).astype(dtype)
            if parts
            else np.empty(0, dtype=dtype)
        )

    if native:
        from guacamole_tpu_torch.runtime.native import build_events_native

        seq_cat = cat(seqs, np.uint8)
        qual_cat = cat(quals, np.uint8)
        clen_cat = cat(clens, np.uint32)
        cop_cat = cat(cops, np.uint8)
        md_cat = cat(mds, np.uint8)
        ev = build_events_native(
            start, mapq, seq_off, seq_cat, qual_cat, cigar_off, clen_cat,
            cop_cat, md_off, md_cat, ev_off,
        )
        if ev is None:  # library raced away: recompute in Python
            return columnar_from_reads(reads, native=False)
        return ColumnarReads(
            ref_names=ref_names,
            ref_lengths=[0] * len(ref_names),
            samples=samples or ["default"],
            ref_id=ref_id,
            start=start,
            end=end,
            mapq=mapq,
            flags_=flags_arr,
            mismatches=ev["mismatches"],
            sample_id=sample_id,
            seq_off=seq_off,
            seq=seq_cat,
            qual=qual_cat,
            cigar_off=cigar_off,
            cigar_len=clen_cat,
            cigar_op=cop_cat,
            md_off=md_off,
            md_text=md_cat,
            ev_off=ev_off,
            ev_kind=ev["ev_kind"],
            ev_base=ev["ev_base"],
            ev_qual=ev["ev_qual"],
            ev_mdref=ev["ev_mdref"],
            sp_read=ev["sp_read"],
            sp_offset=ev["sp_offset"],
            sp_kind=ev["sp_kind"],
            sp_payload_offset=ev["sp_payload_offset"],
            sp_payload_len=ev["sp_payload_len"],
            sp_qual=ev["sp_qual"],
            special_payload=ev["special_payload"],
        )

    return ColumnarReads(
        ref_names=ref_names,
        ref_lengths=[0] * len(ref_names),
        samples=samples or ["default"],
        ref_id=ref_id,
        start=start,
        end=end,
        mapq=mapq,
        flags_=flags_arr,
        mismatches=mismatches,
        sample_id=sample_id,
        seq_off=seq_off,
        seq=cat(seqs, np.uint8),
        qual=cat(quals, np.uint8),
        cigar_off=cigar_off,
        cigar_len=cat(clens, np.uint32),
        cigar_op=cat(cops, np.uint8),
        md_off=md_off,
        md_text=cat(mds, np.uint8),
        ev_off=ev_off,
        ev_kind=cat(ev_kind, np.uint8),
        ev_base=cat(ev_base, np.uint8),
        ev_qual=cat(ev_qual, np.uint8),
        ev_mdref=cat(ev_mdref, np.uint8),
        sp_read=np.array(sp_read, dtype=np.int64),
        sp_offset=np.array(sp_offset, dtype=np.int64),
        sp_kind=np.array(sp_kind, dtype=np.int32),
        sp_payload_offset=np.array(sp_poff, dtype=np.int64),
        sp_payload_len=np.array(sp_plen, dtype=np.int64),
        sp_qual=np.array(sp_qual, dtype=np.int32),
        special_payload=np.frombuffer(bytes(payload), dtype=np.uint8),
    )
