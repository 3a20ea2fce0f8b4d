"""Vectorized tile packer.

Produces the same LocusTile as pack.tiles.pack_tile (validated
element-for-element in tests) but in O(elements) numpy operations instead of
Python loops — the host packing hot path feeding the device kernels.

Key idea: every pileup element's allele is mapped to a TILE-GLOBAL key rank
whose ordering matches Allele ordering; per-locus allele ids are then the
dense rank of key ranks within each locus, computed with one sort + unique.
Only insertion/deletion ANCHOR elements (1-2 per indel read) need Python
handling; matches, mismatches, mid-deletions and N-gap clips — the other
~99.9% — are pure array ops.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from guacamole_tpu_torch.pack.events import EventKind
from guacamole_tpu_torch.pack.tiles import LocusTile, _pad_depth
from guacamole_tpu_torch.reads.cigar import (
    OP_D,
    OP_EQ,
    OP_I,
    OP_M,
    OP_N,
    OP_P,
    OP_S,
    OP_X,
)
from guacamole_tpu_torch.reads.mdtag import get_reference
from guacamole_tpu_torch.reads.read import MappedRead
from guacamole_tpu_torch.utils import bases as Bases
from guacamole_tpu_torch.variants.allele import Allele

DEFAULT_MAX_ALLELES = 8

# element kinds in the packed event arrays
K_BASE = int(EventKind.BASE)
K_INSERTION = int(EventKind.INSERTION)
K_DELETION = int(EventKind.DELETION)
K_MID_DELETION = int(EventKind.MID_DELETION)
K_CLIPPED = int(EventKind.CLIPPED)


class LazyAlleleTables:
    """Per-locus sorted allele dictionaries, materialized per locus on
    demand (most loci are never inspected — only call candidates are)."""

    __slots__ = ("key_alleles", "uniq_key", "first_of_locus")

    def __init__(self, key_alleles, uniq_key, first_of_locus):
        self.key_alleles = key_alleles  # global sorted Allele list
        self.uniq_key = uniq_key  # [n_unique] key index per (locus, rank)
        self.first_of_locus = first_of_locus  # [L+1] offsets

    def __len__(self) -> int:
        return len(self.first_of_locus) - 1

    def __getitem__(self, li):
        if isinstance(li, slice):
            return [self[i] for i in range(*li.indices(len(self)))]
        lo = int(self.first_of_locus[li])
        hi = int(self.first_of_locus[li + 1])
        return [self.key_alleles[int(k)] for k in self.uniq_key[lo:hi]]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __add__(self, other):
        return _ConcatTables(self, other)

    def __eq__(self, other) -> bool:
        if len(self) != len(other):
            return False
        return all(self[i] == other[i] for i in range(len(self)))


class _ConcatTables:
    """Lazy concatenation of two per-locus table sequences (used when
    padding tiles: the pad side is a short list of empty tables)."""

    __slots__ = ("first", "second")

    def __init__(self, first, second):
        self.first = first
        self.second = second

    def __len__(self) -> int:
        return len(self.first) + len(self.second)

    def __getitem__(self, li):
        if isinstance(li, slice):
            return [self[i] for i in range(*li.indices(len(self)))]
        if li < 0:
            li += len(self)
        if li < len(self.first):
            return self.first[li]
        return self.second[li - len(self.first)]

    def __iter__(self):
        yield from self.first
        yield from self.second

    def __add__(self, other):
        return _ConcatTables(self, other)

    def __eq__(self, other) -> bool:
        if len(self) != len(other):
            return False
        return all(self[i] == other[i] for i in range(len(self)))


class ReadEventArrays:
    """Numpy form of a read's per-locus pileup events (see pack.events)."""

    __slots__ = ("read", "start", "kinds", "quals", "bases", "md_ref", "specials")

    def __init__(self, read, start, kinds, quals, bases, md_ref, specials):
        self.read = read
        self.start = start
        self.kinds = kinds  # uint8 [span]
        self.quals = quals  # int16 [span]
        self.bases = bases  # uint8 [span]
        self.md_ref = md_ref  # uint8 [span]
        self.specials = specials  # dict offset -> (kind, payload bytes, qual)


def read_event_arrays(read: MappedRead) -> ReadEventArrays:
    """Single vectorized CIGAR walk emitting per-locus event arrays."""
    span = read.end - read.start
    kinds = np.full(span, K_CLIPPED, dtype=np.uint8)
    quals = np.full(span, read.alignment_quality, dtype=np.int16)
    bases = np.zeros(span, dtype=np.uint8)
    if read.mdtag is not None:
        md_ref = np.frombuffer(
            get_reference(read.mdtag, read.sequence, read.cigar, True),
            dtype=np.uint8,
        ).copy()
        if len(md_ref) < span:  # pad for trailing padding ops
            md_ref = np.concatenate(
                [md_ref, np.full(span - len(md_ref), Bases.N, dtype=np.uint8)]
            )
    else:
        md_ref = np.full(span, Bases.N, dtype=np.uint8)
    specials: Dict[int, Tuple[int, bytes, int]] = {}

    seq = np.frombuffer(read.sequence, dtype=np.uint8)
    read_quals = np.frombuffer(read.base_qualities, dtype=np.uint8)
    elements = read.cigar.elements
    ref_offset = 0
    read_pos = 0
    contig_start_insertion = None

    for idx, elem in enumerate(elements):
        op = elem.op
        next_elem = elements[idx + 1] if idx + 1 < len(elements) else None
        n = elem.length
        if op in (OP_M, OP_EQ, OP_X):
            kinds[ref_offset : ref_offset + n] = K_BASE
            bases[ref_offset : ref_offset + n] = seq[read_pos : read_pos + n]
            quals[ref_offset : ref_offset + n] = read_quals[read_pos : read_pos + n]
            last = ref_offset + n - 1
            last_read_pos = read_pos + n - 1
            if next_elem is not None and next_elem.op == OP_I and op != OP_X:
                m = next_elem.length
                ins = bytes(read.sequence[last_read_pos : last_read_pos + m + 1])
                q = int(read_quals[last_read_pos : last_read_pos + m + 1].min())
                kinds[last] = K_INSERTION
                quals[last] = q
                bases[last] = 0
                specials[last] = (K_INSERTION, ins, q)
            elif next_elem is not None and next_elem.op == OP_D:
                # Deleted tail from MD; N placeholders when no MD tag.
                abs_locus = read.start + last
                deletions = read.mdtag.deletions if read.mdtag else {}
                tail = bytes(
                    deletions.get(abs_locus + 1 + t, ord("N"))
                    for t in range(next_elem.length)
                )
                q = int(read_quals[last_read_pos])
                kinds[last] = K_DELETION
                quals[last] = q
                bases[last] = 0
                specials[last] = (K_DELETION, tail, q)
            read_pos += n
            ref_offset += n
        elif op == OP_D:
            kinds[ref_offset : ref_offset + n] = K_MID_DELETION
            # md_ref holds the deleted reference bases here (N if no MD)
            ref_offset += n
        elif op in (OP_N, OP_P):
            ref_offset += n
        elif op == OP_I:
            if read.start + ref_offset == 0 and next_elem is not None and span > 0:
                ins = bytes(read.sequence[read_pos : read_pos + n + 1])
                q = int(read_quals[read_pos : read_pos + n + 1].min())
                contig_start_insertion = (ins, q)
            read_pos += n
        elif op == OP_S:
            read_pos += n

    if contig_start_insertion is not None:
        ins, q = contig_start_insertion
        kinds[0] = K_INSERTION
        quals[0] = q
        bases[0] = 0
        specials[0] = (K_INSERTION, ins, q)

    return ReadEventArrays(read, read.start, kinds, quals, bases, md_ref, specials)


def pack_tile_fast(
    reads: Sequence[MappedRead],
    contig: str,
    loci: Sequence[int],
    max_alleles: int = DEFAULT_MAX_ALLELES,
    reference_genome=None,
    depth_pad: Optional[int] = None,
) -> LocusTile:
    """Vectorized equivalent of pack_tile (same output contract)."""
    loci_arr = np.asarray(sorted(loci), dtype=np.int64)
    L = len(loci_arr)
    K = max_alleles

    if L == 0:
        return _empty_tile(contig, loci_arr, K, depth_pad or 8)

    lo_bound = int(loci_arr[0])
    hi_bound = int(loci_arr[-1])

    # ---- element table construction (one block of rows per read) ----
    rows_locus: List[np.ndarray] = []  # tile row index
    rows_kind: List[np.ndarray] = []
    rows_qual: List[np.ndarray] = []
    rows_base: List[np.ndarray] = []
    rows_mdref: List[np.ndarray] = []
    rows_mapq: List[np.ndarray] = []
    rows_strand: List[np.ndarray] = []
    rows_mismatch: List[np.ndarray] = []
    rows_edge: List[np.ndarray] = []
    rows_readidx: List[np.ndarray] = []
    special_entries: List[Tuple[int, int, bytes, int]] = []
    # (flat row offset, kind, payload, ref placeholder resolved later)
    total_rows = 0

    for read_i, read in enumerate(reads):
        if read.reference_contig != contig:
            continue
        if read.end <= lo_bound or read.start > hi_bound:
            continue
        if read.cigar.read_length != len(read.sequence):
            continue  # structurally inconsistent record
        ev = read_event_arrays(read)
        lo = int(np.searchsorted(loci_arr, read.start, side="left"))
        hi = int(np.searchsorted(loci_arr, read.end, side="left"))
        if hi <= lo:
            continue
        tile_rows = np.arange(lo, hi, dtype=np.int64)
        offsets = (loci_arr[lo:hi] - read.start).astype(np.int64)
        count = hi - lo
        rows_locus.append(tile_rows)
        rows_kind.append(ev.kinds[offsets])
        rows_qual.append(ev.quals[offsets])
        rows_base.append(ev.bases[offsets])
        rows_mdref.append(ev.md_ref[offsets])
        rows_mapq.append(
            np.full(count, read.alignment_quality, dtype=np.int16)
        )
        rows_strand.append(
            np.full(count, read.is_positive_strand, dtype=bool)
        )
        rows_mismatch.append(
            np.full(
                count,
                read.mdtag.count_of_mismatches if read.mdtag else 0,
                dtype=np.int16,
            )
        )
        if read.is_positive_strand:
            rows_edge.append((read.end - loci_arr[lo:hi]).astype(np.int32))
        else:
            rows_edge.append((loci_arr[lo:hi] - read.start).astype(np.int32))
        rows_readidx.append(np.full(count, read_i, dtype=np.int32))
        if ev.specials:
            offset_to_rowpos = {int(o): i for i, o in enumerate(offsets)}
            for off, (kind, payload, q) in ev.specials.items():
                pos = offset_to_rowpos.get(off)
                if pos is not None:
                    special_entries.append(
                        (total_rows + pos, kind, payload, q)
                    )
        total_rows += count

    if total_rows == 0:
        return _empty_tile(contig, loci_arr, K, depth_pad or 8)

    return _finish_tile(
        contig,
        loci_arr,
        K,
        depth_pad,
        reference_genome,
        np.concatenate(rows_locus),
        np.concatenate(rows_kind),
        np.concatenate(rows_qual),
        np.concatenate(rows_base),
        np.concatenate(rows_mdref),
        np.concatenate(rows_mapq),
        np.concatenate(rows_strand),
        np.concatenate(rows_mismatch),
        np.concatenate(rows_edge),
        np.concatenate(rows_readidx),
        special_entries,
    )


def _finish_tile(
    contig,
    loci_arr,
    K,
    depth_pad,
    reference_genome,
    locus_row,
    kind,
    qual,
    base,
    mdref,
    mapq,
    strand,
    mismatch,
    edge,
    readidx,
    special_entries,
):
    """Shared tile-assembly stage: flat element table -> LocusTile.

    special_entries: (pre-sort flat row index, kind, payload bytes, qual).
    """
    L = len(loci_arr)
    total_rows = len(locus_row)

    # Stable sort by locus keeps read order within each locus.
    order = np.argsort(locus_row, kind="stable")
    locus_row = locus_row[order]
    kind = kind[order]
    qual = qual[order]
    base = base[order]
    mdref = mdref[order]
    mapq = mapq[order]
    strand = strand[order]
    mismatch = mismatch[order]
    edge = edge[order]
    readidx = readidx[order]
    # Map original flat row -> sorted position for special entries.
    inv_order = np.empty_like(order)
    inv_order[order] = np.arange(len(order))

    # ---- depth, slots ----
    depth = np.bincount(locus_row, minlength=L).astype(np.int32)
    first_of_locus = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(depth, out=first_of_locus[1:])
    slot = np.arange(total_rows, dtype=np.int64) - first_of_locus[locus_row]

    # ---- per-locus reference base ----
    ref_base = np.full(L, Bases.N, dtype=np.uint8)
    if reference_genome is not None:
        contig_seq = np.frombuffer(
            reference_genome.get_contig(contig), dtype=np.uint8
        )
        ref_base = contig_seq[loci_arr]
    else:
        standard = Bases.IS_STANDARD_TABLE[mdref]
        if standard.any():
            locus_std, first_idx = np.unique(
                locus_row[standard], return_index=True
            )
            ref_base[locus_std] = mdref[standard][first_idx]

    # ---- allele keys ----
    # Global key table: bytes-pair alleles present in the tile, sorted so
    # rank order == Allele order. BASE alleles are (resolved_ref, base);
    # MID_DELETION are (md_ref_base, ''); CLIPPED is ('', ''); anchors from
    # special_entries.
    elem_ref = ref_base[locus_row]  # resolved reference base per element
    key_pairs: set = set()
    base_mask = kind == K_BASE
    if base_mask.any():
        codes = (
            elem_ref[base_mask].astype(np.uint16) * 256
            + base[base_mask].astype(np.uint16)
        )
        for code in np.unique(codes):
            key_pairs.add((bytes([code >> 8]), bytes([code & 0xFF])))
    mid_mask = kind == K_MID_DELETION
    if mid_mask.any():
        for b in np.unique(mdref[mid_mask]):
            key_pairs.add((bytes([b]), b""))
    clip_mask = kind == K_CLIPPED
    if clip_mask.any():
        key_pairs.add((b"", b""))
    resolved_specials: List[Tuple[int, Tuple[bytes, bytes], int]] = []
    for flat_row, skind, payload, q in special_entries:
        srow = int(inv_order[flat_row])
        rb = int(elem_ref[srow])
        if skind == K_INSERTION:
            pair = (payload[:1], payload)
        else:  # DELETION anchor
            ref_bytes = bytes([rb]) + payload
            pair = (ref_bytes, ref_bytes[:1])
        key_pairs.add(pair)
        resolved_specials.append((srow, pair, q))

    sorted_keys = sorted(key_pairs)
    key_rank = {pair: i for i, pair in enumerate(sorted_keys)}
    key_alleles = [Allele(r, a) for r, a in sorted_keys]
    key_is_variant = np.array([r != a for r, a in sorted_keys], dtype=bool)
    key_is_standard_alt = np.array(
        [all(Bases.IS_STANDARD_TABLE[b] for b in a) for _, a in sorted_keys],
        dtype=bool,
    )

    # per-element key rank
    elem_key = np.zeros(total_rows, dtype=np.int32)
    if base_mask.any():
        base_lookup = np.full(65536, -1, dtype=np.int32)
        for (r, a), rank in key_rank.items():
            if len(r) == 1 and len(a) == 1:
                base_lookup[r[0] * 256 + a[0]] = rank
        codes = (
            elem_ref[base_mask].astype(np.int32) * 256
            + base[base_mask].astype(np.int32)
        )
        elem_key[base_mask] = base_lookup[codes]
    if mid_mask.any():
        mid_lookup = np.full(256, -1, dtype=np.int32)
        for (r, a), rank in key_rank.items():
            if len(r) == 1 and len(a) == 0:
                mid_lookup[r[0]] = rank
        elem_key[mid_mask] = mid_lookup[mdref[mid_mask]]
    if clip_mask.any():
        elem_key[clip_mask] = key_rank[(b"", b"")]
    for srow, pair, _q in resolved_specials:
        elem_key[srow] = key_rank[pair]

    # ---- per-locus dense allele ids ----
    # combined sort key: (locus, key_rank); dense-rank within locus
    combined = locus_row * (len(sorted_keys) + 1) + elem_key
    uniq_combined, inverse = np.unique(combined, return_inverse=True)
    uniq_locus = (uniq_combined // (len(sorted_keys) + 1)).astype(np.int64)
    uniq_key = (uniq_combined % (len(sorted_keys) + 1)).astype(np.int64)
    num_alleles_full = np.bincount(uniq_locus, minlength=L)
    first_uniq_of_locus = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(num_alleles_full, out=first_uniq_of_locus[1:])
    allele_rank_within_locus = np.arange(len(uniq_combined)) - first_uniq_of_locus[
        uniq_locus
    ]
    elem_allele_id = allele_rank_within_locus[inverse]

    overflow = num_alleles_full > K
    num_alleles = np.minimum(num_alleles_full, K).astype(np.int16)

    # ---- scatter into [L, D] ----
    max_depth = int(depth.max()) if L else 0
    D = depth_pad if depth_pad is not None else _pad_depth(max(max_depth, 1))
    in_range = slot < D
    overflow |= np.bincount(
        locus_row[~in_range], minlength=L
    ).astype(bool) if (~in_range).any() else False

    li = locus_row[in_range]
    si = slot[in_range]
    allele_id = np.full((L, D), -1, dtype=np.int16)
    qual_a = np.zeros((L, D), dtype=np.int16)
    mapq_a = np.zeros((L, D), dtype=np.int16)
    strand_a = np.zeros((L, D), dtype=bool)
    mismatch_a = np.zeros((L, D), dtype=np.int16)
    edge_a = np.zeros((L, D), dtype=np.int32)
    readidx_a = np.full((L, D), -1, dtype=np.int32)
    valid_a = np.zeros((L, D), dtype=bool)

    elem_ids = elem_allele_id[in_range]
    capped = elem_ids < K
    allele_id[li[capped], si[capped]] = elem_ids[capped].astype(np.int16)
    # elements whose allele fell beyond the cap stay -1 but occupy a slot
    qual_a[li, si] = qual[in_range]
    mapq_a[li, si] = mapq[in_range]
    strand_a[li, si] = strand[in_range]
    mismatch_a[li, si] = mismatch[in_range]
    edge_a[li, si] = edge[in_range]
    readidx_a[li, si] = readidx[in_range]
    valid_a[li, si] = True
    # invalidate slots that exceeded the allele cap so kernels don't see them
    if (~capped).any():
        valid_a[li[~capped], si[~capped]] = False
        qual_a[li[~capped], si[~capped]] = 0
        mapq_a[li[~capped], si[~capped]] = 0
        strand_a[li[~capped], si[~capped]] = False
        mismatch_a[li[~capped], si[~capped]] = 0
        edge_a[li[~capped], si[~capped]] = 0
        readidx_a[li[~capped], si[~capped]] = -1

    # ---- per-locus allele tables (lazy) + vectorized variant flags ----
    alleles = LazyAlleleTables(key_alleles, uniq_key, first_uniq_of_locus)
    capped_ranks = allele_rank_within_locus < K
    iv_locus = uniq_locus[capped_ranks]
    iv_rank = allele_rank_within_locus[capped_ranks]
    iv_key = uniq_key[capped_ranks]
    is_variant = np.zeros((L, K), dtype=bool)
    is_standard_alt = np.zeros((L, K), dtype=bool)
    is_variant[iv_locus, iv_rank] = key_is_variant[iv_key]
    is_standard_alt[iv_locus, iv_rank] = key_is_standard_alt[iv_key]

    return LocusTile(
        contig=contig,
        loci=loci_arr,
        ref_base=ref_base,
        depth=depth,
        allele_id=allele_id,
        qual=qual_a,
        mapq=mapq_a,
        strand=strand_a,
        mismatches=mismatch_a,
        edge_distance=edge_a,
        read_index=readidx_a,
        valid=valid_a,
        alleles=alleles,
        is_variant=is_variant,
        is_standard_alt=is_standard_alt,
        num_alleles=num_alleles,
        overflow=np.asarray(overflow, dtype=bool),
    )


def _empty_tile(contig, loci_arr, K, D) -> LocusTile:
    L = len(loci_arr)
    return LocusTile(
        contig=contig,
        loci=loci_arr,
        ref_base=np.full(L, Bases.N, dtype=np.uint8),
        depth=np.zeros(L, dtype=np.int32),
        allele_id=np.full((L, D), -1, dtype=np.int16),
        qual=np.zeros((L, D), dtype=np.int16),
        mapq=np.zeros((L, D), dtype=np.int16),
        strand=np.zeros((L, D), dtype=bool),
        mismatches=np.zeros((L, D), dtype=np.int16),
        edge_distance=np.zeros((L, D), dtype=np.int32),
        read_index=np.full((L, D), -1, dtype=np.int32),
        valid=np.zeros((L, D), dtype=bool),
        alleles=[[] for _ in range(L)],
        is_variant=np.zeros((L, K), dtype=bool),
        is_standard_alt=np.zeros((L, K), dtype=bool),
        num_alleles=np.zeros(L, dtype=np.int16),
        overflow=np.zeros(L, dtype=bool),
    )
