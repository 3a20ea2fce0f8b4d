"""Locus-tile packing: reads -> fixed-shape pileup tensors.

This layer replaces Pileup/PileupElement objects on the compute path.
For a tile of L loci the packer emits dense [L, D] arrays (D = padded max
depth, bucketed to powers of two so XLA sees few distinct shapes):

  allele_id[L, D]  per-element id into the per-locus allele dictionary
  qual[L, D]       element phred quality (insertion-min / deletion-anchor /
                   MAPQ rules already applied)
  mapq[L, D]       read mapping quality
  strand[L, D]     positive strand?
  mismatches[L,D]  read-level MD mismatch count
  valid[L, D]      slot occupied?

plus per-locus metadata: resolved reference base, true depth, sorted allele
dictionaries (host-side), variant flags, and overflow markers for loci whose
distinct-allele count exceeds K (handled exactly on host; the multi-allelic
filter caps K in practice, cf. reference .../PileupFilter.scala:29-44).

Elements appear in read-sorted order per locus — the same order the
reference's shuffle+sort delivers reads to pileups — so per-locus statistics
and tie-breaks are reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from guacamole_tpu_torch.pack.events import EventKind, event_allele, read_pileup_events
from guacamole_tpu_torch.reads.read import MappedRead
from guacamole_tpu_torch.utils import bases as Bases
from guacamole_tpu_torch.variants.allele import Allele

DEFAULT_MAX_ALLELES = 8


def _pad_depth(depth: int) -> int:
    """Bucket depths to powers of four (>=8) so a whole run sees only a
    couple of distinct XLA shapes."""
    d = 8
    while d < depth:
        d *= 4
    return d


@dataclass
class LocusTile:
    """Fixed-shape pileup tensors for a tile of loci on one contig."""

    contig: str
    loci: np.ndarray  # [L] int64 absolute loci (sorted, may be sparse)
    ref_base: np.ndarray  # [L] uint8 resolved reference base
    depth: np.ndarray  # [L] int32 true depth (may exceed D on overflow)
    allele_id: np.ndarray  # [L, D] int16, -1 = empty slot
    qual: np.ndarray  # [L, D] int16
    mapq: np.ndarray  # [L, D] int16
    strand: np.ndarray  # [L, D] bool
    mismatches: np.ndarray  # [L, D] int16
    edge_distance: np.ndarray  # [L, D] int32 distance from sequencing end
    read_index: np.ndarray  # [L, D] int32 index into the packed read list
    valid: np.ndarray  # [L, D] bool
    alleles: List[List[Allele]]  # per-locus sorted allele dictionary
    is_variant: np.ndarray  # [L, K] bool
    is_standard_alt: np.ndarray  # [L, K] bool (alt all standard bases)
    num_alleles: np.ndarray  # [L] int16
    overflow: np.ndarray  # [L] bool: > K distinct alleles at this locus
    # [L, ceil(D/2)] uint8, two 4-bit allele ids per byte (0xF = empty):
    # the device-transfer encoding for counting screens, emitted by the
    # native packer; None when packed in Python (dispatch packs on demand).
    packed_nib: Optional[np.ndarray] = None
    # Depth-axis size when the per-element [L, D] tensors are omitted
    # (fields="screen" tiles); ignored otherwise.
    d_pad: Optional[int] = None
    # CSR screen encoding (fields="screen"): row r's nibble-packed allele
    # ids occupy csr_nib bytes [csr_off[r], csr_off[r+1]); rows are
    # byte-aligned (odd-depth rows pad the final nibble with 0xF). No
    # depth padding, no depth cap.
    csr_nib: Optional[np.ndarray] = None  # [total_bytes] uint8
    csr_off: Optional[np.ndarray] = None  # [L+1] int32
    # Likelihood-screen encoding (fields="likelihood"): [L, D] uint16 of
    # allele_id | qual << 4 (0xFFFF = empty / MAPQ-filtered / beyond-cap),
    # consumed by the device genotype-likelihood screen.
    ll_pack: Optional[np.ndarray] = None
    # Qual-dictionary form (native packer, <= 16 distinct quals in the
    # tile): ONE byte per element — allele id | qual-index << 4, 0xFF
    # empty; ll_qvals[idx] is the phred value. Same candidate flags as
    # ll_pack (the kernels decode identical f32 qual values), half the
    # H2D / HBM-read volume.
    ll_pack8: Optional[np.ndarray] = None  # [L, D] uint8
    ll_qvals: Optional[np.ndarray] = None  # [n_quals <= 16] uint8
    # fields="likelihood_mapq" additionally: [L, D] uint8 per-element read
    # MAPQ, for alignment-included likelihoods (somatic tumor screen).
    ll_mapq: Optional[np.ndarray] = None
    # The MAPQ filter baked into ll_pack at pack time (screen launches
    # verify they request the same threshold).
    ll_min_mapq: int = 0
    # Screen-mode by-product of the native packer: [L, K] int32 counts
    # over the same elements csr_nib encodes. The host fallback screen
    # (no accelerator attached) thresholds these directly; the device
    # path ignores them.
    counts32: Optional[np.ndarray] = None
    # Host form of the germline likelihood screen (screen-mode pack with
    # ll_screen_margin > 0): [L] bool candidate flags, same factored rule
    # as ops/kernels.py::germline_screen_math in f64.
    ll_candidates: Optional[np.ndarray] = None

    @property
    def L(self) -> int:
        return len(self.loci)

    @property
    def D(self) -> int:
        if self.allele_id is not None:
            return self.allele_id.shape[1]
        return self.d_pad

    @property
    def K(self) -> int:
        return self.is_variant.shape[1]


def ref_match_allele_ids(tile: "LocusTile") -> np.ndarray:
    """[L] int32: per locus, the index within the allele dictionary of the
    reference-match allele (ref_base, ref_base), or -1 when absent.

    Vectorized over the tile's global key table for fast/native-packed
    tiles (LazyAlleleTables) so analytics tools never walk loci in Python;
    list-backed oracle tiles fall back to a per-locus search."""
    from guacamole_tpu_torch.pack.fast import LazyAlleleTables, _ConcatTables

    def run(tables, ref_base: np.ndarray) -> np.ndarray:
        n = len(tables)
        if isinstance(tables, _ConcatTables):
            n1 = len(tables.first)
            return np.concatenate(
                [
                    run(tables.first, ref_base[:n1]),
                    run(tables.second, ref_base[n1:]),
                ]
            )
        out = np.full(n, -1, dtype=np.int32)
        if isinstance(tables, LazyAlleleTables):
            key_alleles = tables.key_alleles
            first = np.asarray(tables.first_of_locus, dtype=np.int64)
            uniq_key = np.asarray(tables.uniq_key, dtype=np.int64)
            n_keys = len(key_alleles)
            is_match = np.zeros(n_keys, dtype=bool)
            key_base = np.zeros(n_keys, dtype=np.uint8)
            for i, al in enumerate(key_alleles):
                if len(al.ref_bases) == 1 and al.ref_bases == al.alt_bases:
                    is_match[i] = True
                    key_base[i] = al.ref_bases[0]
            if not is_match.any() or len(uniq_key) == 0:
                return out
            uniq_locus = np.repeat(
                np.arange(n, dtype=np.int64), np.diff(first[: n + 1])
            )
            rank = (
                np.arange(len(uniq_locus), dtype=np.int64) - first[uniq_locus]
            )
            hit = is_match[uniq_key[: len(uniq_locus)]] & (
                key_base[uniq_key[: len(uniq_locus)]] == ref_base[uniq_locus]
            )
            out[uniq_locus[hit]] = rank[hit].astype(np.int32)
            return out
        for li in range(n):
            rb = int(ref_base[li])
            ref_allele = Allele(bytes([rb]), bytes([rb]))
            try:
                out[li] = tables[li].index(ref_allele)
            except ValueError:
                pass
        return out

    return run(tile.alleles, np.asarray(tile.ref_base))


def pure_ref_allele_mask(tile: "LocusTile") -> np.ndarray:
    """[L, K] bool: dictionary entries that are "pure reference" — ref ==
    alt with a non-empty ref (exactly the oracle predicate on event
    alleles: matches qualify, the empty clipped allele does not).

    Unlike `ref_match_allele_ids` this does NOT require the match base to
    equal the tile's resolved ref_base: a read whose MD-implied reference
    base disagrees with the tile's ref_base still produced a (X, X) match
    allele, and the somatic candidate gate must treat it as reference
    support, same as the per-element oracle does."""
    from guacamole_tpu_torch.pack.fast import LazyAlleleTables, _ConcatTables

    K = tile.K

    def run(tables) -> np.ndarray:
        n = len(tables)
        if isinstance(tables, _ConcatTables):
            return np.concatenate([run(tables.first), run(tables.second)])
        out = np.zeros((n, K), dtype=bool)
        if isinstance(tables, LazyAlleleTables):
            key_alleles = tables.key_alleles
            first = np.asarray(tables.first_of_locus, dtype=np.int64)
            uniq_key = np.asarray(tables.uniq_key, dtype=np.int64)
            n_keys = len(key_alleles)
            is_match = np.zeros(n_keys, dtype=bool)
            for i, al in enumerate(key_alleles):
                if len(al.ref_bases) >= 1 and al.ref_bases == al.alt_bases:
                    is_match[i] = True
            if not is_match.any() or len(uniq_key) == 0:
                return out
            uniq_locus = np.repeat(
                np.arange(n, dtype=np.int64), np.diff(first[: n + 1])
            )
            rank = (
                np.arange(len(uniq_locus), dtype=np.int64) - first[uniq_locus]
            )
            hit = is_match[uniq_key[: len(uniq_locus)]] & (rank < K)
            out[uniq_locus[hit], rank[hit]] = True
            return out
        for li in range(n):
            for k, al in enumerate(tables[li]):
                if k >= K:
                    break
                if len(al.ref_bases) >= 1 and al.ref_bases == al.alt_bases:
                    out[li, k] = True
        return out

    return run(tile.alleles)


def pack_tile(
    reads: Sequence[MappedRead],
    contig: str,
    loci: Sequence[int],
    max_alleles: int = DEFAULT_MAX_ALLELES,
    reference_genome=None,
    depth_pad: Optional[int] = None,
) -> LocusTile:
    """Pack sorted reads into a LocusTile over the given loci.

    reads must be sorted by start; only reads overlapping the tile loci
    contribute. The reference base per locus comes from `reference_genome`
    when given, else the first read (in order) whose MD-reconstructed base is
    a standard base (parity with Pileup.referenceBaseAtLocus).
    """
    loci_arr = np.asarray(sorted(loci), dtype=np.int64)
    L = len(loci_arr)
    K = max_alleles

    # Collect per-locus element lists: (events, locus) in read order.
    per_locus_events: List[List] = [[] for _ in range(L)]
    if L > 0:
        lo_bound = int(loci_arr[0])
        hi_bound = int(loci_arr[-1])
        for read_i, read in enumerate(reads):
            if read.reference_contig != contig:
                continue
            if read.end <= lo_bound or read.start > hi_bound:
                continue
            if read.cigar.read_length != len(read.sequence):
                # Structurally inconsistent record (CIGAR consumes a
                # different number of read bases than SEQ provides); such
                # reads cannot be classified and are dropped defensively.
                continue
            events = read_pileup_events(read)
            # indices of tile loci covered by this read
            lo = int(np.searchsorted(loci_arr, read.start, side="left"))
            hi = int(np.searchsorted(loci_arr, read.end, side="left"))
            for li in range(lo, hi):
                per_locus_events[li].append((read_i, events))

    # Resolve reference bases.
    ref_base = np.full(L, Bases.N, dtype=np.uint8)
    for li in range(L):
        locus = int(loci_arr[li])
        if reference_genome is not None:
            ref_base[li] = reference_genome.get_reference_base(contig, locus)
            continue
        for _read_i, events in per_locus_events[li]:
            base = events.md_ref[locus - events.start]
            if Bases.IS_STANDARD_TABLE[base]:
                ref_base[li] = base
                break

    max_depth = max((len(e) for e in per_locus_events), default=0)
    D = depth_pad if depth_pad is not None else _pad_depth(max(max_depth, 1))

    allele_id = np.full((L, D), -1, dtype=np.int16)
    qual = np.zeros((L, D), dtype=np.int16)
    mapq = np.zeros((L, D), dtype=np.int16)
    strand = np.zeros((L, D), dtype=bool)
    mismatches = np.zeros((L, D), dtype=np.int16)
    edge_distance = np.zeros((L, D), dtype=np.int32)
    read_index = np.full((L, D), -1, dtype=np.int32)
    valid = np.zeros((L, D), dtype=bool)
    depth = np.zeros(L, dtype=np.int32)
    is_variant = np.zeros((L, K), dtype=bool)
    is_standard_alt = np.zeros((L, K), dtype=bool)
    num_alleles = np.zeros(L, dtype=np.int16)
    overflow = np.zeros(L, dtype=bool)
    allele_tables: List[List[Allele]] = []

    for li in range(L):
        locus = int(loci_arr[li])
        events_here = per_locus_events[li]
        depth[li] = len(events_here)
        rb = int(ref_base[li])
        # First pass: element alleles in read order.
        element_alleles = [
            event_allele(ev, locus, rb) for _ri, ev in events_here
        ]
        distinct = sorted(set(element_alleles))
        if len(distinct) > K:
            overflow[li] = True
            allele_tables.append(
                [Allele(r, a) for r, a in distinct]
            )
            # Still pack the first D elements with capped dictionary ids so
            # screening kernels see the locus; exact handling is host-side.
            distinct = distinct[:K]
        else:
            allele_tables.append([Allele(r, a) for r, a in distinct])
        index = {pair: i for i, pair in enumerate(distinct)}
        num_alleles[li] = len(distinct)
        for k, (r, a) in enumerate(distinct):
            is_variant[li, k] = r != a
            is_standard_alt[li, k] = all(Bases.IS_STANDARD_TABLE[b] for b in a)
        for slot, ((read_i, ev), pair) in enumerate(
            zip(events_here, element_alleles)
        ):
            if slot >= D:
                overflow[li] = True
                break
            aid = index.get(pair)
            if aid is None:
                continue  # beyond capped dictionary
            i = locus - ev.start
            read_index[li, slot] = read_i
            allele_id[li, slot] = aid
            qual[li, slot] = ev.quals[i]
            mapq[li, slot] = ev.read.alignment_quality
            strand[li, slot] = ev.read.is_positive_strand
            mismatches[li, slot] = (
                ev.read.mdtag.count_of_mismatches if ev.read.mdtag else 0
            )
            if ev.read.is_positive_strand:
                edge_distance[li, slot] = ev.read.end - locus
            else:
                edge_distance[li, slot] = locus - ev.read.start
            valid[li, slot] = True

    return LocusTile(
        contig=contig,
        loci=loci_arr,
        ref_base=ref_base,
        depth=depth,
        allele_id=allele_id,
        qual=qual,
        mapq=mapq,
        strand=strand,
        mismatches=mismatches,
        edge_distance=edge_distance,
        read_index=read_index,
        valid=valid,
        alleles=allele_tables,
        is_variant=is_variant,
        is_standard_alt=is_standard_alt,
        num_alleles=num_alleles,
        overflow=overflow,
    )


def pack_tiles(
    reads: Sequence[MappedRead],
    contig: str,
    loci,
    tile_size: int = 2048,
    max_alleles: int = DEFAULT_MAX_ALLELES,
    reference_genome=None,
    skip_empty: bool = True,
    use_fast: bool = True,
    pad_to_tile_size: bool = True,
) -> List[LocusTile]:
    """Pack a contig's loci (a SingleContigSet or iterable of ints) into
    tiles of at most tile_size loci.

    With skip_empty (the common-caller default), loci not covered by any
    read are dropped before tiling, so tiles stay dense over covered regions
    (the analog of skipEmpty fast-forwarding in SlidingWindow.scala:149-187).
    """
    contig_reads = [r for r in reads if r.reference_contig == contig]

    loci_ranges = (
        loci.ranges
        if hasattr(loci, "ranges")
        else _ranges_from_loci(sorted(loci))
    )

    if skip_empty:
        if not contig_reads:
            all_loci = np.empty(0, dtype=np.int64)
        else:
            # Intersect the loci ranges with the union of read intervals
            # WITHOUT materializing per-locus arrays over uncovered spans
            # (whole-genome loci sets are interval-compressed; keep them so).
            starts = np.fromiter(
                (r.start for r in contig_reads), dtype=np.int64
            )
            ends = np.fromiter((r.end for r in contig_reads), dtype=np.int64)
            order = np.argsort(starts, kind="stable")
            starts, ends = starts[order], np.maximum.accumulate(ends[order])
            # merged covered intervals
            covered: List[Tuple[int, int]] = []
            for s, e in zip(starts.tolist(), ends.tolist()):
                if covered and s <= covered[-1][1]:
                    covered[-1] = (covered[-1][0], max(covered[-1][1], e))
                else:
                    covered.append((s, e))
            pieces = []
            ci = 0
            for s, e in loci_ranges:
                while ci < len(covered) and covered[ci][1] <= s:
                    ci += 1
                cj = ci
                while cj < len(covered) and covered[cj][0] < e:
                    lo = max(s, covered[cj][0])
                    hi = min(e, covered[cj][1])
                    if hi > lo:
                        pieces.append(np.arange(lo, hi, dtype=np.int64))
                    cj += 1
            all_loci = (
                np.concatenate(pieces) if pieces else np.empty(0, dtype=np.int64)
            )
    else:
        all_loci = (
            np.concatenate(
                [np.arange(s, e, dtype=np.int64) for s, e in loci_ranges]
            )
            if loci_ranges
            else np.empty(0, dtype=np.int64)
        )

    from guacamole_tpu_torch.pack.fast import pack_tile_fast

    packer = pack_tile_fast if use_fast else pack_tile
    tiles = []
    for i in range(0, len(all_loci), tile_size):
        tile = packer(
            contig_reads,
            contig,
            all_loci[i : i + tile_size],
            max_alleles=max_alleles,
            reference_genome=reference_genome,
        )
        if pad_to_tile_size and tile.L < tile_size:
            tile = pad_tile_loci(tile, tile_size)
        tiles.append(tile)
    return tiles


def _ranges_from_loci(sorted_loci) -> List[Tuple[int, int]]:
    """Compress a sorted list of loci into half-open ranges."""
    ranges: List[Tuple[int, int]] = []
    for locus in sorted_loci:
        if ranges and locus == ranges[-1][1]:
            ranges[-1] = (ranges[-1][0], locus + 1)
        else:
            ranges.append((locus, locus + 1))
    return ranges


def pad_tile_loci(tile: LocusTile, target_l: int) -> LocusTile:
    """Pad a tile's locus axis to target_l with sentinel rows (locus -1,
    depth 0, all slots invalid) so every tile in a run has the same [L, D]
    shape per depth bucket — keeping the number of distinct XLA compilations
    small and fixed."""
    import dataclasses

    pad = target_l - tile.L
    if pad <= 0:
        return tile
    if tile.ll_pack is not None and tile.allele_id is None:
        # Likelihood-mode tiles: pad the screen encodings with empty rows.
        import dataclasses

        return dataclasses.replace(
            tile,
            loci=np.concatenate(
                [tile.loci, np.full(pad, -1, dtype=np.int64)]
            ),
            ref_base=np.concatenate(
                [tile.ref_base, np.zeros(pad, dtype=tile.ref_base.dtype)]
            ),
            depth=np.concatenate(
                [tile.depth, np.zeros(pad, dtype=tile.depth.dtype)]
            ),
            alleles=tile.alleles + [[] for _ in range(pad)],
            is_variant=np.concatenate(
                [tile.is_variant, np.zeros((pad, tile.K), dtype=bool)]
            ),
            is_standard_alt=np.concatenate(
                [tile.is_standard_alt, np.zeros((pad, tile.K), dtype=bool)]
            ),
            num_alleles=np.concatenate(
                [tile.num_alleles, np.zeros(pad, tile.num_alleles.dtype)]
            ),
            overflow=np.concatenate(
                [tile.overflow, np.zeros(pad, dtype=bool)]
            ),
            ll_pack=np.concatenate(
                [
                    tile.ll_pack,
                    np.full((pad, tile.ll_pack.shape[1]), 0xFFFF, np.uint16),
                ]
            ),
            ll_pack8=(
                None
                if tile.ll_pack8 is None
                else np.concatenate(
                    [
                        tile.ll_pack8,
                        np.full(
                            (pad, tile.ll_pack8.shape[1]), 0xFF, np.uint8
                        ),
                    ]
                )
            ),
            ll_mapq=(
                None
                if tile.ll_mapq is None
                else np.concatenate(
                    [
                        tile.ll_mapq,
                        np.zeros((pad, tile.ll_mapq.shape[1]), np.uint8),
                    ]
                )
            ),
        )
    if tile.csr_nib is not None:
        # Screen-mode CSR tiles: sentinel rows contribute zero bytes.
        import dataclasses

        off = np.asarray(tile.csr_off, dtype=np.int32)
        return dataclasses.replace(
            tile,
            loci=np.concatenate(
                [tile.loci, np.full(pad, -1, dtype=np.int64)]
            ),
            ref_base=np.concatenate(
                [tile.ref_base, np.zeros(pad, dtype=tile.ref_base.dtype)]
            ),
            depth=np.concatenate(
                [tile.depth, np.zeros(pad, dtype=tile.depth.dtype)]
            ),
            alleles=tile.alleles + [[] for _ in range(pad)],
            is_variant=np.concatenate(
                [tile.is_variant, np.zeros((pad, tile.K), dtype=bool)]
            ),
            is_standard_alt=np.concatenate(
                [tile.is_standard_alt, np.zeros((pad, tile.K), dtype=bool)]
            ),
            num_alleles=np.concatenate(
                [tile.num_alleles, np.zeros(pad, tile.num_alleles.dtype)]
            ),
            overflow=np.concatenate(
                [tile.overflow, np.zeros(pad, dtype=bool)]
            ),
            csr_off=np.concatenate(
                [off, np.full(pad, off[-1], dtype=np.int32)]
            ),
            counts32=(
                None
                if tile.counts32 is None
                else np.concatenate(
                    [
                        tile.counts32,
                        np.zeros((pad, tile.K), tile.counts32.dtype),
                    ]
                )
            ),
            ll_candidates=(
                None
                if tile.ll_candidates is None
                else np.concatenate(
                    [tile.ll_candidates, np.zeros(pad, dtype=bool)]
                )
            ),
        )

    def pad2(a):
        return np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], dtype=a.dtype)], axis=0
        )

    loci = np.concatenate([tile.loci, np.full(pad, -1, dtype=np.int64)])
    allele_id = np.concatenate(
        [tile.allele_id, np.full((pad, tile.D), -1, dtype=tile.allele_id.dtype)]
    )
    return dataclasses.replace(
        tile,
        loci=loci,
        ref_base=pad2(tile.ref_base),
        depth=pad2(tile.depth),
        allele_id=allele_id,
        qual=pad2(tile.qual),
        mapq=pad2(tile.mapq),
        strand=pad2(tile.strand),
        mismatches=pad2(tile.mismatches),
        edge_distance=pad2(tile.edge_distance),
        read_index=np.concatenate(
            [tile.read_index, np.full((pad, tile.D), -1, dtype=np.int32)]
        ),
        valid=pad2(tile.valid),
        alleles=tile.alleles + [[] for _ in range(pad)],
        is_variant=pad2(tile.is_variant),
        is_standard_alt=pad2(tile.is_standard_alt),
        num_alleles=pad2(tile.num_alleles),
        overflow=pad2(tile.overflow),
        packed_nib=(
            None
            if tile.packed_nib is None
            else np.concatenate(
                [
                    tile.packed_nib,
                    np.full(
                        (pad, tile.packed_nib.shape[1]), 0xFF, np.uint8
                    ),
                ]
            )
        ),
    )
