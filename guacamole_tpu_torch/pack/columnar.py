"""Columnar tile packer: ColumnarReads -> LocusTile with zero per-read
Python work.

The flat element table is built with pure numpy gathers over the decoder's
event arrays (native C++ or Python fallback), then finished by the shared
tile-assembly stage. This is the production packing path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from guacamole_tpu_torch.pack.fast import (
    K_DELETION,
    K_INSERTION,
    _empty_tile,
    _finish_tile,
)
from guacamole_tpu_torch.pack.tiles import LocusTile, pad_tile_loci
from guacamole_tpu_torch.runtime.columnar import ColumnarReads
from guacamole_tpu_torch.utils import trace


def pack_tile_columnar(
    cols: ColumnarReads,
    contig_id: int,
    contig_name: str,
    loci: Sequence[int],
    max_alleles: int = 8,
    reference_genome=None,
    depth_pad: Optional[int] = None,
    sorted_by_start: bool = True,
    use_native: bool = True,
    l_pad: int = 0,
    fields: str = "full",
    min_mapq: int = 0,
    ll_screen_margin: float = 0.0,
    ll_screen_kind: int = 1,
    skip_nibbles: bool = False,
    ll_screen_min_phred: float = 0.0,
) -> LocusTile:
    """Pack one tile from columnar reads (must be sorted by start).

    Uses the C++ packer when available (identical output, cross-checked in
    tests); falls back to the numpy implementation below. l_pad > L pads the
    locus axis with sentinel rows in the native packer itself (equivalent to
    pad_tile_loci, without the Python-side copy).
    """
    if use_native:
        tile = _pack_tile_native(
            cols, contig_id, contig_name, loci, max_alleles,
            reference_genome, depth_pad, l_pad, fields, min_mapq,
            ll_screen_margin, ll_screen_kind, skip_nibbles,
            ll_screen_min_phred,
        )
        if tile is not None:
            return tile
    loci_arr = np.asarray(loci, dtype=np.int64)
    L = len(loci_arr)
    K = max_alleles
    if L == 0 or cols.n == 0:
        return _empty_tile(contig_name, loci_arr, K, depth_pad or 8)

    lo_bound = int(loci_arr[0])
    hi_bound = int(loci_arr[-1])

    window = cols.read_scan_window(contig_id, lo_bound, hi_bound)
    w_lo, w_hi = window if window is not None else (0, cols.n)
    on_contig = cols.ref_id[w_lo:w_hi] == contig_id
    overlaps = (
        on_contig
        & (cols.end[w_lo:w_hi] > lo_bound)
        & (cols.start[w_lo:w_hi] <= hi_bound)
    )
    sel = np.flatnonzero(overlaps) + w_lo
    if len(sel) == 0:
        return _empty_tile(contig_name, loci_arr, K, depth_pad or 8)

    # Within-locus element order must be read-start order (pileup parity);
    # stable-sort the selection by start (no-op for coordinate-sorted BAMs).
    sel = sel[np.argsort(cols.start[sel], kind="stable")]

    starts = cols.start[sel]
    ends = cols.end[sel]
    row_lo = np.searchsorted(loci_arr, starts, side="left")
    row_hi = np.searchsorted(loci_arr, ends, side="left")
    counts = (row_hi - row_lo).astype(np.int64)
    keep = counts > 0
    sel, starts, ends, row_lo, counts = (
        sel[keep], starts[keep], ends[keep], row_lo[keep], counts[keep],
    )
    total = int(counts.sum())
    if total == 0:
        return _empty_tile(contig_name, loci_arr, K, depth_pad or 8)

    # flat table: one row per (read, covered locus)
    sel_of_row = np.repeat(np.arange(len(sel), dtype=np.int64), counts)
    cum = np.zeros(len(sel) + 1, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])
    within = np.arange(total, dtype=np.int64) - cum[sel_of_row]
    locus_row = row_lo[sel_of_row] + within
    read_of_row = sel[sel_of_row]
    locus_vals = loci_arr[locus_row]
    ev_idx = cols.ev_off[read_of_row] + (locus_vals - cols.start[read_of_row])

    kind = cols.ev_kind[ev_idx]
    base = cols.ev_base[ev_idx]
    qual = cols.ev_qual[ev_idx].astype(np.int16)
    mdref = cols.ev_mdref[ev_idx]
    mapq = cols.mapq[read_of_row].astype(np.int16)
    strand = cols.is_positive_strand[read_of_row]
    mismatch = cols.mismatches[read_of_row].astype(np.int16)
    edge = np.where(
        strand,
        cols.end[read_of_row] - locus_vals,
        locus_vals - cols.start[read_of_row],
    ).astype(np.int32)
    readidx = read_of_row.astype(np.int32)

    # specials: map (read, offset) -> flat row via the global event index
    special_entries: List[Tuple[int, int, bytes, int]] = []
    if len(cols.sp_read):
        sp_ev = cols.ev_off[cols.sp_read] + cols.sp_offset
        order = np.argsort(ev_idx, kind="stable")
        sorted_ev = ev_idx[order]
        pos = np.searchsorted(sorted_ev, sp_ev)
        valid = (pos < total) & (
            sorted_ev[np.minimum(pos, total - 1)] == sp_ev
        )
        for j in np.flatnonzero(valid):
            flat_row = int(order[pos[j]])
            payload = bytes(
                cols.special_payload[
                    cols.sp_payload_offset[j] : cols.sp_payload_offset[j]
                    + cols.sp_payload_len[j]
                ]
            )
            skind = (
                K_INSERTION
                if cols.sp_kind[j] == K_INSERTION
                else K_DELETION
            )
            special_entries.append(
                (flat_row, skind, payload, int(cols.sp_qual[j]))
            )

    return _finish_tile(
        contig_name,
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
    )


def _pack_tile_native(
    cols, contig_id, contig_name, loci, max_alleles, reference_genome,
    depth_pad, l_pad=0, fields="full", min_mapq=0, ll_screen_margin=0.0,
    ll_screen_kind=1, skip_nibbles=False, ll_screen_min_phred=0.0,
) -> Optional[LocusTile]:
    from guacamole_tpu_torch.pack.fast import LazyAlleleTables
    from guacamole_tpu_torch.runtime.native import pack_tile_native
    from guacamole_tpu_torch.variants.allele import Allele

    ref_contig = (
        reference_genome.get_contig(contig_name)
        if reference_genome is not None
        else None
    )
    loci_arr = np.asarray(loci, dtype=np.int64)
    scan_window = (
        cols.read_scan_window(contig_id, int(loci_arr[0]), int(loci_arr[-1]))
        if len(loci_arr)
        else None
    )
    out = pack_tile_native(
        cols,
        contig_id,
        loci_arr,
        max_alleles,
        depth_pad=depth_pad or 0,
        l_pad=l_pad,
        ref_contig=ref_contig,
        scan_window=scan_window,
        mode=(
            {"full": 0, "screen": 1, "likelihood": 2, "likelihood_mapq": 3}[
                fields
            ]
            if max_alleles <= 15
            else 0
        ),
        min_mapq=min_mapq,
        ll_screen_margin=ll_screen_margin,
        ll_screen_kind=ll_screen_kind,
        skip_nibbles=skip_nibbles and fields == "screen",
        ll_screen_min_phred=ll_screen_min_phred,
    )
    if out is None:
        return None
    if fields.startswith("likelihood") and max_alleles <= 15:
        # Modes 2 and 3: the rows the packer's locus-major sweep filled.
        trace.count("pack.ll_sweep_rows", len(loci_arr))
    L, D, K = int(out["L"]), int(out["D"]), max_alleles
    if L > len(loci_arr):
        loci_arr = np.concatenate(
            [loci_arr, np.full(L - len(loci_arr), -1, dtype=np.int64)]
        )
    blob = bytes(out["key_blob"])
    ref_off = out["key_ref_off"]
    alt_off = out["key_alt_off"]
    key_alleles = [
        Allele(blob[ref_off[i] : alt_off[i]], blob[alt_off[i] : ref_off[i + 1]])
        for i in range(len(alt_off))
    ]
    alleles = LazyAlleleTables(
        key_alleles, out["uniq_key"], out["uniq_off"]
    )
    def grid(name, as_bool=False):
        # Screen-only tiles omit the per-element [L, D] tensors entirely.
        a = out[name]
        if a.size == 0 and L * D > 0:
            return None
        a = a.reshape(L, D)
        # Native uint8 0/1 flags reinterpret as bool without copying
        # (astype would copy megatile-sized arrays).
        return a.view(np.bool_) if as_bool else a

    return LocusTile(
        contig=contig_name,
        loci=loci_arr,
        ref_base=out["ref_base"],
        depth=out["depth"],
        allele_id=grid("allele_id"),
        qual=grid("qual"),
        mapq=grid("mapq"),
        strand=grid("strand", as_bool=True),
        mismatches=grid("mismatches"),
        edge_distance=grid("edge"),
        read_index=grid("read_index"),
        valid=grid("valid", as_bool=True),
        alleles=alleles,
        is_variant=out["is_variant"].reshape(L, K).view(np.bool_),
        is_standard_alt=out["is_standard_alt"].reshape(L, K).view(np.bool_),
        num_alleles=out["num_alleles"],
        overflow=out["overflow"].view(np.bool_),
        packed_nib=(
            out["packed_nib"].reshape(L, (D + 1) // 2)
            if out["packed_nib"].size
            else None
        ),
        d_pad=D,
        csr_nib=out["csr_nib"] if out["csr_off"].size else None,
        csr_off=out["csr_off"] if out["csr_off"].size else None,
        counts32=(
            out["counts"].reshape(L, K)
            if out.get("counts") is not None and out["counts"].size
            else None
        ),
        ll_candidates=(
            out["ll_candidates"].view(np.bool_)
            if out.get("ll_candidates") is not None
            and out["ll_candidates"].size
            else None
        ),
        ll_pack=(
            out["ll_pack"].reshape(L, D) if out["ll_pack"].size else None
        ),
        ll_pack8=(
            out["ll_pack8"].reshape(L, D)
            if out.get("ll_pack8") is not None and out["ll_pack8"].size
            else None
        ),
        ll_qvals=(
            out["ll_qvals"]
            if out.get("ll_qvals") is not None and out["ll_qvals"].size
            else None
        ),
        ll_mapq=(
            out["ll_mapq"].reshape(L, D) if out["ll_mapq"].size else None
        ),
        ll_min_mapq=min_mapq if fields.startswith("likelihood") else 0,
    )


def covered_loci(
    cols: ColumnarReads, contig_id: int, loci_ranges: Sequence[Tuple[int, int]]
) -> np.ndarray:
    """Loci from loci_ranges covered by >= 1 read, without materializing
    uncovered spans (interval intersection). Computed natively when the
    runtime library is available (identical output, pinned by
    tests/test_pack_columnar.py); numpy fallback below."""
    from guacamole_tpu_torch.runtime.native import covered_loci_native

    native = covered_loci_native(cols, contig_id, loci_ranges)
    if native is not None:
        return native
    mask = cols.ref_id == contig_id
    if not mask.any():
        return np.empty(0, dtype=np.int64)
    starts = cols.start[mask]
    ends = cols.end[mask]
    order = np.argsort(starts, kind="stable")
    starts = starts[order]
    ends = np.maximum.accumulate(ends[order])
    # Vectorized interval merge: a new merged interval begins wherever a
    # read starts past the running max end of everything before it.
    is_new = np.empty(len(starts), dtype=bool)
    is_new[0] = True
    np.greater(starts[1:], ends[:-1], out=is_new[1:])
    first = np.flatnonzero(is_new)
    last = np.r_[first[1:] - 1, len(starts) - 1]
    covered = list(zip(starts[first].tolist(), ends[last].tolist()))
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
    return (
        np.concatenate(pieces) if pieces else np.empty(0, dtype=np.int64)
    )


def pack_tiles_columnar(
    cols: ColumnarReads,
    contig_name: str,
    loci,
    tile_size: int = 4096,
    max_alleles: int = 8,
    reference_genome=None,
    skip_empty: bool = True,
    pad_to_tile_size: bool = True,
    fields: str = "full",
) -> List[LocusTile]:
    """Pack a contig's loci into tiles from columnar reads."""
    return list(
        iter_tiles_columnar(
            cols,
            contig_name,
            loci,
            tile_size=tile_size,
            max_alleles=max_alleles,
            reference_genome=reference_genome,
            skip_empty=skip_empty,
            pad_to_tile_size=pad_to_tile_size,
            fields=fields,
        )
    )


def _depth_per_locus(
    cols: ColumnarReads, contig_id: int, loci_arr: np.ndarray
) -> np.ndarray:
    """Read depth at each locus, by interval stabbing (no packing)."""
    mask = cols.ref_id == contig_id
    starts = np.sort(cols.start[mask])
    ends = np.sort(cols.end[mask])
    return (
        np.searchsorted(starts, loci_arr, side="right")
        - np.searchsorted(ends, loci_arr, side="right")
    ).astype(np.int64)


# Depth cap for fields="likelihood*" tiles: deeper rows take the exact
# host path (f32 row error at this depth is ~2e-6 * 16384 ~ 0.03, far
# inside the 0.5 screen margin).
LIKELIHOOD_DEPTH_CAP = 16384


def _bucket_rows(n: int) -> int:
    """Pad locus-axis lengths to quarter-power-of-two steps (>= 4096): a
    small compiled-shape set with at most ~12% padding."""
    b = 4096
    while b < n:
        b *= 2
    if b > 4096:
        half = b // 2
        for step in (1, 2, 3):
            cand = half + (half * step) // 4
            if cand >= n:
                return cand
    return b


# Auto-tile sizing (tile_size=0): one kernel launch covers as many loci as
# a memory budget allows. Megatiles amortize the per-call Python + ctypes +
# dispatch overhead (the round-3 host bottleneck: 2,200 x 4096-loci tiles
# cost ~6 ms each in per-tile overhead) AND make the device path
# latency-tolerant: O(1) transfers per region instead of thousands (the
# replacement for the reference's one-shuffle delivery,
# cf. reference .../DistributedUtil.scala:621-626).
MEGA_TILE_ROWS = 1 << 20
# Dense [L, D] likelihood tiles bound L so one tile's ll_pack stays
# within this cell budget (128 MB u16); the dispatch layer slabs the
# screen launches, so one pack call can still cover a whole region.
DENSE_TILE_CELLS = 64 << 20


def _auto_tile_size(n_loci: int, depth_pad: int, fields: str) -> int:
    if fields == "screen":
        # CSR tiles have no dense depth axis; the dispatch layer slabs
        # oversized blobs, so one tile can cover a whole region.
        return max(4096, min(MEGA_TILE_ROWS, _bucket_rows(n_loci)))
    # Dense [L, D] likelihood modes: megatile up to the cell budget —
    # the dispatch layer slabs the screen launches along rows, so the
    # genotype-likelihood kernels' per-slab intermediates stay bounded
    # (unbounded megatile launches measured 2x slower).
    cap = max(
        4096,
        min(MEGA_TILE_ROWS, DENSE_TILE_CELLS // max(depth_pad or 8, 1)),
    )
    return max(4096, min(cap, _bucket_rows(n_loci)))


def _depth_bucket(depth: np.ndarray) -> np.ndarray:
    """Bucket ceiling for each depth: 8, 16, 32, ... (powers of two; the
    compiled-shape set stays small while halving pile padding vs a x4
    ladder)."""
    bucket = np.full(len(depth), 8, dtype=np.int64)
    d = np.maximum(depth, 1)
    while True:
        over = d > bucket
        if not over.any():
            return bucket
        bucket[over] *= 2


def iter_tiles_columnar(
    cols: ColumnarReads,
    contig_name: str,
    loci,
    tile_size: int = 0,
    max_alleles: int = 8,
    reference_genome=None,
    skip_empty: bool = True,
    pad_to_tile_size: bool = True,
    depth_bucketing: bool = True,
    fields: str = "full",
    min_mapq: int = 0,
    ll_screen_margin: float = 0.0,
    ll_screen_kind: int = 1,
    skip_nibbles: bool = False,
    ll_screen_min_phred: float = 0.0,
):
    """Yield a contig's loci tiles one at a time (lazy pack_tiles_columnar).

    tile_size=0 (the production default) sizes tiles automatically:
    screen-mode tiles cover up to MEGA_TILE_ROWS loci per native pack
    call (the dispatch layer slabs oversized launches); dense
    likelihood modes keep the classic 4096 (their kernels materialize
    per-genotype intermediates, measured 2x slower on megatiles). The
    locus axis pads to quarter-power-of-two buckets so the
    compiled-shape set stays small.

    depth_bucketing groups loci by their depth's pad bucket before tiling,
    so a tile's [L, D] grid is sized for its own loci rather than the
    contig's maximum depth (the whole-tile D would otherwise be set by the
    deepest locus; most pileup cells would be padding)."""
    try:
        contig_id = cols.ref_names.index(contig_name)
    except ValueError:
        return
    loci_ranges = (
        loci.ranges if hasattr(loci, "ranges") else [(int(l), int(l) + 1) for l in loci]
    )
    if skip_empty:
        all_loci = covered_loci(cols, contig_id, loci_ranges)
    else:
        all_loci = (
            np.concatenate(
                [np.arange(s, e, dtype=np.int64) for s, e in loci_ranges]
            )
            if loci_ranges
            else np.empty(0, dtype=np.int64)
        )

    if fields == "screen":
        # CSR screen tiles have no depth axis: bucketing would only cost
        # a depth-histogram pass and split batched launches.
        depth_bucketing = False
    if depth_bucketing and len(all_loci):
        buckets = _depth_bucket(_depth_per_locus(cols, contig_id, all_loci))
        if fields.startswith("likelihood"):
            # Cap the likelihood screen's depth axis: rows deeper than the
            # cap overflow to the exact host path (keeping f32 summation
            # error far below the screen margin) instead of inflating the
            # dense [L, D] grid.
            buckets = np.minimum(buckets, LIKELIHOOD_DEPTH_CAP)
        # A bucket only gets its own tiles when it can fill at least one:
        # sub-tile buckets merge upward into the next deeper bucket, so
        # kernel dispatch count stays close to the unbucketed tiling.
        merge_floor = tile_size or 4096
        groups = []
        carry = np.empty(0, dtype=np.int64)
        uniq = [int(b) for b in np.unique(buckets)]
        for j, b in enumerate(uniq):
            group = np.concatenate([carry, all_loci[buckets == b]])
            if len(group) >= merge_floor or j == len(uniq) - 1:
                group.sort()
                groups.append((b, group))
                carry = np.empty(0, dtype=np.int64)
            else:
                carry = group
    else:
        groups = [(0, all_loci)]

    for depth_pad, group_loci in groups:
        eff = tile_size or _auto_tile_size(
            len(group_loci), depth_pad, fields
        )
        for i in range(0, len(group_loci), eff):
            chunk = group_loci[i : i + eff]
            # Partial tiles pad to a row bucket, not the full tile size —
            # a 10k-loci tail would otherwise pad (and screen) a million
            # sentinel rows.
            l_pad = (
                (eff if tile_size else min(eff, _bucket_rows(len(chunk))))
                if pad_to_tile_size
                else 0
            )
            tile = pack_tile_columnar(
                cols,
                contig_id,
                contig_name,
                chunk,
                max_alleles=max_alleles,
                reference_genome=reference_genome,
                depth_pad=depth_pad or None,
                l_pad=l_pad,
                fields=fields,
                min_mapq=min_mapq,
                ll_screen_margin=ll_screen_margin,
                ll_screen_kind=ll_screen_kind,
                skip_nibbles=skip_nibbles,
                ll_screen_min_phred=ll_screen_min_phred,
            )
            if pad_to_tile_size and tile.L < l_pad:
                tile = pad_tile_loci(tile, l_pad)
            yield tile
