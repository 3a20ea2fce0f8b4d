"""Pileup elements of a ReadSet, worked out from the generated reads alone.

An element is one read at one reference locus, with an allele (reference
bases, sequenced bases), as variant callers after Guacamole define them:

- a match or mismatch: (reference base, read base), quality the base's;
- an insertion, at its anchor (the last aligned base before it): (read base
  at the anchor, that base and the inserted bases), quality the least of
  those bases';
- a deletion, at its anchor: (reference base and the deleted bases,
  reference base), quality the anchor base's;
- inside a deletion: (reference base, nothing), quality the read's MAPQ.

Elements at one locus come in file order (the order of the reads). Plain
reads (one aligned block) are handled as arrays; reads with an indel, which
are few, one by one.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

BASES = b"ACGT"
_CODE = np.full(256, -1, dtype=np.int64)
_CODE[np.frombuffer(BASES, np.uint8)] = np.arange(4)

Allele = Tuple[bytes, bytes]


def base_code(seq: np.ndarray) -> np.ndarray:
    return _CODE[seq]


def indel_elements(rs, ref: np.ndarray):
    """Every element of the reads that carry an indel, as columns:
    (locus, read, allele code, special allele or None, qual, mapq). Base alleles have code 0..3 (the read base) and special None;
    indel alleles have code -1 and their (ref, alt) bytes."""
    rows = np.flatnonzero(rs.kind != 0)
    r = rs.seq.shape[1]
    j = np.arange(r, dtype=np.int64)[None, :]
    s = rs.start[rows, None]
    a = rs.anchor[rows, None].astype(np.int64)
    k = rs.ilen[rows, None].astype(np.int64)
    ins = (rs.kind[rows] == 1)[:, None]
    # Aligned bases: before the anchor, and after the indel (skipping the
    # inserted bases); their loci shift by the indel's length after it.
    before = j < a
    after = np.where(ins, j > a + k, j > a)
    locus = np.where(before, s + j, np.where(ins, s + j - k, s + j + k))
    take = before | after
    rr, cc = np.nonzero(take)
    b_loc = locus[rr, cc]
    b_read = rows[rr]
    b_code = _CODE[rs.seq[b_read, cc]]
    b_qual = rs.qual[b_read, cc].astype(np.int64)
    loci, reads, quals, mapqs, specials = [], [], [], [], []
    for t, row in enumerate(rows.tolist()):
        st, an, ln = int(rs.start[row]), int(rs.anchor[row]), int(rs.ilen[row])
        mq = int(rs.mapq[row])
        if rs.kind[row] == 1:
            bases = bytes(rs.seq[row, an: an + ln + 1])
            loci.append(st + an)
            reads.append(row)
            specials.append((bases[:1], bases))
            quals.append(int(rs.qual[row, an: an + ln + 1].min()))
            mapqs.append(mq)
        else:
            anchor = st + an
            deleted = bytes(ref[anchor: anchor + ln + 1])
            loci.append(anchor)
            reads.append(row)
            specials.append((deleted, deleted[:1]))
            quals.append(int(rs.qual[row, an]))
            mapqs.append(mq)
            for d in range(1, ln + 1):
                loci.append(anchor + d)
                reads.append(row)
                specials.append((deleted[d: d + 1], b""))
                quals.append(mq)
                mapqs.append(mq)
    n_b = len(b_loc)
    read_all = np.concatenate([b_read, np.asarray(reads, np.int64)])
    return (np.concatenate([b_loc, np.asarray(loci, np.int64)]),
            read_all,
            np.concatenate([b_code, np.full(len(loci), -1, np.int64)]),
            [None] * n_b + specials,
            np.concatenate([b_qual, np.asarray(quals, np.int64)]),
            rs.mapq[read_all].astype(np.int64))


def plain_block(rs, rows):
    """(rows, loci [n, R], base codes [n, R], quals [n, R]) of the given
    plain reads."""
    r = rs.seq.shape[1]
    cols = np.arange(r, dtype=np.int64)
    return (rows, rs.start[rows, None] + cols[None, :], _CODE[rs.seq[rows]],
            rs.qual[rows].astype(np.int64))


class Column:
    """The elements at one locus, in file order."""

    __slots__ = ("locus", "alleles", "quals", "mapqs")

    def __init__(self, locus, alleles, quals, mapqs):
        self.locus = locus
        self.alleles: List[Allele] = alleles
        self.quals = quals
        self.mapqs = mapqs


def columns_at(rs, ref: np.ndarray, loci: np.ndarray,
               indels=None) -> Dict[int, Column]:
    """The element columns at the given loci (ascending)."""
    loci = np.asarray(loci, dtype=np.int64)
    if indels is None:
        indels = indel_elements(rs, ref)
    r = rs.seq.shape[1]
    max_span = int(rs.ref_span.max()) if rs.n else r
    # Plain reads over each locus: starts in [locus - r + 1, locus].
    plain = rs.kind == 0
    lo = np.searchsorted(rs.start, loci - max_span + 1, side="left")
    hi = np.searchsorted(rs.start, loci, side="right")
    counts = hi - lo
    pair_locus = np.repeat(loci, counts)
    first = np.repeat(lo - np.concatenate([[0], np.cumsum(counts)[:-1]]),
                      counts)
    pair_read = first + np.arange(len(pair_locus))
    off = pair_locus - rs.start[pair_read]
    ok = plain[pair_read] & (off < r)
    pair_locus, pair_read, off = pair_locus[ok], pair_read[ok], off[ok]
    p_code = _CODE[rs.seq[pair_read, off]]
    p_qual = rs.qual[pair_read, off].astype(np.int64)
    # Indel reads' elements at these loci.
    i_loc, i_read, i_code, i_special, i_qual, i_mapq = indels
    sel = np.flatnonzero(np.isin(i_loc, loci))
    all_locus = np.concatenate([pair_locus, i_loc[sel]])
    all_read = np.concatenate([pair_read, i_read[sel]])
    order = np.lexsort((all_read, all_locus))
    n_plain = len(pair_locus)
    out: Dict[int, Column] = {}
    bounds = np.searchsorted(all_locus[order], loci)
    bounds = np.append(bounds, len(order))
    mapq = rs.mapq.astype(np.int64)
    for t, locus in enumerate(loci.tolist()):
        idx = order[bounds[t]: bounds[t + 1]]
        rb = ref[locus: locus + 1].tobytes()
        alleles, quals, mapqs = [], [], []
        for e in idx.tolist():
            if e < n_plain:
                alleles.append((rb, BASES[p_code[e]: p_code[e] + 1]))
                quals.append(int(p_qual[e]))
                read = int(pair_read[e])
                mapqs.append(int(mapq[read]))
            else:
                j = sel[e - n_plain]
                sp = i_special[j]
                if sp is None:
                    c = int(i_code[j])
                    sp = (rb, BASES[c: c + 1])
                alleles.append(sp)
                quals.append(int(i_qual[j]))
                mapqs.append(int(i_mapq[j]))
        out[locus] = Column(locus, alleles, np.asarray(quals, np.int64),
                            np.asarray(mapqs, np.int64))
    return out
