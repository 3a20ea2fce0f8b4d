"""Seeded samples for the benchmark: reads generated from a configuration,
written as a coordinate-sorted BAM with its .bai, with no SAM step.

A configuration (configs/<name>.json) says what to make: a germline sample
("germline": one BAM, `reads`) or a tumor/normal pair ("tumor_normal": two
BAMs, `tumor` and `normal`), over one contig, with the configuration's read
length, binned base qualities and the sequencing errors those qualities
imply, germline SNVs and small indels (het and hom), and for a pair somatic
SNVs in the tumor. Every
count is fixed by the configuration; the seed draws only positions, bases,
qualities and errors, so every seed asks the callers for the same amount of
work.

The reads stay in memory as columns (`ReadSet`); the reference reads those
columns, the program reads the BAM. `ensure_sample` writes the files once per
(configuration, seed, GENERATOR_VERSION) under a cache directory and makes
the columns again on later calls: generation is cheap next to BAM writing.

Rewritten from the port's utils/simulate.py (make_scale_fixture): the same
idea, with real read lengths and qualities, and records packed column-wise
into BGZF blocks compressed on all cores.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

GENERATOR_VERSION = 1

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# Transition partner of A, C, G, T (A<->G, C<->T).
_TRANSITION = np.array([2, 3, 0, 1], dtype=np.int64)
# Base byte -> 0..3 (anything else 0; only ACGT are ever generated).
_CODE = np.zeros(256, dtype=np.int64)
_CODE[BASES] = np.arange(4)

# Indels start at least this far from the ends of a read (an aligner clips
# them otherwise); a read that would carry one closer is not emitted.
INDEL_EDGE = 5

# CIGAR op codes (SAM spec 4.2): M, I, D.
OP_M, OP_I, OP_D = 0, 1, 2


@dataclass
class ReadSet:
    """The reads of one BAM, in file (coordinate) order."""

    name: str  # the sample name (@RG SM)
    start: np.ndarray  # [N] int64, 0-based reference start
    seq: np.ndarray  # [N, R] uint8 ASCII bases
    qual: np.ndarray  # [N, R] uint8 phred
    mapq: np.ndarray  # [N] uint8
    reverse: np.ndarray  # [N] bool
    # Indel reads: kind 0 none, 1 insertion, 2 deletion; `anchor` is the
    # read offset of the last base before the indel, `ilen` its length.
    kind: np.ndarray  # [N] int8
    anchor: np.ndarray  # [N] int16
    ilen: np.ndarray  # [N] int16

    @property
    def n(self) -> int:
        return len(self.start)

    @property
    def ref_span(self) -> np.ndarray:
        r = self.seq.shape[1]
        span = np.full(self.n, r, dtype=np.int64)
        span -= np.where(self.kind == 1, self.ilen, 0)
        span += np.where(self.kind == 2, self.ilen, 0)
        return span


@dataclass
class Sample:
    config: str
    seed: int
    contig: str
    reference: np.ndarray  # [C] uint8 ASCII
    reads: Dict[str, ReadSet]  # "reads", or "tumor" and "normal"
    truth: dict = field(default_factory=dict)

    @property
    def n_reads(self) -> Dict[str, int]:
        return {k: v.n for k, v in self.reads.items()}


def load_config(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


# --- variants -----------------------------------------------------------


@dataclass
class Variants:
    """Germline variants of one genome over one contig."""

    snv_pos: np.ndarray  # [n] int64
    snv_alt: np.ndarray  # [n] uint8
    snv_haps: np.ndarray  # [n, 2] bool: present on hap 0 / hap 1
    # Indels, anchored at the base before them: an insertion of `ins` after
    # anchor, or a deletion of del_len bases after anchor.
    indel_anchor: np.ndarray  # [m] int64, ascending
    indel_is_ins: np.ndarray  # [m] bool
    indel_len: np.ndarray  # [m] int64
    indel_ins: List[bytes]  # [m] inserted bases (b"" for deletions)
    indel_haps: np.ndarray  # [m, 2] bool


def _zygosity(rng, n: int, het_share: float) -> np.ndarray:
    """[n, 2] haplotype masks: a fixed count of hets (on one haplotype
    each, drawn) and homs (both)."""
    n_het = int(round(n * het_share))
    het = np.zeros(n, dtype=bool)
    het[rng.permutation(n)[:n_het]] = True
    hap1 = rng.random(n) < 0.5
    haps = np.ones((n, 2), dtype=bool)
    haps[het, 0] = ~hap1[het]
    haps[het, 1] = hap1[het]
    return haps


def plant_germline(rng, ref: np.ndarray, g: dict, read_len: int) -> Variants:
    c = len(ref)
    margin = 2 * read_len + 64
    n_snv = int(round(c * g["snv_per_kbp"] / 1000))
    n_indel = int(round(n_snv * g["indel_per_snv"]))
    max_len = int(g["indel_max_len"])
    spacing = 2 * (read_len + max_len)
    # Indels: a fixed count, each at least `spacing` from the next, so no
    # read holds two.
    slots = (c - 2 * margin) // spacing
    if n_indel > slots:
        raise ValueError(f"{n_indel} indels do not fit {c} bp at {spacing} bp")
    anchor = np.sort(rng.choice(slots, n_indel, replace=False)) * spacing
    anchor = margin + anchor + rng.integers(0, spacing - max_len - 2, n_indel)
    lens = np.minimum(rng.geometric(g["indel_len_p"], n_indel), max_len)
    is_ins = rng.random(n_indel) < g["insertion_share"]
    ins = [bytes(BASES[rng.integers(0, 4, int(k))]) if i else b""
           for i, k in zip(is_ins, lens)]
    # SNVs: a fixed count at distinct positions, none on an indel's anchor
    # or deleted bases.
    blocked = np.zeros(c, dtype=bool)
    blocked[:margin] = blocked[c - margin:] = True
    for a, k, i in zip(anchor, lens, is_ins):
        blocked[a: a + 1 + (0 if i else k)] = True
    free = np.flatnonzero(~blocked)
    pos = np.sort(rng.choice(free, n_snv, replace=False))
    ref_code = _CODE[ref[pos]]
    ti = rng.random(n_snv) < g["transition_share"]
    tv = (ref_code + rng.integers(1, 4, n_snv)) % 4
    tv = np.where(tv == _TRANSITION[ref_code], (tv + 1) % 4, tv)
    tv = np.where(tv == ref_code, (tv + 1) % 4, tv)
    alt = BASES[np.where(ti, _TRANSITION[ref_code], tv)]
    return Variants(
        snv_pos=pos.astype(np.int64),
        snv_alt=alt,
        snv_haps=_zygosity(rng, n_snv, g["het_share"]),
        indel_anchor=anchor.astype(np.int64),
        indel_is_ins=is_ins,
        indel_len=lens.astype(np.int64),
        indel_ins=ins,
        indel_haps=_zygosity(rng, n_indel, g["het_share"]),
    )


# --- reads --------------------------------------------------------------


def _haplotypes(ref: np.ndarray, v: Variants) -> List[np.ndarray]:
    """Each haplotype's bases in reference coordinates, SNVs applied (the
    indels are applied per read)."""
    haps = []
    for h in range(2):
        hap = ref.copy()
        on = v.snv_haps[:, h]
        hap[v.snv_pos[on]] = v.snv_alt[on]
        haps.append(hap)
    return haps


def _draw_quals(rng, shape, q: dict) -> np.ndarray:
    """Base qualities from the bins' shares, through a table of 2^16
    entries indexed by a random 16-bit draw."""
    values = np.asarray(q["bins"], dtype=np.uint8)
    cdf = np.cumsum(np.asarray(q["shares"], dtype=np.float64))
    cdf /= cdf[-1]
    table = values[np.searchsorted(cdf, (np.arange(1 << 16) + 0.5) / (1 << 16),
                                   side="right")]
    return np.take(table, rng.integers(0, 1 << 16, shape, dtype=np.uint16))


def _draw_mapq(rng, n: int, m: dict) -> np.ndarray:
    u = rng.random(n)
    out = np.full(n, m["high"], dtype=np.uint8)
    low = u < m["zero_share"]
    mid = (u >= m["zero_share"]) & (u < m["zero_share"] + m["mid_share"])
    out[low] = 0
    out[mid] = rng.integers(m["mid_range"][0], m["mid_range"][1] + 1,
                            int(mid.sum()))
    return out


def _errors(rng, seq: np.ndarray, qual: np.ndarray) -> None:
    """Sequencing errors in place: each base is wrong with the probability
    its quality states (a 32-bit draw under 10^(-q/10) * 2^32), and then
    one of the other three bases."""
    limit = np.floor(np.power(10.0, -np.arange(256) / 10.0) * 2.0**32)
    limit = np.minimum(limit, 2.0**32 - 1).astype(np.uint32)
    wrong = rng.integers(0, 1 << 32, seq.shape, dtype=np.uint32) < np.take(
        limit, qual)
    idx = np.nonzero(wrong)
    cur = _CODE[seq[idx]]
    seq[idx] = BASES[(cur + rng.integers(1, 4, len(cur))) % 4]


def simulate_reads(
    rng, name: str, ref: np.ndarray, v: Variants, starts: np.ndarray,
    read_len: int, g: dict, somatic: Tuple[np.ndarray, np.ndarray,
                                           np.ndarray] = None,
) -> ReadSet:
    """Reads at the given starts (drawn by the caller), each from a random
    haplotype; a read that would hold an indel within INDEL_EDGE of its
    ends, or start inside a deletion, is not emitted. somatic: (positions,
    alt bases, VAFs): each read over such a position carries its alt with
    probability VAF."""
    n = len(starts)
    starts = np.sort(starts)
    hap = rng.integers(0, 2, n)
    reverse = rng.random(n) < 0.5
    haps = _haplotypes(ref, v)
    c = len(ref)

    # Which read meets an indel of its haplotype: the first indel whose
    # anchor is at or after start - max_len (a deletion before the start
    # still covers it).
    max_len = int(v.indel_len.max()) if len(v.indel_len) else 0
    kind = np.zeros(n, dtype=np.int8)
    anchor_off = np.zeros(n, dtype=np.int16)
    ilen = np.zeros(n, dtype=np.int16)
    keep = np.ones(n, dtype=bool)
    which = np.full(n, -1, dtype=np.int64)
    if len(v.indel_anchor):
        j = np.searchsorted(v.indel_anchor, starts - max_len - 1, side="left")
        j = np.minimum(j, len(v.indel_anchor) - 1)
        a = v.indel_anchor[j]
        on_hap = v.indel_haps[j, hap]
        is_ins = v.indel_is_ins[j]
        k = v.indel_len[j]
        off = a - starts  # read offset of the anchor (plain coordinates)
        # Deletion: the read starts inside the deleted bases.
        inside_del = on_hap & ~is_ins & (starts > a) & (starts <= a + k)
        # The indel lies inside the read's span.
        ref_span = read_len - np.where(is_ins, k, 0)
        meets = on_hap & (off >= 0) & (off < ref_span - 1)
        after = read_len - (off + 1) - np.where(is_ins, k, 0)
        ok = (off >= INDEL_EDGE - 1) & (after >= INDEL_EDGE)
        keep &= ~inside_del & ~(meets & ~ok)
        has = meets & ok
        which[has] = j[has]
        kind[has] = np.where(is_ins[has], 1, 2)
        anchor_off[has] = off[has]
        ilen[has] = k[has]
    # A read must end inside the contig.
    span = read_len - np.where(kind == 1, ilen, 0) + np.where(kind == 2, ilen, 0)
    keep &= starts + span <= c
    starts, hap, reverse = starts[keep], hap[keep], reverse[keep]
    kind, anchor_off, ilen, which = (
        kind[keep], anchor_off[keep], ilen[keep], which[keep])
    n = len(starts)

    seq = np.empty((n, read_len), dtype=np.uint8)
    plain = np.flatnonzero(kind == 0)
    cols = np.arange(read_len, dtype=np.int64)
    chunk = 200_000
    both = np.concatenate(haps)
    for lo in range(0, len(plain), chunk):
        rows = plain[lo: lo + chunk]
        seq[rows] = np.take(both, (starts[rows] + hap[rows] * c)[:, None]
                            + cols[None, :])
    for r in np.flatnonzero(kind != 0):
        s, h, a = int(starts[r]), int(hap[r]), int(anchor_off[r])
        t = haps[h]
        j = int(which[r])
        if kind[r] == 1:
            ins = np.frombuffer(v.indel_ins[j], dtype=np.uint8)
            b = read_len - (a + 1) - len(ins)
            seq[r] = np.concatenate(
                [t[s: s + a + 1], ins, t[s + a + 1: s + a + 1 + b]])
        else:
            k = int(ilen[r])
            b = read_len - (a + 1)
            seq[r] = np.concatenate(
                [t[s: s + a + 1], t[s + a + 1 + k: s + a + 1 + k + b]])

    if somatic is not None and len(somatic[0]):
        spos, salt, svaf = somatic
        for p, b, f in zip(spos, salt, svaf):
            lo = np.searchsorted(starts, p - read_len + 1, side="left")
            hi = np.searchsorted(starts, p, side="right")
            rows = np.arange(lo, hi)
            # Somatic sites lie away from every indel: covering reads are
            # plain.
            rows = rows[kind[rows] == 0]
            take = rows[rng.random(len(rows)) < f]
            seq[take, p - starts[take]] = b

    qual = _draw_quals(rng, seq.shape, g["quality"])
    _errors(rng, seq, qual)
    mapq = _draw_mapq(rng, n, g["mapq"])
    return ReadSet(name, starts.astype(np.int64), seq, qual, mapq, reverse,
                   kind, anchor_off, ilen)


def make_sample(config: dict, seed: int) -> Sample:
    """The sample of `config` for `seed`, in memory."""
    rng = np.random.default_rng(np.random.SeedSequence(int(seed) % 2**64))
    g = config["genome"]
    read_len = int(g["read_length"])
    c = int(config["contig_length"])
    ref = BASES[rng.integers(0, 4, c)]
    v = plant_germline(rng, ref, g["germline"], read_len)
    truth = {"snv": int(len(v.snv_pos)), "indel": int(len(v.indel_anchor))}
    reads = {}
    if config["kind"] == "germline":
        n = int(round(c * config["depth"] / read_len))
        starts = rng.integers(0, c - read_len - 2 * int(v.indel_len.max()),
                              n)
        reads["reads"] = simulate_reads(rng, config["sample_names"]["reads"],
                                        ref, v, starts, read_len, g)
    elif config["kind"] == "tumor_normal":
        t = config["targets"]
        n_t = int(t["count"])
        width = int(t["width"])
        tstart = int(t["first"]) + np.arange(n_t, dtype=np.int64) * int(
            t["spacing"])
        # A read over a target starts anywhere from read_len - 1 before it
        # to its last base: on average it overlaps the target by
        # width * read_len / (width + read_len - 1) bases.
        window = width + read_len - 1
        overlap = width * read_len / window
        somatic = _plant_somatic(rng, ref, v, tstart, width, t, read_len)
        truth["somatic"] = int(len(somatic[0]))
        for which in ("tumor", "normal"):
            per_target = int(round(config["depth"][which] * width / overlap))
            starts = (tstart[:, None] - (read_len - 1)
                      + rng.integers(0, window, (n_t, per_target)))
            reads[which] = simulate_reads(
                rng, config["sample_names"][which], ref, v,
                starts.reshape(-1), read_len, g,
                somatic=somatic if which == "tumor" else None,
            )
    else:
        raise ValueError(f"unknown sample kind {config['kind']!r}")
    return Sample(config["name"], int(seed), config["contig"], ref, reads,
                  truth)


def _plant_somatic(rng, ref, v: Variants, tstart, width, t, read_len):
    """Somatic SNVs inside the targets, a fixed count, each at least one
    read length from every germline indel and SOMATIC_SNV_GAP from every
    germline SNV; VAFs drawn uniformly from t["somatic_vaf"]."""
    n = int(round(len(tstart) * width / 1000 * t["somatic_per_kbp"]))
    cand = (tstart[:, None] + np.arange(width)[None, :]).reshape(-1)
    ok = np.ones(len(cand), dtype=bool)
    for anchors, gap in ((v.indel_anchor, read_len + 16),
                         (v.snv_pos, t["somatic_snv_gap"])):
        if len(anchors):
            j = np.searchsorted(anchors, cand)
            for o in (-1, 0):
                k = np.clip(j + o, 0, len(anchors) - 1)
                ok &= np.abs(anchors[k] - cand) >= gap
    pos = np.sort(rng.choice(cand[ok], n, replace=False))
    code = _CODE[ref[pos]]
    alt = BASES[(code + rng.integers(1, 4, n)) % 4]
    vaf = rng.uniform(t["somatic_vaf"][0], t["somatic_vaf"][1], n)
    return pos.astype(np.int64), alt, vaf


# --- BAM ----------------------------------------------------------------

# 4-bit base codes, "=ACMGRSVTWYHKDBN" (SAM spec 4.2.3).
_SEQ_CODE = np.full(256, 15, dtype=np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    _SEQ_CODE[_b] = _i

BGZF_BLOCK = 65280
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_NAME_LEN = 11  # "r" + 9 digits + NUL


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """UCSC binning (SAM spec 5.3), vectorised over records."""
    e = end - 1
    out = np.zeros(len(beg), dtype=np.int64)
    done = np.zeros(len(beg), dtype=bool)
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        same = ~done & ((beg >> shift) == (e >> shift))
        out[same] = offset + (beg[same] >> shift)
        done |= same
    return out


_DIGITS = np.zeros((1000, 3), dtype=np.uint8)
_NDIG = np.zeros(1000, dtype=np.int64)
for _v in range(1000):
    _t = b"%d" % _v
    _DIGITS[_v, : len(_t)] = np.frombuffer(_t, np.uint8)
    _NDIG[_v] = len(_t)


def md_tags(rs: ReadSet, ref: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """MD:Z of every read against the reference, as a [N, W] byte matrix
    NUL-padded and each tag's length: runs of matches as numbers, a
    mismatch as its reference base, a deletion as ^ and its bases."""
    n, r = rs.seq.shape
    plain = np.flatnonzero(rs.kind == 0)
    cols = np.arange(r, dtype=np.int64)
    parts_r, parts_c, parts_b = [], [], []
    for lo in range(0, len(plain), 200_000):
        rows = plain[lo: lo + 200_000]
        refm = np.take(ref, rs.start[rows, None] + cols[None, :])
        rr, cc = np.nonzero(rs.seq[rows] != refm)
        parts_r.append(rows[rr])
        parts_c.append(cc)
        parts_b.append(refm[rr, cc])
    mr = np.concatenate(parts_r) if parts_r else np.zeros(0, np.int64)
    mc = np.concatenate(parts_c) if parts_c else np.zeros(0, np.int64)
    mb = np.concatenate(parts_b) if parts_b else np.zeros(0, np.uint8)
    # Tokens, in order within a read: each mismatch (a run, then the base)
    # and the final run.
    first = np.ones(len(mr), dtype=bool)
    first[1:] = mr[1:] != mr[:-1]
    prev_end = np.where(first, 0, np.concatenate([[0], mc[:-1] + 1]))
    run = mc - prev_end
    last_end = np.zeros(n, dtype=np.int64)
    last_end[mr] = mc + 1  # the last mismatch of a read wins
    tail = r - last_end
    tok_len = _NDIG[run] + 1
    md_len = _NDIG[tail].copy()
    np.add.at(md_len, mr, tok_len)
    width = int(md_len.max()) + 1
    out = np.zeros((n, width), dtype=np.uint8)
    # Offset of each mismatch token inside its read's tag.
    csum = np.cumsum(tok_len) - tok_len
    read_first = np.zeros(n, dtype=np.int64)
    starts_of_read = np.flatnonzero(first)
    read_first[mr[starts_of_read]] = csum[starts_of_read]
    off = csum - read_first[mr]
    for k in range(3):
        m = _NDIG[run] > k
        out[mr[m], off[m] + k] = _DIGITS[run[m], k]
    out[mr, off + _NDIG[run]] = mb
    tail_off = md_len - _NDIG[tail]
    rows = np.arange(n)
    for k in range(3):
        m = _NDIG[tail] > k
        out[rows[m], tail_off[m] + k] = _DIGITS[tail[m], k]
    for i in np.flatnonzero(rs.kind != 0):
        tag = _md_indel(rs, i, ref)
        if len(tag) >= out.shape[1]:
            out = np.pad(out, ((0, 0), (0, len(tag) + 1 - out.shape[1])))
        out[i] = 0
        out[i, : len(tag)] = np.frombuffer(tag, np.uint8)
        md_len[i] = len(tag)
    return out, md_len


def _md_indel(rs: ReadSet, i: int, ref: np.ndarray) -> bytes:
    s, a, k = int(rs.start[i]), int(rs.anchor[i]), int(rs.ilen[i])
    seq = rs.seq[i]
    if rs.kind[i] == 1:  # insertion: the read's M bases skip the inserted
        read_m = np.concatenate([seq[: a + 1], seq[a + 1 + k:]])
        segments = [(s, read_m)]
        deleted = None
    else:
        segments = [(s, seq[: a + 1]), (s + a + 1 + k, seq[a + 1:])]
        deleted = bytes(ref[s + a + 1: s + a + 1 + k])
    parts, run = [], 0
    for si, (rs0, bases) in enumerate(segments):
        if si == 1:
            parts.append(b"%d^%s" % (run, deleted))
            run = 0
        refm = ref[rs0: rs0 + len(bases)]
        for base, rb in zip(bases.tolist(), refm.tolist()):
            if base == rb:
                run += 1
            else:
                parts.append(b"%d%c" % (run, rb))
                run = 0
    parts.append(b"%d" % run)
    return b"".join(parts)


def _cigars(rs: ReadSet) -> Tuple[np.ndarray, np.ndarray]:
    """([N, 3] uint32 encoded ops, [N] op count)."""
    r = rs.seq.shape[1]
    n = rs.n
    ops = np.zeros((n, 3), dtype=np.uint32)
    n_ops = np.ones(n, dtype=np.int64)
    ops[:, 0] = (r << 4) | OP_M
    ind = rs.kind != 0
    a = rs.anchor[ind].astype(np.uint32) + 1
    k = rs.ilen[ind].astype(np.uint32)
    ins = rs.kind[ind] == 1
    b = np.where(ins, r - a - k, r - a).astype(np.uint32)
    ops[ind, 0] = (a << 4) | OP_M
    ops[ind, 1] = (k << 4) | np.where(ins, OP_I, OP_D).astype(np.uint32)
    ops[ind, 2] = (b << 4) | OP_M
    n_ops[ind] = 3
    return ops, n_ops


def bam_records(rs: ReadSet, ref: np.ndarray, ref_id: int = 0,
                rg: bytes = b"rg1") -> Tuple[np.ndarray, np.ndarray]:
    """(the records' bytes, each record's start in them), packed column-wise:
    every record's fixed part goes into one row of a matrix and a mask drops
    each row's unused cigar and MD bytes."""
    n, r = rs.seq.shape
    md_mat, md_len = md_tags(rs, ref)
    md_w = md_mat.shape[1]
    ops, n_ops = _cigars(rs)
    seq_bytes = (r + 1) // 2
    rg_tag = b"RGZ" + rg + b"\x00"
    # Row layout: header (36), name, cigar (3 slots), seq, qual, RG, "MDZ",
    # MD with its NUL in a padded slot.
    o_name = 36
    o_cig = o_name + _NAME_LEN
    o_seq = o_cig + 12
    o_qual = o_seq + seq_bytes
    o_rg = o_qual + r
    o_md = o_rg + len(rg_tag) + 3
    width = o_md + md_w
    rec_len = (o_md - 12 + 4 * n_ops) + md_len + 1  # bytes kept per row
    span = rs.ref_span
    end = rs.start + span
    head = np.zeros(n, dtype=np.dtype([
        ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
        ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
        ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
        ("next_ref", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4"),
    ]))
    head["block_size"] = rec_len - 4
    head["ref_id"] = ref_id
    head["pos"] = rs.start
    head["l_read_name"] = _NAME_LEN
    head["mapq"] = rs.mapq
    head["bin"] = reg2bin(rs.start, end)
    head["n_cigar"] = n_ops
    head["flag"] = np.where(rs.reverse, 16, 0)
    head["l_seq"] = r
    head["next_ref"] = -1
    head["next_pos"] = -1
    rows = np.zeros((n, width), dtype=np.uint8)
    rows[:, :36] = head.view(np.uint8).reshape(n, 36)
    rows[:, o_name] = ord("r")
    serial = np.arange(n, dtype=np.int64)
    for k in range(9):  # "r" and the record's number in nine digits
        rows[:, o_name + 9 - k] = 48 + (serial // 10**k) % 10
    rows[:, o_cig: o_cig + 12] = ops.astype("<u4").view(np.uint8).reshape(
        n, 12)
    codes = _SEQ_CODE[rs.seq]
    if r & 1:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    rows[:, o_seq: o_seq + seq_bytes] = (codes[:, 0::2] << 4) | codes[:, 1::2]
    rows[:, o_qual: o_qual + r] = rs.qual
    rows[:, o_rg: o_rg + len(rg_tag)] = np.frombuffer(rg_tag, np.uint8)
    rows[:, o_rg + len(rg_tag): o_md] = np.frombuffer(b"MDZ", np.uint8)
    rows[:, o_md:] = md_mat
    keep = np.ones((n, width), dtype=bool)
    keep[:, o_cig: o_cig + 12] = (np.arange(12)[None, :]
                                  < 4 * n_ops[:, None])
    keep[:, o_md:] = np.arange(md_w)[None, :] < md_len[:, None] + 1
    data = rows[keep]
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(rec_len[:-1], out=offsets[1:])
    return data, offsets


def _bgzf_block(payload: bytes, level: int) -> bytes:
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    deflated = comp.compress(payload) + comp.flush()
    return b"".join([
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff",
        struct.pack("<HBBHH", 6, ord("B"), ord("C"), 2, len(deflated) + 25),
        deflated,
        struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload)),
    ])


def write_bam(path: str, rs: ReadSet, ref: np.ndarray, contig: str,
              level: int = 6, threads: int = 0) -> None:
    """Write `rs` as a BAM and its .bai (path + ".bai"). BGZF blocks of
    BGZF_BLOCK raw bytes each are compressed in parallel; a record may span
    two blocks, as the format allows."""
    header_text = (
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{len(ref)}\n"
        f"@RG\tID:rg1\tSM:{rs.name}\tPL:ILLUMINA\n"
    ).encode()
    name = contig.encode() + b"\x00"
    header = b"".join([
        b"BAM\x01", struct.pack("<i", len(header_text)), header_text,
        struct.pack("<i", 1), struct.pack("<i", len(name)), name,
        struct.pack("<i", len(ref)),
    ])
    records, offsets = bam_records(rs, ref)
    raw = np.concatenate([np.frombuffer(header, np.uint8), records])
    offsets = offsets + len(header)
    n_blocks = (len(raw) + BGZF_BLOCK - 1) // BGZF_BLOCK
    view = memoryview(raw)
    with ThreadPoolExecutor(max_workers=threads or os.cpu_count() or 1) as ex:
        blocks = list(ex.map(
            lambda b: _bgzf_block(
                view[b * BGZF_BLOCK: (b + 1) * BGZF_BLOCK], level),
            range(n_blocks)))
    coff = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blocks], out=coff[1:])
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        for b in blocks:
            fh.write(b)
        fh.write(_BGZF_EOF)
        # On disk before the calls read it: no write-back during a window.
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)

    def voff(u):
        return (coff[u // BGZF_BLOCK] << 16) | (u % BGZF_BLOCK)

    rec_end = np.append(offsets[1:], len(raw))
    write_bai(path + ".bai", rs.start, rs.start + rs.ref_span,
              voff(offsets), voff(rec_end))


def write_bai(path: str, beg, end, vstart, vend) -> None:
    """A standard .bai for one reference: chunks per bin (records of a bin
    that follow each other in the file share a chunk) and the 16 kbp linear
    index, as samtools writes them (without the metadata pseudo-bin)."""
    bins = reg2bin(beg, end)
    order = np.argsort(bins, kind="stable")
    b_sorted = bins[order]
    new_chunk = np.ones(len(order), dtype=bool)
    new_chunk[1:] = (b_sorted[1:] != b_sorted[:-1]) | (
        order[1:] != order[:-1] + 1)
    first = np.flatnonzero(new_chunk)
    last = np.append(first[1:], len(order)) - 1
    chunk_bin = b_sorted[first]
    chunk_beg = vstart[order[first]]
    chunk_end = vend[order[last]]
    out = [b"BAI\x01", struct.pack("<i", 1)]
    ubins, starts = np.unique(chunk_bin, return_index=True)
    stops = np.append(starts[1:], len(chunk_bin))
    out.append(struct.pack("<i", len(ubins)))
    for b, s0, s1 in zip(ubins.tolist(), starts.tolist(), stops.tolist()):
        out.append(struct.pack("<Ii", b, s1 - s0))
        pairs = np.empty((s1 - s0, 2), dtype="<u8")
        pairs[:, 0] = chunk_beg[s0:s1]
        pairs[:, 1] = chunk_end[s0:s1]
        out.append(pairs.tobytes())
    w0 = beg >> 14
    w1 = (end - 1) >> 14
    n_win = int(w1.max()) + 1 if len(beg) else 0
    lin = np.full(n_win, np.iinfo(np.int64).max, dtype=np.int64)
    for w in (w0, w1):  # a record spans at most two 16 kbp windows
        np.minimum.at(lin, w, vstart)
    fill = 0
    for w in range(n_win):  # empty windows take the last offset seen
        if lin[w] == np.iinfo(np.int64).max:
            lin[w] = fill
        fill = lin[w]
    out.append(struct.pack("<i", n_win))
    out.append(lin.astype("<u8").tobytes())
    with open(path + ".tmp", "wb") as fh:
        fh.write(b"".join(out))
    os.replace(path + ".tmp", path)


# --- the cache ------------------------------------------------------------


def sample_dir(root: str, config: dict, seed: int) -> str:
    return os.path.join(root, f"{config['name']}-{seed}-v{GENERATOR_VERSION}")


def ensure_sample(config: dict, seed: int, root: str):
    """(Sample, {read set: BAM path}, whether the files were written now).
    The files are written once per configuration and seed; a directory
    whose manifest does not match the configuration is written again."""
    sample = make_sample(config, seed)
    out = sample_dir(root, config, seed)
    manifest = os.path.join(out, "manifest.json")
    paths = {k: os.path.join(out, f"{k}.bam") for k in sample.reads}
    key = {"config": config, "seed": int(seed),
           "version": GENERATOR_VERSION, "reads": sample.n_reads}
    fresh = False
    try:
        with open(manifest) as fh:
            fresh = json.load(fh) == key and all(
                os.path.exists(p) and os.path.exists(p + ".bai")
                for p in paths.values())
    except (OSError, ValueError):
        fresh = False
    if not fresh:
        os.makedirs(out, exist_ok=True)
        for k, rs in sample.reads.items():
            write_bam(paths[k], rs, sample.reference, sample.contig)
        with open(manifest, "w") as fh:
            json.dump(key, fh)
    return sample, paths, not fresh
