"""Inputs at the edges of the CUDA kernels' routes, and a numpy model of
the counting kernel's arithmetic.

The kernels in ops/csrc/ choose how to work from what they are given: the
counting screen by a row's bytes (one thread up to 64, its warp beyond,
16-byte pieces, chunks of 2,560 bytes, 32 rows a warp, 128 a block), the
likelihood screen by D
(one thread per row up to 64, teams of lanes beyond, steps of 16, 8, 4 or 1
elements) and by which rows are live. The cases here sit on and beside
those edges. chip_smoke.py runs them on the card against the plain
versions; the CPU tests run the same cases through the wrappers against
the JAX forms, so a shape is known good before the card sees it.

Everything is numpy, made from a seed.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

# ops/csrc/csr_screen.cu: the rows of a warp, kScreenThreads, kChunkBytes,
# kThreadRowBytes, and the bytes a warp's 32 lanes take per turn.
CSR_WARP_ROWS = 32
CSR_BLOCK_ROWS = 128
CSR_CHUNK_BYTES = 2560
CSR_THREAD_ROW_BYTES = 64
CSR_WARP_TURN_BYTES = 512

# Row lengths in bytes on and beside every edge of the counting kernel.
CSR_EDGE_ROW_BYTES = tuple(
    n
    for edge in (1, 16, 32, CSR_THREAD_ROW_BYTES, 128, CSR_WARP_TURN_BYTES,
                 CSR_CHUNK_BYTES, 2 * CSR_CHUNK_BYTES, 8192)
    for n in (edge - 1, edge, edge + 1)
)

# ops/csrc/ll_screen.cu: kThreadRowDepth, and the depths around its routes
# (D = 8 and 15 leave the 16-element step; 48 is three steps; 128 is the
# first team).
LL_THREAD_ROW_DEPTH = 64
LL_EDGE_DEPTHS = (8, 15, 16, 32, 48, 64, 128)

CsrCase = Tuple[str, np.ndarray, np.ndarray, np.ndarray]


def csr_tile(rng, row_bytes, K: int):
    """(blob, row_off, is_variant) with rows of the given byte lengths:
    random nibbles 0..15 (ids >= K and the 0xF pad are not counted) and
    random variant flags. The blob is exactly as long as its rows: the
    last row ends at its last byte."""
    row_bytes = np.asarray(row_bytes, dtype=np.int64)
    row_off = np.concatenate([[0], np.cumsum(row_bytes)]).astype(np.int32)
    blob = rng.integers(0, 256, size=int(row_off[-1]), dtype=np.uint8)
    is_variant = rng.random((len(row_bytes), K)) < 0.4
    return blob, row_off, is_variant


def csr_edge_cases(K: int = 8, seed: int = 2026) -> Iterator[CsrCase]:
    """(name, blob, row_off, is_variant) tiles at the counting kernel's
    edges. Every blob is unpadded."""
    rng = np.random.default_rng(seed)
    edges = list(CSR_EDGE_ROW_BYTES)
    # Every edge length twice, in two orders, so each meets several
    # alignments; an empty row between any two.
    lengths = []
    for n in edges + edges[::-1]:
        lengths += [n, 0]
    yield ("edge lengths", *csr_tile(rng, lengths, K))
    yield ("empty rows only, empty blob", *csr_tile(rng, [0] * 300, K))
    blob, off, iv = csr_tile(rng, [0] * 300, K)
    yield ("empty rows only, padded blob",
           np.full(2048, 0xFF, np.uint8), off, iv)
    long_rows = list(rng.integers(475, 526, size=40)) + [3900, 4100, 4000]
    yield ("long rows only", *csr_tile(rng, long_rows, K))
    yield ("one row", *csr_tile(rng, [5], K))
    yield ("one empty row", *csr_tile(rng, [0], K))
    for L in (CSR_WARP_ROWS - 1, CSR_WARP_ROWS, CSR_WARP_ROWS + 1,
              CSR_BLOCK_ROWS - 1, CSR_BLOCK_ROWS, CSR_BLOCK_ROWS + 1,
              2 * CSR_BLOCK_ROWS + 1):
        yield (f"{L} short rows",
               *csr_tile(rng, rng.integers(0, 16, size=L), K))
    # Rows of every kind meeting chunk boundaries: a warp's span of many
    # chunks, and one row of three chunks and more among short ones.
    mixed = rng.choice(
        [0, 1, 7, 13, 40, 64, 65, 300, 500, 4000], size=700,
        p=[.1, .1, .3, .2, .1, .04, .04, .05, .05, .02],
    )
    yield ("mixed rows over many chunks", *csr_tile(rng, mixed, K))
    yield ("a row of three chunks among short rows",
           *csr_tile(rng, [3] * 100 + [2 * CSR_CHUNK_BYTES + 4000] + [3] * 100,
                     K))


# --- the counting kernel's arithmetic in numpy -----------------------------


def pad_outside_model(word: int, a: int, lo: int, hi: int) -> int:
    """pad_outside of csr_screen.cu: the bytes of `word` lie at a .. a+3;
    those outside [lo, hi) become the 0xFF pad."""
    word, head, keep = int(word), int(lo) - int(a), int(hi) - int(a)
    if head > 0:
        word |= 0xFFFFFFFF if head >= 4 else (1 << (8 * head)) - 1
    if keep < 4:
        word |= 0xFFFFFFFF if keep <= 0 else (0xFFFFFFFF << (8 * keep))
    return word & 0xFFFFFFFF


def pad_outside16_model(piece: np.ndarray, a: int, lo: int, hi: int):
    """The four words of a 16-byte piece that lies at a .. a+15, bytes
    outside [lo, hi) set to the pad."""
    return [
        pad_outside_model(int(w), a + 4 * j, lo, hi)
        for j, w in enumerate(np.frombuffer(piece.tobytes(), dtype="<u4"))
    ]


def count16_model(words, K: int):
    """count16 of csr_screen.cu on the four words of one 16-byte piece: the
    4x4 bit transpose into four planes (bit 4n + j of plane i is bit i of
    nibble n of word j), nibble == k as an AND of planes, one popcount."""
    planes = []
    for i in range(4):
        plane = 0
        for j, w in enumerate(words):
            moved = w >> (i - j) if i >= j else (w << (j - i)) & 0xFFFFFFFF
            plane |= moved & ((0x11111111 << j) & 0xFFFFFFFF)
        planes.append(plane)
    counts = np.zeros(K, dtype=np.int64)
    for k in range(K):
        equal = 0xFFFFFFFF
        for i in range(4):
            equal &= planes[i] if (k >> i) & 1 else ~planes[i] & 0xFFFFFFFF
        counts[k] = bin(equal).count("1")
    return counts


def count_row_model(blob: np.ndarray, b0: int, b1: int, K: int,
                    neighbours: int = 0x00):
    """The kernel's count of row [b0, b1) of the blob, as if it lay in one
    chunk: the first and the last aligned 16-byte piece padded outside the
    row and, where the last one's bytes sit below the first one's, merged
    into one piece; the pieces between as they are; int32 counters,
    narrowed to int16 with wrap. Bytes around the blob read as
    `neighbours` (0x00 would count as allele 0 if a mask let them
    through)."""
    room = np.full(len(blob) + 32, neighbours, dtype=np.uint8)
    room[16:16 + len(blob)] = blob
    lo, hi = int(b0) + 16, int(b1) + 16
    total = np.zeros(K, dtype=np.int64)
    if hi > lo:
        first, last = lo & ~15, (hi - 1) & ~15
        q = pad_outside16_model(room[first:first + 16], first, lo, hi)
        if last != first:
            r = pad_outside16_model(room[last:last + 16], last, lo, hi)
            if ((hi - 1) & 15) < (lo & 15):
                q = [x & y for x, y in zip(q, r)]
            else:
                total += count16_model(r, K)
        total += count16_model(q, K)
        for a in range(first + 16, last, 16):
            total += count16_model(
                np.frombuffer(room[a:a + 16].tobytes(), dtype="<u4").tolist(),
                K)
    return ((total + 2**31) % 2**32 - 2**31).astype(np.int32).astype(np.int16)


# --- likelihood tiles --------------------------------------------------------

QUAL_DICTIONARY = (0, 2, 8, 15, 20, 25, 30, 33, 37, 41, 50, 60, 70, 80, 90, 93)


def ll_tile(rng, L: int, D: int, K: int, live_share: Optional[float] = None):
    """A random likelihood tile as the numpy arrays the dispatch stages, in
    both encodings: (pack16, pack8, qvals, mapq, is_variant, is_standard).
    Rows of depth 0..D (one row in 16 is all empty), a row's alleles drawn
    with an alt share of 0, 1%, 20%, 50% or 100%, quals from a 16-entry
    dictionary that includes q = 0, a MAPQ plane, and random allele planes
    (allele 0 the reference; four in five alleles standard). With
    live_share, that share of the rows (drawn per row) has a standard
    variant allele and no other row has one: the kernel reads live rows
    only."""
    depth = rng.integers(0, D + 1, size=L)
    depth[rng.random(L) < 1 / 16] = 0
    valid = np.arange(D)[None, :] < depth[:, None]
    alt_share = rng.choice([0.0, 0.01, 0.2, 0.5, 1.0], size=(L, 1))
    alt = rng.integers(1, max(2, min(K, 5)), size=(L, D))
    aid = np.where(rng.random((L, D)) < alt_share, alt, 0)
    aid[rng.random((L, D)) < 0.002] = 14  # an id beyond most K: no allele
    qidx = rng.integers(0, len(QUAL_DICTIONARY), size=(L, D))
    qvals = np.asarray(QUAL_DICTIONARY, np.uint8)
    qual = qvals[qidx].astype(np.uint16)
    pack16 = np.where(valid, aid | (qual << 4), 0xFFFF).astype(np.uint16)
    pack8 = np.where(valid, aid | (qidx << 4), 0xFF).astype(np.uint8)
    mapq = rng.choice([0, 10, 37, 60, 254], size=(L, D)).astype(np.uint8)
    is_variant = np.zeros((L, K), bool)
    is_variant[:, 1:] = rng.random((L, K - 1)) < 0.8
    is_standard = rng.random((L, K)) < 0.8
    if live_share is not None:
        live = rng.random(L) < live_share
        is_variant[live, 1] = is_standard[live, 1] = True
        is_standard[~live] &= ~is_variant[~live]
    return pack16, pack8, qvals, mapq, is_variant, is_standard
