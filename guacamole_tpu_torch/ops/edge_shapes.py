"""Inputs at the edges of the CUDA kernels' routes, and a numpy model of
the counting kernel's arithmetic and of the compaction's partition.

The kernels in ops/csrc/ choose how to work from what they are given: the
counting screen by a row's bytes (one thread up to 64, its warp beyond,
16-byte pieces, chunks of 2,560 bytes, 32 rows a warp, 128 a block), the
likelihood screen by D
(one thread per row up to 64, teams of lanes beyond, steps of 16, 8, 4 or 1
elements) and by which rows are live, the compaction by the count of flags
(one block up to 32,768, two passes of up to 1,024 blocks beyond), the fused
dense kernel by D (steps of 8 elements, teams of lanes from 256) and by
the row count (a tile of few rows takes larger teams). The cases
here sit on and beside those edges. chip_smoke.py runs them on the card against the plain
versions; the CPU tests run the same cases through the wrappers against
the JAX forms, so a shape is known good before the card sees it.

The cases are numpy, made from a seed; view_into_larger takes the tensors
made of them.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def view_into_larger(a: torch.Tensor, lead: int, fill=0) -> torch.Tensor:
    """The same values as a contiguous view that starts `lead` rows
    (elements, for a vector) into a larger tensor filled with `fill`."""
    pad = a.new_full((lead, *a.shape[1:]), fill)
    return torch.cat([pad, a])[lead:]

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


# --- the compaction ----------------------------------------------------------

# ops/csrc/csr_screen.cu: kFlagsPerThread, a tile of the two-pass route
# (kCompactThreads x kFlagsPerThread) and of the one-block route
# (kOneBlockThreads x kFlagsPerThread), kOneBlockFlags, kCompactMaxBlocks.
COMPACT_FLAGS_PER_THREAD = 32
COMPACT_TILE_FLAGS = 256 * COMPACT_FLAGS_PER_THREAD
COMPACT_ONE_BLOCK_TILE_FLAGS = 1024 * COMPACT_FLAGS_PER_THREAD
COMPACT_ONE_BLOCK_FLAGS = 32768
COMPACT_MAX_BLOCKS = 1024
# Where a view of the flags (bytes) or of the counts (rows) starts inside a
# larger tensor.
COMPACT_LEADS = (0, 1, 3, 15)

# Flag counts on and beside every edge of csr_compact: nothing, one flag, a
# thread's 32, a tile, the one-block route's last length, the first chunks
# of the two-pass route.
COMPACT_EDGE_ROWS = (
    0, 1,
    COMPACT_FLAGS_PER_THREAD - 1, COMPACT_FLAGS_PER_THREAD,
    COMPACT_FLAGS_PER_THREAD + 1,
    COMPACT_TILE_FLAGS - 1, COMPACT_TILE_FLAGS, COMPACT_TILE_FLAGS + 1,
    COMPACT_ONE_BLOCK_FLAGS - 15, COMPACT_ONE_BLOCK_FLAGS - 1,
    COMPACT_ONE_BLOCK_FLAGS, COMPACT_ONE_BLOCK_FLAGS + 1,
    5 * COMPACT_TILE_FLAGS - 15, 5 * COMPACT_TILE_FLAGS - 1,
    5 * COMPACT_TILE_FLAGS, 5 * COMPACT_TILE_FLAGS + 1,
)
# Beyond this many flags a block's chunk is more than one tile.
COMPACT_ONE_TILE_FLAGS = COMPACT_MAX_BLOCKS * COMPACT_TILE_FLAGS


def compact_tile(rng, L: int, K: int, where: str = "some",
                 max_count: int = 50):
    """(flags [L] bool, counts [L, K] int16) for the compaction. `where`
    says which flags are set: "none", "all", "some" (one row in 64),
    "first" or "last" (some rows of the first or the last 1,000 only).
    Every row has counts of its own, a candidate at least one read, so a
    count that is copied from the wrong row shows."""
    flags = np.zeros(L, dtype=bool)
    if where == "all":
        flags[:] = True
    elif where == "some":
        flags = rng.random(L) < 1 / 64
    elif where == "first":
        flags[:1000] = rng.random(min(L, 1000)) < 0.3
    elif where == "last":
        flags[max(0, L - 1000):] = rng.random(min(L, 1000)) < 0.3
    elif where != "none":
        raise ValueError(where)
    counts = rng.integers(0, max_count, size=(L, K)).astype(np.int16)
    counts[:, 0] += (np.arange(L) % 13).astype(np.int16) + 1
    return flags, counts


def compact_caps(total: int):
    """cap 0, below, at and above the candidate total."""
    return sorted({0, max(total - 1, 0), total, total + 8})


def compact_edge_cases(K: int = 8, seed: int = 2026, big: bool = True,
                       max_count: int = 50):
    """(name, flags, counts) at the edges of csr_compact. With `big`, also
    the lengths around 8.4M flags where a chunk grows past one tile (made
    with K = 1 whatever K is asked, to stay small)."""
    rng = np.random.default_rng(seed)
    for L in COMPACT_EDGE_ROWS:
        yield (f"{L} rows", *compact_tile(rng, L, K, "some", max_count))
    two_pass = 5 * COMPACT_TILE_FLAGS + 77
    for where in ("none", "all", "first", "last"):
        yield (f"one block, {where}",
               *compact_tile(rng, 3000, K, where, max_count))
        yield (f"two passes, {where}",
               *compact_tile(rng, two_pass, K, where, max_count))
    if big:
        for L in (COMPACT_ONE_TILE_FLAGS - 15, COMPACT_ONE_TILE_FLAGS,
                  COMPACT_ONE_TILE_FLAGS + 1):
            yield (f"{L} rows", *compact_tile(rng, L, 1, "last"))


def csr_of_counts(flags: np.ndarray, counts: np.ndarray):
    """(blob, row_off, is_variant): a CSR tile whose counting screen without
    a threshold gives exactly these counts and these flags: row r holds
    counts[r, k] nibbles k; every allele of a flagged row is a variant, none
    of another row's."""
    L, K = counts.shape
    depth = counts.sum(axis=1, dtype=np.int64)
    row_bytes = (depth + 1) // 2
    row_off = np.concatenate([[0], np.cumsum(row_bytes)]).astype(np.int32)
    nibbles = np.full(2 * int(row_off[-1]), 0xF, dtype=np.uint8)
    starts = 2 * row_off[:-1].astype(np.int64)
    ids = np.repeat(np.tile(np.arange(K, dtype=np.uint8), L),
                    counts.reshape(-1).astype(np.int64))
    within = np.arange(len(ids)) - np.repeat(
        np.cumsum(depth) - depth, depth)
    nibbles[np.repeat(starts, depth) + within] = ids
    blob = (nibbles[0::2] | (nibbles[1::2] << 4)).astype(np.uint8)
    is_variant = np.repeat(flags[:, None], K, axis=1)
    return blob, row_off, is_variant


def compact_partition_model(flags: np.ndarray, counts: np.ndarray, cap: int,
                            lead: int = 0) -> np.ndarray:
    """csr_compact of csr_screen.cu in numpy, block by block: the flags lie
    `lead` bytes past a 16-byte boundary and positions count from there;
    pass A's block totals; in pass B each block's offset (the totals before
    it) and the total, the ranks of its chunk tile by tile and thread by
    thread (32 flags each), candidates written while they rank below cap, a
    chunk skipped once its first rank is at or above cap; the unused body
    rows filled in groups of four elements; the footer. Every word of the
    output must be written exactly once."""
    L, K = counts.shape
    width = K + 1
    lo, hi = lead, lead + L
    at = np.zeros(hi, dtype=bool)
    at[lo:] = flags
    one_block = L <= COMPACT_ONE_BLOCK_FLAGS
    if one_block:
        tile, chunk, n_blocks = COMPACT_ONE_BLOCK_TILE_FLAGS, max(hi, 1), 1
    else:
        tile = COMPACT_TILE_FLAGS
        tiles = -(-hi // tile)
        chunk = -(-tiles // COMPACT_MAX_BLOCKS) * tile
        n_blocks = -(-hi // chunk)
        assert n_blocks <= COMPACT_MAX_BLOCKS
    block_total = [int(at[b * chunk:(b + 1) * chunk].sum())
                   for b in range(n_blocks)]
    out = np.zeros((cap + 1) * width, dtype=np.int32)
    written = np.zeros((cap + 1) * width, dtype=np.int32)
    total = 0
    for b in range(n_blocks):
        rank0 = sum(block_total[:b])
        total = sum(block_total)
        for v0 in range(b * chunk, min((b + 1) * chunk, hi), tile):
            if not one_block and rank0 >= cap:
                break
            part = at[v0:v0 + tile]
            part = np.concatenate(
                [part, np.zeros(-len(part) % COMPACT_FLAGS_PER_THREAD, bool)])
            per_thread = part.reshape(-1, COMPACT_FLAGS_PER_THREAD).sum(axis=1)
            first_rank = rank0 + np.cumsum(per_thread) - per_thread
            for thread in np.nonzero(per_thread)[0]:
                v = v0 + thread * COMPACT_FLAGS_PER_THREAD
                rank = int(first_rank[thread])
                for j in np.nonzero(part[thread * 32:thread * 32 + 32])[0]:
                    if rank >= cap:
                        break
                    row = v + int(j) - lo
                    out[rank * width] = row
                    out[rank * width + 1:(rank + 1) * width] = counts[row]
                    written[rank * width:(rank + 1) * width] += 1
                    rank += 1
            rank0 += int(per_thread.sum())
        if one_block:
            total = rank0
    used = min(total, cap)
    e_lo, e_hi = used * width, cap * width
    for g in range(e_lo >> 2, (e_hi + 3) >> 2):
        for e in range(4 * g, 4 * g + 4):
            if e_lo <= e < e_hi:
                out[e] = -1 if e % width == 0 else 0
                written[e] += 1
    out[e_hi] = total
    written[e_hi:] += 1
    assert (written == 1).all(), "a word written twice or not at all"
    return out.reshape(cap + 1, width)


# --- dense tiles ---------------------------------------------------------------

# ops/csrc/stats_ll.cu: kLaneElements, kGroup and kSmallTileWarps. Depths on
# and beside its routes: one vector step (8), steps that do not fill a lane's
# batch (24, 40), one thread a row below 256, teams of 2 to 32 lanes from
# there (each lane at least 128 elements), depths that are no multiple of 8
# (read element by element). A tile of few rows takes larger teams, down to
# one step a lane, while rows x lanes stay within 16 warps for every SM.
DENSE_LANE_ELEMENTS = 128
DENSE_GROUP = 8
DENSE_SMALL_TILE_WARPS = 16
# Rows x lanes of the largest small tile on an H100 SXM (132 SMs).
DENSE_SMALL_TILE_THREADS = 132 * DENSE_SMALL_TILE_WARPS * 32
# (D, team sizes whose last row count is a case).
DENSE_SMALL_TILE_TEAMS = ((16, (2,)), (64, (8, 4)), (256, (32, 16)))
DENSE_EDGE_DEPTHS = (1, 7, 8, 9, 16, 24, 32, 40, 64, 65, 128, 248, 255, 256,
                     257, 264, 511, 512, 1023, 1024, 1025, 2048, 4096)
DENSE_EDGE_ALLELES = (1, 2, 8, 15, 16, 17, 20)


def dense_tile(rng, L: int, D: int, K: int, empty: bool = False):
    """A random dense tile as the numpy arrays the dispatch stages
    (allele_id, qual, mapq, strand, valid, is_variant): rows of depth 0..D
    (one row in 16 empty; all of them with `empty`), a row's alleles drawn
    with an alt share of 0, 1%, 20%, 50% or 100%, a few valid elements that
    belong to no allele, quals 0..45 with q = 0 and q = 93 among them,
    MAPQs that include 0. Slots that are not valid hold values that would
    count if they were read."""
    depth = rng.integers(0, D + 1, size=L)
    depth[rng.random(L) < 1 / 16] = 0
    if empty:
        depth[:] = 0
    valid = np.arange(D)[None, :] < depth[:, None]
    alt_share = rng.choice([0.0, 0.01, 0.2, 0.5, 1.0], size=(L, 1))
    alt = rng.integers(min(1, K - 1), K, size=(L, D))
    aid = np.where(rng.random((L, D)) < alt_share, alt, 0)
    aid[rng.random((L, D)) < 0.002] = K + 1
    aid[rng.random((L, D)) < 0.002] = -1
    aid = np.where(valid, aid, rng.integers(0, K, size=(L, D))).astype(np.int16)
    qual = rng.integers(0, 46, size=(L, D))
    qual[rng.random((L, D)) < 0.001] = 93
    qual = qual.astype(np.int16)
    mapq = rng.choice([0, 10, 37, 60, 254], size=(L, D)).astype(np.int16)
    strand = rng.random((L, D)) < 0.5
    is_variant = rng.random((L, K)) < 0.4
    return aid, qual, mapq, strand, valid, is_variant


def dense_edge_cases(seed: int = 2026):
    """(name, K, tile) at the edges of stats_ll: every edge depth at K = 8
    with a row count that is no multiple of a warp's share, every edge
    allele count at two depths, row counts around a warp's and a block's
    share of rows and around every team size of a small tile (the largest
    of them with one thread a row), tiles of empty rows."""
    rng = np.random.default_rng(seed)
    for D in DENSE_EDGE_DEPTHS:
        L = 67 if D < 500 else 19 if D < 4096 else 5
        yield (f"D={D}", 8, dense_tile(rng, L, D, 8))
    for K in DENSE_EDGE_ALLELES:
        yield (f"K={K} D=32", K, dense_tile(rng, 45, 32, K))
        yield (f"K={K} D=256", K, dense_tile(rng, 21, 256, K))
    for L in (31, 32, 33, 127, 128, 129):
        yield (f"{L} rows, D=16", 8, dense_tile(rng, L, 16, 8))
    for L in (7, 8, 9, 31, 32, 33):
        yield (f"{L} rows, D=512", 8, dense_tile(rng, L, 512, 8))
    # The last row count of every team size of a small tile, and the next:
    # at D = 16 a row has 2 lanes and, beyond, one thread; at D = 64 8, then
    # 4 lanes; at D = 256 a warp, then 16 lanes.
    for D, teams in DENSE_SMALL_TILE_TEAMS:
        for team in teams:
            last = DENSE_SMALL_TILE_THREADS // team
            for L in (last, last + 1):
                yield (f"{L} rows, D={D}", 8, dense_tile(rng, L, D, 8))
    yield ("empty rows, D=32", 8, dense_tile(rng, 300, 32, 8, empty=True))
    yield ("empty rows, D=256", 8, dense_tile(rng, 40, 256, 8, empty=True))
    # Rows of 12 and 20 elements: a slice that starts at row 1 is not
    # aligned to 16 bytes.
    for D in (12, 20):
        yield (f"D={D}, for row slices", 8, dense_tile(rng, 70, D, 8))
