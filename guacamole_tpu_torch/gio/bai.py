"""BAM index (.bai) parsing and region queries.

Lets the loader inflate only the byte ranges overlapping the requested loci
(the BAM-index pushdown of the reference's samtools path,
cf. reference .../reads/Read.scala:395-406).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

BAI_MAGIC = b"BAI\x01"

Chunk = Tuple[int, int]  # (virtual start, virtual end)


class BamIndex:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != BAI_MAGIC:
            raise ValueError(f"Not a BAI index: {path}")
        n_ref = struct.unpack_from("<i", data, 4)[0]
        pos = 8
        # per reference: bin id -> chunks, plus the 16kb linear index
        self.bins: List[Dict[int, List[Chunk]]] = []
        self.linear: List[List[int]] = []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", data, pos)[0]
            pos += 4
            ref_bins: Dict[int, List[Chunk]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, pos)
                pos += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, pos)
                    pos += 16
                    chunks.append((beg, end))
                ref_bins[bin_id] = chunks
            n_intv = struct.unpack_from("<i", data, pos)[0]
            pos += 4
            intervals = list(struct.unpack_from("<%dQ" % n_intv, data, pos))
            pos += 8 * n_intv
            self.bins.append(ref_bins)
            self.linear.append(intervals)

    @staticmethod
    def region_to_bins(beg: int, end: int) -> List[int]:
        """All bin ids that may contain records overlapping [beg, end)."""
        if end <= beg:
            return []
        end -= 1
        bins = [0]
        for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
            bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
        return bins

    def chunks_for_region(self, ref_id: int, beg: int, end: int) -> List[Chunk]:
        """Merged, sorted chunk list possibly containing records overlapping
        [beg, end) on reference ref_id."""
        if ref_id < 0 or ref_id >= len(self.bins):
            return []
        ref_bins = self.bins[ref_id]
        linear = self.linear[ref_id]
        # Linear index: minimum virtual offset of records overlapping the
        # 16kb window containing beg.
        window = beg >> 14
        min_offset = linear[window] if window < len(linear) else (
            linear[-1] if linear else 0
        )
        chunks: List[Chunk] = []
        for bin_id in self.region_to_bins(beg, end):
            for cbeg, cend in ref_bins.get(bin_id, ()):
                if cend > min_offset:
                    chunks.append((max(cbeg, min_offset), cend))
        chunks.sort()
        # Merge adjacent/overlapping chunks.
        merged: List[Chunk] = []
        for cbeg, cend in chunks:
            if merged and cbeg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
            else:
                merged.append((cbeg, cend))
        return merged


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin fully containing [beg, end) (UCSC binning, SAM spec)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def build_bam_index(bam_path: str, bai_path: Optional[str] = None) -> str:
    """Build a .bai index for a coordinate-sorted BAM (the `samtools index`
    / htsjdk BAMIndexer capability the reference gets from its JVM deps).

    Returns the index path (default: bam_path + '.bai')."""
    import os

    from guacamole_tpu_torch.gio.bam import BamFile

    if bai_path is None:
        bai_path = bam_path + ".bai"
    bam = BamFile(bam_path)
    n_ref = len(bam.references)

    # Inflate everything once, remembering block boundaries so any
    # uncompressed offset maps back to a virtual offset.
    data = bytearray()
    ustarts: List[int] = []
    coffs: List[int] = []
    for coffset, block in bam.reader.blocks():
        ustarts.append(len(data))
        coffs.append(coffset)
        data.extend(block)
    file_csize = os.path.getsize(bam_path)

    import bisect

    def voffset(u: int) -> int:
        i = bisect.bisect_right(ustarts, u) - 1
        if i < 0:
            return 0
        if i + 1 < len(ustarts) and u == ustarts[i + 1]:
            # Block-boundary offsets address the start of the next block.
            return coffs[i + 1] << 16
        if u >= len(data):
            return file_csize << 16
        return (coffs[i] << 16) | (u - ustarts[i])

    # Start of records: convert the header-end virtual offset back.
    v = bam._records_voffset
    ci = coffs.index(v >> 16)
    pos = ustarts[ci] + (v & 0xFFFF)

    bins: List[Dict[int, List[Chunk]]] = [dict() for _ in range(n_ref)]
    linear: List[Dict[int, int]] = [dict() for _ in range(n_ref)]
    # Fine-grained sidecar: per FINE_WINDOW bp window, the (min vstart,
    # max vend) of records overlapping it — byte-exact region pushdown at
    # 1 kb granularity where .bai's 16 kb windows are too coarse (deep
    # tiny contigs like chrM).
    fine: List[Dict[int, Chunk]] = [dict() for _ in range(n_ref)]
    n = len(data)
    while pos + 4 <= n:
        block_size = struct.unpack_from("<i", data, pos)[0]
        if block_size <= 0 or pos + 4 + block_size > n:
            break
        vstart = voffset(pos)
        vend = voffset(pos + 4 + block_size)
        rec = pos + 4
        ref_id, pos0, l_rn_etc, flag_nc = struct.unpack_from(
            "<iiii", data, rec
        )
        pos += 4 + block_size
        if ref_id < 0 or pos0 < 0:
            continue
        n_cigar = flag_nc & 0xFFFF
        l_read_name = l_rn_etc & 0xFF
        span = 0
        cp = rec + 32 + l_read_name
        for k in range(n_cigar):
            op = struct.unpack_from("<I", data, cp + 4 * k)[0]
            if (op & 0xF) in (0, 2, 3, 6, 7, 8):  # M/D/N/P/=/X consume ref
                span += op >> 4
        end = pos0 + max(span, 1)
        b = reg2bin(pos0, end)
        chunks = bins[ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == vstart:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vstart, vend))
        lin = linear[ref_id]
        for w in range(pos0 >> 14, ((end - 1) >> 14) + 1):
            if w not in lin or vstart < lin[w]:
                lin[w] = vstart
        fw = fine[ref_id]
        for w in range(pos0 >> FINE_SHIFT, ((end - 1) >> FINE_SHIFT) + 1):
            cur = fw.get(w)
            fw[w] = (
                (vstart, vend)
                if cur is None
                else (min(cur[0], vstart), max(cur[1], vend))
            )

    out = bytearray()
    out += BAI_MAGIC
    out += struct.pack("<i", n_ref)
    for rid in range(n_ref):
        ref_bins = bins[rid]
        out += struct.pack("<i", len(ref_bins))
        for bin_id in sorted(ref_bins):
            chunks = ref_bins[bin_id]
            out += struct.pack("<Ii", bin_id, len(chunks))
            for cbeg, cend in chunks:
                out += struct.pack("<QQ", cbeg, cend)
        lin = linear[rid]
        n_intv = (max(lin) + 1) if lin else 0
        out += struct.pack("<i", n_intv)
        fill = 0
        for w in range(n_intv):
            if w in lin:
                fill = lin[w]
            out += struct.pack("<Q", fill)
    with open(bai_path, "wb") as f:
        f.write(bytes(out))
    _write_fine_index(bai_path + ".gli", fine)
    return bai_path


FINE_SHIFT = 10  # 1 kb fine-index windows
GLI_MAGIC = b"GLI\x01"


def _write_fine_index(path: str, fine: List[Dict[int, Chunk]]) -> None:
    out = bytearray()
    out += GLI_MAGIC
    out += struct.pack("<i", len(fine))
    for fw in fine:
        n_win = (max(fw) + 1) if fw else 0
        out += struct.pack("<i", n_win)
        for w in range(n_win):
            beg, end = fw.get(w, (0, 0))
            out += struct.pack("<QQ", beg, end)
    with open(path, "wb") as f:
        f.write(bytes(out))


class FineIndex:
    """The .gli sidecar: per 1 kb window, the (min vstart, max vend) of
    records overlapping it. One merged chunk per queried range."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != GLI_MAGIC:
            raise ValueError(f"Not a GLI index: {path}")
        n_ref = struct.unpack_from("<i", data, 4)[0]
        pos = 8
        self.windows: List[List[Chunk]] = []
        for _ in range(n_ref):
            n_win = struct.unpack_from("<i", data, pos)[0]
            pos += 4
            vals = struct.unpack_from("<%dQ" % (2 * n_win), data, pos)
            pos += 16 * n_win
            self.windows.append(
                [(vals[2 * i], vals[2 * i + 1]) for i in range(n_win)]
            )

    def chunks_for_region(
        self, ref_id: int, beg: int, end: int
    ) -> List[Chunk]:
        if ref_id < 0 or ref_id >= len(self.windows) or end <= beg:
            return []
        wins = self.windows[ref_id]
        lo = beg >> FINE_SHIFT
        hi = min(((end - 1) >> FINE_SHIFT) + 1, len(wins))
        cbeg = None
        cend = 0
        for w in range(lo, hi):
            b, e = wins[w]
            if e == 0:
                continue
            cbeg = b if cbeg is None else min(cbeg, b)
            cend = max(cend, e)
        return [] if cbeg is None else [(cbeg, cend)]


def optimize_chunks(chunk_lists: List[List[Chunk]]) -> List[Chunk]:
    """Merge chunk lists from multiple region queries into one sorted,
    non-overlapping list (the QueryInterval.optimizeIntervals analog)."""
    all_chunks = sorted(c for chunks in chunk_lists for c in chunks)
    merged: List[Chunk] = []
    for cbeg, cend in all_chunks:
        if merged and cbeg <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
        else:
            merged.append((cbeg, cend))
    return merged
