"""BAM writer: ColumnarReads -> coordinate-sorted BGZF BAM.

The reference only ever READS BAM (htsjdk) — this writer exists for the
TPU framework's own pipeline: converting large simulated/processed
columnar read sets into BAM so downstream runs use the production
streaming path (.bai byte-range pushdown, index-depth partitioning,
multi-process shard loading) instead of whole-file text decode.

Scope: the fields ColumnarReads carries — positions, flags, MAPQ, CIGAR,
SEQ, QUAL, MD:Z, RG:Z/sample. Read names are synthesized ("r<index>")
and mate/template fields are written as unset (ColumnarReads is a
mapped-read pipeline format and does not carry them); pair-aware flows
(structural-variant) should keep their original BAM/SAM inputs.

Format per the SAM/BAM spec v1.6 §4 (BGZF blocks, little-endian record
layout, 4-bit packed SEQ, reg2bin).
"""

from __future__ import annotations

import struct
import zlib
from typing import IO, Optional

import numpy as np

# 4-bit base codes, "=ACMGRSVTWYHKDBN" (SAM spec §4.2.3). Bytes outside
# the alphabet encode as N (15), not '=' (0) — '=' means "matches the
# reference" to BAM readers and would silently change meaning.
_SEQ_CODE = np.full(256, 15, dtype=np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    _SEQ_CODE[_b] = _i
    _SEQ_CODE[ord(chr(_b).lower())] = _i

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _reg2bin(beg: int, end: int) -> int:
    """UCSC binning (SAM spec §5.3)."""
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


class BgzfWriter:
    """Writes BGZF blocks of <= 64 KiB uncompressed payload each."""

    def __init__(self, fh: IO[bytes], level: int = 1):
        self._fh = fh
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= 65280:
            self._flush_block(self._buf[:65280])
            del self._buf[:65280]

    def _flush_block(self, payload) -> None:
        payload = bytes(payload)
        comp = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        deflated = comp.compress(payload) + comp.flush()
        bsize = len(deflated) + 25 + 1  # header(12)+extra(6)+crc(4)+isize(4)
        block = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC"
            + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
            + deflated
            + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
            + struct.pack("<I", len(payload))
        )
        self._fh.write(block)

    def close(self) -> None:
        if self._buf:
            self._flush_block(self._buf)
            self._buf = bytearray()
        self._fh.write(_BGZF_EOF)


def write_bam_from_columnar(
    cols, path: str, level: int = 1, header_text: Optional[str] = None
) -> int:
    """Write cols (must be coordinate-sorted, mapped reads) as a BAM.
    Returns the number of records written."""
    n = cols.n
    samples = list(cols.samples) or ["default"]
    if header_text is None:
        lines = ["@HD\tVN:1.5\tSO:coordinate"]
        for name, length in zip(cols.ref_names, cols.ref_lengths):
            lines.append(f"@SQ\tSN:{name}\tLN:{length}")
        for si, sample in enumerate(samples):
            lines.append(f"@RG\tID:rg{si}\tSM:{sample}")
        header_text = "\n".join(lines) + "\n"
    rg_of_sample = {si: f"rg{si}".encode() for si in range(len(samples))}

    seq = np.asarray(cols.seq)
    qual = np.asarray(cols.qual)
    cigar_len = np.asarray(cols.cigar_len, dtype=np.uint32)
    cigar_op = np.asarray(cols.cigar_op, dtype=np.uint32)
    md_text = np.asarray(cols.md_text)
    md_blob = md_text.tobytes()
    seq_codes = _SEQ_CODE[seq]

    with open(path, "wb") as raw:
        w = BgzfWriter(raw, level=level)
        htext = header_text.encode()
        w.write(
            b"BAM\x01"
            + struct.pack("<i", len(htext))
            + htext
            + struct.pack("<i", len(cols.ref_names))
        )
        for name, length in zip(cols.ref_names, cols.ref_lengths):
            nb = name.encode() + b"\x00"
            w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(length)))

        for i in range(n):
            s_lo, s_hi = cols._span(cols.seq_off, cols.seq_end, i)
            c_lo, c_hi = cols._span(cols.cigar_off, cols.cigar_end, i)
            m_lo, m_hi = cols._span(cols.md_off, cols.md_end, i)
            l_seq = s_hi - s_lo
            name = b"r%d" % i
            enc_cigar = (
                (cigar_len[c_lo:c_hi] << 4) | cigar_op[c_lo:c_hi]
            ).astype("<u4").tobytes()
            codes = seq_codes[s_lo:s_hi]
            if l_seq & 1:
                codes = np.concatenate([codes, np.zeros(1, np.uint8)])
            packed_seq = ((codes[0::2] << 4) | codes[1::2]).tobytes()
            tags = b""
            if m_hi > m_lo:
                tags += b"MDZ" + md_blob[m_lo:m_hi] + b"\x00"
            rg = rg_of_sample.get(int(cols.sample_id[i]))
            if rg is not None:
                tags += b"RGZ" + rg + b"\x00"
            start = int(cols.start[i])
            end = max(int(cols.end[i]), start + 1)
            # next_refID/next_pos are -1 and tlen 0: mate info is not
            # carried by ColumnarReads (see module docstring)
            body = (
                struct.pack(
                    "<iiBBHHHiiii",
                    int(cols.ref_id[i]),
                    start,
                    len(name) + 1,
                    int(cols.mapq[i]),
                    _reg2bin(start, end),
                    (c_hi - c_lo),
                    int(cols.flags_[i]),
                    l_seq,
                    -1,
                    -1,
                    0,
                )
                + name
                + b"\x00"
                + enc_cigar
                + packed_seq
                + qual[s_lo:s_hi].tobytes()
                + tags
            )
            w.write(struct.pack("<i", len(body)) + body)
        w.close()
    return n


def sam_to_bam(sam_path: str, bam_path: str, level: int = 1) -> int:
    """Convert a SAM file to BAM via the columnar decoder (mapped records;
    see write_bam_from_columnar for scope)."""
    from guacamole_tpu_torch.runtime.columnar import decode_sam_columnar

    cols = decode_sam_columnar(sam_path)
    if cols is None:
        raise RuntimeError(f"cannot decode {sam_path}")
    return write_bam_from_columnar(cols, bam_path, level=level)
