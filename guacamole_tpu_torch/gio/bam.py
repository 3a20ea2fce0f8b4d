"""BAM binary format reader (BAM spec v1, over BGZF).

Decodes BAM records into the shared read model. With a .bai index present
and a loci filter given, performs region queries so only the relevant byte
ranges are inflated — the equivalent of the reference's samtools-with-index
path (cf. reference .../reads/Read.scala:382-430).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

from guacamole_tpu_torch.gio.bgzf import BgzfReader
from guacamole_tpu_torch.gio.sam import SamHeader, parse_header_line, record_to_read
from guacamole_tpu_torch.reads.cigar import Cigar

BAM_MAGIC = b"BAM\x01"

# 4-bit SEQ code -> base character (BAM spec).
SEQ_CODES = b"=ACMGRSVTWYHKDBN"

_seq_decode_table: Optional[List[bytes]] = None


def _build_seq_decode_table() -> List[bytes]:
    """256-entry table mapping a packed byte to its two base chars."""
    global _seq_decode_table
    if _seq_decode_table is None:
        _seq_decode_table = [
            bytes((SEQ_CODES[b >> 4], SEQ_CODES[b & 0xF])) for b in range(256)
        ]
    return _seq_decode_table


def decode_seq(packed: bytes, l_seq: int) -> bytes:
    table = _build_seq_decode_table()
    out = b"".join(table[b] for b in packed)
    return out[:l_seq]


_TAG_SIZES = {
    ord("A"): 1, ord("c"): 1, ord("C"): 1,
    ord("s"): 2, ord("S"): 2,
    ord("i"): 4, ord("I"): 4, ord("f"): 4,
}


def scan_tags(data: bytes, start: int, end: int) -> Dict[str, object]:
    """Scan the optional-tag region of a BAM record; decodes Z-strings and
    fixed-size scalars (enough for MD/RG/NM and friends)."""
    tags: Dict[str, object] = {}
    pos = start
    while pos < end:
        tag = data[pos : pos + 2].decode("ascii")
        typ = data[pos + 2]
        pos += 3
        if typ in _TAG_SIZES:
            size = _TAG_SIZES[typ]
            if typ == ord("A"):
                tags[tag] = chr(data[pos])
            elif typ == ord("c"):
                tags[tag] = struct.unpack_from("<b", data, pos)[0]
            elif typ == ord("C"):
                tags[tag] = data[pos]
            elif typ == ord("s"):
                tags[tag] = struct.unpack_from("<h", data, pos)[0]
            elif typ == ord("S"):
                tags[tag] = struct.unpack_from("<H", data, pos)[0]
            elif typ == ord("i"):
                tags[tag] = struct.unpack_from("<i", data, pos)[0]
            elif typ == ord("I"):
                tags[tag] = struct.unpack_from("<I", data, pos)[0]
            else:  # f
                tags[tag] = struct.unpack_from("<f", data, pos)[0]
            pos += size
        elif typ in (ord("Z"), ord("H")):
            zero = data.index(0, pos)
            tags[tag] = data[pos:zero].decode("ascii")
            pos = zero + 1
        elif typ == ord("B"):
            subtype = data[pos]
            count = struct.unpack_from("<I", data, pos + 1)[0]
            pos += 5 + count * _TAG_SIZES[subtype]
            tags[tag] = None  # array tags unused downstream
        else:
            raise ValueError(f"Unknown BAM tag type: {chr(typ)}")
    return tags


class BamFile:
    """A parsed BAM file handle."""

    def __init__(self, path: str):
        self.path = path
        self.reader = BgzfReader(path)
        self.header = SamHeader([], {}, {})
        self._refs: List[Tuple[str, int]] = []
        self._records_voffset = 0
        self._parse_header()

    def _parse_header(self) -> None:
        # The header (magic, text, reference list) can span blocks; inflate
        # from the start until we've consumed it.
        data = bytearray()
        blocks = []  # (coffset, ulen) prefix sums to map uoffset -> voffset
        needed = 8
        it = self.reader.blocks()
        for coffset, block in it:
            blocks.append((coffset, len(data)))
            data.extend(block)
            if len(data) >= needed:
                if data[:4] != BAM_MAGIC:
                    raise ValueError(f"Not a BAM file: {self.path}")
                l_text = struct.unpack_from("<i", data, 4)[0]
                needed = 8 + l_text + 4
                if len(data) < needed:
                    continue
                pos = 8 + l_text
                text = data[8:pos].decode("ascii", errors="replace")
                n_ref = struct.unpack_from("<i", data, pos)[0]
                pos += 4
                # Ensure we have all reference entries buffered.
                complete = True
                refs: List[Tuple[str, int]] = []
                for _ in range(n_ref):
                    if pos + 4 > len(data):
                        complete = False
                        break
                    l_name = struct.unpack_from("<i", data, pos)[0]
                    if pos + 8 + l_name > len(data):
                        complete = False
                        break
                    name = data[pos + 4 : pos + 4 + l_name - 1].decode("ascii")
                    l_ref = struct.unpack_from("<i", data, pos + 4 + l_name)[0]
                    refs.append((name, l_ref))
                    pos += 8 + l_name
                if not complete:
                    needed = len(data) + 1
                    continue
                # Parse @SQ/@RG out of the text header.
                for line in text.split("\n"):
                    if line.startswith("@"):
                        parse_header_line(line, self.header)
                self._refs = refs
                for name, length in refs:
                    if name not in self.header.contig_lengths:
                        self.header.contig_names.append(name)
                        self.header.contig_lengths[name] = length
                # Map the records start position to a virtual offset.
                for coff, ustart in reversed(blocks):
                    if pos >= ustart:
                        self._records_voffset = (coff << 16) | (pos - ustart)
                        break
                return
        raise ValueError(f"Truncated BAM header: {self.path}")

    @property
    def references(self) -> List[Tuple[str, int]]:
        return list(self._refs)

    def ref_name(self, ref_id: int) -> Optional[str]:
        if 0 <= ref_id < len(self._refs):
            return self._refs[ref_id][0]
        return None

    # --- record iteration ---

    def raw_records(
        self, chunks: Optional[List[Tuple[int, int]]] = None
    ) -> Iterator[Tuple[bytes, int]]:
        """Iterate (record_bytes, record_start_offset_within_buffer).

        chunks: optional list of (vstart, vend) virtual-offset ranges from an
        index query; None iterates the whole file.
        """
        if chunks is None:
            chunks = [(self._records_voffset, None)]
        for vstart, vend in chunks:
            data = self.reader.read_range(vstart, vend)
            pos = 0
            n = len(data)
            while pos + 4 <= n:
                block_size = struct.unpack_from("<i", data, pos)[0]
                if pos + 4 + block_size > n:
                    break
                yield data[pos + 4 : pos + 4 + block_size], pos
                pos += 4 + block_size

    def records(
        self,
        token: int = 0,
        chunks: Optional[List[Tuple[int, int]]] = None,
        region: Optional[Tuple[int, int, int]] = None,
    ) -> Iterator:
        """Decode reads. region=(ref_id, beg, end) filters mapped records to
        those overlapping [beg, end) (0-based)."""
        for raw, _ in self.raw_records(chunks):
            read = self._decode_record(raw, token, region)
            if read is not None:
                yield read

    def _decode_record(
        self, raw: bytes, token: int, region: Optional[Tuple[int, int, int]]
    ):
        (
            ref_id,
            pos0,
            l_read_name,
            mapq,
            _bin,
            n_cigar_op,
            flag,
            l_seq,
            next_ref_id,
            next_pos,
            tlen,
        ) = struct.unpack_from("<iiBBHHHiiii", raw, 0)
        if region is not None:
            want_ref, want_beg, want_end = region
            if ref_id != want_ref:
                return None
        p = 32 + l_read_name  # skip read_name (null-terminated)
        cigar_ops = struct.unpack_from("<%dI" % n_cigar_op, raw, p)
        p += 4 * n_cigar_op
        cigar = Cigar.from_binary([(op >> 4, op & 0xF) for op in cigar_ops])
        if region is not None:
            ref_len = cigar.reference_length
            end = pos0 + ref_len
            if not (pos0 < want_end and end > want_beg):
                return None
        seq_bytes = (l_seq + 1) // 2
        sequence = decode_seq(raw[p : p + seq_bytes], l_seq)
        p += seq_bytes
        quals = raw[p : p + l_seq]
        if l_seq and quals[0] == 0xFF:
            quals = bytes(l_seq)
        p += l_seq
        tags = scan_tags(raw, p, len(raw))
        rg = tags.get("RG")
        sample = (
            self.header.read_group_samples.get(rg, "default") if rg else "default"
        )
        md = tags.get("MD")
        rname = self.ref_name(ref_id) or "*"
        rnext = "*"
        if next_ref_id >= 0:
            rnext = "=" if next_ref_id == ref_id else (self.ref_name(next_ref_id) or "*")
        return record_to_read(
            flag=flag,
            rname=rname,
            pos=pos0 + 1,  # record_to_read expects 1-based
            mapq=mapq,
            cigar=cigar,
            rnext=rnext,
            pnext=next_pos + 1,
            tlen=tlen,
            sequence=sequence,
            base_qualities=quals,
            md=md if isinstance(md, str) else None,
            sample_name=sample,
            token=token,
        )
