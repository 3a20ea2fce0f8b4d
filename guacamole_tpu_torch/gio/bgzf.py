"""BGZF block-compressed file support (the container format of BAM).

A BGZF file is a series of independent gzip members, each with a BSIZE
extra subfield giving the compressed block size. Random access uses
"virtual offsets": (compressed_block_offset << 16) | within_block_offset.

This is the Python reference implementation; the hot decode path is
replaced by the multithreaded C++ runtime when available (see
guacamole_tpu_torch/runtime).
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, List, Optional, Tuple

BGZF_EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfError(ValueError):
    pass


def _parse_block_header(data: bytes, offset: int) -> Tuple[int, int]:
    """Return (xlen, bsize) for the block starting at offset."""
    if data[offset] != 0x1F or data[offset + 1] != 0x8B:
        raise BgzfError(f"Not a gzip block at offset {offset}")
    flg = data[offset + 3]
    if not flg & 0x04:
        raise BgzfError("gzip block missing FEXTRA (not BGZF)")
    xlen = struct.unpack_from("<H", data, offset + 10)[0]
    # Scan extra subfields for BC (BSIZE).
    pos = offset + 12
    end = pos + xlen
    bsize = None
    while pos < end:
        si1, si2, slen = struct.unpack_from("<BBH", data, pos)
        if si1 == 66 and si2 == 67 and slen == 2:
            bsize = struct.unpack_from("<H", data, pos + 4)[0] + 1
        pos += 4 + slen
    if bsize is None:
        raise BgzfError("BGZF block missing BSIZE subfield")
    return xlen, bsize


def decompress_block(data: bytes, offset: int) -> Tuple[bytes, int]:
    """Decompress one BGZF block at byte `offset`. Returns
    (uncompressed_bytes, compressed_block_size)."""
    xlen, bsize = _parse_block_header(data, offset)
    cdata_start = offset + 12 + xlen
    cdata_end = offset + bsize - 8
    isize = struct.unpack_from("<I", data, offset + bsize - 4)[0]
    out = zlib.decompress(data[cdata_start:cdata_end], wbits=-15, bufsize=isize or 1)
    if len(out) != isize:
        raise BgzfError(f"BGZF ISIZE mismatch at offset {offset}")
    return out, bsize


def compress_block(data: bytes, level: int = 6) -> bytes:
    """Compress up to 64KiB of data into one BGZF block."""
    assert len(data) <= 65536
    compressor = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = compressor.compress(data) + compressor.flush()
    bsize = len(cdata) + 12 + 6 + 8
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4,  # magic, CM=deflate, FLG=FEXTRA
        0,  # MTIME
        0, 0xFF,  # XFL, OS
        6,  # XLEN
        66, 67, 2,  # BC subfield
        bsize - 1,
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + cdata + footer


class BgzfReader:
    """Random-access reader over an in-memory BGZF file.

    For the file sizes in play on a single host shard (each host reads only
    its loci shard's byte ranges), reading the compressed bytes into memory
    and inflating blocks on demand is both simple and fast; block inflation
    is also offloaded to the C++ runtime when built.
    """

    def __init__(self, path: str):
        import mmap

        self._file = open(path, "rb")
        try:
            # Memory-map so header-only reads (e.g. the pushdown planner)
            # touch only the pages they parse, not the whole file.
            self._data = mmap.mmap(
                self._file.fileno(), 0, access=mmap.ACCESS_READ
            )
        except (ValueError, OSError):  # empty file or mmap-less FS
            self._data = self._file.read()
        self._block_cache: dict[int, bytes] = {}

    def block(self, coffset: int) -> bytes:
        cached = self._block_cache.get(coffset)
        if cached is None:
            cached, _ = decompress_block(self._data, coffset)
            self._block_cache[coffset] = cached
        return cached

    def blocks(self) -> Iterator[Tuple[int, bytes]]:
        """Iterate (compressed_offset, uncompressed_bytes) over all blocks."""
        offset = 0
        n = len(self._data)
        while offset < n:
            out, bsize = decompress_block(self._data, offset)
            if out:
                yield offset, out
            offset += bsize

    def read_all(self) -> bytes:
        return b"".join(block for _, block in self.blocks())

    def read_range(self, vstart: int, vend: Optional[int]) -> bytes:
        """Read the uncompressed bytes between two virtual offsets.

        vend of None reads to end of file.
        """
        cstart, ustart = vstart >> 16, vstart & 0xFFFF
        if vend is not None:
            cend, uend = vend >> 16, vend & 0xFFFF
        else:
            cend, uend = len(self._data), 0
        parts: List[bytes] = []
        offset = cstart
        n = len(self._data)
        while offset < n:
            out, bsize = decompress_block(self._data, offset)
            lo = ustart if offset == cstart else 0
            hi = uend if offset == cend else len(out)
            if offset == cend and uend == 0 and offset != cstart:
                break
            parts.append(out[lo:hi])
            if offset == cend:
                break
            offset += bsize
        return b"".join(parts)


class BgzfWriter:
    """Streaming BGZF writer (used for BAM output and tests)."""

    def __init__(self, path: str, level: int = 6):
        self._fh = open(path, "wb")
        self._buffer = bytearray()
        self._level = level

    def write(self, data: bytes) -> None:
        self._buffer.extend(data)
        while len(self._buffer) >= 65280:
            self._flush_block(65280)

    def _flush_block(self, size: int) -> None:
        chunk = bytes(self._buffer[:size])
        del self._buffer[:size]
        self._fh.write(compress_block(chunk, self._level))

    def close(self) -> None:
        if self._buffer:
            self._flush_block(len(self._buffer))
        self._fh.write(BGZF_EOF_MARKER)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
