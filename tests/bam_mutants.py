"""Malformed BAM records for the record parser of the port's native runtime.

Each targeted mutant changes one field of a BAM's last record (or cuts
it, appends a tag to it, or gives it another MD tag and CIGAR) and writes
the file again: the blocks before
the one that holds the record's start are kept byte for byte, the rest of
the inflated stream is compressed anew with gio/bgzf.compress_block. So a
.bai chunk of the clean file stays a chunk of the mutant, once an end that
lay past the kept blocks is moved to the mutant's end (`chunks_of`).
Besides, a BAM cut in its last data block, and one that lost whole
trailing blocks at a record boundary (`cut_at_block_boundary`).

Used by tests/test_torch_native_records.py and by chip_smoke.py's `native`
phase; it imports nothing of JAX.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from guacamole_tpu_torch.gio.bgzf import (
    BGZF_EOF_MARKER,
    compress_block,
    decompress_block,
)
from guacamole_tpu_torch.reads.mdtag import MdTagError

INT32_MAX = (1 << 31) - 1
_BLOCK = 0xFF00  # inflated bytes per block written, as BgzfWriter does
# Offsets of the fixed fields in a record, counted from its block_size.
_REF_ID, _POS, _L_READ_NAME, _N_CIGAR, _L_SEQ, _NEXT_REF = 4, 8, 12, 16, 20, 24


class Bam(NamedTuple):
    """A BAM taken apart: its compressed blocks, the inflated stream, the
    inflated offset of each block, where the records start, where each
    record starts, and the header's reference count."""

    data: bytes
    coffsets: List[int]
    ustarts: List[int]
    stream: bytes
    header_end: int
    records: List[int]
    n_ref: int


def read_bam(path: str) -> Bam:
    with open(path, "rb") as fh:
        data = fh.read()
    coffsets, ustarts, parts, off, total = [], [], [], 0, 0
    while off < len(data):
        block, bsize = decompress_block(data, off)
        coffsets.append(off)
        ustarts.append(total)
        parts.append(block)
        total += len(block)
        off += bsize
    stream = b"".join(parts)
    (l_text,) = struct.unpack_from("<i", stream, 4)
    pos = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", stream, pos)
    pos += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", stream, pos)
        pos += 4 + l_name + 4
    header_end, records = pos, []
    while pos < len(stream):
        records.append(pos)
        pos += 4 + struct.unpack_from("<i", stream, pos)[0]
    return Bam(data, coffsets, ustarts, stream, header_end, records, n_ref)


def compress(stream: bytes) -> bytes:
    return b"".join(compress_block(stream[i:i + _BLOCK])
                    for i in range(0, len(stream), _BLOCK)) + BGZF_EOF_MARKER


def _kept_block(bam: Bam) -> int:
    """Index of the block that holds the start of the last record."""
    last = bam.records[-1]
    return max(i for i, u in enumerate(bam.ustarts) if u <= last)


def rewrite_last(bam: Bam, new_stream: bytes) -> bytes:
    """The file of a stream that equals bam.stream before its last record:
    the blocks before the one holding that record's start byte for byte,
    the rest compressed anew."""
    k = _kept_block(bam)
    assert new_stream[:bam.records[-1]] == bam.stream[:bam.records[-1]]
    return bam.data[:bam.coffsets[k]] + compress(new_stream[bam.ustarts[k]:])


def chunks_of(bam: Bam, chunks, mutant_size: int):
    """The clean file's .bai chunks as chunks of a mutant made by
    rewrite_last: offsets in the kept blocks and in the first rewritten
    one stay; an end past them (the next block, or the file's end) becomes
    the mutant's end."""
    kept = bam.coffsets[_kept_block(bam)]
    return [(b, e if (e >> 16) <= kept else mutant_size << 16)
            for b, e in chunks]


def cut_in_last_data_block(bam: Bam) -> bytes:
    """The file cut in the middle of its last block that holds records:
    the blocks before it whole, then half of its compressed bytes."""
    k = max(i for i, u in enumerate(bam.ustarts) if u < len(bam.stream))
    end = bam.coffsets[k + 1] if k + 1 < len(bam.coffsets) else len(bam.data)
    return bam.data[:(bam.coffsets[k] + end) // 2]


def compress_at_records(bam: Bam) -> bytes:
    """The file of bam.stream written as htslib writes a BAM: the header in
    blocks of its own, then records, a block ending before a record that
    would not fit in it, so that every block ends at a record boundary."""
    cuts = list(range(0, bam.header_end, _BLOCK)) + [bam.header_end]
    for start, end in zip(bam.records, bam.records[1:] + [len(bam.stream)]):
        if end - cuts[-1] > _BLOCK:
            cuts.append(start)
    cuts.append(len(bam.stream))
    return b"".join(compress_block(bam.stream[a:b])
                    for a, b in zip(cuts, cuts[1:]) if b > a) + BGZF_EOF_MARKER


def cut_at_block_boundary(bam: Bam, lost: int = 1) -> Tuple[bytes, bytes]:
    """(clean, cut): the file written by compress_at_records, and that file
    without its last `lost` data blocks and its EOF marker. Every decoder
    reads the kept blocks' records whole, so only an index of the clean
    file can tell that reads are missing."""
    clean = compress_at_records(bam)
    starts, off = [], 0
    while off < len(clean):
        starts.append(off)
        off += decompress_block(clean, off)[1]
    return clean, clean[:starts[-1 - lost]]


def _set(fmt: str, at: int, value) -> Callable[[bytearray, Bam], None]:
    """Writes value, or value(bam) where it is a function of the BAM."""
    def edit(rec: bytearray, bam: Bam) -> None:
        struct.pack_into(fmt, rec, at,
                         value(bam) if callable(value) else value)
    return edit


def _cigar_at(rec: bytes) -> int:
    return 36 + rec[_L_READ_NAME]


def _first_op(length: int, op: int, pos: Optional[int] = None):
    def edit(rec: bytearray, _bam: Bam) -> None:
        struct.pack_into("<I", rec, _cigar_at(rec), (length << 4) | op)
        if pos is not None:
            struct.pack_into("<i", rec, _POS, pos)
    return edit


def _long_ops(count: int, pos: int):
    """The first CIGAR op becomes count ops of 2^28 - 1 M at pos: n_cigar
    and block_size grow with the ops inserted."""
    def edit(rec: bytearray, _bam: Bam) -> None:
        at = _cigar_at(rec)
        word = struct.pack("<I", (((1 << 28) - 1) << 4) | 0)
        rec[at:at + 4] = word * count
        (n_cigar,) = struct.unpack_from("<H", rec, _N_CIGAR)
        struct.pack_into("<H", rec, _N_CIGAR, n_cigar + count - 1)
        struct.pack_into("<i", rec, _POS, pos)
        struct.pack_into("<i", rec, 0, len(rec) - 4)
    return edit


def _op_code(code: int):
    def edit(rec: bytearray, _bam: Bam) -> None:
        at = _cigar_at(rec)
        (word,) = struct.unpack_from("<I", rec, at)
        struct.pack_into("<I", rec, at, (word & ~0xF) | code)
    return edit


def _append(tail: bytes):
    def edit(rec: bytearray, _bam: Bam) -> None:
        rec.extend(tail)
        struct.pack_into("<i", rec, 0, len(rec) - 4)
    return edit


def _cut(rec: bytearray, _bam: Bam) -> None:
    del rec[len(rec) // 2:]


def _tags_at(rec: bytes) -> int:
    (n_cigar,) = struct.unpack_from("<H", rec, _N_CIGAR)
    (l_seq,) = struct.unpack_from("<i", rec, _L_SEQ)
    return _cigar_at(rec) + 4 * n_cigar + (l_seq + 1) // 2 + l_seq


def _other_tags(tags: bytes, name: bytes) -> bytes:
    """The tags of a record but the one named."""
    sizes = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
    out, p = b"", 0
    while p < len(tags):
        typ = chr(tags[p + 2])
        if typ in "ZH":
            end = tags.index(b"\0", p + 3) + 1
        elif typ == "B":
            (count,) = struct.unpack_from("<I", tags, p + 4)
            end = p + 8 + count * sizes.get(chr(tags[p + 3]), 4)
        else:
            end = p + 3 + sizes[typ]
        if tags[p:p + 2] != name:
            out += tags[p:end]
        p = end
    return out


def _md(tag: str, cigar: Optional[str] = None):
    """The record's MD tag becomes tag, and its CIGAR cigar where given."""
    def edit(rec: bytearray, _bam: Bam) -> None:
        tags = _other_tags(bytes(rec[_tags_at(rec):]), b"MD")
        if cigar is not None:
            at = _cigar_at(rec)
            (n_cigar,) = struct.unpack_from("<H", rec, _N_CIGAR)
            rec[at:at + 4 * n_cigar] = b"".join(
                struct.pack("<I", (int(n) << 4) | "MIDNSHP=X".index(op))
                for n, op in re.findall(r"(\d+)(\D)", cigar))
            struct.pack_into("<H", rec, _N_CIGAR,
                             len(re.findall(r"\D", cigar)))
        rec[_tags_at(rec):] = tags + b"MDZ" + tag.encode() + b"\0"
        struct.pack_into("<i", rec, 0, len(rec) - 4)
    return edit


class Mutant(NamedTuple):
    name: str
    edit: Callable[[bytearray, Bam], None]  # rewrites the record in place
    field: Optional[str]  # what the refusal must name; None: accepted
    # What gio/bam.py's BamFile.records() raises on it; () where it reads
    # the file.
    object_reader_raises: Tuple[type, ...]


_STRUCT = (struct.error, IndexError)


# One field of the last record each. The first seven are the rows of the
# reproduction on the scale-0.02 fixture; the seventh, one CIGAR op of
# 2^28 - 1 bases, is a legal 28-bit length and stays accepted (the read's
# CIGAR does not match its sequence, so it is marked inconsistent).
MUTANTS = (
    Mutant("l_seq_2e24", _set("<i", _L_SEQ, 1 << 24), "l_seq", _STRUCT),
    Mutant("l_seq_negative", _set("<i", _L_SEQ, -7), "l_seq", _STRUCT),
    Mutant("n_cigar_ffff", _set("<H", _N_CIGAR, 0xFFFF), "n_cigar", _STRUCT),
    Mutant("l_read_name_255", _set("<B", _L_READ_NAME, 255), "l_read_name",
           _STRUCT),
    Mutant("cigar_op_9", _op_code(9), "CIGAR op", ()),
    Mutant("block_size_8", _set("<i", 0, 8), "block_size", _STRUCT),
    Mutant("op_2e28_m", _first_op((1 << 28) - 1, 0), None, ()),
    Mutant("block_size_0", _set("<i", 0, 0), "block_size", _STRUCT),
    Mutant("block_size_31", _set("<i", 0, 31), "block_size", _STRUCT),
    Mutant("block_size_past_end", _set("<i", 0, 1_000_000), "block_size",
           ()),
    # A B tag whose subtype and count lie past the block's end.
    Mutant("b_tag_header_cut", _append(b"ZZBc\0\0"), "B tag", ()),
    # A B tag of 1,000 int8 values with 2 in the block.
    Mutant("b_tag_count", _append(b"ZZBc" + struct.pack("<I", 1000) + b"\1\2"),
           "B tag count", ()),
    Mutant("record_cut", _cut, "block_size", ()),
    Mutant("span_past_int32",
           _first_op((1 << 28) - 1, 0, pos=INT32_MAX - (1 << 27)), "span",
           ()),
    # An unmapped record (pos -1) whose nine ops of 2^28 - 1 bases span
    # more than 2^31 - 1: the span alone sizes its event arrays.
    Mutant("span_unmapped", _long_ops(9, -1), "span", ()),
    # Reference ids past the header's list or below -1, and a position
    # below -1. The object reader maps such an id to '*' (and a position
    # of -2 makes the read unmapped) where the decoders refuse them.
    Mutant("ref_id_past_header", _set("<i", _REF_ID, lambda bam: bam.n_ref),
           "ref_id", ()),
    Mutant("ref_id_minus_2", _set("<i", _REF_ID, -2), "ref_id", ()),
    Mutant("next_ref_past_header",
           _set("<i", _NEXT_REF, lambda bam: bam.n_ref), "next_ref", ()),
    Mutant("pos_minus_2", _set("<i", _POS, -2), "pos", ()),
    # MD tags that cannot be expanded against their CIGAR, one for each
    # MdTagError of reads/mdtag.py's MdTag: bytes that are no MD text, in
    # the tag and after it; a tag that ends before its CIGAR, a deletion
    # inside a match run, a D op without its deletion, a deletion of
    # another length. The last record is 100M, 100 bases.
    Mutant("md_not_md_text", _md("30A35?33"), "MD tag", (MdTagError,)),
    Mutant("md_trailing_caret", _md("100^"), "MD tag", (MdTagError,)),
    Mutant("md_ended_early", _md("50"), "MD tag", (MdTagError,)),
    Mutant("md_deletion_in_match", _md("50^AC50"), "MD tag", (MdTagError,)),
    Mutant("md_missing_deletion", _md("100", "50M2D50M"), "MD tag",
           (MdTagError,)),
    Mutant("md_deletion_length", _md("50^ACG50", "50M2D50M"), "MD tag",
           (MdTagError,)),
    # A well-formed tag over an N gap, which MD does not cover: decoded,
    # with N reference bases over the gap.
    Mutant("md_over_n_gap", _md("100", "50M100N50M"), None, ()),
)


def make_mutant(bam: Bam, mutant: Mutant) -> bytes:
    start = bam.records[-1]
    rec = bytearray(bam.stream[start:])
    mutant.edit(rec, bam)
    return rewrite_last(bam, bam.stream[:start] + bytes(rec))


def write_mutants(bam_path: str, out_dir: str) -> Dict[str, str]:
    """{mutant name: path} of every targeted mutant of one BAM."""
    bam = read_bam(bam_path)
    stem = os.path.splitext(os.path.basename(bam_path))[0]
    paths = {}
    for mutant in MUTANTS:
        path = os.path.join(out_dir, f"{stem}.{mutant.name}.bam")
        with open(path, "wb") as fh:
            fh.write(make_mutant(bam, mutant))
        paths[mutant.name] = path
    return paths


def random_mutants(bam_path: str, out_dir: str, n: int,
                   seed: int = 2026) -> List[Tuple[str, str]]:
    """(path, what) of n mutants of one BAM: each changes one byte, or
    writes one int32, at a seeded place in the record area of the inflated
    stream, which is then compressed anew."""
    bam = read_bam(bam_path)
    rng = np.random.default_rng(seed)
    specials = [0, -1, 1, INT32_MAX, -INT32_MAX - 1, 1 << 24, 0xFFFF,
                ((1 << 28) - 1) << 4, (((1 << 28) - 1) << 4) | 2]
    out = []
    for i in range(n):
        stream = bytearray(bam.stream)
        at = int(rng.integers(bam.header_end, len(stream)))
        if i % 2 == 0:
            flip = int(rng.integers(1, 256))
            stream[at] ^= flip
            what = f"byte {at} ^= {flip}"
        else:
            at = min(at, len(stream) - 4)
            value = (int(rng.choice(specials)) if rng.random() < 0.5
                     else int(rng.integers(-(1 << 31), 1 << 31)))
            struct.pack_into("<I", stream, at, value & 0xFFFFFFFF)
            what = f"int32 {at} = {value}"
        path = os.path.join(out_dir, f"fuzz{i}.bam")
        with open(path, "wb") as fh:
            fh.write(compress(bytes(stream)))
        out.append((path, what))
    return out
