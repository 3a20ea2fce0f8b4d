"""Malformed SAM lines for the SAM parser of the port's native runtime.

Each targeted mutant changes one field of a SAM's last record line, or of
its first @SQ header line, and writes the file again; every other byte
stays. A refusal must name the field and the line (1-based, header lines
counted). Files are read and written as latin-1, so that a mutant can hold
any byte.

Used by tests/test_torch_native_sam.py and by chip_smoke.py's `native`
phase; it imports nothing of JAX.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np

INT32_MAX = (1 << 31) - 1
# Record fields by index: QNAME FLAG RNAME POS MAPQ CIGAR RNEXT PNEXT TLEN
# SEQ QUAL, then the tags.
_QNAME, _FLAG, _RNAME, _POS, _MAPQ, _CIGAR = 0, 1, 2, 3, 4, 5
_RNEXT, _PNEXT, _TLEN, _SEQ, _QUAL = 6, 7, 8, 9, 10


class SamMutant(NamedTuple):
    name: str
    header: bool  # the first @SQ line; else the last record line
    edit: Callable[[List[str]], None]  # rewrites the line's fields
    field: str  # what the refusal must name
    object_reader_raises: bool  # gio/sam.py read_sam raises too


def _field(index: int, value: str):
    def edit(fields: List[str]) -> None:
        fields[index] = value
    return edit


def _byte(index: int, at: int, byte: int, replace: bool = False):
    """`byte` inserted into the field before its byte `at`, or put in
    that byte's place (so that SEQ and QUAL keep their length)."""
    def edit(fields: List[str]) -> None:
        value = fields[index]
        fields[index] = value[:at] + chr(byte) + value[at + replace:]
    return edit


def _md(tag: str, cigar: str = ""):
    """The record's MD tag becomes tag, and its CIGAR cigar where given."""
    def edit(fields: List[str]) -> None:
        if cigar:
            fields[_CIGAR] = cigar
        k = next(i for i, f in enumerate(fields) if f.startswith("MD:Z:"))
        fields[k] = "MD:Z:" + tag
    return edit


def _joined(fields: List[str]) -> None:
    """The record's line written twice, without the newline between."""
    fields.extend(list(fields))


def _ln(value: str):
    def edit(fields: List[str]) -> None:
        k = next(i for i, f in enumerate(fields) if f.startswith("LN:"))
        fields[k] = "LN:" + value
    return edit


# The first three and LN:abc are not numbers, which the object reader
# refuses too (int() raises); the next four are numbers outside the
# field's range in the SAM spec, which it accepts. Ten ops of 2^28 - 1
# bases span more than 2^31 - 1 reference bases; the object reader raises
# there only because the record's MD tag no longer fits its CIGAR.
MUTANTS = (
    SamMutant("pos_12abc", False, _field(_POS, "12abc"), "POS", True),
    SamMutant("pos_abc", False, _field(_POS, "abc"), "POS", True),
    SamMutant("mapq_empty", False, _field(_MAPQ, ""), "MAPQ", True),
    SamMutant("flag_70000", False, _field(_FLAG, "70000"), "FLAG", False),
    SamMutant("mapq_300", False, _field(_MAPQ, "300"), "MAPQ", False),
    SamMutant("mapq_minus_1", False, _field(_MAPQ, "-1"), "MAPQ", False),
    SamMutant("pos_2e31", False, _field(_POS, str(1 << 31)), "POS", False),
    SamMutant("ten_long_ops", False,
              _field(_CIGAR, f"{(1 << 28) - 1}M" * 10), "span", True),
    SamMutant("ln_abc", True, _ln("abc"), "LN", True),
    # The MD mutants of tests/bam_mutants.py, one for each MdTagError of
    # reads/mdtag.py's MdTag; the last record is 100M.
    SamMutant("md_not_md_text", False, _md("30A35?33"), "MD tag", True),
    SamMutant("md_trailing_caret", False, _md("100^"), "MD tag", True),
    SamMutant("md_ended_early", False, _md("50"), "MD tag", True),
    SamMutant("md_deletion_in_match", False, _md("50^AC50"), "MD tag", True),
    SamMutant("md_missing_deletion", False, _md("100", "50M2D50M"), "MD tag",
              True),
    SamMutant("md_deletion_length", False, _md("50^ACG50", "50M2D50M"),
              "MD tag", True),
    # Two records on one line: the second one's QNAME is read as an
    # optional field, which the object reader skips.
    SamMutant("joined_line", False, _joined, "optional field", False),
    # A byte SAMv1 section 1.4 excludes from each mandatory text field.
    # The object reader takes the first four; 0x80 is no UTF-8, and a
    # CIGAR with whitespace does not match its pattern.
    SamMutant("qname_0x01", False, _byte(_QNAME, 3, 0x01), "QNAME", False),
    SamMutant("rname_0x20", False, _byte(_RNAME, 4, 0x20), "RNAME", False),
    SamMutant("rnext_0x7f", False, _field(_RNEXT, "mate\x7f"), "RNEXT",
              False),
    SamMutant("qual_0x7f", False, _byte(_QUAL, 50, 0x7F, True), "QUAL",
              False),
    SamMutant("seq_0x80", False, _byte(_SEQ, 50, 0x80, True), "SEQ", True),
    SamMutant("cigar_0x0b", False, _byte(_CIGAR, 0, 0x0B), "CIGAR", True),
)


def _lines(path: str) -> List[str]:
    with open(path, encoding="latin-1") as fh:
        return fh.read().split("\n")


def target_line(lines: List[str], header: bool) -> int:
    """Index of the line a mutant edits: the first @SQ line, or the last
    record line."""
    if header:
        return next(i for i, line in enumerate(lines)
                    if line.startswith("@SQ\t"))
    return max(i for i, line in enumerate(lines)
               if line and not line.startswith("@"))


def make_mutant(lines: List[str], mutant: SamMutant) -> Tuple[str, int]:
    """(text, 1-based line number) of one mutant of a SAM's lines."""
    i = target_line(lines, mutant.header)
    fields = lines[i].split("\t")
    mutant.edit(fields)
    out = list(lines)
    out[i] = "\t".join(fields)
    return "\n".join(out), i + 1


def write_mutants(sam_path: str, out_dir: str) -> Dict[str, Tuple[str, int]]:
    """{mutant name: (path, line number)} of every targeted mutant of one
    SAM."""
    lines = _lines(sam_path)
    stem = os.path.splitext(os.path.basename(sam_path))[0]
    out = {}
    for mutant in MUTANTS:
        text, line_no = make_mutant(lines, mutant)
        path = os.path.join(out_dir, f"{stem}.{mutant.name}.sam")
        with open(path, "w", encoding="latin-1") as fh:
            fh.write(text)
        out[mutant.name] = (path, line_no)
    return out


# Field values for the random mutants: empty, signs, the ends of the
# ranges and one past them, forms strtol would take in part.
_VALUES = ("", "-", "+", "-1", "0", "+7", " 7", "7 ", "255", "256", "65535",
           "65536", str(INT32_MAX), str(INT32_MAX + 1), str(-INT32_MAX),
           str(-INT32_MAX - 1), "9" * 25, "1e3", "0x10", "12abc", "abc")


def random_mutants(sam_path: str, out_dir: str, n: int,
                   seed: int = 2026) -> List[Tuple[str, str]]:
    """(path, what) of n mutants of one SAM's record lines: the even ones
    flip one byte at a seeded place in the records, the odd ones give one
    numeric field of a seeded record a value of _VALUES."""
    with open(sam_path, "rb") as fh:
        data = fh.read()
    lines = data.split(b"\n")
    first = next(i for i, line in enumerate(lines)
                 if line and not line.startswith(b"@"))
    body = sum(len(line) + 1 for line in lines[:first])
    records = [i for i in range(first, len(lines)) if lines[i]]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 2 == 0:
            at = int(rng.integers(body, len(data)))
            flip = int(rng.integers(1, 256))
            mutated = bytearray(data)
            mutated[at] ^= flip
            what = f"byte {at} ^= {flip}"
        else:
            k = records[int(rng.integers(len(records)))]
            index = int(rng.choice([_FLAG, _POS, _MAPQ, _PNEXT, _TLEN]))
            value = _VALUES[int(rng.integers(len(_VALUES)))]
            fields = lines[k].split(b"\t")
            fields[index] = value.encode()
            mutated = b"\n".join(lines[:k] + [b"\t".join(fields)]
                                 + lines[k + 1:])
            what = f"line {k + 1} field {index} = {value!r}"
        path = os.path.join(out_dir, f"fuzz{i}.sam")
        with open(path, "wb") as fh:
            fh.write(bytes(mutated))
        out.append((path, what))
    return out
