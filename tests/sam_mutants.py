"""Malformed SAM lines for the SAM parser of the port's native runtime.

Each targeted mutant changes one field of a SAM's last record line, or of
its first @SQ header line, and writes the file again; every other byte
stays. A refusal must name the field and the line (1-based, header lines
counted).

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
_FLAG, _POS, _MAPQ, _CIGAR, _PNEXT, _TLEN = 1, 3, 4, 5, 7, 8


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
)


def _lines(path: str) -> List[str]:
    with open(path) as fh:
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
        with open(path, "w") as fh:
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
