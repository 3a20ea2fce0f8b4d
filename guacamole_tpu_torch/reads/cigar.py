"""CIGAR parsing and coordinate arithmetic.

Equivalent functionality to the htsjdk Cigar machinery the reference relies
on (cf. reference .../CigarUtils.scala:23-43 and the BAM spec), written
for columnar/numpy-friendly consumption.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Tuple

# Canonical operator order from the BAM spec: op code -> char.
OPS = "MIDNSHP=X"
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)

CONSUMES_READ = (True, True, False, False, True, False, False, True, True)
CONSUMES_REF = (True, False, True, True, False, False, False, True, True)
IS_CLIP = (False, False, False, False, True, True, False, False, False)

_OP_CODE = {c: i for i, c in enumerate(OPS)}
_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


@dataclass(frozen=True)
class CigarElement:
    length: int
    op: int  # op code, index into OPS

    @property
    def op_char(self) -> str:
        return OPS[self.op]

    @property
    def consumes_read_bases(self) -> bool:
        return CONSUMES_READ[self.op]

    @property
    def consumes_reference_bases(self) -> bool:
        return CONSUMES_REF[self.op]

    @property
    def read_length(self) -> int:
        """Length in read coordinates (0 if op doesn't consume read bases)."""
        return self.length if CONSUMES_READ[self.op] else 0

    @property
    def reference_length(self) -> int:
        """Length in reference coordinates (0 if op doesn't consume them)."""
        return self.length if CONSUMES_REF[self.op] else 0

    def __str__(self) -> str:
        return f"{self.length}{self.op_char}"


class Cigar:
    """A parsed CIGAR: a list of (length, op) elements."""

    __slots__ = ("elements",)

    def __init__(self, elements: List[CigarElement]):
        self.elements = elements

    @staticmethod
    def from_string(cigar_string: str) -> "Cigar":
        if cigar_string in ("", "*"):
            return Cigar([])
        elements = []
        pos = 0
        for m in _CIGAR_RE.finditer(cigar_string):
            if m.start() != pos:
                raise ValueError(f"Malformed CIGAR: {cigar_string!r}")
            elements.append(CigarElement(int(m.group(1)), _OP_CODE[m.group(2)]))
            pos = m.end()
        if pos != len(cigar_string):
            raise ValueError(f"Malformed CIGAR: {cigar_string!r}")
        return Cigar(elements)

    @staticmethod
    def from_binary(ops: List[Tuple[int, int]]) -> "Cigar":
        """Build from (length, op_code) pairs as decoded from a BAM record."""
        return Cigar([CigarElement(length, op) for length, op in ops])

    @property
    def read_length(self) -> int:
        return sum(e.length for e in self.elements if CONSUMES_READ[e.op])

    @property
    def reference_length(self) -> int:
        """Bases of reference consumed (M/D/N/=/X)."""
        return sum(e.length for e in self.elements if CONSUMES_REF[e.op])

    @property
    def padded_reference_length(self) -> int:
        """Reference length including padding ops (M/D/N/=/X/P)."""
        return sum(
            e.length for e in self.elements if CONSUMES_REF[e.op] or e.op == OP_P
        )

    def __len__(self) -> int:
        return len(self.elements)

    def __iter__(self):
        return iter(self.elements)

    def __getitem__(self, i) -> CigarElement:
        return self.elements[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Cigar) and self.elements == other.elements

    def __hash__(self) -> int:
        return hash(tuple(self.elements))

    def __str__(self) -> str:
        return "".join(str(e) for e in self.elements) or "*"

    def __repr__(self) -> str:
        return f"Cigar({self})"
