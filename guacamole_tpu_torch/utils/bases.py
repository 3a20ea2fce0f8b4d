"""Nucleotide base utilities.

Bases are represented as single ASCII byte values (ints), and sequences as
Python ``bytes`` — mirroring the byte-encoded representation of the reference
(cf. reference .../Bases.scala:31-128) while staying numpy/TPU friendly
(a ``bytes`` maps directly onto a uint8 array).
"""

from __future__ import annotations

import numpy as np

A = ord("A")
C = ord("C")
T = ord("T")
G = ord("G")
N = ord("N")

# Placeholder alt used when emitting no-call / hom-ref records
# (cf. Bases.scala:43 `ALT = "<ALT>"`).
ALT = b"<ALT>"

_COMPLEMENT = {A: T, T: A, C: G, G: C}

_STANDARD = frozenset((A, C, G, T))

# uint8 lookup tables for vectorized operations.
COMPLEMENT_TABLE = np.full(256, N, dtype=np.uint8)
for _b, _c in _COMPLEMENT.items():
    COMPLEMENT_TABLE[_b] = _c

IS_STANDARD_TABLE = np.zeros(256, dtype=bool)
for _b in _STANDARD:
    IS_STANDARD_TABLE[_b] = True

UNMASK_TABLE = np.arange(256, dtype=np.uint8)
for _b in range(ord("a"), ord("z") + 1):
    UNMASK_TABLE[_b] = _b - 32  # uppercase


def complement(base: int) -> int:
    """Watson-Crick complement of a single base (N for non-standard)."""
    return _COMPLEMENT.get(base, N)


def complement_seq(seq: bytes) -> bytes:
    return bytes(COMPLEMENT_TABLE[np.frombuffer(seq, dtype=np.uint8)])


def reverse_complement(seq: bytes) -> bytes:
    return complement_seq(seq[::-1])


def is_standard_base(base: int) -> bool:
    """Is the base one of the 4 canonical DNA bases?"""
    return base in _STANDARD


def all_standard_bases(seq: bytes) -> bool:
    return all(b in _STANDARD for b in seq)


def bases_to_string(seq) -> str:
    """Convert a byte sequence to its string form (e.g. b'ACT' -> 'ACT')."""
    if isinstance(seq, (bytes, bytearray)):
        return seq.decode("ascii")
    return bytes(seq).decode("ascii")


def string_to_bases(s: str) -> bytes:
    """Convert a string (e.g. 'aaGgc') to an upper-cased byte sequence."""
    return s.upper().encode("ascii")


def unmask(seq: bytes) -> bytes:
    """Uppercase soft-masked (lower-case) bases."""
    return bytes(UNMASK_TABLE[np.frombuffer(seq, dtype=np.uint8)])
