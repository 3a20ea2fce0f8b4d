"""LociSet: an immutable collection of genomic regions.

Interval-compressed (memory is O(ranges), not O(loci)) so whole-genome sets
are cheap; wraps LociMap with ignored values
(cf. reference .../LociSet.scala:39-352).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from guacamole_tpu_torch.loci.locimap import LociMap, LociMapBuilder, SingleContigMap


class SingleContigSet:
    """A set of loci on a single contig."""

    __slots__ = ("map",)

    def __init__(self, contig_map: SingleContigMap):
        self.map = contig_map

    @property
    def contig(self) -> str:
        return self.map.contig

    def contains(self, locus: int) -> bool:
        return self.map.contains(locus)

    def __contains__(self, locus: int) -> bool:
        return self.map.contains(locus)

    @property
    def ranges(self) -> List[Tuple[int, int]]:
        return self.map.ranges

    @property
    def starts(self) -> np.ndarray:
        return self.map.starts

    @property
    def ends(self) -> np.ndarray:
        return self.map.ends

    @property
    def count(self) -> int:
        return self.map.count

    @property
    def is_empty(self) -> bool:
        return self.map.is_empty

    def intersects(self, start: int, end: int) -> bool:
        """Does any locus of this set fall in [start, end)?"""
        return self.map.intersects(start, end)

    def union(self, other: "SingleContigSet") -> "SingleContigSet":
        return SingleContigSet(self.map.union(other.map))

    def iterator(self) -> "SkippableLociIterator":
        return SkippableLociIterator(self)

    def __iter__(self) -> Iterator[int]:
        return self.iterator()

    def __str__(self) -> str:
        return ",".join(self.map.string_pieces(include_values=False))


class SkippableLociIterator:
    """Sorted iterator over the loci of a SingleContigSet that supports
    skipping ahead (cf. LociSet.scala:287-351)."""

    __slots__ = ("_ranges", "_range_idx", "_offset")

    def __init__(self, loci: SingleContigSet):
        self._ranges = loci.ranges
        self._range_idx = 0
        self._offset = 0

    def has_next(self) -> bool:
        return self._range_idx < len(self._ranges)

    @property
    def head(self) -> int:
        if not self.has_next():
            raise StopIteration("empty iterator")
        start, _ = self._ranges[self._range_idx]
        return start + self._offset

    def __next__(self) -> int:
        value = self.head
        self._offset += 1
        start, end = self._ranges[self._range_idx]
        if start + self._offset == end:
            self._range_idx += 1
            self._offset = 0
        return value

    def __iter__(self):
        return self

    def skip_to(self, locus: int) -> None:
        """After this, next() returns the first element >= locus."""
        while (
            self._range_idx < len(self._ranges)
            and self._ranges[self._range_idx][1] <= locus
        ):
            self._range_idx += 1
            self._offset = 0
        if self._range_idx < len(self._ranges):
            start, end = self._ranges[self._range_idx]
            if start <= locus < end:
                self._offset = locus - start


class LociSet:
    """An immutable set of loci across contigs."""

    __slots__ = ("map",)

    def __init__(self, loci_map: LociMap):
        self.map = loci_map

    @staticmethod
    def empty() -> "LociSet":
        return LociSet(LociMap({}))

    @staticmethod
    def of(contig: str, start: int, end: int) -> "LociSet":
        return LociSetBuilder().put(contig, start, end).result()

    @property
    def contigs(self) -> List[str]:
        return self.map.contigs

    @property
    def count(self) -> int:
        return self.map.count

    @property
    def is_empty(self) -> bool:
        return self.map.is_empty

    def on_contig(self, contig: str) -> SingleContigSet:
        return SingleContigSet(self.map.on_contig(contig))

    def union(self, other: "LociSet") -> "LociSet":
        return LociSet(self.map.union(other.map))

    @staticmethod
    def union_all(*loci_sets: "LociSet") -> "LociSet":
        maker = LociMapBuilder()
        for loci_set in loci_sets:
            maker.put_loci_set(loci_set, 0)
        return LociSet(maker.result())

    def filter_contigs(self, predicate) -> "LociSet":
        return LociSet(self.map.filter_contigs(predicate))

    def take(self, num_to_take: int) -> Tuple["LociSet", "LociSet"]:
        assert num_to_take <= self.count, (
            f"Can't take {num_to_take} loci from a set of size {self.count}."
        )
        if num_to_take == 0:
            return LociSet.empty(), self
        if num_to_take == self.count:
            return self, LociSet.empty()
        first, second = self.map.take(num_to_take)
        return LociSet(first), LociSet(second)

    def truncated_string(self, max_length: int = 200) -> str:
        return self.map.truncated_string(max_length, include_values=False)

    def __str__(self) -> str:
        return self.map.truncated_string(2**62, include_values=False)

    def __eq__(self, other) -> bool:
        return isinstance(other, LociSet) and self._key() == other._key()

    def _key(self):
        return tuple(
            (c, tuple(self.map.on_contig(c).ranges)) for c in self.contigs
        )

    def __hash__(self) -> int:
        return hash(self._key())


_CONTIG_AND_LOCI = re.compile(r"^([\w.]+):(\d+)-(\d+)$", re.UNICODE)
_CONTIG_ONLY = re.compile(r"^([\w.]+)$", re.UNICODE)


class LociSetBuilder:
    """Builds a LociSet, supporting specifications made before contig lengths
    are known ('all', or bare contig names; cf. LociSet.scala:118-222).
    """

    def __init__(self) -> None:
        self.fully_resolved = True
        self.contains_all = False
        self._ranges: List[Tuple[str, int, Optional[int]]] = []

    def put_all_contigs(self) -> "LociSetBuilder":
        self.contains_all = True
        self.fully_resolved = False
        return self

    def put(
        self, contig: str, start: int = 0, end: Optional[int] = None
    ) -> "LociSetBuilder":
        assert start >= 0
        assert end is None or end >= start
        if not self.contains_all:
            self._ranges.append((contig, start, end))
            if end is None:
                self.fully_resolved = False
        return self

    def put_expression(self, loci: str) -> "LociSetBuilder":
        """Parse a loci expression, e.g. 'all', 'chr1,chr3',
        'chr1:10000-20000,chr2'."""
        if loci == "all":
            return self.put_all_contigs()
        for piece in re.sub(r"\s", "", loci).split(","):
            if piece == "":
                continue
            m = _CONTIG_AND_LOCI.match(piece)
            if m is not None:
                self.put(m.group(1), int(m.group(2)), int(m.group(3)))
                continue
            m = _CONTIG_ONLY.match(piece)
            if m is not None:
                self.put(m.group(1))
                continue
            raise ValueError(f"Couldn't parse loci range: {piece}")
        return self

    def result(self, contig_lengths: Optional[Dict[str, int]] = None) -> LociSet:
        assert contig_lengths is not None or self.fully_resolved, (
            "Unresolved LociSet requires contig lengths"
        )
        maker = LociMapBuilder()
        if contig_lengths is not None:
            for contig, start, end in self._ranges:
                if contig not in contig_lengths:
                    raise ValueError(f"No such contig: {contig}")
                length = contig_lengths[contig]
                if end is not None and end > length:
                    raise ValueError(
                        "Invalid range %d-%d for contig '%s' which has length %d"
                        % (start, end, contig, length)
                    )
        if self.contains_all:
            # NOTE: matches the reference's quirk of excluding the final base
            # of each contig when expanding "all" (LociSet.scala:205-207 puts
            # [0, contigLength - 1)).
            assert contig_lengths is not None
            for contig, length in contig_lengths.items():
                maker.put(contig, 0, length - 1, 0)
        else:
            for contig, start, end in self._ranges:
                resolved_end = end if end is not None else contig_lengths[contig]
                maker.put(contig, start, resolved_end, 0)
        return LociSet(maker.result())


def parse_loci(loci: str) -> LociSetBuilder:
    """Parse a loci expression into a (possibly unresolved) maker."""
    return LociSetBuilder().put_expression(loci)
