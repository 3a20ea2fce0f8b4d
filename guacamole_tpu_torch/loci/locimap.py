"""LociMap: an immutable map from genomic loci to values of arbitrary type.

Implemented as per-contig sorted interval arrays (half-open [start, end)),
with adjacent equal-value coalescing — functionally equivalent to the
reference's Guava-RangeMap-backed LociMap
(cf. reference .../LociMap.scala:37-341) but stored as parallel numpy
arrays so lookups vectorize (binary search) on host.
"""

from __future__ import annotations

import bisect
from typing import Dict, Generic, Iterable, List, Optional, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


class SingleContigMap(Generic[T]):
    """A loci -> value map restricted to one contig.

    Stores sorted non-overlapping ranges as (starts, ends, values), with
    adjacent ranges mapping to the same value coalesced.
    """

    __slots__ = ("contig", "starts", "ends", "values")

    def __init__(
        self, contig: str, starts: np.ndarray, ends: np.ndarray, values: list
    ):
        self.contig = contig
        self.starts = starts  # int64, sorted
        self.ends = ends  # int64
        self.values = values  # python list, parallel to starts/ends

    @staticmethod
    def empty(contig: str) -> "SingleContigMap":
        return SingleContigMap(
            contig,
            np.empty(0, dtype=np.int64),
            np.empty(0, dtype=np.int64),
            [],
        )

    def _range_index(self, locus: int) -> int:
        """Index of the range containing locus, or -1."""
        i = int(np.searchsorted(self.starts, locus, side="right")) - 1
        if i >= 0 and locus < self.ends[i]:
            return i
        return -1

    def get(self, locus: int) -> Optional[T]:
        i = self._range_index(locus)
        return self.values[i] if i >= 0 else None

    def contains(self, locus: int) -> bool:
        return self._range_index(locus) >= 0

    def get_all(self, start: int, end: int) -> set:
        """All values mapped to by any locus in [start, end)."""
        if end <= start or len(self.starts) == 0:
            return set()
        lo = int(np.searchsorted(self.ends, start, side="right"))
        hi = int(np.searchsorted(self.starts, end, side="left"))
        return set(self.values[lo:hi])

    def get_all_indices(self, start: int, end: int) -> Tuple[int, int]:
        """Range [lo, hi) of interval indices overlapping [start, end)."""
        if end <= start:
            return 0, 0
        lo = int(np.searchsorted(self.ends, start, side="right"))
        hi = int(np.searchsorted(self.starts, end, side="left"))
        return lo, hi

    def intersects(self, start: int, end: int) -> bool:
        lo, hi = self.get_all_indices(start, end)
        return hi > lo

    @property
    def ranges(self) -> List[Tuple[int, int]]:
        return list(zip(self.starts.tolist(), self.ends.tolist()))

    @property
    def items(self) -> List[Tuple[int, int, T]]:
        return list(zip(self.starts.tolist(), self.ends.tolist(), self.values))

    @property
    def count(self) -> int:
        return int((self.ends - self.starts).sum()) if len(self.starts) else 0

    @property
    def num_ranges(self) -> int:
        return len(self.starts)

    @property
    def is_empty(self) -> bool:
        return len(self.starts) == 0

    def loci_individually(self) -> Iterable[int]:
        for s, e in self.ranges:
            yield from range(s, e)

    def union(self, other: "SingleContigMap") -> "SingleContigMap":
        assert self.contig == other.contig
        maker = LociMapBuilder()
        for s, e, v in self.items:
            maker.put(self.contig, s, e, v)
        for s, e, v in other.items:
            maker.put(self.contig, s, e, v)
        return maker.result().on_contig(self.contig)

    def string_pieces(self, include_values: bool = True) -> Iterable[str]:
        for s, e, v in self.items:
            if include_values:
                yield f"{self.contig}:{s}-{e}={v}"
            else:
                yield f"{self.contig}:{s}-{e}"

    def __str__(self) -> str:
        return ",".join(self.string_pieces())

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SingleContigMap)
            and self.contig == other.contig
            and np.array_equal(self.starts, other.starts)
            and np.array_equal(self.ends, other.ends)
            and self.values == other.values
        )

    def __hash__(self) -> int:
        return hash((self.contig, self.starts.tobytes(), self.ends.tobytes()))


class LociMap(Generic[T]):
    """An immutable map from loci (across contigs) to values."""

    __slots__ = ("_contigs",)

    def __init__(self, contigs: Dict[str, SingleContigMap]):
        self._contigs = {
            name: m for name, m in sorted(contigs.items()) if not m.is_empty
        }

    @property
    def contigs(self) -> List[str]:
        return list(self._contigs.keys())

    @property
    def count(self) -> int:
        return sum(m.count for m in self._contigs.values())

    @property
    def is_empty(self) -> bool:
        return self.count == 0

    def on_contig(self, contig: str) -> SingleContigMap:
        found = self._contigs.get(contig)
        if found is None:
            return SingleContigMap.empty(contig)
        return found

    def filter_contigs(self, predicate) -> "LociMap":
        return LociMap({c: m for c, m in self._contigs.items() if predicate(c)})

    def union(self, other: "LociMap") -> "LociMap":
        maker = LociMapBuilder()
        for m in (self, other):
            for contig in m.contigs:
                for s, e, v in m.on_contig(contig).items:
                    maker.put(contig, s, e, v)
        return maker.result()

    def inverse_map(self) -> Dict[T, "object"]:
        """The value -> LociSet map giving the loci mapping to each value
        (cf. LociMap.scala:51-62)."""
        from guacamole_tpu_torch.loci.lociset import LociSet, LociSetBuilder

        builders: Dict[T, LociSetBuilder] = {}
        for contig in self.contigs:
            for s, e, v in self.on_contig(contig).items:
                builders.setdefault(v, LociSetBuilder()).put(contig, s, e)
        return {v: b.result() for v, b in builders.items()}

    def take(self, num_to_take: int) -> Tuple["LociMap", "LociMap"]:
        """Split into a map with the first num_to_take loci and the rest
        (in contig-name, then position order; cf. LociMap.scala:110-146)."""
        assert num_to_take <= self.count, (
            f"Can't take {num_to_take} loci from a map of size {self.count}."
        )
        if num_to_take == 0:
            return LociMap({}), self
        if num_to_take == self.count:
            return self, LociMap({})
        first = LociMapBuilder()
        second = LociMapBuilder()
        remaining = num_to_take
        done_taking = False
        for contig in self.contigs:
            for start, end, value in self.on_contig(contig).items:
                if done_taking:
                    second.put(contig, start, end, value)
                elif remaining >= end - start:
                    first.put(contig, start, end, value)
                    remaining -= end - start
                else:
                    first.put(contig, start, start + remaining, value)
                    second.put(contig, start + remaining, end, value)
                    done_taking = True
        first_result, second_result = first.result(), second.result()
        assert first_result.count == num_to_take
        assert first_result.count + second_result.count == self.count
        return first_result, second_result

    def truncated_string(self, max_length: int = 500, include_values: bool = True) -> str:
        pieces = []
        total = 0
        for contig in self.contigs:
            for piece in self.on_contig(contig).string_pieces(include_values):
                if total + len(piece) > max_length:
                    pieces.append(" [...]")
                    return ",".join(pieces)
                pieces.append(piece)
                total += len(piece) + 1
        return ",".join(pieces)

    def __str__(self) -> str:
        return self.truncated_string(2**62)

    def __eq__(self, other) -> bool:
        return isinstance(other, LociMap) and self._contigs == other._contigs

    def __hash__(self) -> int:
        return hash(tuple(sorted(self._contigs.items(), key=lambda kv: kv[0])))


class LociMapBuilder(Generic[T]):
    """Builder for LociMap. Later puts override earlier ones on overlap;
    adjacent ranges with equal values are coalesced (cf. LociMap.scala:210-234).
    """

    def __init__(self) -> None:
        # contig -> list of (start, end, value) in insertion order
        self._data: Dict[str, List[Tuple[int, int, T]]] = {}

    def put(self, contig: str, start: int, end: int, value: T) -> "LociMapBuilder":
        assert end >= start
        if end > start:
            self._data.setdefault(contig, []).append((start, end, value))
        return self

    def put_loci_set(self, loci, value: T) -> "LociMapBuilder":
        for contig in loci.contigs:
            for s, e in loci.on_contig(contig).ranges:
                self.put(contig, s, e, value)
        return self

    def result(self) -> LociMap:
        contigs: Dict[str, SingleContigMap] = {}
        for contig, puts in self._data.items():
            # Apply puts in order with overwrite semantics over a sorted
            # disjoint interval list.
            starts: List[int] = []
            ends: List[int] = []
            values: List[T] = []
            for start, end, value in puts:
                # Remove/trim existing overlap with [start, end).
                lo = bisect.bisect_right(ends, start)
                hi = bisect.bisect_left(starts, end, lo=lo)
                overlapped = list(zip(starts[lo:hi], ends[lo:hi], values[lo:hi]))
                replacement: List[Tuple[int, int, T]] = []
                if overlapped and overlapped[0][0] < start:
                    replacement.append((overlapped[0][0], start, overlapped[0][2]))
                replacement.append((start, end, value))
                if overlapped and overlapped[-1][1] > end:
                    replacement.append((end, overlapped[-1][1], overlapped[-1][2]))
                starts[lo:hi] = [r[0] for r in replacement]
                ends[lo:hi] = [r[1] for r in replacement]
                values[lo:hi] = [r[2] for r in replacement]
            # Coalesce adjacent ranges with equal values.
            c_starts: List[int] = []
            c_ends: List[int] = []
            c_values: List[T] = []
            for s, e, v in zip(starts, ends, values):
                if c_ends and c_ends[-1] == s and c_values[-1] == v:
                    c_ends[-1] = e
                else:
                    c_starts.append(s)
                    c_ends.append(e)
                    c_values.append(v)
            contigs[contig] = SingleContigMap(
                contig,
                np.asarray(c_starts, dtype=np.int64),
                np.asarray(c_ends, dtype=np.int64),
                c_values,
            )
        return LociMap(contigs)


def loci_map_of(contig: str, start: int, end: int, value: T) -> LociMap:
    return LociMapBuilder().put(contig, start, end, value).result()
