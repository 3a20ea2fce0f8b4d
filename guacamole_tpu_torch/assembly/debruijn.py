"""De Bruijn graph for local assembly.

(cf. reference .../assembly/DeBruijnGraph.scala:7-302)
k-mer graph with support pruning, unique-path node merging, and bounded
source->sink path enumeration.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from guacamole_tpu_torch.utils import bases as Bases

Kmer = bytes


class DeBruijnGraph:
    def __init__(self, kmer_size: int, kmer_counts: Dict[Kmer, int]):
        self.kmer_size = kmer_size
        self.kmer_counts = dict(kmer_counts)
        self.prefix_table: Dict[bytes, List[Kmer]] = {}
        self.suffix_table: Dict[bytes, List[Kmer]] = {}
        for kmer in sorted(self.kmer_counts):
            self.prefix_table.setdefault(self._prefix(kmer), []).append(kmer)
            self.suffix_table.setdefault(self._suffix(kmer), []).append(kmer)
        # kmer -> (merged sequence, index of kmer within it)
        self.merge_index: Dict[Kmer, Tuple[bytes, int]] = {}

    @classmethod
    def from_sequences(
        cls,
        sequences: Sequence[bytes],
        kmer_size: int,
        min_occurrence: int = 1,
        merge_nodes: bool = False,
    ) -> "DeBruijnGraph":
        counts: Dict[Kmer, int] = {}
        for seq in sequences:
            if not Bases.all_standard_bases(seq):
                continue
            for i in range(len(seq) - kmer_size + 1):
                kmer = seq[i : i + kmer_size]
                counts[kmer] = counts.get(kmer, 0) + 1
        graph = cls(kmer_size, counts)
        graph.prune_kmers(min_occurrence)
        if merge_nodes:
            graph.merge_nodes()
        return graph

    def _prefix(self, kmer: Kmer) -> bytes:
        return kmer[: self.kmer_size - 1]

    def _suffix(self, kmer: Kmer) -> bytes:
        return kmer[-(self.kmer_size - 1):]

    def _remove_kmer(self, kmer: Kmer) -> None:
        self.kmer_counts.pop(kmer, None)
        for table, key in (
            (self.prefix_table, self._prefix(kmer)),
            (self.suffix_table, self._suffix(kmer)),
        ):
            remaining = [k for k in table.get(key, []) if k != kmer]
            if remaining:
                table[key] = remaining
            else:
                table.pop(key, None)

    def prune_kmers(self, min_support: int) -> None:
        """Remove k-mers not present in at least min_support reads."""
        for kmer in [k for k, c in self.kmer_counts.items() if c < min_support]:
            del self.kmer_counts[kmer]

    def children(self, node: Kmer) -> List[Kmer]:
        return self.prefix_table.get(self._suffix(node), [])

    def parents(self, node: Kmer) -> List[Kmer]:
        return self.suffix_table.get(self._prefix(node), [])

    def roots(self) -> List[Kmer]:
        return [k for k in self.kmer_counts if not self.parents(k)]

    @staticmethod
    def merge_kmers(kmers: Sequence[Kmer]) -> bytes:
        """Collapse overlapping consecutive k-mers into one sequence."""
        if not kmers:
            return b""
        return kmers[0][:-1] + bytes(k[-1] for k in kmers)

    def _find_mergeable(self, kmer: Kmer, forward: bool) -> List[Kmer]:
        next_fn = self.children if forward else self.parents
        prev_fn = self.parents if forward else self.children
        current = kmer
        visited = {current}
        mergeable = [kmer]
        nxt = [n for n in next_fn(current) if n not in visited]
        while len(nxt) == 1 and len(prev_fn(nxt[0])) == 1:
            current = nxt[0]
            visited.add(current)
            mergeable.insert(0, current)
            nxt = [n for n in next_fn(current) if n not in visited]
        return mergeable

    def merge_forward(self, kmer: Kmer) -> List[Kmer]:
        """K-mers reachable from kmer by a unique path, in genomic order."""
        return list(reversed(self._find_mergeable(kmer, True)))

    def merge_backward(self, kmer: Kmer) -> List[Kmer]:
        """K-mers reaching kmer by a unique path, in genomic order."""
        return self._find_mergeable(kmer, False)

    def merge_nodes(self) -> None:
        """Merge k-mers connected by unique paths into single nodes."""
        all_nodes: Set[Kmer] = set(self.kmer_counts)
        while all_nodes:
            node = next(iter(all_nodes))
            forward = list(reversed(self._find_mergeable(node, True)))
            backward = self._find_mergeable(node, False)
            full_path = backward + forward[1:]
            if len(full_path) > 1:
                for k in full_path:
                    all_nodes.discard(k)
                    self._remove_kmer(k)
                merged = self.merge_kmers(full_path)
                for index, element in enumerate(full_path):
                    self.merge_index[element] = (merged, index)
                self.prefix_table.setdefault(self._prefix(merged), []).append(
                    merged
                )
                self.suffix_table.setdefault(self._suffix(merged), []).append(
                    merged
                )
                self.kmer_counts[merged] = self.kmer_counts.get(merged, 0) + 1
            else:
                all_nodes.discard(node)

    def depth_first_search(
        self,
        source: Kmer,
        sink: Kmer,
        min_path_length: int = 1,
        max_path_length: int = 2**31 - 1,
        max_paths: int = 10,
        avoid_loops: bool = True,
    ) -> List[List[bytes]]:
        """Enumerate up to max_paths node-paths from source to sink."""
        assert len(source) == self.kmer_size
        assert len(sink) == self.kmer_size

        paths: List[List[bytes]] = []
        if source in self.merge_index:
            merged, index = self.merge_index[source]
            frontier: List[bytes] = [merged[index:]]
        else:
            frontier = [source]
        visited: Set[bytes] = set()
        current_path: List[bytes] = []
        sink_merge = self.merge_index.get(sink)

        while frontier and len(paths) < max_paths:
            node = frontier.pop()
            current_path.insert(0, node)
            visited.add(node)
            found_merged_sink = sink_merge is not None and sink_merge[0] == node
            found_sink = node == sink or found_merged_sink
            if not found_sink and len(current_path) < max_path_length:
                next_nodes = self.children(node)
                frontier.extend(
                    n for n in next_nodes if not (avoid_loops and n in visited)
                )
            else:
                if found_sink and len(current_path) + 1 >= min_path_length:
                    if found_merged_sink:
                        merged, merged_idx = self.merge_index[sink]
                        end_idx = merged_idx + self.kmer_size
                        trimmed = current_path[0][: len(current_path[0]) - (len(merged) - end_idx)]
                        current_path = [trimmed] + current_path[1:]
                    paths.append(list(reversed(current_path)))
                current_path = []
        return paths
