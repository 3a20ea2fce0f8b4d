"""structural-variant caller of the port: DELLY-style large-deletion finder.

Port of guacamole_tpu/callers/structural_variant.py (cf. reference
.../commands/StructuralVariantCaller.scala:27-289). It launches nothing on
a device; the command still resolves one (--device), as every command of
the port does. One process: the multi-process contig split and gathers of
the original are not ported.
1. Find read pairs with abnormally large insert sizes (median + 5*MAD).
2. Build a compatibility graph of pairs explainable by one deletion.
3. Greedily grow one clique per connected component.

This is host-side control flow by nature (data-dependent graph algorithms);
the insert-size statistics are vectorized numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from guacamole_tpu_torch.reads.read import PairedMappedRead

MAX_INSERT_SIZE = 25000
BLOCK_SIZE = 25


@dataclass(frozen=True)
class GenomeRange:
    contig: str
    start: int
    stop: int

    def __str__(self) -> str:
        return f"GenomeRange({self.contig},{self.start},{self.stop})"


@dataclass(frozen=True)
class MedianStats:
    median: float
    mad: float


def median_stats(values: Sequence[float]) -> MedianStats:
    """Median and median absolute deviation of an unordered sample."""
    if len(values) == 0:
        return MedianStats(0.0, 0.0)
    arr = np.sort(np.asarray(values, dtype=np.float64))
    n = len(arr)
    if n % 2 == 0:
        median = 0.5 * (arr[n // 2 - 1] + arr[n // 2])
    else:
        median = float(arr[n // 2])
    residuals = np.sort(np.abs(arr - median))
    if n % 2 == 0:
        mad = 0.5 * (residuals[n // 2 - 1] + residuals[n // 2])
    else:
        mad = float(residuals[n // 2])
    return MedianStats(float(median), float(mad))


def oriented_insert_size(pair: PairedMappedRead) -> int:
    """Insert size signed by read orientation, positive in the common case."""
    sign = 1 if pair.read.is_positive_strand else -1
    return pair.inferred_insert_size * sign


@dataclass
class ExceptionalReads:
    reads_in_range: List[PairedMappedRead]
    insert_stats: MedianStats
    max_normal_insert_size: int
    exceptional_reads: List[PairedMappedRead]


def pairs_in_range(pairs: Sequence[PairedMappedRead]) -> List[PairedMappedRead]:
    """Same-contig, opposite-strand pairs below the sanity cap — the
    population the insert-size statistics are computed over
    (StructuralVariantCaller.scala:102-113)."""
    return [
        p
        for p in pairs
        if p.read.reference_contig == p.mate.reference_contig
        and p.read.is_positive_strand != p.mate.is_positive_strand
        and p.inferred_insert_size < MAX_INSERT_SIZE
    ]


def get_exceptional_reads(
    pairs: Sequence[PairedMappedRead], sample_limit: int = 100000
) -> ExceptionalReads:
    """Pairs whose insert size exceeds median + 5*MAD
    (StructuralVariantCaller.scala:102-129)."""
    reads_in_range = pairs_in_range(pairs)
    insert_sizes = [oriented_insert_size(p) for p in reads_in_range]
    stats = median_stats(insert_sizes[:sample_limit])
    max_normal = int(stats.median + 5 * stats.mad)
    exceptional = [
        p for p in reads_in_range if p.inferred_insert_size > max_normal
    ]
    return ExceptionalReads(reads_in_range, stats, max_normal, exceptional)


def are_reads_compatible(
    pair1: PairedMappedRead, pair2: PairedMappedRead, max_normal_insert_size: int
) -> bool:
    """Could one deletion make both pairs' insert sizes normal?
    (DELLY logic, StructuralVariantCaller.scala:132-151)"""
    if pair1.min_pos > pair2.min_pos:
        return are_reads_compatible(pair2, pair1, max_normal_insert_size)
    p1_min, p1_gap_min, p1_gap_max, p1_max = pair1.starts_and_stops
    p2_min, p2_gap_min, p2_gap_max, p2_max = pair2.starts_and_stops
    return not (
        (p2_gap_min - p1_min) > max_normal_insert_size
        or (
            p2_gap_max < p1_gap_max
            and (p1_max - p2_gap_max) > max_normal_insert_size
        )
        or (
            p2_gap_max >= p1_gap_max
            and (p2_max - p1_gap_max) > max_normal_insert_size
        )
        or (p1_gap_max < p2_min or p2_gap_max < p1_min)
    )


class PairGraph:
    """Undirected weighted graph over read pairs (nodes keyed by index)."""

    def __init__(self, nodes: List[PairedMappedRead]):
        self.nodes = nodes
        self.edges: List[Tuple[float, int, int]] = []  # (weight, i, j)
        self.adjacency: Dict[int, Set[int]] = {}

    def add_edge(self, i: int, j: int, weight: float) -> None:
        self.edges.append((weight, i, j))
        self.adjacency.setdefault(i, set()).add(j)
        self.adjacency.setdefault(j, set()).add(i)

    def connected_components(self) -> List[List[int]]:
        seen: Set[int] = set()
        components = []
        for start in sorted(self.adjacency):
            if start in seen:
                continue
            stack = [start]
            component = []
            while stack:
                node = stack.pop()
                if node in seen:
                    continue
                seen.add(node)
                component.append(node)
                stack.extend(self.adjacency.get(node, ()))
            components.append(sorted(component))
        return components


def build_variant_graph(
    exceptional: Iterable[PairedMappedRead], max_normal_insert_size: int
) -> PairGraph:
    """Edges between pairs explainable by the same deletion
    (StructuralVariantCaller.scala:159-189)."""
    reads = sorted(exceptional, key=lambda p: p.min_pos)
    graph = PairGraph(reads)
    for i, pair in enumerate(reads):
        start, _, gap_end, _ = pair.starts_and_stops
        for j in range(i + 1, len(reads)):
            next_pair = reads[j]
            next_start, next_gap_start, next_gap_end, _ = (
                next_pair.starts_and_stops
            )
            if abs(next_gap_start - start) > max_normal_insert_size:
                break
            if are_reads_compatible(pair, next_pair, max_normal_insert_size):
                weight = abs((next_gap_end - next_start) - (gap_end - start))
                graph.add_edge(i, j, weight)
    return graph


@dataclass(frozen=True)
class SVClique:
    """A set of mutually compatible read pairs inducing one deletion
    (StructuralVariantCaller.scala:191-246)."""

    read_pairs: frozenset  # of node indices
    wiggle: int
    sv_start: int
    sv_end: int
    max_normal_insert_size: int

    @staticmethod
    def seed(
        node: int, pair: PairedMappedRead, max_normal_insert_size: int
    ) -> "SVClique":
        _, sv_start, sv_end, _ = pair.starts_and_stops
        wiggle = max_normal_insert_size - (pair.insert_size - (sv_end - sv_start))
        return SVClique(
            frozenset([node]), wiggle, sv_start, sv_end, max_normal_insert_size
        )

    def maybe_absorb(
        self, node: int, pair: PairedMappedRead
    ) -> Optional["SVClique"]:
        _, gap_min, gap_max, _ = pair.starts_and_stops
        new_start = max(self.sv_start, gap_min)
        new_end = min(self.sv_end, gap_max)
        wiggle_new_read = self.max_normal_insert_size - (
            pair.insert_size - (new_end - new_start)
        )
        wiggle_change = self.wiggle + (new_end - new_start) - (
            self.sv_end - self.sv_start
        )
        new_wiggle = min(wiggle_new_read, wiggle_change)
        if new_start < new_end and new_wiggle >= 0:
            return SVClique(
                self.read_pairs | {node},
                new_wiggle,
                new_start,
                new_end,
                self.max_normal_insert_size,
            )
        return None

    def span(self, graph: PairGraph) -> GenomeRange:
        any_node = next(iter(self.read_pairs))
        return GenomeRange(
            graph.nodes[any_node].read.reference_contig, self.sv_start, self.sv_end
        )


def find_one_clique(
    graph: PairGraph, component: List[int], max_normal_insert_size: int
) -> SVClique:
    """Greedy clique growth from the lowest-weight edge
    (StructuralVariantCaller.scala:248-264)."""
    component_set = set(component)
    edges = sorted(
        (e for e in graph.edges if e[1] in component_set),
        key=lambda e: e[0],
    )
    weight, i, j = edges[0]
    seed_node = min((i, j), key=lambda n: graph.nodes[n].min_pos)
    clique = SVClique.seed(
        seed_node, graph.nodes[seed_node], max_normal_insert_size
    )
    for weight, i, j in edges:
        in_i = i in clique.read_pairs
        in_j = j in clique.read_pairs
        if in_i == in_j:
            continue
        candidate = j if in_i else i
        # candidate must be connected to every clique member
        if not clique.read_pairs <= graph.adjacency.get(candidate, set()):
            continue
        absorbed = clique.maybe_absorb(candidate, graph.nodes[candidate])
        if absorbed is not None:
            clique = absorbed
    return clique


def find_cliques(
    graph: PairGraph, max_normal_insert_size: int
) -> List[SVClique]:
    return [
        find_one_clique(graph, component, max_normal_insert_size)
        for component in graph.connected_components()
        if len(component) >= 2
    ]


def call_structural_variants(
    paired_reads: Sequence[PairedMappedRead],
    max_normal_insert_size: Optional[int] = None,
) -> Tuple[int, Dict[str, List[GenomeRange]]]:
    """Full pipeline: exceptional pairs -> per-contig graphs -> cliques.

    max_normal_insert_size: externally computed threshold — in a
    multi-host run the median+5*MAD must come from the GLOBAL insert-size
    sample (DCN-gathered), not one process's contig shard."""
    if max_normal_insert_size is None:
        exceptional = get_exceptional_reads(paired_reads)
        max_normal = exceptional.max_normal_insert_size
        exceptional_reads = exceptional.exceptional_reads
    else:
        max_normal = max_normal_insert_size
        exceptional_reads = [
            p
            for p in pairs_in_range(paired_reads)
            if p.inferred_insert_size > max_normal
        ]
    by_contig: Dict[str, List[PairedMappedRead]] = {}
    for pair in exceptional_reads:
        by_contig.setdefault(pair.read.reference_contig, []).append(pair)
    results: Dict[str, List[GenomeRange]] = {}
    for contig, pairs in sorted(by_contig.items()):
        graph = build_variant_graph(pairs, max_normal)
        cliques = find_cliques(graph, max_normal)
        results[contig] = [c.span(graph) for c in cliques]
    return max_normal, results


def exceptional_from_columnar(cols, filter_contig: str = "", contigs=None):
    """Vectorized pairs_in_range + insert-size sampling over the native
    decoder's mate columns — the columnar form of the object stage-1
    (record order preserved, so the [:100000] stats sample is identical).
    Returns (in_range_sizes, make_exceptional) where make_exceptional(
    max_normal) materializes PairedMappedRead objects for ONLY the
    exceptional records (the graph stage's tiny input), or None when the
    mate columns are unavailable."""
    import numpy as np

    from guacamole_tpu_torch.gio import sam_flags as flags
    from guacamole_tpu_torch.reads.read import (
        MateAlignmentProperties,
        PairedMappedRead,
    )

    if cols is None or cols.tlen is None or cols.mate_ref_id is None:
        return None
    f = np.asarray(cols.flags_)
    eligible = (
        ((f & flags.PAIRED) != 0)
        & ((f & flags.UNMAPPED) == 0)
        & ((f & flags.MATE_UNMAPPED) == 0)
        & ((f & flags.FIRST_IN_PAIR) != 0)
        & ((f & flags.DUPLICATE) == 0)
        & (np.asarray(cols.ref_id) >= 0)
        & (np.asarray(cols.mate_ref_id) >= 0)
        & (np.asarray(cols.tlen) != 0)
    )
    name_arr = np.asarray(cols.ref_names, dtype=object)
    if contigs is not None:
        in_set = np.asarray(
            [name in contigs for name in cols.ref_names], dtype=bool
        )
        eligible &= in_set[np.asarray(cols.ref_id)]
    if filter_contig:
        is_filter = np.asarray(
            [name == filter_contig for name in cols.ref_names], dtype=bool
        )
        eligible &= (
            is_filter[np.asarray(cols.ref_id)]
            | is_filter[np.asarray(cols.mate_ref_id)]
        )
    read_rev = (f & flags.REVERSE) != 0
    mate_rev = (f & flags.MATE_REVERSE) != 0
    tlen = np.asarray(cols.tlen, dtype=np.int64)
    in_range = (
        eligible
        & (np.asarray(cols.mate_ref_id) == np.asarray(cols.ref_id))
        & (read_rev != mate_rev)
        & (tlen < MAX_INSERT_SIZE)
    )
    oriented = np.where(read_rev, -tlen, tlen)
    in_range_idx = np.flatnonzero(in_range)
    sizes = oriented[in_range_idx]

    def make_exceptional(max_normal: int):
        exc = in_range_idx[tlen[in_range_idx] > max_normal]
        out = []
        for i in exc:
            i = int(i)
            mate = MateAlignmentProperties(
                reference_contig=str(name_arr[int(cols.mate_ref_id[i])]),
                start=int(cols.mate_start[i]),
                inferred_insert_size=int(tlen[i]),
                is_positive_strand=not bool(mate_rev[i]),
            )
            out.append(
                PairedMappedRead(
                    cols.to_mapped_read(i), True, int(tlen[i]), mate
                )
            )
        return out

    return sizes, make_exceptional


def main(argv, _add_fns) -> int:
    import argparse

    from guacamole_tpu_torch.gio.load import load_read_set
    from guacamole_tpu_torch.reads.read import InputFilters, PairedMappedRead
    from guacamole_tpu_torch.utils.progress import progress

    p = argparse.ArgumentParser(
        prog="guacamole-torch structural-variant",
        description="Find structural variants, e.g. large deletions",
    )
    _add_fns["base"](p)
    _add_fns["loci"](p)
    _add_fns["reads"](p)
    _add_fns["distributed"](p)
    _add_fns["device"](p)
    p.add_argument("--filter-contig", default="")
    p.add_argument("--output", default="")
    args = p.parse_args(argv)
    # One device, one process: --mesh on and the multi-process flags are
    # refused until the mesh and the multi-process runtime are ported.
    _add_fns["refuse_unported"](args)
    _add_fns["resolve_device"](args)

    # Columnar fast path: the native decoders carry mate columns, so the
    # stage-1 discordant-pair scan (same-contig / opposite-strand /
    # insert-size stats over EVERY record) is pure vectorized numpy;
    # pair OBJECTS materialize only for the exceptional records the
    # graph stage consumes (~hundreds). Identical results to the object
    # path (pinned by tests/test_structural_variant.py).
    fast = None
    if args.bam_reader_api in ("best", "native"):
        from guacamole_tpu_torch.runtime.columnar import (
            decode_bam_columnar,
            decode_sam_columnar,
        )

        lower = args.reads.lower()
        cols = (
            decode_bam_columnar(args.reads)
            if lower.endswith(".bam")
            else (
                decode_sam_columnar(args.reads)
                if lower.endswith(".sam")
                else None
            )
        )
        fast = exceptional_from_columnar(cols, args.filter_contig)
    if fast is not None:
        local_sizes, make_exceptional = fast
        stats = median_stats(local_sizes[:100000])
        max_normal = int(stats.median + 5 * stats.mad)
        exceptional = make_exceptional(max_normal)
        by_contig: Dict[str, List[PairedMappedRead]] = {}
        for pair in exceptional:
            by_contig.setdefault(pair.read.reference_contig, []).append(pair)
        results = {}
        for contig, contig_pairs in sorted(by_contig.items()):
            graph = build_variant_graph(contig_pairs, max_normal)
            cliques = find_cliques(graph, max_normal)
            results[contig] = [c.span(graph) for c in cliques]
    else:
        read_set = load_read_set(
            args.reads, InputFilters.create(non_duplicate=True)
        )
        pairs = [
            pm
            for pm in (
                PairedMappedRead.from_paired_read(pr)
                for pr in read_set.mapped_paired_reads
                if pr.is_first_in_pair
            )
            if pm is not None
        ]
        if args.filter_contig:
            pairs = [
                pm
                for pm in pairs
                if pm.read.reference_contig == args.filter_contig
                or pm.mate.reference_contig == args.filter_contig
            ]
        max_normal, results = call_structural_variants(pairs)
    progress(f"max normal insert size: {max_normal}")
    lines = [
        f"({contig},{[str(r) for r in ranges]})"
        for contig, ranges in results.items()
    ]
    if args.output:
        with open(args.output, "w") as out:
            out.write("\n".join(lines) + ("\n" if lines else ""))
    else:
        for line in lines:
            print(line)
    return 0
