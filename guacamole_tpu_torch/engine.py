"""Generic per-locus engine API: flatmap/fold over pileups and windows.

Host-side equivalents of the reference's distributed-engine primitives
(cf. reference .../DistributedUtil.scala:288-486): the same API a
caller author would use for new analyses that don't (yet) have a
tile-packed device kernel. The loci partitioning argument plays the role of
Spark tasks: results are produced task by task in task order, so output is
deterministic and parallelism-invariant.

Also maintains the per-task statistics the reference tracks through Spark
accumulators (region counts and per-task skew percentiles,
DistributedUtil.scala:573-618).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from guacamole_tpu_torch.loci.locimap import LociMap
from guacamole_tpu_torch.pileup.pileup import Pileup
from guacamole_tpu_torch.reads.read import MappedRead
from guacamole_tpu_torch.utils.progress import progress
from guacamole_tpu_torch.windowing import SlidingWindow, advance_multiple_windows


@dataclass
class TaskStats:
    """Per-run counters (the Spark-accumulator analog)."""

    total_regions: int = 0
    relevant_regions: int = 0
    expanded_regions: int = 0
    per_task_regions: Dict[int, int] = field(default_factory=dict)

    def report(self) -> None:
        if not self.per_task_regions:
            return
        counts = np.asarray(sorted(self.per_task_regions.values()))
        progress(
            "Regions per task: min=%d 25%%=%d median=%d 75%%=%d max=%d "
            "(%d tasks; %d total, %d relevant, %d after boundary expansion)"
            % (
                counts.min(),
                int(np.percentile(counts, 25)),
                int(np.percentile(counts, 50)),
                int(np.percentile(counts, 75)),
                counts.max(),
                len(counts),
                self.total_regions,
                self.relevant_regions,
                self.expanded_regions,
            )
        )


def _task_reads(
    reads_per_sample: Sequence[Sequence[MappedRead]],
    task_loci,
    half_window_size: int,
    stats: Optional[TaskStats],
    task: int,
) -> List[List[MappedRead]]:
    """Reads overlapping a task's loci (+- halfWindowSize), per sample,
    sorted by start — the halo-duplicated shard contents (the reference's
    boundary-read duplication, DistributedUtil.scala:585-597)."""
    out = []
    expanded = 0
    for reads in reads_per_sample:
        selected = [
            r
            for r in reads
            if r.overlaps_loci_set(task_loci, half_window_size)
        ]
        selected.sort(key=lambda r: (r.reference_contig, r.start))
        expanded += len(selected)
        out.append(selected)
    if stats is not None:
        stats.expanded_regions += expanded
        stats.per_task_regions[task] = expanded
    return out


def window_flat_map_with_state(
    reads_per_sample: Sequence[Sequence[MappedRead]],
    loci_partitions: LociMap,
    skip_empty: bool,
    half_window_size: int,
    initial_state,
    function: Callable,
    stats: Optional[TaskStats] = None,
) -> List:
    """Stateful flatmap across loci with one sliding window per sample
    (cf. windowFlatMapWithState, DistributedUtil.scala:388-418).

    function(state, windows) -> (new_state, iterable of results).
    """
    if stats is not None:
        stats.total_regions += sum(len(r) for r in reads_per_sample)
    results: List = []
    inverse = loci_partitions.inverse_map()
    for task in sorted(inverse):
        task_loci = inverse[task]
        task_reads = _task_reads(
            reads_per_sample, task_loci, half_window_size, stats, task
        )
        for contig in task_loci.contigs:
            contig_reads = [
                [r for r in sample if r.reference_contig == contig]
                for sample in task_reads
            ]
            windows = [
                SlidingWindow(contig, half_window_size, iter(sample))
                for sample in contig_reads
            ]
            loci_iterator = task_loci.on_contig(contig).iterator()
            state = initial_state
            while (
                advance_multiple_windows(windows, loci_iterator, skip_empty)
                is not None
            ):
                state, elements = function(state, windows)
                results.extend(elements)
    return results


def _init_or_move_pileup(
    existing: Optional[Pileup], window: SlidingWindow, reference_genome
) -> Pileup:
    """(cf. initOrMovePileup, DistributedUtil.scala:260-274)"""
    locus = window.current_locus
    if reference_genome is not None:
        reference_base = reference_genome.get_reference_base(
            window.reference_name, locus
        )
    else:
        reference_base = Pileup.reference_base_at_locus(
            window.current_regions(), locus
        )
    if existing is None:
        return Pileup.from_reads(
            window.current_regions(), window.reference_name, locus, reference_base
        )
    return existing.at_greater_locus(locus, reference_base, window.new_regions)


def pileup_flat_map(
    reads: Sequence[MappedRead],
    loci_partitions: LociMap,
    skip_empty: bool,
    function: Callable[[Pileup], Iterable],
    reference_genome=None,
    stats: Optional[TaskStats] = None,
) -> List:
    """Flatmap across loci with a Pileup at each (cf. pileupFlatMap)."""
    return pileup_flat_map_multiple(
        [reads],
        loci_partitions,
        skip_empty,
        lambda pileups: function(pileups[0]),
        reference_genome,
        stats,
    )


def pileup_flat_map_two(
    reads1: Sequence[MappedRead],
    reads2: Sequence[MappedRead],
    loci_partitions: LociMap,
    skip_empty: bool,
    function: Callable[[Pileup, Pileup], Iterable],
    reference_genome=None,
    stats: Optional[TaskStats] = None,
) -> List:
    """Two-sample pileup flatmap (cf. pileupFlatMapTwoRDDs)."""
    return pileup_flat_map_multiple(
        [reads1, reads2],
        loci_partitions,
        skip_empty,
        lambda pileups: function(pileups[0], pileups[1]),
        reference_genome,
        stats,
    )


def pileup_flat_map_multiple(
    reads_per_sample: Sequence[Sequence[MappedRead]],
    loci_partitions: LociMap,
    skip_empty: bool,
    function: Callable[[Sequence[Pileup]], Iterable],
    reference_genome=None,
    stats: Optional[TaskStats] = None,
) -> List:
    """N-sample pileup flatmap (cf. pileupFlatMapMultipleRDDs), with
    incremental per-sample pileup reuse between loci."""

    def step(state, windows):
        if state is None:
            pileups = [
                _init_or_move_pileup(None, w, reference_genome) for w in windows
            ]
        else:
            pileups = [
                _init_or_move_pileup(p, w, reference_genome)
                for p, w in zip(state, windows)
            ]
        return pileups, function(pileups)

    return window_flat_map_with_state(
        reads_per_sample,
        loci_partitions,
        skip_empty,
        0,
        None,
        step,
        stats,
    )


def window_fold_loci(
    reads_per_sample: Sequence[Sequence[MappedRead]],
    loci_partitions: LociMap,
    skip_empty: bool,
    half_window_size: int,
    initial_value,
    agg_function: Callable,
    stats: Optional[TaskStats] = None,
) -> List:
    """Per-task fold over loci (cf. windowFoldLoci,
    DistributedUtil.scala:434-459). Returns one aggregate per task."""
    results: List = []
    inverse = loci_partitions.inverse_map()
    for task in sorted(inverse):
        task_loci = inverse[task]
        task_reads = _task_reads(
            reads_per_sample, task_loci, half_window_size, stats, task
        )
        value = initial_value
        for contig in task_loci.contigs:
            contig_reads = [
                [r for r in sample if r.reference_contig == contig]
                for sample in task_reads
            ]
            windows = [
                SlidingWindow(contig, half_window_size, iter(sample))
                for sample in contig_reads
            ]
            loci_iterator = task_loci.on_contig(contig).iterator()
            while (
                advance_multiple_windows(windows, loci_iterator, skip_empty)
                is not None
            ):
                value = agg_function(value, windows)
        results.append(value)
    return results
