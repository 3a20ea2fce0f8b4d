"""Loci partitioning: assign loci to shards (tasks/devices).

Host-side replacements for the reference's Spark partitioners:
 - uniform split (cf. reference .../DistributedUtil.scala:83-108)
 - depth-balanced split via micro-partition read counting
   (cf. DistributedUtil.scala:162-251), with the Spark counting job replaced
   by a vectorized numpy histogram over read intervals.

The result is a LociMap[int]: locus -> shard id. On TPU, each shard's loci
become fixed-shape tiles processed by one device; boundary reads are
duplicated into adjacent shards on host (halo duplication), so no device
halo exchange is required.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from guacamole_tpu_torch.loci.locimap import LociMap, LociMapBuilder
from guacamole_tpu_torch.loci.lociset import LociSet
from guacamole_tpu_torch.utils.progress import progress


def partition_loci_uniformly(tasks: int, loci: LociSet) -> LociMap:
    """Split loci into `tasks` contiguous chunks of (approximately) equal
    loci count. Exact-output parity with the reference algorithm, including
    its rounding behavior (DistributedUtil.scala:83-108)."""
    assert tasks >= 1, "`tasks` (--parallelism) should be >= 1"
    loci_per_task = max(1.0, loci.count / tasks)
    maker = LociMapBuilder()
    loci_assigned = 0
    task = 0

    def remaining_for_this_task() -> int:
        # Scala math.round: floor(x + 0.5) for positive x.
        return int(np.floor((task + 1) * loci_per_task - loci_assigned + 0.5))

    for contig in loci.contigs:
        for start, end in loci.on_contig(contig).ranges:
            while start < end:
                length = min(remaining_for_this_task(), end - start)
                if length > 0:
                    maker.put(contig, start, start + length, task)
                    start += length
                    loci_assigned += length
                if remaining_for_this_task() == 0:
                    task += 1
    result = maker.result()
    assert result.count == loci.count
    return result


def _region_arrays_by_contig(regions) -> Dict[str, tuple]:
    """Extract {contig: (starts, ends)} from region objects, a ReadSource,
    or columnar reads."""
    cols = getattr(regions, "_cols", None)
    if cols is None and hasattr(regions, "ref_names") and hasattr(
        regions, "ref_id"
    ):
        cols = regions
    if cols is not None:
        out = {}
        for contig_id, contig in enumerate(cols.ref_names):
            mask = cols.ref_id == contig_id
            if mask.any():
                out[contig] = (cols.start[mask], cols.end[mask])
        return out
    if hasattr(regions, "reads_list"):
        regions = regions.reads_list()
    by_contig: Dict[str, List] = {}
    for region in regions:
        by_contig.setdefault(region.reference_contig, []).append(region)
    return {
        contig: (
            np.fromiter((r.start for r in rs), dtype=np.int64),
            np.fromiter((r.end for r in rs), dtype=np.int64),
        )
        for contig, rs in by_contig.items()
    }


def count_regions_per_micro_partition(
    micro_partitions: LociMap, region_sets: Sequence, num_micro: int
) -> np.ndarray:
    """For each micro partition, count regions (reads) overlapping it.

    A region spanning several micro partitions counts once in each — the same
    semantics as the reference's flatMap(getAll).countByValue
    (DistributedUtil.scala:181-191) — computed here with searchsorted over
    the interval arrays instead of a Spark job.
    """
    counts = np.zeros(num_micro, dtype=np.int64)
    for regions in region_sets:
        for contig, (starts, ends) in _region_arrays_by_contig(regions).items():
            cmap = micro_partitions.on_contig(contig)
            if cmap.is_empty:
                continue
            # interval index range [lo, hi) overlapping each region
            los = np.searchsorted(cmap.ends, starts, side="right")
            his = np.searchsorted(cmap.starts, ends, side="left")
            values = np.asarray(cmap.values, dtype=np.int64)
            steps = np.diff(values)
            if len(values) == 0:
                continue
            if not len(steps) or ((steps >= 0) & (steps <= 1)).all():
                # Uniform micro partitions are consecutive within a
                # contig, so the distinct micros overlapped by a region
                # are exactly the integer range [values[lo], values[hi-1]]
                # — counted for every region at once with two bincounts
                # over a difference array (the per-region np.unique loop
                # cost ~6 us x millions of reads).
                sel = his > los
                if not sel.any():
                    continue
                vlo = values[los[sel]]
                vhi = values[his[sel] - 1]
                diff = np.bincount(
                    vlo, minlength=num_micro + 1
                ) - np.bincount(vhi + 1, minlength=num_micro + 1)
                counts += np.cumsum(diff[:num_micro])
            else:
                for lo, hi in zip(los.tolist(), his.tolist()):
                    if hi > lo:
                        # distinct micro partitions overlapped by region
                        counts[np.unique(values[lo:hi])] += 1
    return counts


def partition_loci_by_approximate_depth(
    tasks: int, loci: LociSet, accuracy: int, *region_sets
) -> LociMap:
    """Assign loci to tasks so each task overlaps about the same number of
    regions, via uniform micro-partitioning + greedy equalizing assignment
    (DistributedUtil.scala:162-251)."""
    assert tasks >= 1
    assert loci.count > 0
    assert len(region_sets) > 0
    num_micro = int(min(accuracy * tasks, loci.count))
    micro_partitions = partition_loci_uniformly(num_micro, loci)
    counts = count_regions_per_micro_partition(
        micro_partitions, region_sets, num_micro
    )
    return _assign_micros_to_tasks(
        tasks, loci, micro_partitions, counts, num_micro
    )


def partition_loci_by_index_depth(
    tasks: int,
    loci: LociSet,
    accuracy: int,
    path: str,
    bai_path: str,
) -> LociMap:
    """Depth-balanced partitioning WITHOUT decoding any read: per-window
    read density is approximated by the compressed byte span the BAM
    index attributes to each index window (16 kb linear-index bins, or
    the 1 kb .gli fine windows when present). This is what lets the
    streaming .bai-pushdown path depth-balance by default — the
    reference's counting Spark job (DistributedUtil.scala:181-191)
    needed the reads loaded; the index histogram is one vectorized pass
    over in-memory index arrays.

    Task boundaries are weight quantiles at index-window granularity
    (finer than `accuracy` micro partitions would give for any
    realistically-sized loci set, so no fractional micro splitting is
    needed); the partition choice never affects calls (parallelism
    invariance), only load balance."""
    import os

    from guacamole_tpu_torch.gio.bai import BamIndex, FineIndex
    from guacamole_tpu_torch.gio.bam import BamFile

    assert tasks >= 1
    assert loci.count > 0
    ref_ids = {
        name: i for i, (name, _) in enumerate(BamFile(path).references)
    }
    if os.path.exists(bai_path + ".gli"):
        index = FineIndex(bai_path + ".gli")
        shift = 10
    else:
        index = BamIndex(bai_path)
        shift = 14

    def window_weights(rid) -> np.ndarray:
        """Per-window compressed byte spans for one contig."""
        if isinstance(index, FineIndex):
            wins = index.windows[rid]
            if not wins:
                return np.zeros(0, np.int64)
            arr = np.asarray(wins, dtype=np.int64).reshape(-1, 2)
            vb, ve = arr[:, 0] >> 16, arr[:, 1] >> 16
            return np.where(arr[:, 1] > 0, ve - vb + 1, 0)
        lin = np.asarray(index.linear[rid], dtype=np.int64)
        if len(lin) < 2:
            return np.ones(len(lin), np.int64)
        spans = np.maximum(np.diff(lin >> 16), 0)
        return np.append(spans, 1)

    # One (start, end, weight) segment per index window clipped to the
    # loci ranges, in loci order.
    seg_contig: List[str] = []
    seg_start, seg_end, seg_weight = [], [], []
    for contig in loci.contigs:
        rid = ref_ids.get(contig)
        weights = window_weights(rid) if rid is not None else None
        for start, end in loci.on_contig(contig).ranges:
            if weights is None or not len(weights):
                seg_contig.append(contig)
                seg_start.append(np.asarray([start]))
                seg_end.append(np.asarray([end]))
                seg_weight.append(np.zeros(1, np.int64))
                continue
            w0, w1 = start >> shift, (end - 1) >> shift
            ws = np.arange(w0, w1 + 1, dtype=np.int64)
            seg_contig.extend([contig] * len(ws))
            seg_start.append(np.maximum(start, ws << shift))
            seg_end.append(np.minimum(end, (ws + 1) << shift))
            inb = ws < len(weights)
            seg_weight.append(
                np.where(inb, weights[np.minimum(ws, len(weights) - 1)], 0)
            )
    starts = np.concatenate(seg_start)
    ends = np.concatenate(seg_end)
    weight = np.concatenate(seg_weight)
    total = int(weight.sum())
    if total == 0:
        return partition_loci_uniformly(tasks, loci)
    # Each segment goes to the task owning its cumulative-weight midpoint.
    cum = np.cumsum(weight)
    task_of = np.minimum(
        (cum - weight // 2) * tasks // total, tasks - 1
    ).astype(np.int64)
    task_of = np.maximum.accumulate(task_of)
    maker = LociMapBuilder()
    run_start = 0
    for i in range(1, len(starts) + 1):
        if (
            i == len(starts)
            or task_of[i] != task_of[run_start]
            or seg_contig[i] != seg_contig[run_start]
            or starts[i] != ends[i - 1]
        ):
            maker.put(
                seg_contig[run_start],
                int(starts[run_start]),
                int(ends[i - 1]),
                int(task_of[run_start]),
            )
            run_start = i
    result = maker.result()
    assert result.count == loci.count
    return result


def _assign_micros_to_tasks(
    tasks: int,
    loci: LociSet,
    micro_partitions: LociMap,
    counts: np.ndarray,
    num_micro: int,
) -> LociMap:
    """Greedy equalizing assignment of weighted micro partitions to tasks,
    with fractional micro splitting (DistributedUtil.scala:204-247)."""
    total_regions = int(counts.sum())
    regions_per_task = max(1.0, total_regions / tasks)
    inverse = micro_partitions.inverse_map()

    maker = LociMapBuilder()
    regions_assigned = 0.0
    task = 0

    def regions_remaining_for_this_task() -> int:
        return int(np.floor((task + 1) * regions_per_task - regions_assigned + 0.5))

    for micro_task in range(num_micro):
        loci_set = inverse.get(micro_task, LociSet.empty())
        regions_in_set = int(counts[micro_task])
        while not loci_set.is_empty:
            if regions_in_set == 0:
                maker.put_loci_set(loci_set, task)
                loci_set = LociSet.empty()
            else:
                if regions_remaining_for_this_task() == 0:
                    task += 1
                assert regions_remaining_for_this_task() > 0
                assert task < tasks
                fraction_to_take = min(
                    1.0, regions_remaining_for_this_task() / regions_in_set
                )
                loci_to_take = max(1, int(fraction_to_take * loci_set.count))
                regions_to_take = int(fraction_to_take * regions_in_set)
                current_set, remaining_set = loci_set.take(loci_to_take)
                maker.put_loci_set(current_set, task)
                regions_assigned += regions_to_take
                regions_in_set -= regions_to_take
                loci_set = remaining_set
    result = maker.result()
    assert result.count == loci.count
    return result


def partition_loci_from_args(
    parallelism: int,
    partition_accuracy: int,
    loci: LociSet,
    *region_sets,
    default_parallelism: int = 1,
) -> LociMap:
    """Dispatch on CLI args, mirroring partitionLociAccordingToArgs
    (DistributedUtil.scala:55-69)."""
    tasks = parallelism if parallelism > 0 else default_parallelism
    if partition_accuracy == 0 or loci.count == 0:
        # Uniform split; also the degenerate empty-loci case (e.g. an
        # empty multi-host shard), which depth balancing asserts against.
        return partition_loci_uniformly(tasks, loci)
    return partition_loci_by_approximate_depth(
        tasks, loci, partition_accuracy, *region_sets
    )


def filter_loci_whose_contigs_have_no_regions(loci: LociSet, regions) -> LociSet:
    """Drop contigs with no overlapping regions
    (DistributedUtil.scala:114-127)."""
    contigs_in_set = set(loci.contigs)
    counts: Dict[str, int] = {c: 0 for c in contigs_in_set}
    for region in regions:
        if region.reference_contig in contigs_in_set:
            counts[region.reference_contig] += 1
    without = {c for c, n in counts.items() if n == 0}
    if without:
        progress(
            "Filtering out contigs with no overlapping regions: %s"
            % ", ".join(sorted(without))
        )
        return loci.filter_contigs(lambda c: c not in without)
    return loci
