"""Streaming per-task input pipeline: each loci-partition task decodes only
its own BAM byte ranges (BGZF virtual-offset chunks from the .bai — the
samtools QueryInterval pushdown, cf. reference .../reads/Read.scala:
395-406), with the NEXT task's IO + decode running on a background thread
while the current task packs tiles and screens on device.

This is the single-host form of the multi-host input sharding design
(SURVEY.md §2: "each host reads its loci shard directly, using the BAM
index"): the shuffle-free analog of one Spark task reading its input split.

When the input is not an indexed BAM (or no index can be cached), callers
fall back to one whole-file decode.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

from guacamole_tpu_torch.loci.lociset import LociSet
from guacamole_tpu_torch.utils import trace
from guacamole_tpu_torch.utils.progress import progress


def _cache_dir() -> str:
    root = os.environ.get("GUAC_CACHE_DIR") or os.path.join(
        tempfile.gettempdir(), "guacamole_tpu_cache"
    )
    os.makedirs(root, exist_ok=True)
    return root


def ensure_bam_index(path: str) -> Optional[str]:
    """Path to a .bai for `path`: an existing sibling index, a cached
    auto-built one, or a freshly built one (cached by file identity).
    None when the input can't be indexed."""
    for candidate in (path + ".bai", os.path.splitext(path)[0] + ".bai"):
        if os.path.exists(candidate):
            return candidate
    try:
        st = os.stat(path)
        key = hashlib.sha1(
            f"{os.path.abspath(path)}:{st.st_size}:{st.st_mtime_ns}".encode()
        ).hexdigest()[:16]
        cached = os.path.join(_cache_dir(), f"{key}.bai")
        # The fine (.gli) sidecar is built together with the .bai; a cache
        # entry missing it predates the sidecar and gets rebuilt.
        if os.path.exists(cached) and os.path.exists(cached + ".gli"):
            return cached
        from guacamole_tpu_torch.gio.bai import build_bam_index

        progress("Building BAM index (cached at %s)." % cached)
        build_bam_index(path, cached)
        return cached
    except Exception as exc:
        progress(
            "Could not build a BAM index (%s: %s)."
            % (type(exc).__name__, exc)
        )
        return None


def chunks_for_loci_set(path: str, bai_path: str, loci_set: LociSet):
    """Merged BGZF chunks covering every read that overlaps loci_set."""
    from guacamole_tpu_torch.gio.bai import BamIndex, FineIndex, optimize_chunks
    from guacamole_tpu_torch.gio.bam import BamFile

    bam = BamFile(path)
    ref_ids = {name: i for i, (name, _) in enumerate(bam.references)}
    index = (
        FineIndex(bai_path + ".gli")
        if os.path.exists(bai_path + ".gli")
        else BamIndex(bai_path)
    )
    lists = []
    for contig in loci_set.contigs:
        rid = ref_ids.get(contig)
        if rid is None:
            continue
        for start, end in loci_set.on_contig(contig).ranges:
            lists.append(index.chunks_for_region(rid, start, end))
    return optimize_chunks(lists)


def iter_task_sources(
    path: str,
    filters,
    loci_partitions,
    prefetch: int = 1,
) -> Optional[Iterator[Tuple[int, LociSet, object]]]:
    """Yield (task, task_loci, ReadSource) per partition task, decoding
    each task's byte ranges on a background thread so task i+1's IO +
    decode overlaps task i's packing and device screens.

    Returns None when the streaming path is unavailable (non-BAM input,
    no native runtime, or no index) — callers then use one whole-file
    load_read_source.
    """
    if not path.lower().endswith(".bam"):
        return None
    from guacamole_tpu_torch.runtime.native import load_library

    if load_library() is None:
        return None
    bai_path = ensure_bam_index(path)
    if bai_path is None:
        return None

    inverse = loci_partitions.inverse_map()
    tasks = sorted(inverse)
    task_chunks = {}
    try:
        for task in tasks:
            task_chunks[task] = chunks_for_loci_set(
                path, bai_path, inverse[task]
            )
    except Exception as exc:
        progress(
            "BAM-index pushdown unavailable (%s: %s); using whole-file "
            "decode." % (type(exc).__name__, exc)
        )
        return None

    # Adaptive guard: index bins are 16 kb-granular, so on tiny contigs
    # (or very fine partitions) every task's chunks cover nearly the whole
    # file and per-task decode would multiply work instead of splitting
    # it. Stream only when the summed per-task compressed ranges stay
    # close to one file's worth.
    file_size = os.stat(path).st_size
    total_compressed = 0
    for chunk_list in task_chunks.values():
        for cbeg, cend in chunk_list:
            total_compressed += max(0, (cend >> 16) - (cbeg >> 16)) + 1
    if len(tasks) > 1 and total_compressed > 1.25 * file_size:
        progress(
            "Streaming pushdown skipped: task byte ranges overlap "
            "(%d tasks cover %.1fx the file)."
            % (len(tasks), total_compressed / max(file_size, 1))
        )
        return None

    def decode(task):
        from guacamole_tpu_torch.callers.source import ReadSource
        from guacamole_tpu_torch.runtime.columnar import (
            decode_bam_columnar,
            filter_columnar,
        )

        cols = decode_bam_columnar(path, chunks=task_chunks[task])
        if cols is None:
            raise RuntimeError("native chunk decode failed")
        trace.count("decode.tasks")
        trace.count("decode.reads", cols.n)
        trace.count("decode.bytes", sum(
            (cend >> 16) - (cbeg >> 16) for cbeg, cend in task_chunks[task]))
        loci_set = (
            filters.overlaps_loci.result(cols.contig_lengths)
            if filters.overlaps_loci is not None
            else None
        )
        filtered = filter_columnar(
            cols,
            loci_set=loci_set,
            non_duplicate=filters.non_duplicate,
            passed_vendor_quality_checks=(
                filters.passed_vendor_quality_checks
            ),
            has_mdtag=filters.has_mdtag,
        )
        if loci_set is None:
            filtered = filtered.select(filtered.is_mapped_mask)
        return ReadSource.from_columnar(filtered)

    def traced_decode(task):
        with trace.span("decode", task=task):
            return decode(task)

    def generate():
        with ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="guac-decode"
        ) as pool:
            pending = {}
            for i, task in enumerate(tasks):
                for j in range(i, min(i + 1 + prefetch, len(tasks))):
                    t = tasks[j]
                    if t not in pending:
                        pending[t] = pool.submit(traced_decode, t)
                with trace.wait("decode.wait", task=task):
                    source = pending.pop(task).result()
                yield task, inverse[task], source

    return generate()
