"""germline-threshold caller on the port's dispatch: call variants where
the percent of reads supporting an allele exceeds a threshold.

Port of guacamole_tpu/callers/germline_threshold.py onto the port's
dispatch. The pipeline is the same:

  load reads (or stream them per partition task) -> pack covered loci
  into CSR screen tiles -> the counting screen on the device counts
  alleles per (locus, allele) and flags candidates -> the host classifies
  calls from the counts of candidate rows.

Classification (classify_locus) is the JAX module's, line for line:
integer percent thresholding (count * 100 // depth), the no-call /
hom-ref / hom-alt / het-deletion skip / het / compound-alt / N-reference
cases, and ties broken by canonical allele order.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from guacamole_tpu_torch.gio.vcf import VcfRecord
from guacamole_tpu_torch.loci.locimap import LociMap
from guacamole_tpu_torch.pack.tiles import LocusTile
from guacamole_tpu_torch.pileup.pileup import Pileup
from guacamole_tpu_torch.reads.read import MappedRead
from guacamole_tpu_torch.utils import bases as Bases
from guacamole_tpu_torch.utils import trace
from guacamole_tpu_torch.variants.allele import Allele
from guacamole_tpu_torch.ops.dispatch import (
    CompactScreen,
    pack_skip_nibbles,
    pipelined_screens,
    prefetch_iter,
    screen_tile_for,
)

log = logging.getLogger(__name__)

NO_CALL = ("NoCall", "NoCall")
HOM_REF = ("Ref", "Ref")
HOM_ALT = ("Alt", "Alt")
HET = ("Ref", "Alt")
COMPOUND = ("Alt", "OtherAlt")

ALT_PLACEHOLDER = Bases.ALT.decode("ascii")

# Device-side candidate compaction width for variant-only runs: each tile
# fetches [cap+1, K+1] int32 instead of the full [L, K] counts. Tiles with
# more candidates than this refetch the full screen (rare).
COMPACT_CAP = 512


@dataclass(frozen=True)
class ThresholdCall:
    sample_name: str
    contig: str
    start: int
    allele: Allele
    labels: Tuple[str, str]

    def to_vcf_record(self) -> VcfRecord:
        return VcfRecord(
            contig=self.contig,
            start=self.start,
            ref=Bases.bases_to_string(self.allele.ref_bases),
            alt=Bases.bases_to_string(self.allele.alt_bases),
            sample_name=self.sample_name or "default",
            genotype=self.labels,
        )


def classify_locus(
    alleles_and_counts: List[Tuple[Allele, int]],
    total_reads: int,
    reference_base: int,
    sample_name: str,
    contig: str,
    locus: int,
    threshold_percent: int,
    emit_ref: bool,
    emit_no_call: bool,
) -> List[ThresholdCall]:
    """Classify one (sample, locus) from its per-allele counts."""
    passing = [
        (allele, count)
        for allele, count in alleles_and_counts
        if count * 100 // total_reads > threshold_percent
    ]
    # Sort by descending count; ties broken by canonical allele order.
    passing.sort(key=lambda pair: (-pair[1], pair[0]))

    def call(allele: Allele, labels: Tuple[str, str]) -> ThresholdCall:
        return ThresholdCall(sample_name, contig, locus, allele, labels)

    ref_placeholder = Allele(bytes([reference_base]), Bases.ALT)

    if not passing:
        return [call(ref_placeholder, NO_CALL)] if emit_no_call else []
    if len(passing) == 1:
        allele, _ = passing[0]
        if not allele.is_variant:
            return [call(ref_placeholder, HOM_REF)] if emit_ref else []
        return [call(allele, HOM_ALT)]
    (a1, _), (a2, _) = passing[0], passing[1]
    # Heterozygous deletion: skip (GermlineThresholdCaller.scala:147-149).
    if (not a1.is_variant or not a2.is_variant) and (
        (a1.alt_bases == b"") != (a2.alt_bases == b"")
    ):
        return []
    if a1.is_variant != a2.is_variant:
        return [call(a1 if a1.is_variant else a2, HET)]
    if a1.is_variant and a2.is_variant:
        return [call(a1, COMPOUND), call(a2, COMPOUND)]
    # Multiple "reference" alleles: tolerate an N reference, else error.
    if a1.ref_bases == b"N" or a2.ref_bases == b"N":
        log.warning(
            "Reference base N found and ignored in sample=%s at (%s, %d)",
            sample_name,
            contig,
            locus,
        )
        proper = a2.ref_bases if a1.ref_bases == b"N" else a1.ref_bases
        return [call(Allele(proper, Bases.ALT), HOM_REF)]
    raise ValueError(
        "Multiple reference bases found in sample = %s at (chr, pos) = (%s, %d)"
        % (sample_name, contig, locus)
    )


def call_variants_at_locus(
    pileup: Pileup,
    threshold_percent: int,
    emit_ref: bool = True,
    emit_no_call: bool = True,
) -> List[ThresholdCall]:
    """Per-pileup API (host oracle path; the tile path is call_tile).
    Mirrors callVariantsAtLocus (GermlineThresholdCaller.scala:90-178),
    including its emitRef/emitNoCall defaults."""
    if not pileup.elements:
        return []
    calls: List[ThresholdCall] = []
    for sample_name, sample_pileup in sorted(pileup.by_sample().items()):
        counts_map: Dict[Allele, int] = {}
        for e in sample_pileup.elements:
            counts_map[e.allele] = counts_map.get(e.allele, 0) + 1
        calls.extend(
            classify_locus(
                sorted(counts_map.items()),
                sample_pileup.depth,
                pileup.reference_base,
                sample_name,
                pileup.reference_name,
                pileup.locus,
                threshold_percent,
                emit_ref,
                emit_no_call,
            )
        )
    return calls


def call_tile(
    tile: LocusTile,
    sample_name: str,
    threshold_percent: int,
    emit_ref: bool,
    emit_no_call: bool,
    *,
    device: torch.device,
    sample_reads: Optional[Sequence[MappedRead]] = None,
    source=None,
    pending=None,
) -> List[ThresholdCall]:
    """Screen a tile (or take its already-launched screen, `pending`) and
    classify its active rows on the host."""
    if tile.L == 0:
        return []
    if pending is not None:
        stats = pending.result()
    else:
        stats = screen_tile_for(
            tile, threshold_percent=threshold_percent, device=device
        )
    depth_arr = np.asarray(tile.depth)[: tile.L]
    overflow_arr = np.asarray(tile.overflow).astype(bool)[: tile.L]
    if isinstance(stats, CompactScreen):
        if stats.overflowed:
            # More candidates than the compaction cap: refetch the full
            # [L, K] screen for this tile (rare).
            stats = screen_tile_for(
                tile, threshold_percent=threshold_percent, device=device
            )
        else:
            if emit_ref or emit_no_call:
                raise ValueError("compact screens only carry candidate rows")
            counts_by_row = {
                int(r): stats.counts[i] for i, r in enumerate(stats.idx)
            }
            calls = []
            rows = np.union1d(
                stats.idx.astype(np.int64),
                np.nonzero(overflow_arr & (depth_arr > 0))[0],
            )
            for li in rows:
                li = int(li)
                row_counts = (
                    None if overflow_arr[li] else counts_by_row.get(li)
                )
                calls.extend(
                    _classify_tile_locus(
                        tile, li, int(depth_arr[li]), row_counts,
                        sample_name, sample_reads, source,
                        threshold_percent, emit_ref, emit_no_call,
                    )
                )
            return calls
    counts = stats.counts
    calls: List[ThresholdCall] = []
    # Only loci flagged by the screen (the exact thresholded passing rule)
    # or needing the exact host fallback can produce output; with emit
    # flags set every covered locus can.
    active = depth_arr > 0
    if not (emit_ref or emit_no_call):
        evidence = np.asarray(stats.candidates).astype(bool)[: tile.L]
        active &= evidence | overflow_arr
    for li in np.nonzero(active)[0]:
        li = int(li)
        row_counts = None if tile.overflow[li] else counts[li]
        calls.extend(
            _classify_tile_locus(
                tile, li, int(depth_arr[li]), row_counts, sample_name,
                sample_reads, source, threshold_percent, emit_ref,
                emit_no_call,
            )
        )
    return calls


def _classify_tile_locus(
    tile: LocusTile,
    li: int,
    total: int,
    row_counts,
    sample_name: str,
    sample_reads,
    source,
    threshold_percent: int,
    emit_ref: bool,
    emit_no_call: bool,
) -> List[ThresholdCall]:
    """Classify one tile row from its screen counts (row_counts, [K]) or,
    when row_counts is None (overflow row), via the exact host pileup."""
    locus = int(tile.loci[li])
    if row_counts is None:
        # Exact host fallback for >K-allele or deeper-than-int16 loci.
        if source is not None:
            pileup = source.pileup_at(tile.contig, locus)
        else:
            if sample_reads is None:
                raise ValueError(
                    "overflow locus requires reads for exact host fallback"
                )
            pileup = Pileup.from_reads(sample_reads, tile.contig, locus)
        counts_map: Dict[Allele, int] = {}
        for e in pileup.elements:
            counts_map[e.allele] = counts_map.get(e.allele, 0) + 1
        alleles_and_counts = sorted(counts_map.items())
        total = pileup.depth
        reference_base = pileup.reference_base
    else:
        n = int(tile.num_alleles[li])
        alleles_and_counts = [
            (tile.alleles[li][k], int(row_counts[k])) for k in range(n)
        ]
        reference_base = int(tile.ref_base[li])
    return classify_locus(
        alleles_and_counts,
        total,
        reference_base,
        sample_name,
        tile.contig,
        locus,
        threshold_percent,
        emit_ref,
        emit_no_call,
    )


def _per_sample(source):
    return {name: source.for_sample(name) for name in source.sample_names()}


def _sample_tiles(sample_sources, task_loci, device, tile_size, max_alleles,
                  reference_genome, mesh=None):
    """(tile, sample_name, sample_source) for one partition task's loci."""
    skip_nib = pack_skip_nibbles(device, mesh)
    for sample_name, sample_source in sorted(sample_sources.items()):
        for contig in task_loci.contigs:
            for tile in sample_source.iter_tiles(
                contig,
                task_loci.on_contig(contig),
                tile_size=tile_size,
                max_alleles=max_alleles,
                reference_genome=reference_genome,
                fields="screen",
                skip_nibbles=skip_nib,
            ):
                trace.count("pack.tiles")
                trace.count("pack.rows", tile.L)
                yield tile, sample_name, sample_source


def call_variants(
    reads,
    loci_partitions: LociMap,
    threshold_percent: int = 8,
    emit_ref: bool = False,
    emit_no_call: bool = False,
    tile_size: int = 0,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
    *,
    device: torch.device,
) -> List[ThresholdCall]:
    """Call variants over a loci partitioning (shard -> loci).

    reads: a list of MappedReads or a ReadSource (columnar or object).
    mesh: a parallel.mesh.LociMesh — when given, the counting screens run
    in groups of mesh.size tiles, each tile on its own shard (device and
    CUDA stream), with full counts and no compaction, instead of one tile
    after another on `device`. Output is identical by construction
    (pinned by tests/test_torch_mesh.py)."""
    from guacamole_tpu_torch.callers.source import ReadSource

    source = (
        reads if isinstance(reads, ReadSource) else ReadSource.from_reads(reads)
    )
    inverse = loci_partitions.inverse_map()
    sample_sources = _per_sample(source)

    def tiles():
        for task in sorted(inverse):
            yield from _sample_tiles(
                sample_sources, inverse[task], device, tile_size, max_alleles,
                reference_genome, mesh,
            )

    return _screen_and_classify(
        tiles(), threshold_percent, emit_ref, emit_no_call, device, mesh
    )


def _screen_and_classify(
    tile_items, threshold_percent, emit_ref, emit_no_call, device, mesh=None
) -> List[ThresholdCall]:
    """Pipelined execution over (tile, sample_name, source) items: tiles
    pack on a background thread (the native packer releases the GIL), each
    packed tile's screen launches at once, and classification trails a
    bounded window of screens in flight. With a mesh, groups of mesh.size
    tiles screen at once, one tile per shard. Returns calls in
    deterministic order."""
    if mesh is not None:
        from guacamole_tpu_torch.parallel.mesh import mesh_csr_screens

        screen_iter = mesh_csr_screens(
            prefetch_iter(tile_items, ahead=2),
            tile_of=lambda item: item[0],
            mesh=mesh,
            threshold_percent=threshold_percent,
        )
    else:
        screen_iter = pipelined_screens(
            prefetch_iter(tile_items, ahead=2),
            tile_of=lambda item: item[0],
            device=device,
            threshold_percent=threshold_percent,
            # Variant-only runs read counts at candidate loci alone:
            # compact them on the device so each tile's fetch is one small
            # array.
            compact_cap=None if (emit_ref or emit_no_call) else COMPACT_CAP,
        )
    calls: List[ThresholdCall] = []
    for seq, ((tile, name, src), pending) in enumerate(screen_iter):
        with trace.span("classify", tile=seq):
            calls.extend(
                call_tile(
                    tile,
                    name,
                    threshold_percent,
                    emit_ref,
                    emit_no_call,
                    device=device,
                    source=src,
                    pending=pending,
                )
            )
    # Deterministic emission order regardless of tiling.
    with trace.span("sort"):
        calls.sort(key=lambda c: (c.contig, c.start, c.sample_name, c.allele))
    return calls


def call_variants_streaming(
    path: str,
    filters,
    loci_partitions: LociMap,
    threshold_percent: int = 8,
    emit_ref: bool = False,
    emit_no_call: bool = False,
    tile_size: int = 0,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
    *,
    device: torch.device,
) -> Optional[List[ThresholdCall]]:
    """Streaming variant: each partition task decodes only its own BAM
    byte ranges (.bai pushdown), with task i+1's IO + decode on a
    background thread while task i packs and screens. Output identical to
    load-then-call. Returns None when streaming is unavailable (non-BAM
    input, no native runtime or index): callers then use load_read_source
    + call_variants."""
    from guacamole_tpu_torch.callers.streaming import iter_task_sources

    with trace.span("plan"):
        task_sources = iter_task_sources(path, filters, loci_partitions)
    if task_sources is None:
        return None

    # One pipeline across ALL tasks: tiles from task i+1 keep the device
    # busy while task i's tail classifies.
    def tiles():
        for _task, task_loci, source in task_sources:
            yield from _sample_tiles(
                _per_sample(source), task_loci, device, tile_size,
                max_alleles, reference_genome, mesh,
            )

    return _screen_and_classify(
        tiles(), threshold_percent, emit_ref, emit_no_call, device, mesh
    )
