"""germline-standard caller: Bayesian genotyping from base qualities.

Port of guacamole_tpu/callers/germline_standard.py onto the port's
dispatch, with the same two-phase design
(cf. GermlineStandardCaller.scala:49-124):

 1. Device screen: pack loci tiles, compute per-locus variant-evidence masks
    over MAPQ-filtered elements (one fused kernel over whole tiles). Loci
    with no variant-allele element cannot produce a call (the most likely
    genotype over a ref-only allele set has no variant allele), so the
    screen is an exact superset of emitted loci.
 2. Host confirm: at surviving candidate loci only (a small fraction),
    run the exact float64 likelihood model (normalized, log-space,
    reference summation order), argmax genotype, evidence statistics, and
    genotype filters — vectorized directly over the sparse FULL tile's
    per-element tensors (calls_from_tile_row; bit-identical to the
    per-pileup oracle, object pileups rebuilt only for overflow rows).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from guacamole_tpu_torch.filters.genotype_filters import apply_genotype_filters
from guacamole_tpu_torch.filters.pileup_filters import quality_aligned_reads_filter
from guacamole_tpu_torch.gio.vcf import VcfRecord
from guacamole_tpu_torch.likelihood import (
    genotype_probs_for_rows,
    likelihoods_of_all_possible_genotypes_from_pileup,
)
from guacamole_tpu_torch.loci.locimap import LociMap
from guacamole_tpu_torch.pileup.pileup import Pileup
from guacamole_tpu_torch.utils import bases as Bases
from guacamole_tpu_torch.utils import trace
from guacamole_tpu_torch.utils.phred import success_probability_to_phred
from guacamole_tpu_torch.variants.called import CalledAllele
from guacamole_tpu_torch.variants.evidence import AlleleEvidence


def call_variants_at_locus(
    pileup: Pileup,
    min_alignment_quality: int = 0,
    emit_ref: bool = False,
) -> List[CalledAllele]:
    """Exact per-pileup caller
    (cf. GermlineStandardCaller.callVariantsAtLocus, :90-124).

    emit_ref is accepted but has no effect — bug-for-bug parity: the
    reference declares the parameter (:92) and the --emit-ref flag (:41)
    but its kernel only ever maps getNonReferenceAlleles (:113)."""
    if not pileup.elements:
        return []
    calls: List[CalledAllele] = []
    for sample_name, sample_pileup in sorted(pileup.by_sample().items()):
        filtered = quality_aligned_reads_filter(
            sample_pileup.elements, min_alignment_quality
        )
        if not filtered:
            continue
        filtered_pileup = Pileup(
            sample_pileup.reference_name,
            sample_pileup.locus,
            sample_pileup.reference_base,
            filtered,
        )
        genotype_likelihoods = likelihoods_of_all_possible_genotypes_from_pileup(
            filtered_pileup, log_space=True, normalize=True
        )
        if not genotype_likelihoods:
            continue
        genotype, log_prob = max(genotype_likelihoods, key=lambda gl: gl[1])
        probability = math.exp(log_prob)
        for allele in genotype.non_reference_alleles:
            calls.append(
                CalledAllele(
                    sample_name=sample_name,
                    reference_contig=sample_pileup.reference_name,
                    start=sample_pileup.locus,
                    allele=allele,
                    evidence=AlleleEvidence.from_pileup(
                        probability, allele, sample_pileup
                    ),
                )
            )
    return calls


def calls_from_tile_row(
    tile, li: int, sample_name: str, min_alignment_quality: int = 0
) -> List[CalledAllele]:
    """Exact per-locus caller over one FULL tile row — the vectorized form
    of call_variants_at_locus (bit-identical; pinned by
    tests/test_germline_standard.py::test_tile_row_confirm_bitwise)."""
    return calls_from_tile_rows(tile, [li], sample_name, min_alignment_quality)


def calls_from_tile_rows(
    tile,
    rows: List[int],
    sample_name: str,
    min_alignment_quality: int = 0,
    prefilter_min_likelihood: int = 0,
) -> List[CalledAllele]:
    """Exact f64 confirm over many FULL tile rows in one batched pass
    (genotype_probs_for_rows); bit-identical to per-row
    calls_from_tile_row, which delegates here.

    prefilter_min_likelihood: apply the min-likelihood genotype filter's
    exact predicate (phred of likelihood - 1e-10,
    GenotypeFilter.scala:135) at emission, skipping the evidence work
    for calls the filter chain would drop anyway. ONLY passed when the
    chain's earlier filters are inert (defaults) and debug counting is
    off, so dropping early is order-equivalent (pinned by
    tests/test_germline_standard.py)."""
    if not rows:
        return []
    idx = np.asarray(rows, dtype=np.int64)
    valid = np.asarray(tile.valid)[idx].astype(bool)
    aid = np.asarray(tile.allele_id)[idx]
    mapq = np.asarray(tile.mapq)[idx]
    quals = np.asarray(tile.qual)[idx]
    keep = valid & (mapq >= min_alignment_quality)
    std_rows = np.asarray(tile.is_standard_alt)[idx].astype(bool)
    per_row = genotype_probs_for_rows(
        aid, quals, keep, std_rows, log_space=True
    )

    # Pass 1: argmax gate + allele selection for every emitting row.
    # Variant-ness comes from tile.is_variant[li, dense_id] (the packer's
    # per-dictionary-entry ref!=alt flag — the same predicate as
    # Allele.is_variant), so non-emitting rows never materialize their
    # allele tables or Genotype objects. Emission order and hom-alt
    # duplicate semantics match the oracle's genotype.non_reference_alleles
    # walk exactly: (a1 then a2, one entry per variant allele copy).
    iv = np.asarray(tile.is_variant)
    emit: List[tuple] = []  # (rpos, li, probability, allele, dense_id)
    for rpos, li in enumerate(rows):
        pairs, lls = per_row[rpos]
        if not pairs:
            continue
        best = int(np.argmax(lls))  # first max, like the oracle's max()
        a1, a2 = pairs[best]
        v1 = bool(iv[li, a1])
        v2 = bool(iv[li, a2])
        if not (v1 or v2):
            continue
        probability = math.exp(lls[best])
        if (
            prefilter_min_likelihood > 0
            and success_probability_to_phred(probability - 1e-10)
            < prefilter_min_likelihood
        ):
            continue
        alleles_row = tile.alleles[li]
        if v1:
            emit.append((rpos, li, probability, alleles_row[a1], a1))
        if v2:
            emit.append((rpos, li, probability, alleles_row[a2], a2))
    if not emit:
        return []

    # Pass 2: evidence statistics over the UNFILTERED elements (parity
    # with AlleleEvidence.from_pileup on the unfiltered sample pileup),
    # batched across all emitting rows (AlleleEvidence.stats_batch is
    # bit-identical to the per-row from_arrays form).
    strand_all = np.asarray(tile.strand)
    mismatches_all = np.asarray(tile.mismatches)
    e_rpos = np.asarray([e[0] for e in emit])
    e_li = [e[1] for e in emit]
    e_valid = valid[e_rpos]
    masks = np.stack(
        [valid[rpos] & (aid[rpos] == dense_id) for rpos, _, _, _, dense_id in emit]
    )
    e_strand = strand_all[e_li]
    stats = AlleleEvidence.stats_batch(
        masks, mapq[e_rpos], quals[e_rpos], mismatches_all[e_li]
    )

    # Depth counts batched across all emits (4 x n_emit tiny .sum calls
    # cost ~1 s at 117k emitting rows).
    read_depths = e_valid.sum(axis=1)
    allele_depths = masks.sum(axis=1)
    forward_depths = (e_valid & e_strand).sum(axis=1)
    allele_forward_depths = (masks & e_strand).sum(axis=1)
    calls: List[CalledAllele] = []
    for j, (rpos, li, probability, allele, dense_id) in enumerate(emit):
        calls.append(
            CalledAllele(
                sample_name=sample_name,
                reference_contig=tile.contig,
                start=int(tile.loci[li]),
                allele=allele,
                evidence=AlleleEvidence(
                    likelihood=probability,
                    read_depth=int(read_depths[j]),
                    allele_read_depth=int(allele_depths[j]),
                    forward_depth=int(forward_depths[j]),
                    allele_forward_depth=int(allele_forward_depths[j]),
                    mean_mapping_quality=float(stats[0][j]),
                    median_mapping_quality=float(stats[1][j]),
                    mean_base_quality=float(stats[2][j]),
                    median_base_quality=float(stats[3][j]),
                    median_mismatches_per_read=float(stats[4][j]),
                ),
            )
        )
    return calls


def call_variants(
    reads,
    loci_partitions: LociMap,
    min_alignment_quality: int = 0,
    emit_ref: bool = False,
    tile_size: int = 4096,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
    task_sources=None,
    prefilter_min_likelihood: int = 0,
    *,
    device: torch.device,
) -> List[CalledAllele]:
    """Two-phase (device screen -> exact host confirm) over a partitioning.

    reads: a list of MappedReads or a ReadSource (columnar or object); may
    be None when task_sources is given.
    mesh: a parallel.mesh.LociMesh — when given, the genotype-likelihood
    screen runs in groups of mesh.size tiles, each tile on its own shard
    (device and CUDA stream); the exact f64 confirm is unchanged, so
    output is identical (pinned by tests/test_torch_mesh.py).
    task_sources: an iterator of (task, task_loci, ReadSource) — the
    streaming per-task .bai-pushdown input (callers/streaming.py); when
    given, each task's tiles pack from its own source."""
    from guacamole_tpu_torch.callers.source import ReadSource

    calls: List[CalledAllele] = []

    if task_sources is None:
        source = (
            reads
            if isinstance(reads, ReadSource)
            else ReadSource.from_reads(reads)
        )
        inverse = loci_partitions.inverse_map()
        whole_samples = {
            name: source.for_sample(name) for name in source.sample_names()
        }

        def task_iter():
            for task in sorted(inverse):
                yield inverse[task], whole_samples

    else:

        def task_iter():
            for _task, task_loci, task_source in task_sources:
                yield task_loci, {
                    name: task_source.for_sample(name)
                    for name in task_source.sample_names()
                }

    from guacamole_tpu_torch.ops.dispatch import (
        ScreenPlan,
        candidates_of,
        pipelined,
    )

    plan = ScreenPlan(
        "germline", device=device, mesh=mesh,
        min_mapq=min_alignment_quality,
        # The min-likelihood emission gate, applied in the screen (a safe
        # superset) when the exact emission prefilter is active.
        min_phred=float(prefilter_min_likelihood),
    )

    def tiles():
        for task_loci, sample_sources in task_iter():
            for sample_name, sample_source in sorted(sample_sources.items()):
                for contig in task_loci.contigs:
                    for tile in sample_source.iter_tiles(
                        contig,
                        task_loci.on_contig(contig),
                        reference_genome=reference_genome,
                        **plan.pack_args(tile_size, max_alleles),
                    ):
                        trace.count("pack.tiles")
                        trace.count("pack.rows", tile.L)
                        yield sample_name, sample_source, contig, tile

    def confirm(sample_name, sample_source, contig, sparse):
        dense_rows = [si for si in range(sparse.L) if not sparse.overflow[si]]
        for si in range(sparse.L):
            if sparse.overflow[si]:
                pileup = sample_source.pileup_at(
                    contig,
                    int(sparse.loci[si]),
                    reference_base=int(sparse.ref_base[si]),
                )
                calls.extend(
                    call_variants_at_locus(
                        pileup, min_alignment_quality, emit_ref
                    )
                )
        with trace.span("confirm"):
            calls.extend(
                calls_from_tile_rows(
                    sparse, dense_rows, sample_name, min_alignment_quality,
                    prefilter_min_likelihood=prefilter_min_likelihood,
                )
            )

    # Screen tiles pack on a prefetch thread and the sparse confirm tile
    # packs on an executor thread (the native packer releases the GIL),
    # overlapping the previous tile's exact f64 confirm on the main thread
    # (a second pipelined() stage, one pack in flight).
    from concurrent.futures import ThreadPoolExecutor

    from guacamole_tpu_torch.ops.dispatch import prefetch_iter

    def screened():
        # Per-tile async launches: each packed tile's screen launches at
        # once and overlaps the packing of the next.
        screen_iter = plan.screens(
            prefetch_iter(tiles(), ahead=2), tile_of=lambda item: item[3]
        )
        for item, pending in screen_iter:
            sample_name, sample_source, contig, tile = item
            if pending is None:
                continue
            cand = candidates_of(pending.result())
            rows = np.flatnonzero(
                (cand | np.asarray(tile.overflow))
                & (np.asarray(tile.depth)[: tile.L] > 0)
            )
            if not len(rows):
                continue
            # Group candidates by depth bucket (and bound rows x depth):
            # one sparse confirm tile over mixed depths would pad every
            # row to the deepest candidate's bucket — with megatile
            # screens that's a [all-candidates, deepest-bucket] grid,
            # gigabytes of padding at scale.
            loci_arr = np.asarray(tile.loci)[rows]
            depths = np.asarray(tile.depth)[rows]
            from guacamole_tpu_torch.pack.columnar import _depth_bucket

            buckets = _depth_bucket(depths)
            for b in np.unique(buckets):
                group = loci_arr[buckets == b]
                max_rows = max(1024, (32 << 20) // int(b))
                for i in range(0, len(group), max_rows):
                    yield (
                        sample_name,
                        sample_source,
                        contig,
                        [int(x) for x in group[i : i + max_rows]],
                    )

    with ThreadPoolExecutor(max_workers=1) as executor:

        def launch_pack(item):
            # One sparse FULL tile over just the candidates: the exact f64
            # confirm runs directly on its per-element tensors (object
            # pileups are rebuilt only for overflow rows).
            _, sample_source, contig, candidate_loci = item
            return executor.submit(
                sample_source.pack_sparse_tile,
                contig,
                candidate_loci,
                # Wider allele dictionary than the screens': deep
                # candidate rows carry many error alleles, and a row that
                # fits the dictionary confirms on the batched exact path
                # instead of a scalar oracle pileup (measured: two deep
                # boundary rows with 14-16 distinct alleles cost 0.33 s
                # as pileups). Semantics are unchanged either way — both
                # paths are the exact f64 model; K only picks which one
                # runs.
                max_alleles=max(max_alleles, 24),
                reference_genome=reference_genome,
            )

        for (name, src, ctg, _), fut in pipelined(
            screened(), launch_pack, max_in_flight=1
        ):
            confirm(name, src, ctg, fut.result())
    with trace.span("sort"):
        calls.sort(
            key=lambda c: (
                c.reference_contig, c.start, c.sample_name or "", c.allele
            )
        )
    return calls


def call_variants_streaming(
    path: str,
    filters,
    loci_partitions: LociMap,
    **kwargs,
) -> Optional[List[CalledAllele]]:
    """Streaming variant of call_variants: each partition task decodes
    only its own BAM byte ranges (.bai pushdown, cf. Read.scala:395-406),
    with task i+1's IO + decode prefetched on a background thread while
    task i screens and confirms. Identical output to load-then-call
    (pinned by tests/test_streaming_callers.py). Returns None when
    streaming is unavailable (non-BAM input, no native runtime/index)."""
    from guacamole_tpu_torch.callers.streaming import iter_task_sources

    task_sources = iter_task_sources(path, filters, loci_partitions)
    if task_sources is None:
        return None
    return call_variants(
        None, loci_partitions, task_sources=task_sources, **kwargs
    )


def called_allele_to_vcf_record(call: CalledAllele) -> VcfRecord:
    """ADAM genotype conversion parity (AlleleConversions.scala:30-45)."""
    ev = call.evidence
    return VcfRecord(
        contig=call.reference_contig,
        start=call.start,
        ref=Bases.bases_to_string(call.allele.ref_bases),
        alt=Bases.bases_to_string(call.allele.alt_bases),
        sample_name=call.sample_name or "default",
        genotype=("Ref", "Alt"),
        read_depth=ev.read_depth,
        reference_read_depth=ev.read_depth - ev.allele_read_depth,
        alternate_read_depth=ev.allele_read_depth,
        genotype_quality=ev.phred_scaled_likelihood,
        id_="." if call.rs_id is None else str(call.rs_id),
    )


def _prefilter_min_likelihood(args) -> int:
    """args.min_likelihood, but only when applying it at emission is
    order-equivalent to the filter chain: every earlier filter inert
    (defaults) and per-stage debug counting off."""
    if (
        args.min_read_depth == 0
        and args.max_read_depth == 2**31 - 1
        and args.min_alternate_read_depth == 0
        and not args.debug_genotype_filters
    ):
        return args.min_likelihood
    return 0


def _try_streaming(args, loci_builder, reference, mesh, filters, _add_fns,
                   device):
    """Streaming germline-standard (per-task .bai pushdown). Returns
    (calls, contig_lengths) or (None, None) when unavailable."""
    try:
        from guacamole_tpu_torch.gio.bam import BamFile

        dictionary = dict(BamFile(args.reads).references)
    except Exception:
        return None, None
    loci_set = loci_builder.result(dictionary)
    partitions = _add_fns["streaming_partitions"](
        args, loci_set, args.reads
    )
    if partitions is None:
        return None, None
    calls = call_variants_streaming(
        args.reads,
        filters,
        partitions,
        min_alignment_quality=args.min_alignment_quality,
        emit_ref=args.emit_ref,
        tile_size=args.tile_size,
        reference_genome=reference,
        mesh=mesh,
        prefilter_min_likelihood=_prefilter_min_likelihood(args),
        device=device,
    )
    if calls is None:
        return None, None
    return calls, dictionary


def main(argv, _add_fns) -> int:
    import argparse

    from guacamole_tpu_torch.callers.common import (
        load_read_source,
        resolve_loci_builder,
        validate_output_path,
        write_variants,
    )
    from guacamole_tpu_torch.gio.fasta import ReferenceGenome
    from guacamole_tpu_torch.reads.read import InputFilters
    from guacamole_tpu_torch.utils.progress import progress

    p = argparse.ArgumentParser(
        prog="guacamole-torch germline-standard",
        description="call variants using a simple quality-based probability",
    )
    _add_fns["base"](p)
    _add_fns["loci"](p)
    _add_fns["reads"](p)
    _add_fns["output"](p)
    _add_fns["distributed"](p)
    _add_fns["device"](p)
    p.add_argument("--emit-ref", action="store_true")
    p.add_argument("--reference-fasta", default=None)
    _add_fns["concordance"](p)
    # pileup filter args (PileupFilter.scala:48-59)
    p.add_argument("--min-mapq", type=int, default=1, dest="min_alignment_quality")
    p.add_argument("--filter-multi-allelic", action="store_true")
    p.add_argument("--min-edge-distance", type=int, default=0)
    # genotype filter args (GenotypeFilter.scala:121-138)
    p.add_argument("--min-read-depth", type=int, default=0)
    p.add_argument("--max-read-depth", type=int, default=2**31 - 1)
    p.add_argument("--min-alternate-read-depth", type=int, default=0)
    p.add_argument("--min-likelihood", type=int, default=0)
    p.add_argument(
        "--debug-genotype-filters",
        action="store_true",
        help="Print count of genotypes after each filtering step",
    )
    args = p.parse_args(argv)
    device = _add_fns["resolve_device"](args)

    validate_output_path(args.out)
    loci_builder = resolve_loci_builder(args.loci, args.loci_from_file)
    mh = _add_fns["bootstrap_multihost"](args)
    loci_builder, empty_shard = _add_fns["multihost_shard_builder"](
        mh, loci_builder, args.reads, args
    )
    if empty_shard:
        from guacamole_tpu_torch.loci.lociset import parse_loci

        loci_builder = parse_loci("")  # no loci: loads nothing, calls nothing
    reference = (
        ReferenceGenome.from_fasta(args.reference_fasta)
        if args.reference_fasta
        else None
    )
    filters = InputFilters.create(
        overlaps_loci=loci_builder, non_duplicate=True, has_mdtag=True
    )
    mesh = _add_fns["resolve_mesh"](args)
    calls = None
    contig_lengths = None
    if not empty_shard and _add_fns["streaming_eligible"](args):
        calls, contig_lengths = _try_streaming(
            args, loci_builder, reference, mesh, filters, _add_fns, device
        )
    if calls is None:
        source, contig_lengths = load_read_source(
            args.reads,
            filters,
            contig_lengths_from_dictionary=not args.no_sequence_dictionary,
            reference_genome=reference,
            recompute_mdtags=args.recompute_md_tags,
            use_native=args.bam_reader_api in ("best", "native"),
        )
        progress("Loaded %d mapped non-duplicate reads." % source.n)
        if mh.active:
            totals = _add_fns["multihost_counters"](mh, reads=source.n)
            progress(
                "Global: %d reads across %d processes."
                % (totals["reads"], mh.process_count)
            )
        loci_set = loci_builder.result(contig_lengths)
        partitions = _add_fns["partition"](args, loci_set, source)
        calls = call_variants(
            source,
            partitions,
            min_alignment_quality=args.min_alignment_quality,
            emit_ref=args.emit_ref,
            tile_size=args.tile_size,
            reference_genome=reference,
            mesh=mesh,
            prefilter_min_likelihood=_prefilter_min_likelihood(args),
            device=device,
        )
    filtered = apply_genotype_filters(
        calls,
        min_read_depth=args.min_read_depth,
        max_read_depth=args.max_read_depth,
        min_alternate_read_depth=args.min_alternate_read_depth,
        min_likelihood=args.min_likelihood,
        debug=args.debug_genotype_filters,
    )
    progress("Called %d genotypes after filtering." % len(filtered))
    with trace.span("write"):
        records = _add_fns["multihost_finalize"](
            mh, [called_allele_to_vcf_record(c) for c in filtered], args
        )
        if mh.is_writer:
            write_variants(
                records,
                args.out,
                contig_lengths=contig_lengths,
                max_genotypes=args.max_genotypes,
                vcf_header_compat=getattr(args, "vcf_header_compat", ""),
            )
            _add_fns["clear_shards_after_write"](mh, args)
    if mh.is_writer and args.truth:
        _add_fns["print_concordance"](args, records)
    return 0
