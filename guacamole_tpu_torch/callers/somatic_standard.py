"""somatic-standard caller: tumor/normal subtraction via genotype likelihoods.

Port of guacamole_tpu/callers/somatic_standard.py onto the port's
dispatch, with the same two-phase design
(cf. SomaticStandardCaller.scala:66-245):

 1. Device screen over tumor tiles: loci with >= 1 variant-allele element
    among MAPQ-passing tumor elements (a call requires a variant allele in
    the most likely tumor genotype, which requires tumor variant evidence).
 2. Exact host confirm at candidates: rebuild tumor pileup from packed read
    indices and the normal pileup via a sparse pack over candidate loci
    (each sample resolves its own reference base, as in the reference's
    per-sample initOrMovePileup); apply pileup filters; tumor likelihoods
    include alignment quality, normal likelihoods ignore it; gate on
    somatic odds.

Known numerical deviation: the reference sums normal variant-genotype
likelihoods in JVM HashMap iteration order; we sum in genotype enumeration
order (deterministic), which can differ in the last float64 ulps.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from guacamole_tpu_torch.filters.pileup_filters import filter_pileup
from guacamole_tpu_torch.gio.vcf import VcfRecord
from guacamole_tpu_torch.likelihood import (
    genotype_probs_for_rows,
    likelihoods_of_all_possible_genotypes_from_pileup,
    probability_correct_ignoring_alignment,
    probability_correct_including_alignment,
)
from guacamole_tpu_torch.loci.locimap import LociMap
from guacamole_tpu_torch.pileup.pileup import Pileup
from guacamole_tpu_torch.utils import bases as Bases
from guacamole_tpu_torch.utils import trace
from guacamole_tpu_torch.variants.allele import Allele
from guacamole_tpu_torch.variants.called import CalledSomaticAllele
from guacamole_tpu_torch.variants.evidence import AlleleEvidence

INT_MAX = 2**31 - 1


def find_potential_variant_at_locus(
    tumor_pileup: Pileup,
    normal_pileup: Pileup,
    odds_threshold: int,
    min_alignment_quality: int = 1,
    filter_multi_allelic: bool = False,
    max_read_depth: int = INT_MAX,
) -> List[CalledSomaticAllele]:
    """Exact per-locus somatic kernel
    (cf. SomaticStandardCaller.findPotentialVariantAtLocus, :162-245)."""
    filtered_normal = filter_pileup(
        normal_pileup, filter_multi_allelic, min_alignment_quality, 0
    )
    filtered_tumor = filter_pileup(
        tumor_pileup, filter_multi_allelic, min_alignment_quality, 0
    )
    if (
        not filtered_tumor.elements
        or not filtered_normal.elements
        or filtered_tumor.depth > max_read_depth
        or filtered_normal.depth > max_read_depth
        or filtered_tumor.reference_depth == filtered_tumor.depth
    ):
        return []

    tumor_likelihoods = likelihoods_of_all_possible_genotypes_from_pileup(
        filtered_tumor,
        probability_correct_including_alignment,
        normalize=True,
    )
    if not tumor_likelihoods:
        return []
    best_genotype, best_likelihood = max(tumor_likelihoods, key=lambda gl: gl[1])
    if not best_genotype.has_variant_allele:
        return []

    normal_likelihoods = likelihoods_of_all_possible_genotypes_from_pileup(
        filtered_normal,
        probability_correct_ignoring_alignment,
        normalize=True,
    )
    # Explicit sequential fold, NOT builtin sum(): CPython >= 3.12 gives
    # exact-float sum() Neumaier compensation, which deviates from the
    # JVM's naive foldLeft (SomaticStandardCaller.scala:206-210) by an
    # ulp — found by the round-5 fuzz campaign as an oracle-vs-production
    # evidence mismatch. The production batched path (below) folds the
    # same way.
    normal_variants_total = 0.0
    for g, l in normal_likelihoods:
        if g.has_variant_allele:
            normal_variants_total += l
    somatic_odds = (
        best_likelihood / normal_variants_total
        if normal_variants_total != 0
        else float("inf")
    )
    if somatic_odds * 100 < odds_threshold:
        return []

    allele = next(
        (a for a in best_genotype.non_reference_alleles if a.alt_bases), None
    )
    if allele is None:
        return []
    tumor_evidence = AlleleEvidence.from_pileup(
        best_likelihood, allele, filtered_tumor
    )
    normal_evidence = AlleleEvidence.from_pileup(
        1 - normal_variants_total,
        Allele(allele.ref_bases, allele.ref_bases),
        filtered_normal,
    )
    return [
        CalledSomaticAllele(
            sample_name=tumor_pileup.sample_name,
            reference_contig=tumor_pileup.reference_name,
            start=tumor_pileup.locus,
            allele=allele,
            somatic_log_odds=math.log(somatic_odds),
            tumor_variant_evidence=tumor_evidence,
            normal_reference_evidence=normal_evidence,
        )
    ]


def somatic_calls_from_tile_rows(
    tumor_tile,
    ti: int,
    normal_tile,
    ni: int,
    tumor_source,
    odds_threshold: int,
    min_alignment_quality: int = 1,
    filter_multi_allelic: bool = False,
    max_read_depth: int = INT_MAX,
) -> List[CalledSomaticAllele]:
    """Vectorized exact f64 somatic kernel over one (tumor, normal) pair of
    FULL tile rows — bit-identical to find_potential_variant_at_locus
    (pinned by tests/test_somatic.py::test_tile_row_somatic_bitwise)."""
    return somatic_calls_from_row_pairs(
        tumor_tile,
        [ti],
        normal_tile,
        [ni],
        tumor_source,
        odds_threshold,
        min_alignment_quality,
        filter_multi_allelic,
        max_read_depth,
    )


def _filter_masks_batch(tile, idx, min_alignment_quality, filter_multi_allelic):
    """Batched composite pileup filter over tile rows idx (filter order
    parity with filter_pileup): (valid, keep, aid) slot masks."""
    valid = np.asarray(tile.valid)[idx].astype(bool)
    aid = np.asarray(tile.allele_id)[idx]
    keep = valid.copy()
    if filter_multi_allelic:
        K = np.asarray(tile.is_variant).shape[1]
        presence = np.zeros((len(idx), K), dtype=bool)
        masked = np.where(valid, aid, -1)
        rr, cc = np.nonzero(masked >= 0)
        presence[rr, masked[rr, cc]] = True
        keep[presence.sum(axis=1) > 2] = False
    if min_alignment_quality > 0:
        keep &= np.asarray(tile.mapq)[idx] >= min_alignment_quality
    return valid, keep, aid


def somatic_calls_from_row_pairs(
    tumor_tile,
    tumor_rows: List[int],
    normal_tile,
    normal_rows: List[int],
    tumor_source,
    odds_threshold: int,
    min_alignment_quality: int = 1,
    filter_multi_allelic: bool = False,
    max_read_depth: int = INT_MAX,
) -> List[CalledSomaticAllele]:
    """Exact f64 somatic kernel over many (tumor, normal) row pairs in one
    batched pass (genotype_probs_for_rows); per-pair results are identical
    to somatic_calls_from_tile_rows, which delegates here."""
    R = len(tumor_rows)
    if R == 0:
        return []
    t_idx = np.asarray(tumor_rows, dtype=np.int64)
    n_idx = np.asarray(normal_rows, dtype=np.int64)
    t_valid, t_keep, t_aid = _filter_masks_batch(
        tumor_tile, t_idx, min_alignment_quality, filter_multi_allelic
    )
    _, n_keep, n_aid = _filter_masks_batch(
        normal_tile, n_idx, min_alignment_quality, filter_multi_allelic
    )
    t_depth = t_keep.sum(axis=1)
    n_depth = n_keep.sum(axis=1)
    alive = (
        (t_depth > 0)
        & (n_depth > 0)
        & (t_depth <= max_read_depth)
        & (n_depth <= max_read_depth)
    )

    # reference_depth == depth gate: a "reference" element is a MATCH
    # alignment — allele with ref == alt and a non-empty ref (clipped
    # elements have the empty allele and are neither).
    is_variant_t = np.asarray(tumor_tile.is_variant)[t_idx].astype(bool)
    K = is_variant_t.shape[1]
    kept_masked = np.where(t_keep, t_aid, -1)
    presence = np.zeros((R, K), dtype=bool)
    rr, cc = np.nonzero(kept_masked >= 0)
    presence[rr, kept_masked[rr, cc]] = True
    # A "pure reference" dictionary entry is ref==alt with non-empty ref —
    # the oracle predicate on event alleles (matches qualify; the empty
    # clipped allele does not). One vectorized mask instead of a per-row
    # Python walk over the allele tables. Deliberately independent of the
    # tile's resolved ref_base: a read whose MD-implied base disagrees
    # with it still counts as reference support, same as the oracle.
    from guacamole_tpu_torch.pack.tiles import pure_ref_allele_mask

    pure_ref = pure_ref_allele_mask(tumor_tile)[t_idx]  # [R, K] bool
    alive &= (presence & ~pure_ref).any(axis=1)
    live = np.flatnonzero(alive)
    if not len(live):
        return []

    # Batched exact tumor likelihoods (alignment-included).
    t_quals = np.asarray(tumor_tile.qual)[t_idx]
    t_mapqs = np.asarray(tumor_tile.mapq)[t_idx]
    t_std = np.asarray(tumor_tile.is_standard_alt)[t_idx].astype(bool)
    tumor_res = genotype_probs_for_rows(
        t_aid[live],
        t_quals[live],
        t_keep[live],
        t_std[live],
        mapqs=t_mapqs[live],
    )
    # Tumor argmax gate: best genotype must carry a variant allele.
    survivors: List[int] = []  # positions into `live`
    best_info: Dict[int, Tuple[Tuple[int, int], float]] = {}
    for pos, r in enumerate(live):
        pairs, tumor_probs = tumor_res[pos]
        if not pairs:
            continue
        best = int(np.argmax(tumor_probs))
        best_pair = pairs[best]
        if not (
            is_variant_t[r][best_pair[0]] or is_variant_t[r][best_pair[1]]
        ):
            continue
        survivors.append(pos)
        best_info[pos] = (best_pair, tumor_probs[best])
    if not survivors:
        return []

    # Batched exact normal likelihoods (alignment ignored) at survivors.
    sur_rows = np.asarray([live[pos] for pos in survivors])
    n_quals = np.asarray(normal_tile.qual)[n_idx]
    n_std = np.asarray(normal_tile.is_standard_alt)[n_idx].astype(bool)
    is_variant_n = np.asarray(normal_tile.is_variant)[n_idx].astype(bool)
    normal_res = genotype_probs_for_rows(
        n_aid[sur_rows], n_quals[sur_rows], n_keep[sur_rows], n_std[sur_rows]
    )

    # Pass 1: odds gate + allele selection; collect evidence masks of the
    # emitting rows so the stats run as ONE batched pass (below).
    emit: List[dict] = []
    for spos, pos in enumerate(survivors):
        r = int(live[pos])
        best_pair, best_likelihood = best_info[pos]
        n_pairs, normal_probs = normal_res[spos]
        iv_n = is_variant_n[r]
        # Sequential fold in enumeration order (JVM .sum parity; see
        # find_potential_variant_at_locus).
        normal_variants_total = 0.0
        for (a, b), p in zip(n_pairs, normal_probs):
            if iv_n[a] or iv_n[b]:
                normal_variants_total += float(p)
        somatic_odds = (
            best_likelihood / normal_variants_total
            if normal_variants_total != 0
            else float("inf")
        )
        if somatic_odds * 100 < odds_threshold:
            continue

        ti = int(tumor_rows[r])
        ni = int(normal_rows[r])
        tumor_alleles = tumor_tile.alleles[ti]
        allele = None
        allele_id = None
        for k in best_pair:
            cand = tumor_alleles[k]
            if cand.is_variant and cand.alt_bases:
                allele = cand
                allele_id = k
                break
        if allele is None:
            continue
        # sample name of the (unfiltered) tumor pileup's first element
        first_slot = int(np.flatnonzero(t_valid[r])[0])
        sample_name = tumor_source.read(
            int(tumor_tile.read_index[ti][first_slot])
        ).sample_name
        ref_allele = Allele(allele.ref_bases, allele.ref_bases)
        normal_alleles = normal_tile.alleles[ni]
        normal_id = next(
            (
                k
                for k in range(int(normal_tile.num_alleles[ni]))
                if normal_alleles[k] == ref_allele
            ),
            None,
        )
        emit.append(
            dict(
                r=r,
                ti=ti,
                ni=ni,
                allele=allele,
                allele_id=allele_id,
                normal_id=normal_id,
                best_likelihood=best_likelihood,
                normal_variants_total=normal_variants_total,
                somatic_odds=somatic_odds,
                sample_name=sample_name,
            )
        )
    if not emit:
        return []

    # Pass 2: batched evidence statistics over all emitting rows at once
    # (AlleleEvidence.stats_batch — bit-identical to the scalar
    # from_arrays form; somatic evidence comes from the FILTERED pileups,
    # SomaticStandardCaller.scala:196-210).
    e_rows = np.asarray([e["r"] for e in emit])
    t_mask = np.stack(
        [t_keep[e["r"]] & (t_aid[e["r"]] == e["allele_id"]) for e in emit]
    )
    n_mask = np.stack(
        [
            (
                n_keep[e["r"]] & (n_aid[e["r"]] == e["normal_id"])
                if e["normal_id"] is not None
                else np.zeros_like(n_keep[e["r"]])
            )
            for e in emit
        ]
    )
    e_ti = [e["ti"] for e in emit]
    e_ni = [e["ni"] for e in emit]
    t_strand = np.asarray(tumor_tile.strand)[e_ti]
    n_strand = np.asarray(normal_tile.strand)[e_ni]
    t_stats = AlleleEvidence.stats_batch(
        t_mask,
        t_mapqs[e_rows],
        t_quals[e_rows],
        np.asarray(tumor_tile.mismatches)[e_ti],
    )
    n_stats = AlleleEvidence.stats_batch(
        n_mask,
        np.asarray(normal_tile.mapq)[e_ni],
        n_quals[e_rows],
        np.asarray(normal_tile.mismatches)[e_ni],
    )
    t_keep_e = t_keep[e_rows]
    n_keep_e = n_keep[e_rows]

    calls: List[CalledSomaticAllele] = []
    for j, e in enumerate(emit):
        tumor_evidence = AlleleEvidence(
            likelihood=e["best_likelihood"],
            read_depth=int(t_keep_e[j].sum()),
            allele_read_depth=int(t_mask[j].sum()),
            forward_depth=int((t_keep_e[j] & t_strand[j]).sum()),
            allele_forward_depth=int((t_mask[j] & t_strand[j]).sum()),
            mean_mapping_quality=float(t_stats[0][j]),
            median_mapping_quality=float(t_stats[1][j]),
            mean_base_quality=float(t_stats[2][j]),
            median_base_quality=float(t_stats[3][j]),
            median_mismatches_per_read=float(t_stats[4][j]),
        )
        normal_evidence = AlleleEvidence(
            likelihood=1 - e["normal_variants_total"],
            read_depth=int(n_keep_e[j].sum()),
            allele_read_depth=int(n_mask[j].sum()),
            forward_depth=int((n_keep_e[j] & n_strand[j]).sum()),
            allele_forward_depth=int((n_mask[j] & n_strand[j]).sum()),
            mean_mapping_quality=float(n_stats[0][j]),
            median_mapping_quality=float(n_stats[1][j]),
            mean_base_quality=float(n_stats[2][j]),
            median_base_quality=float(n_stats[3][j]),
            median_mismatches_per_read=float(n_stats[4][j]),
        )
        calls.append(
            CalledSomaticAllele(
                sample_name=e["sample_name"],
                reference_contig=tumor_tile.contig,
                start=int(tumor_tile.loci[e["ti"]]),
                allele=e["allele"],
                somatic_log_odds=math.log(e["somatic_odds"]),
                tumor_variant_evidence=tumor_evidence,
                normal_reference_evidence=normal_evidence,
            )
        )
    return calls


def call_variants(
    tumor_reads,
    normal_reads,
    loci_partitions: LociMap,
    odds_threshold: int = 20,
    min_alignment_quality: int = 1,
    filter_multi_allelic: bool = False,
    max_read_depth: int = INT_MAX,
    tile_size: int = 4096,
    max_alleles: int = 8,
    reference_genome=None,
    mesh=None,
    task_sources=None,
    *,
    device: torch.device,
) -> List[CalledSomaticAllele]:
    """tumor_reads/normal_reads: MappedRead lists or ReadSources (may be
    None when task_sources is given).

    mesh: a parallel.mesh.LociMesh — when given, the tumor likelihood
    screen runs in groups of mesh.size tiles, each tumor tile on its own
    shard (device and CUDA stream); the exact f64 confirm is unchanged, so
    output is identical (pinned by tests/test_torch_mesh.py).
    task_sources: an iterator of (task_loci, tumor_source, normal_source)
    — the streaming per-task .bai-pushdown input; when given, each task's
    tiles pack from its own pair of sources."""
    from guacamole_tpu_torch.callers.source import ReadSource

    calls: List[CalledSomaticAllele] = []

    if task_sources is None:
        whole_tumor = (
            tumor_reads
            if isinstance(tumor_reads, ReadSource)
            else ReadSource.from_reads(tumor_reads)
        )
        whole_normal = (
            normal_reads
            if isinstance(normal_reads, ReadSource)
            else ReadSource.from_reads(normal_reads)
        )
        inverse = loci_partitions.inverse_map()

        def task_iter():
            for task in sorted(inverse):
                yield inverse[task], whole_tumor, whole_normal

    else:
        task_iter = lambda: iter(task_sources)  # noqa: E731

    from guacamole_tpu_torch.ops.dispatch import (
        PendingCandidates,
        candidates_of,
        pipelined,
        screen_on_host,
        screen_tile_launch,
        tumor_screen_launch,
    )

    # Host screen (the CPU, or GUAC_HOST_SCREEN=1): the native packer
    # evaluates the tumor likelihood screen (alignment-included) inline
    # during the CSR single pass — no dense [L, D] tumor tiles, no device
    # kernels. On a GPU (or with a mesh) the device screen path is used.
    host_screen = mesh is None and screen_on_host(device)
    screen_fields = "screen" if host_screen else "likelihood_mapq"

    def tiles():
        for task_loci, tumor, normal in task_iter():
            for contig in task_loci.contigs:
                for tile in tumor.iter_tiles(
                    contig,
                    task_loci.on_contig(contig),
                    # mesh mode screens one whole tile per shard — keep
                    # classic tiles there; otherwise auto.
                    tile_size=(
                        tile_size if mesh is None else (tile_size or 4096)
                    ),
                    max_alleles=max_alleles,
                    reference_genome=reference_genome,
                    fields=screen_fields,
                    min_mapq=min_alignment_quality,
                    ll_screen_margin=0.5 if host_screen else 0.0,
                    ll_screen_kind=2,
                    skip_nibbles=host_screen,
                ):
                    trace.count("pack.tiles")
                    trace.count("pack.rows", tile.L)
                    yield contig, tile, tumor, normal

    def launch(item):
        tile = item[1]
        if not tile.L:
            return None
        if getattr(tile, "ll_candidates", None) is not None:
            return PendingCandidates(np.asarray(tile.ll_candidates))
        if getattr(tile, "ll_mapq", None) is not None:
            # Tumor argmax-genotype screen (alignment-included f32
            # likelihoods with a safety margin): a superset of loci the
            # exact somatic kernel can emit, since its other gates (odds,
            # depth bounds, normal evidence) only remove emissions.
            return tumor_screen_launch(
                tile, min_mapq=min_alignment_quality, device=device
            )
        # Fallback (Python-packed full tiles / the dense switch): counting
        # screen.
        return screen_tile_launch(
            tile.allele_id, tile.qual, tile.mapq, tile.strand,
            np.asarray(tile.valid)
            & (np.asarray(tile.mapq) >= min_alignment_quality),
            tile.is_variant, tile.K, device=device,
        )

    def confirm(contig, tile, candidates, tumor_tile, normal_tile,
                tumor, normal):
        tumor_row = {
            int(tumor_tile.loci[i]): i for i in range(tumor_tile.L)
        }
        normal_row = {
            int(normal_tile.loci[i]): i for i in range(normal_tile.L)
        }
        batch_t: List[int] = []
        batch_n: List[int] = []
        for li in candidates:
            if tile.depth[li] == 0:
                continue
            locus = int(tile.loci[li])
            ti = tumor_row[locus]
            ni = normal_row[locus]
            if not (tumor_tile.overflow[ti] or normal_tile.overflow[ni]):
                if not tumor_tile.valid[ti].any():
                    continue
                batch_t.append(ti)
                batch_n.append(ni)
                continue
            tumor_pileup = (
                tumor.pileup_at(
                    contig, locus, reference_base=int(tumor_tile.ref_base[ti])
                )
                if tumor_tile.overflow[ti]
                else tumor.pileup_from_tile_row(tumor_tile, ti)
            )
            normal_pileup = (
                normal.pileup_at(
                    contig,
                    locus,
                    reference_base=int(normal_tile.ref_base[ni]),
                )
                if normal_tile.overflow[ni]
                else normal.pileup_from_tile_row(normal_tile, ni)
            )
            calls.extend(
                find_potential_variant_at_locus(
                    tumor_pileup,
                    normal_pileup,
                    odds_threshold,
                    min_alignment_quality,
                    filter_multi_allelic,
                    max_read_depth,
                )
            )
        with trace.span("confirm"):
            calls.extend(
                somatic_calls_from_row_pairs(
                    tumor_tile,
                    batch_t,
                    normal_tile,
                    batch_n,
                    tumor,
                    odds_threshold,
                    min_alignment_quality,
                    filter_multi_allelic,
                    max_read_depth,
                )
            )

    # Device screen over the tumor sample; exact host kernel at survivors.
    # Three-way overlap: screen tiles pack on a prefetch thread, the two
    # sparse confirm tiles pack concurrently on executor threads (the
    # native packer releases the GIL), and the main thread runs the
    # previous tile's exact confirm meanwhile (a second pipelined() stage,
    # one tile's pack pair in flight).
    from concurrent.futures import ThreadPoolExecutor

    from guacamole_tpu_torch.ops.dispatch import prefetch_iter

    def screened():
        if mesh is not None:
            from guacamole_tpu_torch.parallel.mesh import mesh_ll_screens

            screen_iter = mesh_ll_screens(
                prefetch_iter(tiles(), ahead=2),
                tile_of=lambda item: item[1],
                mesh=mesh,
                include_alignment=True,
                min_mapq=min_alignment_quality,
            )
        else:
            # Per-tile async launches: each packed tile's screen launches
            # at once and overlaps the packing of the next.
            screen_iter = pipelined(
                prefetch_iter(tiles(), ahead=2), launch,
                span="dispatch.launch",
            )
        for (contig, tile, tumor, normal), pending in screen_iter:
            if pending is None:
                continue
            cand = candidates_of(pending.result())
            rows = np.flatnonzero(
                (cand | np.asarray(tile.overflow))
                & (np.asarray(tile.depth)[: tile.L] > 0)
            )
            if not len(rows):
                continue
            # Group candidates by the tumor depth bucket and bound
            # rows x depth per confirm pair — one sparse tile pair over
            # all of a megatile's candidates would pad every row to the
            # deepest candidate's bucket (see germline_standard).
            depths = np.asarray(tile.depth)[rows]
            from guacamole_tpu_torch.pack.columnar import _depth_bucket

            buckets = _depth_bucket(depths)
            for b in np.unique(buckets):
                group = rows[buckets == b]
                max_rows = max(1024, (32 << 20) // int(b))
                for i in range(0, len(group), max_rows):
                    chunk = group[i : i + max_rows]
                    loci_chunk = [int(tile.loci[li]) for li in chunk]
                    yield contig, tile, chunk, loci_chunk, tumor, normal

    with ThreadPoolExecutor(max_workers=2) as executor:

        def launch_packs(item):
            contig, _, _, candidate_loci, tumor, normal = item
            return tuple(
                executor.submit(
                    src.pack_sparse_tile,
                    contig,
                    candidate_loci,
                    max_alleles=max_alleles,
                    reference_genome=reference_genome,
                )
                for src in (tumor, normal)
            )

        for (contig, tile, candidates, _, tumor, normal), (tf, nf) in pipelined(
            screened(), launch_packs, max_in_flight=1
        ):
            confirm(
                contig, tile, candidates, tf.result(), nf.result(),
                tumor, normal,
            )
    with trace.span("sort"):
        calls.sort(key=lambda c: (c.reference_contig, c.start, c.allele))
    return calls


def call_variants_streaming(
    tumor_path: str,
    normal_path: str,
    filters,
    loci_partitions: LociMap,
    **kwargs,
) -> Optional[List[CalledSomaticAllele]]:
    """Streaming variant of call_variants: both samples decode per task
    via .bai pushdown (two zipped task streams over the SAME loci
    partitioning, the analog of the two-RDD co-partitioned shuffle at
    DistributedUtil.scala:316-335 — here no shuffle, just two index
    reads per task). Identical output to load-then-call. Returns None
    when streaming is unavailable for either input."""
    from guacamole_tpu_torch.callers.streaming import iter_task_sources

    tumor_tasks = iter_task_sources(tumor_path, filters, loci_partitions)
    if tumor_tasks is None:
        return None
    normal_tasks = iter_task_sources(normal_path, filters, loci_partitions)
    if normal_tasks is None:
        return None

    def task_sources():
        for (t_task, t_loci, t_src), (n_task, _n_loci, n_src) in zip(
            tumor_tasks, normal_tasks
        ):
            assert t_task == n_task
            yield t_loci, t_src, n_src

    return call_variants(
        None, None, loci_partitions, task_sources=task_sources(), **kwargs
    )


def annotate_dbsnp(
    calls: Sequence[CalledSomaticAllele], dbsnp_vcf_path: str
) -> List[CalledSomaticAllele]:
    """Annotate calls with dbSNP rsIDs by (contig, start, ref, alt) join
    (cf. SomaticStandardCaller.scala:139-149)."""
    from guacamole_tpu_torch.gio.vcf import read_vcf

    index: Dict[Tuple[str, int, str, str], str] = {}
    for variant in read_vcf(dbsnp_vcf_path):
        for alt in variant.alts:
            if variant.id_:
                index[(variant.contig, variant.start, variant.ref, alt)] = (
                    variant.id_
                )
    out = []
    for call in calls:
        key = (
            call.reference_contig,
            call.start,
            Bases.bases_to_string(call.allele.ref_bases),
            Bases.bases_to_string(call.allele.alt_bases),
        )
        rs_id = index.get(key)
        if rs_id is not None:
            digits = "".join(c for c in rs_id if c.isdigit())
            out.append(call.with_rs_id(int(digits) if digits else None))
        else:
            out.append(call)
    return out


def called_somatic_allele_to_vcf_record(call: CalledSomaticAllele) -> VcfRecord:
    """(cf. AlleleConversions.calledSomaticAlleleToADAMGenotype, :47-62)"""
    ev = call.tumor_variant_evidence
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
        genotype_quality=call.phred_scaled_somatic_likelihood,
        id_="." if call.rs_id is None else f"rs{call.rs_id}",
    )


def _try_streaming(args, loci_builder, reference, mesh, filters, _add_fns,
                   device):
    """Streaming somatic-standard (per-task .bai pushdown on BOTH
    samples). Returns (potential_calls, contig_lengths) or (None, None)
    when unavailable. The depth-balanced streaming partitioning weighs
    only the tumor's index byte-density (the partition choice never
    affects calls, only load balance)."""
    try:
        from guacamole_tpu_torch.gio.bam import BamFile

        dictionary = dict(BamFile(args.normal_reads).references)
        dict(BamFile(args.tumor_reads).references)  # both must be BAM
    except Exception:
        return None, None
    loci_set = loci_builder.result(dictionary)
    partitions = _add_fns["streaming_partitions"](
        args, loci_set, args.tumor_reads
    )
    if partitions is None:
        return None, None
    potential = call_variants_streaming(
        args.tumor_reads,
        args.normal_reads,
        filters,
        partitions,
        odds_threshold=args.odds_threshold,
        min_alignment_quality=args.min_alignment_quality,
        filter_multi_allelic=args.filter_multi_allelic,
        max_read_depth=args.max_tumor_read_depth,
        tile_size=args.tile_size,
        reference_genome=reference,
        mesh=mesh,
        device=device,
    )
    if potential is None:
        return None, None
    return potential, dictionary


def main(argv, _add_fns) -> int:
    import argparse

    from guacamole_tpu_torch.callers.common import (
        load_read_source,
        resolve_loci_builder,
        validate_output_path,
        write_variants,
    )
    from guacamole_tpu_torch.filters.somatic_filters import (
        apply_somatic_filters,
        somatic_minimum_alternate_read_depth,
        somatic_within_read_depth_range,
    )
    from guacamole_tpu_torch.gio.fasta import ReferenceGenome
    from guacamole_tpu_torch.gio.load import load_read_set
    from guacamole_tpu_torch.reads.read import InputFilters
    from guacamole_tpu_torch.utils.progress import progress

    p = argparse.ArgumentParser(
        prog="guacamole-torch somatic-standard",
        description="call somatic variants using independent callers on "
        "tumor and normal",
    )
    _add_fns["base"](p)
    _add_fns["loci"](p)
    _add_fns["tumor_normal"](p)
    _add_fns["output"](p)
    _add_fns["distributed"](p)
    _add_fns["device"](p)
    p.add_argument("--odds", type=int, default=20, dest="odds_threshold")
    p.add_argument("--dbsnp-vcf", default="")
    p.add_argument("--reference-fasta", default=None)
    # pileup filter args
    p.add_argument("--min-mapq", type=int, default=1, dest="min_alignment_quality")
    p.add_argument("--filter-multi-allelic", action="store_true")
    p.add_argument("--min-edge-distance", type=int, default=0)
    # somatic genotype filter args (SomaticGenotypeFilter.scala:245-280)
    p.add_argument("--min-likelihood", type=int, default=0)
    p.add_argument("--min-vaf", type=int, default=0)
    p.add_argument("--min-lod", type=int, default=0)
    p.add_argument("--min-average-mapping-quality", type=int, default=0)
    p.add_argument("--min-average-base-quality", type=int, default=0)
    p.add_argument("--min-tumor-read-depth", type=int, default=0)
    p.add_argument("--min-normal-read-depth", type=int, default=0)
    p.add_argument("--max-tumor-read-depth", type=int, default=INT_MAX)
    p.add_argument("--min-tumor-alternate-read-depth", type=int, default=0)
    p.add_argument("--max-median-mismatches", type=int, default=INT_MAX)
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
        mh, loci_builder, args.tumor_reads, args
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
        overlaps_loci=loci_builder,
        non_duplicate=True,
        passed_vendor_quality_checks=True,
        has_mdtag=True,
    )
    mesh = _add_fns["resolve_mesh"](args)
    potential = None
    normal_lengths = None
    if not empty_shard and _add_fns["streaming_eligible"](args):
        potential, normal_lengths = _try_streaming(
            args, loci_builder, reference, mesh, filters, _add_fns, device
        )
    if potential is None:
        tumor_source, tumor_lengths = load_read_source(
            args.tumor_reads,
            filters,
            contig_lengths_from_dictionary=not args.no_sequence_dictionary,
            reference_genome=reference,
            recompute_mdtags=args.recompute_md_tags,
            use_native=args.bam_reader_api in ("best", "native"),
        )
        normal_source, normal_lengths = load_read_source(
            args.normal_reads,
            filters,
            contig_lengths_from_dictionary=not args.no_sequence_dictionary,
            reference_genome=reference,
            recompute_mdtags=args.recompute_md_tags,
            use_native=args.bam_reader_api in ("best", "native"),
        )
        progress(
            "Loaded %d tumor, %d normal reads."
            % (tumor_source.n, normal_source.n)
        )
        if mh.active:
            totals = _add_fns["multihost_counters"](
                mh, tumor=tumor_source.n, normal=normal_source.n
            )
            progress(
                "Global: %d tumor, %d normal reads across %d processes."
                % (totals["tumor"], totals["normal"], mh.process_count)
            )
        loci_set = loci_builder.result(normal_lengths)
        partitions = _add_fns["partition"](
            args, loci_set, tumor_source, normal_source
        )
        potential = call_variants(
            tumor_source,
            normal_source,
            partitions,
            odds_threshold=args.odds_threshold,
            min_alignment_quality=args.min_alignment_quality,
            filter_multi_allelic=args.filter_multi_allelic,
            max_read_depth=args.max_tumor_read_depth,
            tile_size=args.tile_size,
            reference_genome=reference,
            mesh=mesh,
            device=device,
        )
    progress("Computed %d potential genotypes." % len(potential))
    # Pre-filters applied before dbSNP annotation (program order parity).
    potential = [
        g
        for g in potential
        if somatic_within_read_depth_range(
            g,
            args.min_tumor_read_depth,
            args.max_tumor_read_depth,
            args.min_normal_read_depth,
        )
    ]
    if args.min_tumor_alternate_read_depth > 0:
        potential = [
            g
            for g in potential
            if somatic_minimum_alternate_read_depth(
                g, args.min_tumor_alternate_read_depth
            )
        ]
    if args.dbsnp_vcf:
        potential = annotate_dbsnp(potential, args.dbsnp_vcf)
    filtered = apply_somatic_filters(
        potential,
        min_tumor_read_depth=args.min_tumor_read_depth,
        max_tumor_read_depth=args.max_tumor_read_depth,
        min_normal_read_depth=args.min_normal_read_depth,
        min_tumor_alternate_read_depth=args.min_tumor_alternate_read_depth,
        min_log_odds=args.min_lod,
        min_likelihood=args.min_likelihood,
        min_vaf=args.min_vaf,
        min_average_mapping_quality=args.min_average_mapping_quality,
        min_average_base_quality=args.min_average_base_quality,
        maximum_median_mismatches=args.max_median_mismatches,
        debug=args.debug_genotype_filters,
    )
    progress("Computed %d genotypes after basic filtering." % len(filtered))
    with trace.span("write"):
        records = _add_fns["multihost_finalize"](
            mh, [called_somatic_allele_to_vcf_record(c) for c in filtered],
            args,
        )
        if mh.is_writer:
            write_variants(
                records,
                args.out,
                contig_lengths=normal_lengths,
                max_genotypes=args.max_genotypes,
                vcf_header_compat=getattr(args, "vcf_header_compat", ""),
            )
            _add_fns["clear_shards_after_write"](mh, args)
    return 0
