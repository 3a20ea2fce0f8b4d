"""vaf-histogram tool on the port's dispatch: per-sample
variant-allele-frequency distributions.

Port of guacamole_tpu/callers/vaf_histogram.py (cf. reference
.../commands/VAFHistogram.scala:42-283). VAFs come from the full-count
form of the counting screen (csr_count_screen on a GPU: no threshold, no
compaction); the optional Gaussian mixture clustering runs as a
vectorized EM in torch on the chosen device (replacing Spark MLlib's
GaussianMixture). The screens run on one device or over a mesh; across
processes each takes a loci shard and process 0 writes the merged
histogram.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from guacamole_tpu_torch.loci.locimap import LociMap
from guacamole_tpu_torch.ops.dispatch import ScreenPlan
from guacamole_tpu_torch.pack.tiles import ref_match_allele_ids
from guacamole_tpu_torch.utils.progress import progress


@dataclass(frozen=True)
class VariantLocus:
    contig: str
    locus: int
    variant_allele_frequency: float


def variant_loci_from_reads(
    reads,
    loci_partitions: LociMap,
    min_read_depth: int = 0,
    min_variant_allele_frequency: int = 0,
    print_stats: bool = False,
    sample_percent: int = 100,
    tile_size: int = 0,
    mesh=None,
    *,
    device: torch.device,
) -> List[VariantLocus]:
    """All loci with non-reference evidence and their VAFs
    (VAFHistogram.scala:208-255). referenceDepth counts Match elements:
    elements whose allele equals (ref_base, ref_base).

    reads: a list of MappedReads or a ReadSource. Every tile takes the
    full-count screen on `device`.
    mesh: a parallel.mesh.LociMesh — when given, the counting screens run
    in groups of mesh.size tiles, one tile per shard (identical counts)."""
    from guacamole_tpu_torch.callers.source import ReadSource

    source = (
        reads if isinstance(reads, ReadSource) else ReadSource.from_reads(reads)
    )
    inverse = loci_partitions.inverse_map()

    def task_iter():
        for task in sorted(inverse):
            yield inverse[task], source

    return _variant_loci_over_tasks(
        task_iter(),
        min_read_depth=min_read_depth,
        min_variant_allele_frequency=min_variant_allele_frequency,
        print_stats=print_stats,
        sample_percent=sample_percent,
        tile_size=tile_size,
        mesh=mesh,
        device=device,
    )


def variant_loci_streaming(
    path: str,
    loci_partitions: LociMap,
    **kwargs,
) -> Optional[List[VariantLocus]]:
    """Streaming variant_loci_from_reads: each partition task decodes
    only its own BAM byte ranges (.bai pushdown) on a background thread
    while the previous task packs/screens — the same pipeline the main
    callers use. Identical output to load-then-scan (same task order,
    same tiles). None when streaming is unavailable. Reads are NOT
    filtered, matching the reference's (dead) filter variable
    (VAFHistogram.scala:91-103)."""
    from guacamole_tpu_torch.callers.streaming import iter_task_sources
    from guacamole_tpu_torch.reads.read import InputFilters

    task_sources = iter_task_sources(
        path, InputFilters.empty, loci_partitions
    )
    if task_sources is None:
        return None
    return _variant_loci_over_tasks(
        ((task_loci, src) for _task, task_loci, src in task_sources),
        **kwargs,
    )


def _variant_loci_over_tasks(
    task_iter,
    min_read_depth: int = 0,
    min_variant_allele_frequency: int = 0,
    print_stats: bool = False,
    sample_percent: int = 100,
    tile_size: int = 0,
    mesh=None,
    *,
    device: torch.device,
) -> List[VariantLocus]:
    """Shared screen + VAF-emit loop over (task_loci, source) tasks."""
    from guacamole_tpu_torch.ops.dispatch import prefetch_iter

    plan = ScreenPlan("counts", device=device, mesh=mesh)
    out: List[VariantLocus] = []
    first_sample: List[str] = []

    def tiles():
        for task_loci, source in task_iter:
            if not first_sample:
                names = source.sample_names()
                first_sample.append(names[0] if names else "default")
            for contig in task_loci.contigs:
                for tile in source.iter_tiles(
                    contig, task_loci.on_contig(contig),
                    **plan.pack_args(tile_size),
                ):
                    yield contig, tile, source

    # The mesh's screens pack on this thread.
    screen_iter = plan.screens(
        tiles() if mesh is not None else prefetch_iter(tiles(), ahead=2),
        tile_of=lambda item: item[1],
    )
    min_vaf = min_variant_allele_frequency / 100.0
    for (contig, tile, source), pending in screen_iter:
        stats = pending.result() if pending is not None else None
        if stats is None:
            continue
        counts = np.asarray(stats.counts)
        depth = np.asarray(tile.depth, dtype=np.int64).copy()
        overflow = np.asarray(tile.overflow, dtype=bool)
        # ref depth per locus = count of the (ref_base, ref_base) allele,
        # gathered in one shot (no per-locus Python walk).
        ref_id = ref_match_allele_ids(tile)
        in_dict = (ref_id >= 0) & (ref_id < tile.K)
        ref_depth = np.where(
            in_dict,
            counts[np.arange(tile.L), np.clip(ref_id, 0, tile.K - 1)],
            0,
        ).astype(np.int64)
        # Overflow loci (>K distinct alleles): exact host fallback — rare.
        for li in np.flatnonzero(overflow & (depth > 0)):
            pileup = source.pileup_at(contig, int(tile.loci[li]))
            depth[li] = pileup.depth
            ref_depth[li] = pileup.reference_depth
        emit = (depth > 0) & (ref_depth != depth) & (depth >= min_read_depth)
        vaf = np.where(depth > 0, (depth - ref_depth) / np.maximum(depth, 1), 0.0)
        emit &= vaf >= min_vaf
        loci_emit = tile.loci[emit]
        vaf_emit = vaf[emit]
        out.extend(
            VariantLocus(contig, int(l), float(v))
            for l, v in zip(loci_emit, vaf_emit)
        )
    if print_stats and out:
        print_vaf_stats(
            first_sample[0] if first_sample else "default",
            out,
            sample_percent,
        )
    return out


def print_vaf_stats(
    sample_name: str,
    variant_loci: Sequence[VariantLocus],
    sample_percent: int = 100,
) -> None:
    """Descriptive VAF stats in the reference's format
    (VAFHistogram.scala:138-152); callable post-merge in multi-host runs
    so the stats cover the GLOBAL variant-locus set."""
    vafs = np.array([v.variant_allele_frequency for v in variant_loci])
    if sample_percent < 100:
        rng = np.random.RandomState(0)
        vafs = rng.choice(
            vafs, size=max(1, len(vafs) * sample_percent // 100), replace=False
        )
    progress(
        "Variant loci stats for %s (min: %f, max: %f, median: %f, mean: %f, "
        "25Pct: %f, 75Pct: %f)"
        % (
            sample_name,
            vafs.min(),
            vafs.max(),
            float(np.percentile(vafs, 50)),
            vafs.mean(),
            float(np.percentile(vafs, 25)),
            float(np.percentile(vafs, 75)),
        )
    )


def generate_vaf_histogram(
    variant_loci: Sequence[VariantLocus], bins: int
) -> Dict[int, int]:
    """Bin VAFs with the reference's integer rounding
    (VAFHistogram.scala:188-196)."""
    assert 1 <= bins <= 100, "Bins should be between 1 and 100"
    histogram: Dict[int, int] = {}
    for v in variant_loci:
        percent = int(v.variant_allele_frequency * 100)
        binned = percent - (percent % (100 // bins))
        histogram[binned] = histogram.get(binned, 0) + 1
    return histogram


def build_mixture_model(
    variant_loci: Sequence[VariantLocus],
    num_clusters: int,
    max_iterations: int = 50,
    convergence_tol: float = 1e-2,
    seed: int = 0,
    *,
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """1-D Gaussian mixture EM over VAFs, vectorized in torch f32 on
    `device` (the MLlib GaussianMixture analog, VAFHistogram.scala:265-281).

    Initialization pins MLlib 1.3's scheme deterministically
    (mllib.clustering.GaussianMixture.run): MLlib draws ``k * 5`` points
    with replacement via ``takeSample(..., Random.nextLong())`` and
    initializes cluster ``i``'s mean/covariance from the sample mean and
    *biased* sample covariance of its 5-point slice, with uniform
    weights ``1/k``. The reference never sets a seed, so its own output
    is nondeterministic run-to-run (DEVIATIONS #12); here the same
    sampling runs under a fixed ``seed`` so results are reproducible.
    Convergence matches MLlib: stop when the summed log-likelihood moves
    by less than ``convergence_tol`` (VAFHistogram.scala:268 defaults
    maxIterations=50, convergenceTol=1e-2).

    Returns (weights, means, variances).
    """
    xs = np.asarray(
        [v.variant_allele_frequency for v in variant_loci], dtype=np.float32
    )
    n = xs.shape[0]
    k = num_clusters
    n_samples = 5  # MLlib's nSamples
    rng = np.random.RandomState(seed)
    draws = xs[rng.randint(0, n, size=k * n_samples)].reshape(k, n_samples)
    x = torch.from_numpy(xs).to(device)
    means = torch.from_numpy(draws.mean(axis=1).astype(np.float32)).to(device)
    # Biased covariance over the 5-point slice, as breeze's init does;
    # floored so a degenerate slice (all-equal draws) stays PD.
    variances = torch.from_numpy(
        np.maximum(draws.var(axis=1), 1e-6).astype(np.float32)
    ).to(device)
    weights = torch.full((k,), 1.0 / k, dtype=torch.float32, device=device)

    last_ll = -np.inf
    for _ in range(max_iterations):
        weights, means, variances, ll = _em_step(x, weights, means, variances)
        ll = float(ll)
        if abs(ll - last_ll) < convergence_tol:
            break
        last_ll = ll
    weights, means, variances = (
        t.cpu().numpy() for t in (weights, means, variances)
    )
    for i in range(k):
        print(
            f"Cluster {i}: mean={means[i]}, std. deviation={np.sqrt(variances[i])}, "
            f"weight={weights[i]}"
        )
    return weights, means, variances


def _em_step(x, weights, means, variances):
    """One EM step of build_mixture_model over x [n], in f32: returns the
    new weights, means and variances [k] and the summed log-likelihood."""
    n = x.shape[0]
    # E step: responsibilities [n, k]
    diff = x[:, None] - means[None, :]
    log_pdf = (
        -0.5 * diff * diff / variances[None, :]
        - 0.5 * torch.log(2 * np.pi * variances[None, :])
    )
    log_w = torch.log(weights)[None, :] + log_pdf
    log_norm = torch.logsumexp(log_w, dim=1, keepdim=True)
    resp = torch.exp(log_w - log_norm)
    # M step
    nk = resp.sum(dim=0) + 1e-10
    new_weights = nk / n
    new_means = (resp * x[:, None]).sum(dim=0) / nk
    centered = x[:, None] - new_means[None, :]
    new_vars = (resp * centered * centered).sum(dim=0) / nk + 1e-8
    log_likelihood = log_norm.sum()
    return new_weights, new_means, new_vars, log_likelihood


def main(argv, _add_fns) -> int:
    import argparse

    from guacamole_tpu_torch.callers.common import (
        load_read_source,
        resolve_loci_builder,
    )
    from guacamole_tpu_torch.loci.partition import partition_loci_from_args
    from guacamole_tpu_torch.reads.read import InputFilters

    p = argparse.ArgumentParser(
        prog="guacamole-torch vaf-histogram",
        description="Compute and cluster the variant allele frequencies",
    )
    _add_fns["base"](p)
    _add_fns["loci"](p)
    _add_fns["distributed"](p)
    _add_fns["read_config"](p)
    _add_fns["device"](p)
    p.add_argument("--out", default="", help="File path for the histogram")
    p.add_argument("--local-out", default="", dest="local_out")
    p.add_argument("--bins", type=int, default=20)
    p.add_argument("--cluster", action="store_true")
    p.add_argument("--num-clusters", type=int, default=3)
    p.add_argument("--min-read-depth", type=int, default=0)
    p.add_argument("--min-vaf", type=int, default=0)
    p.add_argument("--print-stats", action="store_true")
    p.add_argument("--sample-percent", type=int, default=25)
    p.add_argument("bams", nargs="+")
    args = p.parse_args(argv)
    device = _add_fns["resolve_device"](args)

    loci_builder = resolve_loci_builder(args.loci, args.loci_from_file)
    mh = _add_fns["bootstrap_multihost"](args)
    # Bug-for-bug parity: the reference builds these filters and then
    # loads every ReadSet with InputFilters.empty anyway — the filters
    # variable is dead code there (VAFHistogram.scala:91-103). Reads are
    # therefore NOT filtered here either (single-process; a multi-process
    # shard must restrict loading to its own loci or sharding is moot).
    load_filters = InputFilters.empty
    if mh.active:
        loci_builder, empty_shard = _add_fns["multihost_shard_builder"](
            mh, loci_builder, args.bams[0], args
        )
        if empty_shard:
            from guacamole_tpu_torch.loci.lociset import parse_loci

            loci_builder = parse_loci("")
        load_filters = InputFilters.create(overlaps_loci=loci_builder)
    mesh = _add_fns["resolve_mesh"](args)
    vl_kwargs = dict(
        min_read_depth=args.min_read_depth,
        min_variant_allele_frequency=args.min_vaf,
        print_stats=args.print_stats and not mh.active,
        sample_percent=args.sample_percent,
        tile_size=args.tile_size,
        mesh=mesh,
        device=device,
    )
    # Streaming path: partition once from the first BAM's index (the
    # reference also partitions once from the first ReadSet,
    # VAFHistogram.scala:112-116), then each task decodes only its own
    # byte ranges with the next task's IO on a background thread — the
    # same pipeline the main callers use.
    all_variant_loci = None
    sample_names: List[str] = []
    if _add_fns["streaming_eligible"](args) and all(
        b.lower().endswith(".bam") for b in args.bams
    ):
        from guacamole_tpu_torch.gio.load import header_contig_lengths

        try:
            lengths = header_contig_lengths(args.bams[0])
            loci_set = loci_builder.result(lengths)
            partitions = _add_fns["streaming_partitions"](
                args, loci_set, args.bams[0]
            )
        except Exception:
            partitions = None
        if partitions is not None:
            from guacamole_tpu_torch.gio.bam import BamFile

            all_variant_loci = []
            for bam in args.bams:
                res = variant_loci_streaming(bam, partitions, **vl_kwargs)
                if res is None:
                    all_variant_loci = None
                    sample_names = []
                    break
                all_variant_loci.append(res)
                rg = BamFile(bam).header.read_group_samples
                samples = sorted(set(rg.values()))
                sample_names.append(samples[0] if samples else "default")
    if all_variant_loci is None:
        sources = [
            load_read_source(
                bam,
                load_filters,
                recompute_mdtags=args.recompute_md_tags,
                use_native=args.bam_reader_api in ("best", "native"),
            )
            for bam in args.bams
        ]
        loci_set = loci_builder.result(sources[0][1])
        partitions = partition_loci_from_args(
            args.parallelism,
            args.partition_accuracy,
            loci_set,
            sources[0][0],
            default_parallelism=_add_fns["default_parallelism"](),
        )
        all_variant_loci = [
            variant_loci_from_reads(src, partitions, **vl_kwargs)
            for src, _ in sources
        ]
        sample_names = [
            (src.sample_names() or ["default"])[0] for src, _ in sources
        ]
    if mh.active:
        from guacamole_tpu_torch.parallel.multihost import gather_objects

        # Rank-ordered concat per bam: shards are contiguous ascending
        # loci, so the merged per-bam lists equal a single-process run's.
        gathered = gather_objects(mh, [all_variant_loci])
        all_variant_loci = [
            [
                v
                for proc_lists in gathered
                for v in proc_lists[b]
            ]
            for b in range(len(args.bams))
        ]
        if args.print_stats and mh.is_writer:
            for sample, variant_loci in zip(sample_names, all_variant_loci):
                if variant_loci:
                    print_vaf_stats(
                        sample, variant_loci, args.sample_percent
                    )
        if not mh.is_writer:
            return 0
    bin_size = 100 // args.bins
    lines: List[str] = []
    for bam, sample, variant_loci in zip(
        args.bams, sample_names, all_variant_loci
    ):
        histogram = generate_vaf_histogram(variant_loci, args.bins)
        for bin_start in sorted(histogram):
            lines.append(
                f"{bam}, {sample}, {bin_start}, "
                f"{min(bin_start + bin_size, 100)}, {histogram[bin_start]}"
            )
    if args.local_out or args.out:
        path = args.local_out or args.out
        with open(path, "w") as out:
            out.write("Filename, SampleName, BinStart, BinEnd, Size\n")
            out.write("\n".join(lines) + ("\n" if lines else ""))
    else:
        for line in lines:
            print(line)
    if args.cluster:
        for variant_loci in all_variant_loci:
            if variant_loci:
                build_mixture_model(
                    variant_loci, args.num_clusters, device=device
                )
    return 0
