"""Entry points of the port's forward step and multi-device dry run.

entry(): the single-device forward step of the JAX package's
__graft_entry__.entry(): allele counts, candidate flags and the diploid
genotype log-likelihoods of one dense tile, here in one pass of the fused
dense kernel (ops/kernels.py::tile_stats_ll: the stats_ll CUDA kernel on
the card, its plain version on the CPU).

dryrun_multichip(n): the counterpart of __graft_entry__.dryrun_multichip:
one sharded calling step over an n-shard mesh, and the six callers over
the mesh against their sequential runs where the reference's test inputs
are at hand.

Both run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np

FORWARD_ALLELES = 8


def _example_tile(L=128, D=32, K=FORWARD_ALLELES, seed=0):
    """The example tile of __graft_entry__._example_tile: the same numpy
    calls on the same seed, so both packages step over equal arrays."""
    rng = np.random.RandomState(seed)
    depth = rng.randint(1, D, size=L)
    valid = np.arange(D)[None, :] < depth[:, None]
    allele_id = np.where(
        valid, rng.randint(0, 3, size=(L, D)).astype(np.int16), -1
    ).astype(np.int16)
    qual = np.where(valid, rng.randint(5, 40, size=(L, D)), 0).astype(np.int16)
    mapq = np.where(valid, rng.randint(10, 60, size=(L, D)), 0).astype(np.int16)
    strand = valid & (rng.rand(L, D) < 0.5)
    is_variant = np.zeros((L, K), dtype=bool)
    is_variant[:, 1:3] = True
    return allele_id, qual, mapq, strand, valid, is_variant


def entry(device=None):
    """Returns (forward, example_args). forward takes the six planes of a
    dense tile (numpy arrays, staged through dense_wire_from_numpy, or
    tensors already on the device) and returns (counts [L, K] int32,
    candidates [L] bool, log_likelihoods [L, P] f32) as tensors on the
    device. device: None or "cuda" for the card (fails without one), "cpu"
    on request."""
    import torch

    from guacamole_tpu_torch.ops.dispatch import dense_wire_from_numpy
    from guacamole_tpu_torch.ops.kernels import tile_stats_ll
    from guacamole_tpu_torch.platform import device as resolve_device

    dev = resolve_device(device)

    def forward(allele_id, qual, mapq, strand, valid, is_variant):
        planes = (allele_id, qual, mapq, strand, valid, is_variant)
        if not all(isinstance(p, torch.Tensor) for p in planes):
            planes = dense_wire_from_numpy(*planes, device=dev)[:6]
        out = tile_stats_ll(
            *planes, FORWARD_ALLELES, include_alignment=False,
            threshold_percent=None,
        )
        return out.counts, out.candidates, out.log_likelihoods

    return forward, _example_tile()


def dryrun_multichip(n_devices: int, device=None, resources=None) -> str:
    """Run ONE full sharded calling step (counts + likelihoods + summed
    global counters) over an n-shard mesh on the example tiles of
    __graft_entry__ (the same seeds), and check its shapes and its element
    total. On the card the shards take the CUDA devices in turn, so a
    one-card machine repeats cuda:0 (each shard on its own stream);
    device="cpu" runs every shard on the CPU.

    Then, like the original, when the reference's test inputs are at hand
    (`resources`: the directory that holds chrM.sorted.bam), it runs the
    six callers over the mesh against their sequential runs; otherwise its
    line says they were skipped. Prints and returns one line."""
    import os

    import torch

    from guacamole_tpu_torch.parallel.mesh import (
        ShardedBatch,
        loci_mesh,
        make_sharded_call_step,
    )
    from guacamole_tpu_torch.platform import device as resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    mesh = loci_mesh(devices)

    K = FORWARD_ALLELES
    tiles = [_example_tile(L=64, D=16, K=K, seed=i) for i in range(n_devices)]
    batch = ShardedBatch(
        *(torch.from_numpy(np.stack([t[f] for t in tiles])) for f in range(6))
    )
    out = make_sharded_call_step(mesh, max_alleles=K)(batch)
    if out.counts.shape != (n_devices, 64, K):
        raise RuntimeError(f"counts shape {tuple(out.counts.shape)}")
    if out.log_likelihoods.shape[0] != n_devices:
        raise RuntimeError(
            f"likelihoods shape {tuple(out.log_likelihoods.shape)}"
        )
    if int(out.total_elements) != int(out.depth.sum()):
        raise RuntimeError(
            f"total_elements {int(out.total_elements)} != depth sum "
            f"{int(out.depth.sum())}"
        )

    if resources and os.path.exists(os.path.join(resources, "chrM.sorted.bam")):
        caller_note = _mesh_callers_note(mesh, devices[0], resources)
    else:
        caller_note = " (chrM fixture unavailable; callers skipped)"
    line = (
        f"dryrun_multichip({n_devices}): OK — "
        f"{int(out.total_elements)} elements, "
        f"{int(out.total_candidates)} candidate loci over "
        f"{[str(d) for d in mesh.devices]}{caller_note}"
    )
    print(line)
    return line


def _mesh_callers_note(mesh, device, res: str) -> str:
    """The six callers over the mesh against their sequential runs on the
    reference's test inputs in `res` (the caller section of
    __graft_entry__.dryrun_multichip); raises on any difference."""
    import os

    from guacamole_tpu_torch.callers.distributed import (
        call_somatic_mesh,
        call_standard_mesh,
        call_variants_mesh,
    )
    from guacamole_tpu_torch.callers.germline_standard import (
        call_variants as call_standard,
    )
    from guacamole_tpu_torch.callers.germline_threshold import call_variants
    from guacamole_tpu_torch.callers.somatic_standard import (
        call_variants as call_somatic,
    )
    from guacamole_tpu_torch.callers.structural_variant import (
        call_structural_variants,
        get_exceptional_reads,
    )
    from guacamole_tpu_torch.callers.vaf_histogram import (
        variant_loci_from_reads,
    )
    from guacamole_tpu_torch.callers.variant_support import (
        loci_from_variants,
        pileup_allele_counts,
    )
    from guacamole_tpu_torch.gio.load import load_read_set
    from guacamole_tpu_torch.loci.lociset import parse_loci
    from guacamole_tpu_torch.loci.partition import partition_loci_uniformly
    from guacamole_tpu_torch.reads.read import InputFilters, PairedMappedRead

    def same(what, a, b):
        if a != b or not a:
            raise RuntimeError(f"{what}: mesh and sequential runs differ")

    n = mesh.size
    chrm = os.path.join(res, "chrM.sorted.bam")
    filters = InputFilters.create(
        overlaps_loci=parse_loci("chrM:0-4000"),
        non_duplicate=True,
        has_mdtag=True,
    )
    reads = load_read_set(chrm, filters).mapped_reads
    partitions = partition_loci_uniformly(
        n, parse_loci("chrM:0-4000").result()
    )

    mesh_calls = call_variants_mesh(reads, partitions, tile_size=512,
                                    mesh=mesh, device=device)
    seq_calls = call_variants(reads, partitions, tile_size=512, device=device)
    k = lambda cs: sorted(  # noqa: E731
        (c.contig, c.start, c.allele, c.labels) for c in cs
    )
    same("germline-threshold", k(mesh_calls), k(seq_calls))

    mesh_std = call_standard_mesh(
        reads, partitions, min_alignment_quality=1, tile_size=512,
        mesh=mesh, device=device,
    )
    seq_std = call_standard(
        reads, partitions, min_alignment_quality=1, tile_size=512,
        device=device,
    )
    ks = lambda cs: sorted(  # noqa: E731
        (c.reference_contig, c.start, c.allele, c.evidence.likelihood)
        for c in cs
    )
    same("germline-standard", ks(mesh_std), ks(seq_std))

    som_filters = InputFilters.create(
        overlaps_loci=parse_loci("all"),
        non_duplicate=True,
        passed_vendor_quality_checks=True,
        has_mdtag=True,
    )
    tumor = load_read_set(
        os.path.join(res, "tumor.chr20.tough.sam"), som_filters
    ).mapped_reads
    normal = load_read_set(
        os.path.join(res, "normal.chr20.tough.sam"), som_filters
    ).mapped_reads
    starts = [r.start for r in tumor + normal]
    som_parts = partition_loci_uniformly(n, parse_loci(
        "20:%d-%d" % (min(starts), max(r.end for r in tumor + normal))
    ).result())
    mesh_som = call_somatic_mesh(
        tumor, normal, som_parts, odds_threshold=120, tile_size=1024,
        mesh=mesh, device=device,
    )
    seq_som = call_somatic(
        tumor, normal, som_parts, odds_threshold=120, tile_size=1024,
        device=device,
    )
    km = lambda cs: sorted(  # noqa: E731
        (c.reference_contig, c.start, c.allele, c.somatic_log_odds)
        for c in cs
    )
    same("somatic-standard", km(mesh_som), km(seq_som))

    # vaf-histogram's counting screen over the mesh
    # (VAFHistogram.scala:208-255).
    mesh_vaf = variant_loci_from_reads(reads, partitions, mesh=mesh,
                                       device=device)
    seq_vaf = variant_loci_from_reads(reads, partitions, device=device)
    kv = lambda vs: sorted(  # noqa: E731
        (v.contig, v.locus, v.variant_allele_frequency) for v in vs
    )
    same("vaf-histogram", kv(mesh_vaf), kv(seq_vaf))

    # variant-support's allele-count screen over the mesh
    # (VariantSupport.scala:91-118).
    bundle = os.path.join(res, "gatk_mini_bundle_extract.bam")
    vs_loci = loci_from_variants(os.path.join(res, "truth.chr20.vcf"))
    vs_reads = load_read_set(
        bundle, InputFilters.create(mapped=True, has_mdtag=True)
    ).mapped_reads
    mesh_vs = pileup_allele_counts(vs_reads, vs_loci, mesh=mesh,
                                   device=device)
    seq_vs = pileup_allele_counts(vs_reads, vs_loci, device=device)
    same("variant-support", mesh_vs, seq_vs)

    # structural-variant, contig-partitioned the way the multi-process
    # runtime shards it: global insert-size threshold, independent
    # per-contig graphs merged across shards
    # (StructuralVariantCaller.scala:102-264).
    sv_set = load_read_set(bundle, InputFilters.create(non_duplicate=True))
    sv_pairs = [
        pm
        for pm in (
            PairedMappedRead.from_paired_read(pr)
            for pr in sv_set.mapped_paired_reads
            if pr.is_first_in_pair
        )
        if pm is not None
    ]
    global_max_normal = get_exceptional_reads(sv_pairs).max_normal_insert_size
    contigs = sorted({p.read.reference_contig for p in sv_pairs})
    shard_results = {}
    for shard in range(n):
        mine = {c for i, c in enumerate(contigs) if i % n == shard}
        shard_pairs = [p for p in sv_pairs if p.read.reference_contig in mine]
        if not shard_pairs:
            continue
        _, part = call_structural_variants(
            shard_pairs, max_normal_insert_size=global_max_normal
        )
        shard_results.update(part)
    _, seq_sv = call_structural_variants(
        sv_pairs, max_normal_insert_size=global_max_normal
    )
    if shard_results != seq_sv:
        raise RuntimeError("structural-variant: shards and whole differ")
    return (
        f"; six callers mesh==sequential: threshold {len(mesh_calls)} + "
        f"standard {len(mesh_std)} + somatic {len(mesh_som)} calls, "
        f"vaf {len(mesh_vaf)} loci, variant-support {len(mesh_vs)} "
        f"rows, sv {sum(len(v) for v in seq_sv.values())} ranges over "
        f"{len(contigs)} contig shard(s)"
    )
