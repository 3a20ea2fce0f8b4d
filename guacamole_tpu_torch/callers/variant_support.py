"""variant-support tool on the port's dispatch: per-BAM allele counts at
known variant sites.

Port of guacamole_tpu/callers/variant_support.py (cf. reference
.../commands/VariantSupport.scala:31-119). Builds a loci set from a VCF's
variant positions, packs sparse tiles at those loci for each BAM, and
reads allele counts off the full-count form of the counting screen
(csr_count_screen on a GPU: no threshold, no compaction), on one device
or over a mesh; across processes each takes a contiguous shard of the
sites and process 0 writes the gathered lines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from guacamole_tpu_torch.gio.vcf import read_vcf
from guacamole_tpu_torch.loci.locimap import LociMapBuilder
from guacamole_tpu_torch.loci.lociset import LociSet
from guacamole_tpu_torch.ops.dispatch import pipelined_screens
from guacamole_tpu_torch.utils import bases as Bases


@dataclass(frozen=True)
class AlleleCount:
    sample: str
    contig: str
    locus: int
    reference: str
    alternate: str
    count: int

    def __str__(self) -> str:
        return (
            f"{self.sample}, {self.contig}, {self.locus}, "
            f"{self.reference}, {self.alternate}, {self.count}"
        )


def loci_from_variants(vcf_path: str) -> LociSet:
    """Union of [start, end) intervals of the VCF's variants
    (VariantSupport.scala:84-89)."""
    maker = LociMapBuilder()
    for variant in read_vcf(vcf_path):
        maker.put(variant.contig, variant.start, variant.end, 0)
    return LociSet(maker.result())


def pileup_allele_counts(
    reads, loci: LociSet, tile_size: int = 4096, mesh=None, *,
    device: torch.device,
) -> List[AlleleCount]:
    """Per-(sample, locus, allele) read counts at the given loci.

    reads: a list of MappedReads or a ReadSource. Every tile takes the
    full-count screen on `device` (no threshold, no compaction).
    mesh: a parallel.mesh.LociMesh — when given, the counting screens run
    in groups of mesh.size tiles, one tile per shard (identical counts)."""
    from guacamole_tpu_torch.callers.source import ReadSource

    source = (
        reads if isinstance(reads, ReadSource) else ReadSource.from_reads(reads)
    )
    out: List[AlleleCount] = []
    names = source.sample_names()
    sample = names[0] if names else "default"

    from guacamole_tpu_torch.ops.dispatch import pack_skip_nibbles

    def tiles():
        for contig in loci.contigs:
            for tile in source.iter_tiles(
                contig, loci.on_contig(contig), tile_size=tile_size,
                fields="screen",
                skip_nibbles=pack_skip_nibbles(device, mesh),
            ):
                yield contig, tile

    if mesh is not None:
        from guacamole_tpu_torch.parallel.mesh import mesh_csr_screens

        screen_iter = mesh_csr_screens(
            tiles(), tile_of=lambda item: item[1], mesh=mesh
        )
    else:
        screen_iter = pipelined_screens(
            tiles(), tile_of=lambda item: item[1], device=device
        )
    for (contig, tile), pending in screen_iter:
        if pending is not None:
            stats = pending.result()
            counts = np.asarray(stats.counts)
            out.extend(
                _tile_allele_counts(source, contig, tile, counts, sample)
            )
    return out


def _tile_allele_counts(
    source, contig: str, tile, counts: np.ndarray, sample: str
) -> List[AlleleCount]:
    """Flatten a tile's (locus, allele) count table into AlleleCount rows
    without a per-locus Python walk: one flat gather builds the
    (locus, rank) -> (allele, count) rows for every emitting locus at once
    (the reference's per-locus flatMap semantics,
    VariantSupport.scala:91-118, kept — just not its loop shape)."""
    from guacamole_tpu_torch.pack.fast import LazyAlleleTables

    depth = np.asarray(tile.depth, dtype=np.int64)
    overflow = np.asarray(tile.overflow, dtype=bool)
    num_alleles = np.asarray(tile.num_alleles, dtype=np.int64)
    rows: List[Tuple[int, AlleleCount]] = []

    fast_mask = (depth > 0) & ~overflow
    tables = tile.alleles
    use_vectorized = fast_mask.any() and isinstance(tables, LazyAlleleTables)
    if use_vectorized:
        # allele at (locus, rank k) = key_alleles[uniq_key[first[locus]+k]]
        key_ref = [
            Bases.bases_to_string(al.ref_bases) for al in tables.key_alleles
        ]
        key_alt = [
            Bases.bases_to_string(al.alt_bases) for al in tables.key_alleles
        ]
        first = np.asarray(tables.first_of_locus, dtype=np.int64)
        uniq_key = np.asarray(tables.uniq_key, dtype=np.int64)
        li_idx = np.flatnonzero(fast_mask)
        reps = num_alleles[li_idx]
        li_rep = np.repeat(li_idx, reps)
        k_rep = np.arange(len(li_rep), dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(reps)[:-1]]), reps
        )
        key_idx = uniq_key[first[li_rep] + k_rep]
        count_flat = counts[li_rep, k_rep]
        loci_flat = tile.loci[li_rep]
        rows.extend(
            (int(l), AlleleCount(
                sample=sample,
                contig=contig,
                locus=int(l),
                reference=key_ref[int(ki)],
                alternate=key_alt[int(ki)],
                count=int(c),
            ))
            for l, ki, c in zip(loci_flat, key_idx, count_flat)
        )
    else:
        # list-backed oracle tiles take the per-locus path
        for li in np.flatnonzero(fast_mask):
            locus = int(tile.loci[li])
            for k in range(int(num_alleles[li])):
                allele = tables[li][k]
                rows.append(
                    (locus, AlleleCount(
                        sample=sample,
                        contig=contig,
                        locus=locus,
                        reference=Bases.bases_to_string(allele.ref_bases),
                        alternate=Bases.bases_to_string(allele.alt_bases),
                        count=int(counts[li, k]),
                    ))
                )
    # overflow loci (>K distinct alleles): exact host fallback — rare
    for li in np.flatnonzero((depth > 0) & overflow):
        locus = int(tile.loci[li])
        pileup = source.pileup_at(contig, locus)
        table: dict = {}
        for e in pileup.elements:
            table[e.allele] = table.get(e.allele, 0) + 1
        for allele, count in sorted(table.items()):
            rows.append(
                (locus, AlleleCount(
                    sample=sample,
                    contig=contig,
                    locus=locus,
                    reference=Bases.bases_to_string(allele.ref_bases),
                    alternate=Bases.bases_to_string(allele.alt_bases),
                    count=count,
                ))
            )
    rows.sort(key=lambda t: t[0])
    return [ac for _locus, ac in rows]


def main(argv, _add_fns) -> int:
    import argparse

    from guacamole_tpu_torch.callers.common import load_read_source
    from guacamole_tpu_torch.reads.read import InputFilters
    from guacamole_tpu_torch.utils.progress import progress

    p = argparse.ArgumentParser(
        prog="guacamole-torch variant-support",
        description="Find number of reads that support each variant across BAMs",
    )
    _add_fns["base"](p)
    # --loci/--loci-from-file come with the distributed arg trait but are
    # unused: sites come from the input VCF (parity with the reference,
    # whose Arguments extend DistributedUtil.Arguments but whose run()
    # builds its LociSet from the variants, VariantSupport.scala:83-89).
    _add_fns["loci"](p)
    _add_fns["distributed"](p)
    _add_fns["read_config"](p)
    _add_fns["device"](p)
    p.add_argument("--input-variant", "-v", required=True, dest="variants")
    p.add_argument("--output", "-o", required=True)
    p.add_argument("bams", nargs="+")
    args = p.parse_args(argv)
    device = _add_fns["resolve_device"](args)

    mh = _add_fns["bootstrap_multihost"](args)
    loci = loci_from_variants(args.variants)
    progress(f"Variant sites cover {loci.count} loci.")
    lines: List[str]
    load_filters = InputFilters.empty
    if mh.active:
        # Each process takes a contiguous shard of the variant sites and
        # loads only reads overlapping it (.bai pushdown via the loci
        # filter); the gathered lines reproduce the single-process order.
        from guacamole_tpu_torch.loci.lociset import parse_loci
        from guacamole_tpu_torch.parallel.multihost import (
            shard_loci_expression,
        )

        expr = shard_loci_expression(mh, loci)
        maker = parse_loci(expr or "")
        loci = maker.result()
        if expr:
            load_filters = InputFilters.create(overlaps_loci=maker)
    mesh = _add_fns["resolve_mesh"](args)
    per_bam: List[List[str]] = []
    for bam in args.bams:
        # contigLengthsFromDictionary is hardcoded false in the reference
        # (VariantSupport.scala:77) and the lengths are unused here.
        source, _ = load_read_source(
            bam,
            load_filters,
            contig_lengths_from_dictionary=False,
            recompute_mdtags=args.recompute_md_tags,
            use_native=args.bam_reader_api in ("best", "native"),
        )
        counts = pileup_allele_counts(
            source, loci, tile_size=args.tile_size, mesh=mesh, device=device
        )
        per_bam.append([str(c) for c in counts])
    if mh.active:
        from guacamole_tpu_torch.parallel.multihost import gather_objects

        # Rank-ordered concat per bam: shards are contiguous ascending
        # loci, so the merged order equals the single-process order.
        gathered = gather_objects(mh, [per_bam])
        lines = []
        for b in range(len(args.bams)):
            for proc_per_bam in gathered:
                lines.extend(proc_per_bam[b])
        if not mh.is_writer:
            return 0
    else:
        lines = [line for bam_lines in per_bam for line in bam_lines]
    with open(args.output, "w") as out:
        out.write("\n".join(lines) + ("\n" if lines else ""))
    progress(f"Wrote {len(lines)} allele counts to {args.output}.")
    return 0
