"""Shared caller program pieces: loci resolution, output writing.

(cf. reference .../Common.scala:223-304)
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence

from guacamole_tpu_torch.gio.vcf import VcfRecord, write_vcf
from guacamole_tpu_torch.loci.lociset import LociSet, LociSetBuilder, parse_loci
from guacamole_tpu_torch.utils.progress import progress


def resolve_loci_builder(
    loci: str = "", loci_from_file: str = ""
) -> LociSetBuilder:
    """Parse --loci / --loci-from-file (default: 'all')."""
    if loci and loci_from_file:
        raise ValueError(
            "Specify at most one of the 'loci' and 'loci-from-file' arguments"
        )
    if loci:
        expression = loci
    elif loci_from_file:
        with open(loci_from_file) as fh:
            expression = fh.read()
    else:
        expression = "all"
    return parse_loci(expression)


def load_read_source(
    path: str,
    filters,
    contig_lengths_from_dictionary: bool = True,
    reference_genome=None,
    recompute_mdtags: bool = False,
    use_native: bool = True,
):
    """Load reads as a ReadSource, preferring the native columnar decoder
    for BAM inputs. Returns (source, sequence_dictionary).

    Falls back to the object path for SAM inputs, when the native runtime is
    unavailable, or when MD recomputation from a FASTA is requested.
    """
    from guacamole_tpu_torch.callers.source import ReadSource
    from guacamole_tpu_torch.gio.load import load_read_set

    if (
        use_native
        and path.lower().endswith((".bam", ".sam"))
        and not recompute_mdtags
    ):
        from guacamole_tpu_torch.runtime.columnar import (
            decode_bam_columnar,
            decode_sam_columnar,
            filter_columnar,
        )

        if path.lower().endswith(".sam"):
            cols = decode_sam_columnar(path)
        else:
            chunks = (
                bai_chunks_for_loci(path, filters.overlaps_loci)
                if filters.overlaps_loci is not None
                else None
            )
            cols = decode_bam_columnar(path, chunks=chunks)
        if cols is not None:
            dictionary = cols.contig_lengths
            for contig_id, contig in enumerate(cols.ref_names):
                # SAM headers may omit @SQ lengths: fall back to the
                # furthest read end (matches the object loader)
                if dictionary.get(contig, 0) == 0:
                    m = cols.ref_id == contig_id
                    if m.any():
                        dictionary[contig] = int(cols.end[m].max())
            loci_set = (
                filters.overlaps_loci.result(dictionary)
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
                # callers operate on mapped reads only
                filtered = filtered.select(filtered.is_mapped_mask)
            if not contig_lengths_from_dictionary:
                dictionary = {}
                for contig_id, contig in enumerate(filtered.ref_names):
                    m = filtered.ref_id == contig_id
                    if m.any():
                        dictionary[contig] = int(filtered.end[m].max())
            return ReadSource.from_columnar(filtered), dictionary

    read_set = load_read_set(
        path,
        filters,
        contig_lengths_from_dictionary=contig_lengths_from_dictionary,
        reference_genome=reference_genome,
        recompute_mdtags=recompute_mdtags,
    )
    reads = read_set.mapped_reads
    if use_native and reads:
        # SAM / object-loaded inputs still get the native packer: build the
        # columnar representation once (event arrays filled by the native
        # runtime — guac_build_events) so every tile packs in C++ instead
        # of re-deriving per-read events in Python per tile.
        from guacamole_tpu_torch.runtime.columnar import (
            columnar_from_reads,
            native_available,
        )

        if native_available():
            reads = sorted(
                reads, key=lambda r: (r.reference_contig, r.start)
            )
            return (
                ReadSource.from_columnar(
                    columnar_from_reads(reads, native=True)
                ),
                read_set.contig_lengths,
            )
    return (
        ReadSource.from_reads(reads),
        read_set.contig_lengths,
    )


def bai_chunks_for_loci(path: str, loci_builder):
    """Merged BGZF virtual-offset chunks covering a loci selection, from
    the .bai (the samtools QueryInterval pushdown, Read.scala:395-406).

    None = no pushdown (no index, or the loci cover ~everything, where a
    whole-file multithreaded decode is faster than chunk bookkeeping)."""
    import os

    bai_path = None
    for candidate in (path + ".bai", os.path.splitext(path)[0] + ".bai"):
        if os.path.exists(candidate):
            bai_path = candidate
            break
    if bai_path is None:
        return None
    try:
        from guacamole_tpu_torch.gio.bai import BamIndex, optimize_chunks
        from guacamole_tpu_torch.gio.bam import BamFile

        bam = BamFile(path)
        dictionary = dict(bam.references)
        loci_set = loci_builder.result(dictionary)
        total = sum(dictionary.values())
        if total == 0 or loci_set.count >= total // 2:
            return None
        index = BamIndex(bai_path)
        ref_ids = {name: i for i, (name, _) in enumerate(bam.references)}
        lists = []
        for contig in loci_set.contigs:
            rid = ref_ids.get(contig)
            if rid is None:
                continue
            for start, end in loci_set.on_contig(contig).ranges:
                lists.append(index.chunks_for_region(rid, start, end))
        return optimize_chunks(lists)
    except Exception as exc:
        progress(
            "BAM-index pushdown unavailable (%s: %s); falling back to "
            "whole-file decode." % (type(exc).__name__, exc)
        )
        return None


def record_to_json(rec: VcfRecord) -> dict:
    out = {
        "sampleId": rec.sample_name,
        "variant": {
            "contig": {"contigName": rec.contig},
            "start": rec.start,
            "referenceAllele": rec.ref,
            "alternateAllele": rec.alt,
        },
        "alleles": list(rec.genotype),
    }
    if rec.genotype_quality is not None:
        out["genotypeQuality"] = rec.genotype_quality
    if rec.read_depth is not None:
        out["readDepth"] = rec.read_depth
        out["referenceReadDepth"] = rec.reference_read_depth
        out["alternateReadDepth"] = rec.alternate_read_depth
        if rec.read_depth:
            out["expectedAlleleDosage"] = (
                (rec.alternate_read_depth or 0) / rec.read_depth
            )
    if rec.id_ != ".":
        out["rsId"] = rec.id_
    return out


def write_variants(
    records: Sequence[VcfRecord],
    out_path: str = "",
    contig_lengths: Optional[Dict[str, int]] = None,
    max_genotypes: int = 0,
    vcf_header_compat: str = "",
) -> None:
    """Write calls: stdout JSON (default), .json file, or .vcf file
    (cf. Common.scala:246-304)."""
    if max_genotypes > 0 and len(records) > max_genotypes:
        progress(f"Subsetting to {max_genotypes} genotypes.")
        records = records[:max_genotypes]
    records = sorted(
        records, key=lambda r: (r.contig, r.start, r.sample_name, r.ref, r.alt)
    )
    lower = out_path.lower()
    if not out_path or lower.endswith(".json"):
        out = sys.stdout if not out_path else open(out_path, "w")
        try:
            for rec in records:
                json.dump(record_to_json(rec), out, indent=2, sort_keys=True)
                out.write("\n")
        finally:
            if out is not sys.stdout:
                out.close()
    elif lower.endswith(".vcf"):
        progress(f"Writing genotypes to VCF file: {out_path}.")
        write_vcf(
            records, out_path, contig_lengths,
            header_compat=vcf_header_compat,
        )
    else:
        # Any other path gets ADAM-Genotype Parquet, matching the
        # reference's adamParquetSave fallthrough (Common.scala:295-303).
        progress(f"Writing genotypes to: {out_path}.")
        from guacamole_tpu_torch.gio.adam import write_genotypes_parquet

        write_genotypes_parquet(records, out_path)


def validate_output_path(out_path: str) -> None:
    import os

    if out_path.lower().endswith(".vcf") and os.path.exists(out_path):
        raise FileExistsError(f"Output file {out_path} already exists")
