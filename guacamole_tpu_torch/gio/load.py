"""Unified read loading: dispatch on file extension, apply input filters
inline, return a ReadSet.

Mirrors the loading semantics of the reference (cf. reference
.../reads/Read.scala:338-451): BAM files use the .bai index for region
pushdown when a loci filter is given; filters that can run on raw records
run before read construction.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

from guacamole_tpu_torch.gio import sam_flags as flags
from guacamole_tpu_torch.gio.bai import BamIndex, optimize_chunks
from guacamole_tpu_torch.gio.bam import BamFile
from guacamole_tpu_torch.gio.sam import read_sam
from guacamole_tpu_torch.reads.read import InputFilters, MappedRead, PairedRead
from guacamole_tpu_torch.reads.readset import ReadSet
from guacamole_tpu_torch.utils.progress import progress


def load_read_set(
    path: str,
    filters: InputFilters = InputFilters.empty,
    token: int = 0,
    contig_lengths_from_dictionary: bool = True,
    reference_genome=None,
    recompute_mdtags: bool = False,
    require_mdtags_on_mapped_reads: bool = False,
) -> ReadSet:
    reads, dictionary = load_reads(
        path,
        filters=filters,
        token=token,
        reference_genome=reference_genome,
        recompute_mdtags=recompute_mdtags,
        require_mdtags_on_mapped_reads=require_mdtags_on_mapped_reads,
    )
    return ReadSet(
        reads=reads,
        sequence_dictionary=dictionary,
        source=path,
        filters=filters,
        token=token,
        contig_lengths_from_dictionary=contig_lengths_from_dictionary,
    )


def header_contig_lengths(path: str) -> dict:
    """Contig lengths from the file header alone (no record decode).

    Cheap enough to run on every process of a multi-host run before shard
    assignment (the SequenceDictionary read at Read.scala:434-435)."""
    lower = path.lower()
    if lower.endswith(".bam"):
        return dict(BamFile(path).references)
    if lower.endswith(".sam"):
        from guacamole_tpu_torch.gio.sam import SamHeader, parse_header_line

        header = SamHeader([], {}, {})
        with open(path, "rt") as fh:
            for line in fh:
                if not line.startswith("@"):
                    break
                parse_header_line(line, header)
        return dict(header.contig_lengths)
    reads, dictionary = _load_adam(path, InputFilters.empty, 0, None, False)
    return dict(dictionary)


def load_reads(
    path: str,
    filters: InputFilters = InputFilters.empty,
    token: int = 0,
    reference_genome=None,
    recompute_mdtags: bool = False,
    require_mdtags_on_mapped_reads: bool = False,
):
    """Load reads from a SAM/BAM file, applying filters during the scan.

    Returns (reads, sequence_dictionary).
    """
    if recompute_mdtags and reference_genome is None:
        raise ValueError(
            "To recompute MD tags, a reference genome fasta must be provided."
        )
    lower = path.lower()
    if lower.endswith(".bam"):
        return _load_bam(
            path, filters, token, reference_genome, recompute_mdtags,
            require_mdtags_on_mapped_reads,
        )
    if lower.endswith(".sam"):
        return _load_sam(
            path, filters, token, reference_genome, recompute_mdtags,
            require_mdtags_on_mapped_reads,
        )
    # Anything else is treated as ADAM Parquet, the way the reference
    # falls through to loadReadRDDAndSequenceDictionaryFromADAM
    # (Read.scala:352-365).
    return _load_adam(path, filters, token, reference_genome, recompute_mdtags)


def _resolve_loci(filters: InputFilters, contig_lengths):
    if filters.overlaps_loci is None:
        return None
    return filters.overlaps_loci.result(contig_lengths)


def _post_filter(read, filters: InputFilters, loci) -> bool:
    """Filters evaluated on constructed reads (cf. Read.scala:411-428)."""
    if loci is not None:
        if not read.is_mapped:
            return False
        mapped = read.as_mapped_read
        if not loci.on_contig(mapped.reference_contig).intersects(
            mapped.start, mapped.start + mapped.cigar.reference_length
        ):
            return False
    if filters.non_duplicate and read.is_duplicate:
        return False
    if filters.passed_vendor_quality_checks and read.failed_vendor_quality_checks:
        return False
    if filters.is_paired and not read.is_paired:
        return False
    if filters.has_mdtag and not read.has_mdtag:
        return False
    return True


def _maybe_fix_mdtag(read, reference_genome, recompute: bool, require: bool):
    """Recompute (or backfill) MD tags from the reference FASTA."""
    mapped = read.as_mapped_read
    if mapped is None:
        return read
    if (recompute or mapped.mdtag is None) and reference_genome is not None:
        from dataclasses import replace

        from guacamole_tpu_torch.reads.mdtag import MdTag

        tag = reference_genome.build_md_tag(
            mapped.sequence, mapped.reference_contig, mapped.start, mapped.cigar
        )
        new_mapped = replace(
            mapped, mdtag=MdTag(tag, mapped.start, mapped.cigar)
        )
        if isinstance(read, PairedRead):
            return PairedRead(
                new_mapped, read.is_first_in_pair, read.mate_alignment_properties
            )
        return new_mapped
    if require and mapped.mdtag is None:
        raise ValueError(f"Missing MD tag in read: {read}")
    return read


def _load_sam(
    path, filters, token, reference_genome, recompute_mdtags, require_mdtags
):
    header, records = read_sam(path, token=token)
    dictionary = header.sequence_dictionary
    loci = _resolve_loci(filters, dictionary)
    out = []
    for read in records:
        read = _maybe_fix_mdtag(
            read, reference_genome, recompute_mdtags, require_mdtags
        )
        if _post_filter(read, filters, loci):
            out.append(read)
    return out, dictionary


def _load_adam(path, filters, token, reference_genome, recompute_mdtags):
    """ADAM Parquet input (cf. Read.scala:454-475)."""
    if recompute_mdtags:
        raise ValueError(
            "Recomputing md tags currently not implemented for ADAM files."
        )
    from guacamole_tpu_torch.gio.adam import read_adam

    all_reads, dictionary = read_adam(
        path, token=token, reference_genome=reference_genome
    )
    loci = _resolve_loci(filters, dictionary)
    reads = [r for r in all_reads if _post_filter(r, filters, loci)]
    return reads, dictionary


def _load_bam(
    path, filters, token, reference_genome, recompute_mdtags, require_mdtags
):
    bam = BamFile(path)
    dictionary = bam.header.sequence_dictionary
    loci = _resolve_loci(filters, dictionary)

    chunks = None
    index_path = None
    for candidate in (path + ".bai", os.path.splitext(path)[0] + ".bai"):
        if os.path.exists(candidate):
            index_path = candidate
            break
    if loci is not None and index_path is not None:
        # Region pushdown through the BAM index (Read.scala:395-406).
        progress(f"Using BAM index to read: {path}")
        index = BamIndex(index_path)
        ref_ids = {name: i for i, (name, _) in enumerate(bam.references)}
        chunk_lists = []
        for contig in loci.contigs:
            ref_id = ref_ids.get(contig)
            if ref_id is None:
                continue
            for start, end in loci.on_contig(contig).ranges:
                chunk_lists.append(index.chunks_for_region(ref_id, start, end))
        chunks = optimize_chunks(chunk_lists)

    out = []
    for read in bam.records(token=token, chunks=chunks):
        read = _maybe_fix_mdtag(
            read, reference_genome, recompute_mdtags, require_mdtags
        )
        if _post_filter(read, filters, loci):
            out.append(read)
    return out, dictionary
