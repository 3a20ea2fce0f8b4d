"""VCF output writer and a minimal VCF reader.

The writer emits deterministic, position-sorted VCF 4.1 (the single-file
output of the reference's `.vcf` path, cf. reference
.../Common.scala:290-293). The reader supports the variant-support tool,
dbSNP annotation and concordance (sites + IDs only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from guacamole_tpu_torch import __version__


@dataclass
class VcfRecord:
    contig: str
    start: int  # 0-based
    ref: str
    alt: str
    sample_name: str = "default"
    id_: str = "."
    qual: Optional[float] = None
    filter_: str = "."
    info: Dict[str, str] = field(default_factory=dict)
    genotype: Tuple[str, str] = ("Ref", "Alt")  # labels: Ref/Alt/OtherAlt/NoCall
    # per-sample fields
    read_depth: Optional[int] = None
    reference_read_depth: Optional[int] = None
    alternate_read_depth: Optional[int] = None
    genotype_quality: Optional[int] = None

    @property
    def gt_string(self) -> str:
        codes = []
        for label in self.genotype:
            if label == "NoCall":
                codes.append(".")
            elif label == "Ref":
                codes.append("0")
            elif label == "Alt":
                codes.append("1")
            else:  # OtherAlt
                codes.append("2")
        return "/".join(codes)


VCF_HEADER_LINES = [
    "##fileformat=VCFv4.1",
    f"##source=guacamole_tpu_torch {__version__}",
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=AD,Number=R,Type=Integer,Description='
    '"Allelic depths for the ref and alt alleles">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
]

# --vcf-header-compat adam016: the header boilerplate an ADAM-0.16-era
# saveAsVcf run writes (Common.scala:290-293 — htsjdk VCFHeader via
# hadoop-bam's KeyIgnoringVCFOutputFormat). Reconstructed from the
# htsjdk-1.x standard header lines ADAM's converter registered, in
# htsjdk's sorted emission order (FORMAT lines alphabetical by ID); no
# ##source line (htsjdk adds none). Body records are identical either
# way — the parity contract is record-level (BASELINE.md); this mode
# exists so a future JVM-vs-here diff can be byte-level after at most
# header inspection. Pinned by tests/golden/chrM.germline-threshold.adam016-header.txt.
ADAM016_HEADER_LINES = [
    "##fileformat=VCFv4.1",
    '##FORMAT=<ID=AD,Number=.,Type=Integer,Description='
    '"Allelic depths for the ref and alt alleles in the order listed">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description='
    '"Approximate read depth (reads with MQ=255 or with bad mates are '
    'filtered)">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description='
    '"Genotype Quality">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
]


def write_vcf(
    records: Sequence[VcfRecord],
    path: str,
    contig_lengths: Optional[Dict[str, int]] = None,
    header_compat: str = "",
) -> None:
    records = sorted(records, key=lambda r: (r.contig, r.start, r.ref, r.alt))
    sample_names = sorted({r.sample_name for r in records}) or ["default"]
    header = (
        ADAM016_HEADER_LINES
        if header_compat == "adam016"
        else VCF_HEADER_LINES
    )
    with open(path, "w") as out:
        for line in header:
            out.write(line + "\n")
        if contig_lengths:
            for contig, length in sorted(contig_lengths.items()):
                out.write(f"##contig=<ID={contig},length={length}>\n")
        out.write(
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(sample_names)
            + "\n"
        )
        for rec in records:
            qual = "." if rec.qual is None else ("%g" % rec.qual)
            info = (
                ";".join(f"{k}={v}" for k, v in sorted(rec.info.items()))
                if rec.info
                else "."
            )
            fmt_fields = ["GT"]
            values = {name: ["./."] for name in sample_names}
            sample_value = [rec.gt_string]
            if rec.read_depth is not None:
                fmt_fields.append("AD")
                sample_value.append(
                    "%d,%d"
                    % (
                        rec.reference_read_depth
                        if rec.reference_read_depth is not None
                        else 0,
                        rec.alternate_read_depth
                        if rec.alternate_read_depth is not None
                        else 0,
                    )
                )
                fmt_fields.append("DP")
                sample_value.append(str(rec.read_depth))
            if rec.genotype_quality is not None:
                fmt_fields.append("GQ")
                sample_value.append(str(rec.genotype_quality))
            empty = ":".join(["./."] + ["."] * (len(fmt_fields) - 1))
            for name in sample_names:
                values[name] = [empty]
            values[rec.sample_name] = [":".join(sample_value)]
            row = [
                rec.contig,
                str(rec.start + 1),  # VCF is 1-based
                rec.id_,
                rec.ref,
                rec.alt,
                qual,
                rec.filter_,
                info,
                ":".join(fmt_fields),
            ] + [values[name][0] for name in sample_names]
            out.write("\t".join(row) + "\n")


@dataclass(frozen=True)
class SimpleVariant:
    contig: str
    start: int  # 0-based
    ref: str
    alts: Tuple[str, ...]
    id_: Optional[str] = None

    @property
    def end(self) -> int:
        return self.start + max(1, len(self.ref))


def read_vcf(path: str) -> Iterator[SimpleVariant]:
    """Parse variant sites from a VCF file (sites + IDs only)."""
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            fields = line.rstrip("\n").split("\t")
            contig, pos, id_, ref, alt = fields[:5]
            yield SimpleVariant(
                contig=contig,
                start=int(pos) - 1,
                ref=ref,
                alts=tuple(alt.split(",")),
                id_=None if id_ == "." else id_,
            )
