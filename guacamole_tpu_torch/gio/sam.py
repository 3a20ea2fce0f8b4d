"""SAM text format reader.

Produces the same read model as the BAM path; equivalent of the htsjdk
SAM parsing used by the reference loader (cf. reference
.../reads/Read.scala:217-291, 411-429).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from guacamole_tpu_torch.gio import sam_flags as flags
from guacamole_tpu_torch.reads.cigar import Cigar
from guacamole_tpu_torch.reads.mdtag import MdTag
from guacamole_tpu_torch.reads.read import (
    MappedRead,
    MateAlignmentProperties,
    PairedRead,
    UnmappedRead,
    base_quality_string_to_bytes,
)


@dataclass
class SamHeader:
    contig_names: List[str]
    contig_lengths: Dict[str, int]
    read_group_samples: Dict[str, str]  # RG ID -> SM sample name

    @property
    def sequence_dictionary(self) -> Dict[str, int]:
        return dict(self.contig_lengths)


def parse_header_line(line: str, header: SamHeader) -> None:
    fields = line.rstrip("\n").split("\t")
    tag = fields[0]
    if tag == "@SQ":
        name = None
        length = None
        for f in fields[1:]:
            if f.startswith("SN:"):
                name = f[3:]
            elif f.startswith("LN:"):
                length = int(f[3:])
        if name is not None and length is not None:
            header.contig_names.append(name)
            header.contig_lengths[name] = length
    elif tag == "@RG":
        rg_id = None
        sample = None
        for f in fields[1:]:
            if f.startswith("ID:"):
                rg_id = f[3:]
            elif f.startswith("SM:"):
                sample = f[3:]
        if rg_id is not None and sample is not None:
            header.read_group_samples[rg_id] = sample


def parse_tags(fields: List[str]) -> Dict[str, object]:
    """Parse optional SAM tag fields (TAG:TYPE:VALUE)."""
    tags: Dict[str, object] = {}
    for f in fields:
        parts = f.split(":", 2)
        if len(parts) != 3:
            continue
        tag, typ, value = parts
        if typ in ("i",):
            tags[tag] = int(value)
        elif typ == "f":
            tags[tag] = float(value)
        else:
            tags[tag] = value
    return tags


def record_to_read(
    *,
    flag: int,
    rname: str,
    pos: int,  # 1-based alignment start from the file; 0 if unmapped
    mapq: int,
    cigar: Cigar,
    rnext: str,
    pnext: int,
    tlen: int,
    sequence: bytes,
    base_qualities: bytes,
    md: Optional[str],
    sample_name: str,
    token: int,
):
    """Build a read from decoded record fields (shared SAM/BAM path;
    behavior mirrors fromSAMRecord at Read.scala:217-291)."""
    is_mapped = not (flag & flags.UNMAPPED) and rname not in ("*", "") and pos > 0
    start = pos - 1  # 1-based -> 0-based
    if is_mapped:
        mdtag = MdTag(md, start, cigar) if md is not None else None
        read = MappedRead(
            token=token,
            sequence=sequence,
            base_qualities=base_qualities,
            is_duplicate=bool(flag & flags.DUPLICATE),
            sample_name=sample_name,
            reference_contig=rname,
            alignment_quality=mapq,
            start=start,
            cigar=cigar,
            mdtag=mdtag,
            failed_vendor_quality_checks=bool(flag & flags.VENDOR_FAILED),
            is_positive_strand=not (flag & flags.REVERSE),
            is_paired=bool(flag & flags.PAIRED),
        )
    else:
        read = UnmappedRead(
            token=token,
            sequence=sequence,
            base_qualities=base_qualities,
            is_duplicate=bool(flag & flags.DUPLICATE),
            sample_name=sample_name,
            failed_vendor_quality_checks=bool(flag & flags.VENDOR_FAILED),
            is_paired=bool(flag & flags.PAIRED),
        )
    if flag & flags.PAIRED:
        if not (flag & flags.MATE_UNMAPPED) and rnext not in ("*", ""):
            mate_contig = rname if rnext == "=" else rnext
            mate = MateAlignmentProperties(
                reference_contig=mate_contig,
                start=pnext - 1,
                inferred_insert_size=tlen if tlen != 0 else None,
                is_positive_strand=not (flag & flags.MATE_REVERSE),
            )
        else:
            mate = None
        return PairedRead(read, bool(flag & flags.FIRST_IN_PAIR), mate)
    return read


def read_sam(
    path: str, token: int = 0
) -> Tuple[SamHeader, Iterator]:
    """Parse a SAM file. Returns (header, iterator of reads)."""
    header = SamHeader([], {}, {})
    fh = open(path, "rt")

    # Parse header lines eagerly so the sequence dictionary is available
    # before reads are consumed.
    first_record_line: Optional[str] = None
    for line in fh:
        if line.startswith("@"):
            parse_header_line(line, header)
        else:
            first_record_line = line
            break

    def records() -> Iterator:
        line = first_record_line
        while line is not None:
            if line.strip():
                yield _parse_record_line(line, header, token)
            line = fh.readline() or None
        fh.close()

    return header, records()


def _parse_record_line(line: str, header: SamHeader, token: int):
    fields = line.rstrip("\n").split("\t")
    flag = int(fields[1])
    rname = fields[2]
    pos = int(fields[3])
    mapq = int(fields[4])
    cigar = Cigar.from_string(fields[5])
    rnext = fields[6]
    pnext = int(fields[7])
    tlen = int(fields[8])
    seq = fields[9].encode("ascii") if fields[9] != "*" else b""
    quals = (
        base_quality_string_to_bytes(fields[10], len(seq))
        if fields[10] != "*"
        else bytes(len(seq))
    )
    tags = parse_tags(fields[11:])
    md = tags.get("MD")
    rg = tags.get("RG")
    sample = header.read_group_samples.get(rg, "default") if rg else "default"
    return record_to_read(
        flag=flag,
        rname=rname,
        pos=pos,
        mapq=mapq,
        cigar=cigar,
        rnext=rnext,
        pnext=pnext,
        tlen=tlen,
        sequence=seq,
        base_qualities=quals,
        md=md if isinstance(md, str) else None,
        sample_name=sample,
        token=token,
    )
