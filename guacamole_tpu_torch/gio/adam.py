"""ADAM Parquet I/O: AlignmentRecord input/output and Genotype output.

TPU-native equivalent of the reference's ADAM paths: reading alignments
from Parquet (cf. reference .../reads/Read.scala:454-539), the
ADAM round-trip contract (ReadSetSuite.scala:88-126), and genotype output
via adamParquetSave (Common.scala:295-303). Column names follow the
bdg-formats 0.6.1 Avro field names (AlignmentRecord / Genotype / Variant /
Contig) so rows carry the same information as ADAM 0.18-era files.

Deviations from the reference (documented in DEVIATIONS.md):
- ``isFirstInPair`` uses SAM semantics (readNum == 0 is the first read of
  the pair, matching ADAM's SAMRecordConverter); the reference tests
  ``getReadNum == 1`` (Read.scala:536), which inverts pair order.
- When rebuilding MD tags from a FASTA we anchor at the record's aligned
  start; the reference passes ``getStart - 1`` (Read.scala:493), which
  mis-anchors the tag by one base.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from guacamole_tpu_torch.reads.cigar import Cigar
from guacamole_tpu_torch.reads.mdtag import MdTag
from guacamole_tpu_torch.reads.read import (
    MappedRead,
    MateAlignmentProperties,
    PairedRead,
    UnmappedRead,
)
from guacamole_tpu_torch.utils import bases as Bases
from guacamole_tpu_torch.utils.progress import progress


def _pyarrow():
    try:
        import pyarrow  # noqa: F401
        import pyarrow.parquet  # noqa: F401

        return pyarrow
    except ImportError as exc:  # pragma: no cover - environment-dependent
        raise ImportError(
            "ADAM Parquet I/O requires pyarrow, which is not installed"
        ) from exc


def _parquet_paths(path: str) -> List[str]:
    """An .adam 'file' is usually a directory of part files (Spark/Hadoop
    layout); accept both a directory and a single Parquet file."""
    if os.path.isdir(path):
        parts = sorted(
            os.path.join(path, name)
            for name in os.listdir(path)
            if (name.startswith("part-") or name.endswith(".parquet"))
            and not name.endswith(".crc")
            and not name.startswith("_")
            and not name.startswith(".")
        )
        if not parts:
            raise FileNotFoundError(f"No Parquet part files in {path}")
        return parts
    if os.path.exists(path):
        return [path]
    raise FileNotFoundError(path)


# AlignmentRecord columns we consume/produce (bdg-formats 0.6.1 names).
_ALIGNMENT_COLUMNS = [
    "contig",
    "start",
    "mapq",
    "readName",
    "sequence",
    "qual",
    "cigar",
    "readPaired",
    "properPair",
    "readMapped",
    "mateMapped",
    "failedVendorQualityChecks",
    "duplicateRead",
    "readNegativeStrand",
    "mateNegativeStrand",
    "mateContig",
    "mateAlignmentStart",
    "inferredInsertSize",
    "mismatchingPositions",
    "recordGroupSample",
    "readNum",
]


def _column(table, name, n_rows):
    if name in table.column_names:
        return table.column(name).to_pylist()
    return [None] * n_rows


def _decode_qual(qual: Optional[str], seq_len: int) -> bytes:
    """Phred string -> byte array; empty means all-zero
    (cf. Read.scala:201-209 baseQualityStringToArray)."""
    if not qual or qual == "*":
        return bytes(seq_len)
    return bytes((ord(c) - 33) & 0xFF for c in qual)


def read_adam(
    path: str,
    token: int = 0,
    reference_genome=None,
) -> Tuple[List[object], Dict[str, int]]:
    """Read AlignmentRecord rows from an .adam Parquet file/directory.

    Returns (reads, sequence_dictionary). The sequence dictionary is
    aggregated from the records' contig structs, the way the reference
    derives it from the loaded RDD (Read.scala:470).
    """
    pa = _pyarrow()
    import pyarrow.parquet as pq

    progress(f"Using ADAM to read: {path}")
    reads: List[object] = []
    dictionary: Dict[str, int] = {}
    for part in _parquet_paths(path):
        table = pq.read_table(part)
        n = table.num_rows
        cols = {name: _column(table, name, n) for name in _ALIGNMENT_COLUMNS}
        for i in range(n):
            read = _row_to_read(
                {name: cols[name][i] for name in _ALIGNMENT_COLUMNS},
                token,
                reference_genome,
                dictionary,
            )
            reads.append(read)
    del pa
    return reads, dictionary


def _contig_fields(value) -> Tuple[Optional[str], Optional[int]]:
    if value is None:
        return None, None
    name = value.get("contigName")
    length = value.get("contigLength")
    return name, length


def _row_to_read(row, token, reference_genome, dictionary):
    """One AlignmentRecord row -> Mapped/Unmapped(/Paired) read
    (cf. Read.scala:484-539 fromADAMRecord)."""
    sequence = Bases.string_to_bases(row["sequence"] or "")
    quals = _decode_qual(row["qual"], len(sequence))
    sample = (row["recordGroupSample"] or "").strip() or ""
    contig_name, contig_length = _contig_fields(row["contig"])
    if contig_name and contig_length:
        dictionary.setdefault(contig_name, int(contig_length))

    if row["readMapped"]:
        cigar = Cigar.from_string(row["cigar"] or "*")
        start = int(row["start"] or 0)
        md_string = row["mismatchingPositions"]
        if reference_genome is not None:
            md_string = reference_genome.build_md_tag(
                sequence, contig_name, start, cigar
            )
        mdtag = (
            MdTag(md_string, start, cigar) if md_string is not None else None
        )
        read = MappedRead(
            token=token,
            sequence=sequence,
            base_qualities=quals,
            is_duplicate=bool(row["duplicateRead"]),
            sample_name=sample,
            reference_contig=contig_name or "",
            alignment_quality=int(row["mapq"] or 0),
            start=start,
            cigar=cigar,
            mdtag=mdtag,
            failed_vendor_quality_checks=bool(row["failedVendorQualityChecks"]),
            is_positive_strand=not row["readNegativeStrand"],
            is_paired=bool(row["readPaired"]),
        )
    else:
        read = UnmappedRead(
            token=token,
            sequence=sequence,
            base_qualities=quals,
            is_duplicate=bool(row["duplicateRead"]),
            sample_name=sample,
            failed_vendor_quality_checks=bool(row["failedVendorQualityChecks"]),
            is_paired=bool(row["readPaired"]),
        )

    if not row["readPaired"]:
        return read

    mate = None
    if row["mateMapped"]:
        mate_contig, mate_length = _contig_fields(row["mateContig"])
        if mate_contig and mate_length:
            dictionary.setdefault(mate_contig, int(mate_length))
        insert = row["inferredInsertSize"]
        mate = MateAlignmentProperties(
            reference_contig=mate_contig or "",
            start=int(row["mateAlignmentStart"] or 0),
            inferred_insert_size=int(insert) if insert else None,
            is_positive_strand=not row["mateNegativeStrand"],
        )
    return PairedRead(read, int(row["readNum"] or 0) == 0, mate)


def _read_to_row(read, contig_lengths: Dict[str, int]) -> dict:
    paired = isinstance(read, PairedRead)
    inner = read.read if paired else read
    mapped = inner.as_mapped_read
    row = {
        "sequence": Bases.bases_to_string(inner.sequence),
        "qual": "".join(chr(q + 33) for q in inner.base_qualities),
        "readPaired": inner.is_paired,
        "readMapped": mapped is not None,
        "mateMapped": False,
        "failedVendorQualityChecks": inner.failed_vendor_quality_checks,
        "duplicateRead": inner.is_duplicate,
        "recordGroupSample": inner.sample_name,
        "readNum": 0,
        "contig": None,
        "start": None,
        "mapq": None,
        "cigar": None,
        "readNegativeStrand": False,
        "mismatchingPositions": None,
        "mateContig": None,
        "mateAlignmentStart": None,
        "mateNegativeStrand": False,
        "inferredInsertSize": None,
        "readName": None,
        "properPair": False,
    }
    if mapped is not None:
        row.update(
            contig={
                "contigName": mapped.reference_contig,
                "contigLength": contig_lengths.get(mapped.reference_contig),
            },
            start=mapped.start,
            mapq=mapped.alignment_quality,
            cigar=str(mapped.cigar),
            readNegativeStrand=not mapped.is_positive_strand,
            mismatchingPositions=mapped.mdtag.tag if mapped.mdtag else None,
        )
    if paired:
        row["readNum"] = 0 if read.is_first_in_pair else 1
        mate = read.mate_alignment_properties
        if mate is not None:
            row.update(
                mateMapped=True,
                mateContig={
                    "contigName": mate.reference_contig,
                    "contigLength": contig_lengths.get(mate.reference_contig),
                },
                mateAlignmentStart=mate.start,
                mateNegativeStrand=not mate.is_positive_strand,
                inferredInsertSize=mate.inferred_insert_size,
            )
    return row


def _avro_field(name: str, avro_type) -> dict:
    """A nullable Avro field the way bdg-formats declares them: a
    ["null", T] union with default null."""
    return {"name": name, "type": ["null", avro_type], "default": None}


_AVRO_CONTIG = {
    "type": "record",
    "name": "Contig",
    "namespace": "org.bdgenomics.formats.avro",
    "fields": [
        _avro_field("contigName", "string"),
        _avro_field("contigLength", "long"),
    ],
}


def _avro_alignment_schema() -> str:
    """bdg-formats AlignmentRecord Avro schema (the fields this writer
    emits), as parquet-avro embeds it. Listed in the exact order of the
    Parquet columns below."""
    import json as _json

    fields = [
        _avro_field("contig", _AVRO_CONTIG),
        _avro_field("start", "long"),
        _avro_field("mapq", "int"),
        _avro_field("readName", "string"),
        _avro_field("sequence", "string"),
        _avro_field("qual", "string"),
        _avro_field("cigar", "string"),
        _avro_field("readPaired", "boolean"),
        _avro_field("properPair", "boolean"),
        _avro_field("readMapped", "boolean"),
        _avro_field("mateMapped", "boolean"),
        _avro_field("failedVendorQualityChecks", "boolean"),
        _avro_field("duplicateRead", "boolean"),
        _avro_field("readNegativeStrand", "boolean"),
        _avro_field("mateNegativeStrand", "boolean"),
        _avro_field(
            "mateContig",
            "org.bdgenomics.formats.avro.Contig",
        ),
        _avro_field("mateAlignmentStart", "long"),
        _avro_field("inferredInsertSize", "long"),
        _avro_field("mismatchingPositions", "string"),
        _avro_field("recordGroupSample", "string"),
        _avro_field("readNum", "int"),
    ]
    return _json.dumps(
        {
            "type": "record",
            "name": "AlignmentRecord",
            "namespace": "org.bdgenomics.formats.avro",
            "fields": fields,
        }
    )


def _avro_genotype_schema() -> str:
    """bdg-formats Genotype Avro schema (the fields this writer emits)."""
    import json as _json

    variant = {
        "type": "record",
        "name": "Variant",
        "namespace": "org.bdgenomics.formats.avro",
        "fields": [
            _avro_field(
                "contig",
                {
                    "type": "record",
                    "name": "Contig",
                    "namespace": "org.bdgenomics.formats.avro",
                    "fields": [_avro_field("contigName", "string")],
                },
            ),
            _avro_field("start", "long"),
            _avro_field("end", "long"),
            _avro_field("referenceAllele", "string"),
            _avro_field("alternateAllele", "string"),
        ],
    }
    fields = [
        _avro_field("variant", variant),
        _avro_field("sampleId", "string"),
        _avro_field(
            "alleles", {"type": "array", "items": "string"}
        ),
        _avro_field("genotypeQuality", "int"),
        _avro_field("readDepth", "int"),
        _avro_field("expectedAlleleDosage", "float"),
        _avro_field("referenceReadDepth", "int"),
        _avro_field("alternateReadDepth", "int"),
    ]
    return _json.dumps(
        {
            "type": "record",
            "name": "Genotype",
            "namespace": "org.bdgenomics.formats.avro",
            "fields": fields,
        }
    )


def _with_avro_metadata(table, avro_schema_json: str):
    """Embed the Avro schema in the Parquet key-value metadata exactly
    where parquet-avro (and so ADAM-era AvroReadSupport) looks for it —
    the 'parquet.avro.schema' footer key (plus the legacy 'avro.schema'
    alias older parquet-mr reads). The byte-level Parquet container is
    still pyarrow's, but Avro-aware readers now recognize the records
    (cf. the reference's adamParquetSave, Common.scala:295-303)."""
    meta = dict(table.schema.metadata or {})
    meta[b"parquet.avro.schema"] = avro_schema_json.encode()
    meta[b"avro.schema"] = avro_schema_json.encode()
    meta[b"writer.model.name"] = b"avro"
    return table.replace_schema_metadata(meta)


def write_adam(
    path: str,
    reads: Sequence[object],
    contig_lengths: Optional[Dict[str, int]] = None,
) -> None:
    """Write reads as an .adam directory of one Parquet part file (the
    Spark/Hadoop layout adamParquetSave produces)."""
    pa = _pyarrow()
    import pyarrow.parquet as pq

    contig_lengths = contig_lengths or {}
    rows = [_read_to_row(r, contig_lengths) for r in reads]
    contig_type = pa.struct(
        [("contigName", pa.string()), ("contigLength", pa.int64())]
    )
    schema = pa.schema(
        [
            ("contig", contig_type),
            ("start", pa.int64()),
            ("mapq", pa.int32()),
            ("readName", pa.string()),
            ("sequence", pa.string()),
            ("qual", pa.string()),
            ("cigar", pa.string()),
            ("readPaired", pa.bool_()),
            ("properPair", pa.bool_()),
            ("readMapped", pa.bool_()),
            ("mateMapped", pa.bool_()),
            ("failedVendorQualityChecks", pa.bool_()),
            ("duplicateRead", pa.bool_()),
            ("readNegativeStrand", pa.bool_()),
            ("mateNegativeStrand", pa.bool_()),
            ("mateContig", contig_type),
            ("mateAlignmentStart", pa.int64()),
            ("inferredInsertSize", pa.int64()),
            ("mismatchingPositions", pa.string()),
            ("recordGroupSample", pa.string()),
            ("readNum", pa.int32()),
        ]
    )
    table = _with_avro_metadata(
        pa.Table.from_pylist(rows, schema=schema), _avro_alignment_schema()
    )
    os.makedirs(path, exist_ok=True)
    pq.write_table(table, os.path.join(path, "part-r-00000.parquet"))
    with open(os.path.join(path, "_SUCCESS"), "w"):
        pass


def write_genotypes_parquet(records, path: str) -> None:
    """Write called genotypes as ADAM-Genotype-shaped Parquet rows
    (cf. Common.scala:295-303 adamParquetSave; field content matches
    AlleleConversions.scala:30-62 + ReferenceVariant.scala:42-48)."""
    pa = _pyarrow()
    import pyarrow.parquet as pq

    variant_type = pa.struct(
        [
            (
                "contig",
                pa.struct([("contigName", pa.string())]),
            ),
            ("start", pa.int64()),
            ("end", pa.int64()),
            ("referenceAllele", pa.string()),
            ("alternateAllele", pa.string()),
        ]
    )
    schema = pa.schema(
        [
            ("variant", variant_type),
            ("sampleId", pa.string()),
            ("alleles", pa.list_(pa.string())),
            ("genotypeQuality", pa.int32()),
            ("readDepth", pa.int32()),
            ("expectedAlleleDosage", pa.float32()),
            ("referenceReadDepth", pa.int32()),
            ("alternateReadDepth", pa.int32()),
        ]
    )
    rows = []
    for rec in records:
        dosage = None
        if rec.read_depth:
            dosage = (rec.alternate_read_depth or 0) / rec.read_depth
        rows.append(
            {
                "variant": {
                    "contig": {"contigName": rec.contig},
                    "start": rec.start,
                    # CalledAllele pins end = start + 1 (CalledAllele.scala:39)
                    "end": rec.start + 1,
                    "referenceAllele": rec.ref,
                    "alternateAllele": rec.alt,
                },
                "sampleId": rec.sample_name,
                "alleles": list(rec.genotype),
                "genotypeQuality": rec.genotype_quality,
                "readDepth": rec.read_depth,
                "expectedAlleleDosage": dosage,
                "referenceReadDepth": rec.reference_read_depth,
                "alternateReadDepth": rec.alternate_read_depth,
            }
        )
    table = _with_avro_metadata(
        pa.Table.from_pylist(rows, schema=schema), _avro_genotype_schema()
    )
    os.makedirs(path, exist_ok=True)
    pq.write_table(table, os.path.join(path, "part-r-00000.parquet"))
    with open(os.path.join(path, "_SUCCESS"), "w"):
        pass


def read_genotypes_parquet(path: str) -> List[dict]:
    """Read back genotype rows written by write_genotypes_parquet."""
    _pyarrow()
    import pyarrow.parquet as pq

    rows: List[dict] = []
    for part in _parquet_paths(path):
        rows.extend(pq.read_table(part).to_pylist())
    return rows
