"""The port's ADAM Parquet I/O (gio/adam.py) against the JAX package.

Both packages read and write the Parquet container through pyarrow (the
`adam` extra of pyproject.toml), and the port's gio/adam.py is the JAX
copy after the package rename (test_torch_host_copies.py holds its
text). These tests run the port's ADAM paths themselves:

- read_adam equals the JAX package's read_adam, read for read and field
  for field, on ADAM files from the scale-0.02 fixture (utils/simulate,
  seed 7) in every codec, with dictionary encoding on and off, data pages
  v1 and v2, several row groups, small pages, two part files, and nulls in
  every optional column;
- the contig lengths of an ADAM input reach the partitioner as a BAM's do;
- read_genotypes_parquet equals pyarrow's to_pylist() with lists in the
  3-level forms (element and item);
- files from the port's writers read back into the rows the JAX writers
  give, with the same Avro metadata;
- germline-threshold on a .adam gives the JAX CLI's VCF byte for byte
  (apart from ##source=), and the same genotype Parquet with --out .adam;
- without pyarrow the port fails an ADAM command with one line naming it,
  and still runs the same command on a BAM.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from guacamole_tpu.gio import adam as jax_adam
from guacamole_tpu.gio.load import load_reads as jax_load_reads
from guacamole_tpu.gio.vcf import VcfRecord as JaxVcfRecord
from guacamole_tpu.utils.simulate import make_scale_fixture
from guacamole_tpu_torch import cli as port_cli
from guacamole_tpu_torch.gio import adam as port_adam
from guacamole_tpu_torch.gio import load as port_load
from guacamole_tpu_torch.gio.vcf import VcfRecord as PortVcfRecord

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PART = "part-r-00000.parquet"
AVRO_KEYS = ("parquet.avro.schema", "avro.schema", "writer.model.name")


@pytest.fixture(scope="module")
def fixture_bam(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sim"))
    manifest = make_scale_fixture(out, scale=0.02, seed=7)
    return os.path.join(out, manifest["files"]["germline_bam"])


@pytest.fixture(scope="module")
def fixture_reads(fixture_bam):
    return jax_load_reads(fixture_bam)


@pytest.fixture(scope="module")
def alignment_adam(fixture_reads, tmp_path_factory):
    """1,506 reads of the fixture (every 56th, on both contigs) as the JAX
    writer writes them."""
    reads, dictionary = fixture_reads
    path = str(tmp_path_factory.mktemp("jax") / "subset.adam")
    jax_adam.write_adam(path, reads[::56], dictionary)
    return path


@pytest.fixture(scope="module")
def alignment_table(alignment_adam):
    """pyarrow's table of alignment_adam, with the Avro metadata."""
    return pq.read_table(os.path.join(alignment_adam, PART))


def _fields(obj):
    """Every field of a read, down through its mate and its paired
    wrapper; a Cigar by its text, an MdTag by its tag."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, {
            f.name: _fields(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return (type(obj).__name__, str(obj), getattr(obj, "tag", None))


def _assert_reads_equal(path):
    jax_reads, jax_dict = jax_adam.read_adam(path)
    port_reads, port_dict = port_adam.read_adam(path)
    assert port_dict == jax_dict
    assert len(port_reads) == len(jax_reads) > 0
    for a, b in zip(port_reads, jax_reads):
        assert _fields(a) == _fields(b)


def _with_nulls(table):
    """Every optional column null in some rows, the contig structs' fields
    too (inside a present struct). A read without a sequence has no
    qualities either (a read's two lengths must agree)."""
    rows = table.to_pylist()
    names = table.column_names
    for i, row in enumerate(rows):
        row[names[i % len(names)]] = None
        if row["sequence"] is None:
            row["qual"] = None
        for key in ("contig", "mateContig"):
            if row[key] is not None and i % 5 == 0:
                row[key] = dict(row[key], contigName=None)
            elif row[key] is not None and i % 5 == 1:
                row[key] = dict(row[key], contigLength=None)
    return pa.Table.from_pylist(rows, schema=table.schema)


_CODECS = ["snappy", "gzip", "none"]
_FORMS = [
    pytest.param(dict(compression=codec, use_dictionary=dictionary,
                      data_page_version=page),
                 id=f"{codec}-{'dict' if dictionary else 'plain'}-v{page[0]}")
    for codec in _CODECS for dictionary in (True, False)
    for page in ("1.0", "2.0")
] + [
    pytest.param(dict(row_group_size=400), id="row-groups"),
    pytest.param(dict(data_page_size=2048, dictionary_pagesize_limit=4096,
                      write_batch_size=256), id="small-pages"),
    pytest.param(dict(data_page_version="2.0", nulls=True), id="nulls-v2"),
    pytest.param(dict(nulls=True, use_dictionary=False), id="nulls-plain"),
    pytest.param(dict(parts=2), id="two-parts"),
]


@pytest.mark.parametrize("form", _FORMS)
def test_read_adam_equals_jax(alignment_table, tmp_path, form):
    form = dict(form)
    table = _with_nulls(alignment_table) if form.pop("nulls", False) \
        else alignment_table
    parts = form.pop("parts", 1)
    path = tmp_path / "reads.adam"
    path.mkdir()
    step = -(-table.num_rows // parts)
    for k in range(parts):
        pq.write_table(table.slice(k * step, step),
                       str(path / f"part-r-{k:05d}.parquet"), **form)
    (path / "_SUCCESS").write_text("")
    _assert_reads_equal(str(path))


def test_adam_contig_lengths_reach_the_partitioner_as_from_a_bam(
        fixture_bam, alignment_adam):
    """The lengths the CLI partitions and shards by (header_contig_lengths)
    and a read set's come from the ADAM rows' contig structs as a BAM's
    come from its header."""
    want = port_load.header_contig_lengths(fixture_bam)
    assert set(want) == {"deep1m", "shallow8m"}
    assert port_load.header_contig_lengths(alignment_adam) == want
    assert port_load.load_read_set(alignment_adam).contig_lengths == want


# --- genotype rows ----------------------------------------------------------


def _genotype_rows(n=60, seed=2026):
    rng = np.random.default_rng(seed)
    labels = ["Ref", "Alt", "OtherAlt", "NoCall"]
    rows = []
    for i in range(n):
        kind = i % 6
        alleles = (None if kind == 0 else [] if kind == 1 else
                   [labels[j] for j in rng.integers(0, 4, size=1 + i % 3)])
        if kind == 2:
            alleles = alleles + [None]
        rows.append({
            "variant": None if i % 9 == 4 else {
                "contig": None if i % 7 == 3 else {
                    "contigName": None if i % 11 == 5 else f"chr{i % 3}"},
                "start": int(rng.integers(0, 1 << 40)),
                "end": None if i % 8 == 2 else i + 1,
                "referenceAllele": "ACGT"[i % 4],
                "alternateAllele": "TGCA"[i % 4],
            },
            "sampleId": None if i % 10 == 7 else "sample",
            "alleles": alleles,
            "genotypeQuality": None if i % 4 == 3 else int(i),
            "readDepth": int(rng.integers(0, 1000)),
            "expectedAlleleDosage": None if i % 5 == 0 else i / 64,
            "referenceReadDepth": i,
            "alternateReadDepth": -i,
        })
    return rows


_GENOTYPE_SCHEMA = pa.schema([
    ("variant", pa.struct([
        ("contig", pa.struct([("contigName", pa.string())])),
        ("start", pa.int64()), ("end", pa.int64()),
        ("referenceAllele", pa.string()), ("alternateAllele", pa.string()),
    ])),
    ("sampleId", pa.string()),
    ("alleles", pa.list_(pa.string())),
    ("genotypeQuality", pa.int32()),
    ("readDepth", pa.int32()),
    ("expectedAlleleDosage", pa.float32()),
    ("referenceReadDepth", pa.int32()),
    ("alternateReadDepth", pa.int32()),
])


@pytest.mark.parametrize("form", ["element", "item"])
def test_genotype_lists_read_as_pyarrow_reads_them(tmp_path, form):
    path = tmp_path / "genotypes.adam"
    path.mkdir()
    part = str(path / PART)
    rows = _genotype_rows()
    pq.write_table(pa.Table.from_pylist(rows, schema=_GENOTYPE_SCHEMA),
                   part, use_compliant_nested_type=form == "element",
                   row_group_size=25)
    schema = pq.ParquetFile(part).schema
    paths = [schema.column(i).path for i in range(len(schema))]
    assert f"alleles.list.{form}" in paths
    want = pq.read_table(part).to_pylist()
    assert port_adam.read_genotypes_parquet(str(path)) == want
    assert port_adam.read_genotypes_parquet(str(path)) == \
        jax_adam.read_genotypes_parquet(str(path))
    assert any(r["alleles"] == [] for r in want)
    assert any(r["alleles"] is None for r in want)


# --- the port's writers -----------------------------------------------------


def _rows_and_metadata(directory):
    table = pq.read_table(os.path.join(directory, PART))
    meta = {k.decode(): v.decode() for k, v in table.schema.metadata.items()}
    return table.to_pylist(), {k: meta[k] for k in AVRO_KEYS}, table.schema


def test_write_adam_reads_back_as_the_jax_writers_rows(
        fixture_reads, tmp_path):
    reads, dictionary = fixture_reads
    jax_dir, port_dir = str(tmp_path / "jax.adam"), str(tmp_path / "port.adam")
    jax_adam.write_adam(jax_dir, reads[::56], dictionary)
    port_reads, _ = port_adam.read_adam(jax_dir)
    port_adam.write_adam(port_dir, port_reads, dictionary)
    want_rows, want_meta, want_schema = _rows_and_metadata(jax_dir)
    got_rows, got_meta, got_schema = _rows_and_metadata(port_dir)
    assert got_rows == want_rows
    assert got_meta == want_meta
    assert got_schema.remove_metadata() == want_schema.remove_metadata()
    assert os.path.exists(os.path.join(port_dir, "_SUCCESS"))


def _records(cls):
    return [
        cls(contig="chrM", start=72, ref="G", alt="A", sample_name="s1",
            genotype=("Ref", "Alt"), read_depth=30, reference_read_depth=14,
            alternate_read_depth=16, genotype_quality=99),
        cls(contig="chr2", start=1 << 33, ref="C", alt="T",
            genotype=("Alt", "Alt"), read_depth=7, alternate_read_depth=7),
        cls(contig="chr2", start=5, ref="A", alt="AC",
            genotype=("NoCall", "OtherAlt")),
        cls(contig="chr3", start=9, ref="T", alt="G", read_depth=0,
            reference_read_depth=0, alternate_read_depth=0),
    ]


@pytest.mark.parametrize("n_records", [4, 0])
def test_write_genotypes_reads_back_as_the_jax_writers_rows(
        tmp_path, n_records):
    jax_dir, port_dir = str(tmp_path / "jax.adam"), str(tmp_path / "port.adam")
    jax_adam.write_genotypes_parquet(_records(JaxVcfRecord)[:n_records],
                                     jax_dir)
    port_adam.write_genotypes_parquet(_records(PortVcfRecord)[:n_records],
                                      port_dir)
    want_rows, want_meta, want_schema = _rows_and_metadata(jax_dir)
    got_rows, got_meta, got_schema = _rows_and_metadata(port_dir)
    assert got_rows == want_rows
    assert got_meta == want_meta
    assert got_schema.field("expectedAlleleDosage").type == pa.float32()
    assert got_schema.remove_metadata() == want_schema.remove_metadata()
    assert port_adam.read_genotypes_parquet(port_dir) == want_rows


# --- through the CLI --------------------------------------------------------


@pytest.fixture(scope="module")
def cli_adam(fixture_reads, tmp_path_factory):
    """The fixture's reads on the shallow contig's first 80,000 bases
    (9,664 reads) as the JAX writer writes them, and the JAX CLI's
    germline-threshold outputs on it, VCF and genotype Parquet, from one
    JAX process."""
    reads, dictionary = fixture_reads
    keep = [r for r in reads if r.as_mapped_read is not None
            and r.as_mapped_read.reference_contig == "shallow8m"
            and r.as_mapped_read.start < 80_000]
    out = tmp_path_factory.mktemp("cli")
    adam = str(out / "reads.adam")
    jax_adam.write_adam(adam, keep, dictionary)
    vcf, geno = str(out / "jax.vcf"), str(out / "jax.genotypes.adam")
    code = (
        "import sys\n"
        "from guacamole_tpu.cli import main\n"
        "for out in sys.argv[2:]:\n"
        "    rc = main(['germline-threshold', '--reads', sys.argv[1],\n"
        "               '--threshold', '25', '--out', out])\n"
        "    assert rc == 0, rc\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code, adam, vcf, geno],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=ROOT,
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return {"adam": adam, "vcf": vcf, "genotypes": geno}


def _without_source(path):
    with open(path, "rb") as fh:
        return [ln for ln in fh if not ln.startswith(b"##source=")]


def test_germline_threshold_on_adam_equals_jax_cli(cli_adam, tmp_path):
    vcf, geno = str(tmp_path / "port.vcf"), str(tmp_path / "port.adam")
    for out in (vcf, geno):
        assert port_cli.main([
            "germline-threshold", "--reads", cli_adam["adam"],
            "--threshold", "25", "--out", out, "--device", "cpu",
            "--debug"]) == 0
    got, want = _without_source(vcf), _without_source(cli_adam["vcf"])
    assert got == want
    assert len([ln for ln in got if not ln.startswith(b"#")]) >= 10
    want_rows = pq.read_table(
        os.path.join(cli_adam["genotypes"], PART)).to_pylist()
    assert port_adam.read_genotypes_parquet(geno) == want_rows
    assert pq.read_table(os.path.join(geno, PART)).to_pylist() == want_rows


def test_without_pyarrow_adam_fails_with_one_line_and_bam_runs(
        cli_adam, fixture_bam, tmp_path):
    """pyarrow is a dependency of the ADAM paths alone: in a process where
    `import pyarrow` fails, germline-threshold on a .adam exits 1 with one
    line that names it, and the same command on a BAM runs."""
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "from guacamole_tpu_torch.cli import main\n"
        "reads, out = sys.argv[1:]\n"
        "sys.exit(main(['germline-threshold', '--reads', reads,\n"
        "               '--threshold', '25', '--out', out,\n"
        "               '--device', 'cpu']))\n"
    )

    def run(reads, out):
        return subprocess.run(
            [sys.executable, "-c", code, reads, str(tmp_path / out)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)

    adam = run(cli_adam["adam"], "adam.vcf")
    assert adam.returncode == 1, adam.stderr[-2000:]
    last = adam.stderr.strip().splitlines()[-1]
    assert last.startswith("guacamole-torch germline-threshold: error: "
                           "ImportError: ADAM Parquet I/O requires pyarrow")
    assert "Traceback" not in adam.stderr
    bam = run(fixture_bam, "bam.vcf")
    assert bam.returncode == 0, bam.stderr[-2000:]
    assert os.path.getsize(tmp_path / "bam.vcf") > 0
