"""The SAM parser of the port's native runtime on malformed lines.

parse_sam_text (runtime/csrc/guac_runtime.cpp) reads every numeric field
of a SAM whole and holds it to its range in the SAM spec (FLAG, POS,
MAPQ, PNEXT, TLEN, @SQ LN), bounds max(POS - 1, 0) + CIGAR span by
2^31 - 1 as the BAM parser does, holds QNAME, RNAME, RNEXT, CIGAR, SEQ and
QUAL to the bytes SAMv1 section 1.4 allows them and every optional field
to TAG:TYPE:VALUE (a line that joins two records fails there), refuses a
placed read's MD tag where reads/mdtag.py's MdTag raises, and names the
field and the line of a refusal. This file holds that:

- every targeted mutant of tests/sam_mutants.py, made from the scale-0.02
  fixture's normal and germline SAMs, through the decode harness built
  with AddressSanitizer: no sanitizer report, no handle, and a reason that
  names the field and the line;
- 200 seeded byte and field mutations of the normal SAM's record lines:
  no sanitizer report and no abort, a reason for every refusal;
- the port's object reader (gio/sam.py) against the native decoder: where
  the object reader raises, the native decoder refuses; where the native
  decoder accepts, its mapped reads' columns equal the object reader's;
- well-formed input as before: values at the ends of the ranges and CRLF
  line ends decode to the JAX library's columns;
- decode_sam_native raises ValueError naming the file, the field and the
  line, and `guacamole-torch germline-threshold --device cpu` fails with
  one line and exit code 1;
- an MD tag over an N gap decodes, with the reference bases the object
  reader gives the read.
"""

import os
import subprocess

import numpy as np
import pytest

import native_build
import sam_mutants
from guacamole_tpu.runtime import columnar as jax_columnar
from guacamole_tpu_torch.gio.load import load_read_set
from guacamole_tpu_torch.reads.mdtag import get_reference
from guacamole_tpu_torch.reads.read import InputFilters
from guacamole_tpu_torch.runtime import columnar as port_columnar
from guacamole_tpu_torch.runtime import native as port_native
from guacamole_tpu_torch.utils.simulate import make_scale_fixture
from test_torch_native import _assert_same_columns

# These inputs decode to under 2 MB; a larger allocation sized itself from
# a field.
_ASAN = "detect_leaks=0:max_allocation_size_mb=64"


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The decode harness with -fsanitize=address, built once with the
    port's copy."""
    return native_build.build(tmp_path_factory.mktemp("asan"), {
        "address": native_build.DECODE_HARNESS})["address"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The fixture at scale 0.02, depth 0.05, seed 7: a normal SAM of 250
    records, a germline SAM of 4,306."""
    out = str(tmp_path_factory.mktemp("small"))
    manifest = make_scale_fixture(out, scale=0.02, depth_scale=0.05, seed=7)
    return {k: os.path.join(out, v) for k, v in manifest["files"].items()}


def _run(harness, paths):
    """{path: [(count, reason)]} of the harness over paths: the whole-file
    BAM decoder, the chunk decoder over the whole file, the SAM decoder."""
    run = subprocess.run(
        [harness, os.devnull, *paths], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, ASAN_OPTIONS=_ASAN))
    assert "AddressSanitizer" not in run.stderr, run.stderr[-6000:]
    assert run.returncode == 0, run.stderr[-6000:]
    out = native_build.parse_decodes(run.stdout)
    assert sorted(out) == sorted(paths)
    return out


@pytest.fixture(scope="module")
def targeted(small, harness, tmp_path_factory):
    """Per sample: the clean SAM, {mutant: (path, line)} and the harness's
    decodes of all of them."""
    out = {}
    for sample in ("normal", "germline"):
        clean = small[sample]
        paths = sam_mutants.write_mutants(
            clean, str(tmp_path_factory.mktemp(sample)))
        decodes = _run(harness, [clean] + [p for p, _ in paths.values()])
        out[sample] = (clean, paths, decodes)
    return out


@pytest.mark.parametrize("sample,n_reads", [("normal", 250),
                                            ("germline", 4_306)])
@pytest.mark.parametrize("mutant", sam_mutants.MUTANTS, ids=lambda m: m.name)
def test_a_malformed_field_is_refused_with_its_field_and_line(
        targeted, sample, n_reads, mutant):
    clean, paths, decodes = targeted[sample]
    assert decodes[clean][-1] == (n_reads, "")
    path, line_no = paths[mutant.name]
    got = decodes[path]
    assert [n for n, _ in got[:2]] == [-1, -1]  # a SAM is no BGZF file
    n, reason = got[-1]
    assert n == -1, got
    what = "header" if mutant.header else "record"
    assert reason.startswith(f"malformed SAM {what} at line {line_no}: "), got
    assert mutant.field in reason, got


def test_random_sam_mutations_read_no_byte_outside_the_text(
        small, harness, tmp_path):
    """200 seeded mutations of the normal SAM's record lines: whatever the
    SAM decoder makes of them, no sanitizer report and no abort; a refusal
    always says why, with its line."""
    mutants = sam_mutants.random_mutants(small["normal"], str(tmp_path), 200)
    decodes = _run(harness, [p for p, _ in mutants])
    refused = 0
    for path, what in mutants:
        n, reason = decodes[path][-1]
        if n == -1:
            assert reason.startswith("malformed SAM record at line "), (
                what, reason)
            refused += 1
        else:
            assert n > 0 and reason == "", (what, n, reason)
    # Every field mutation but a few in-range values is refused; most
    # flipped bytes (bases, qualities, names) are not.
    assert 0 < refused < len(mutants), refused


def _assert_same_as_object_reader(path):
    """The native decode's mapped reads against the object reader's, read
    by read (the oracle of tests/test_runtime.py)."""
    native = port_columnar.decode_sam_columnar(path)
    native = native.select(native.is_mapped_mask).compact()
    reads = load_read_set(path, InputFilters.empty).reads
    oracle = port_columnar.columnar_from_reads(
        [r.as_mapped_read for r in reads if r.is_mapped])
    assert native.n == oracle.n
    for field in ("start", "end", "mapq", "mismatches", "seq_off", "seq",
                  "qual", "cigar_off", "cigar_len", "cigar_op", "md_off",
                  "md_text", "ev_off", "ev_kind", "ev_base", "ev_qual",
                  "ev_mdref"):
        np.testing.assert_array_equal(getattr(native, field),
                                      getattr(oracle, field), err_msg=field)
    # paired, reverse, duplicate and vendor-failed bits
    np.testing.assert_array_equal(native.flags_ & 0x611,
                                  oracle.flags_ & 0x611)
    assert [native.ref_names[i] for i in native.ref_id] == [
        oracle.ref_names[i] for i in oracle.ref_id]
    assert [native.samples[i] for i in native.sample_id] == [
        oracle.samples[i] for i in oracle.sample_id]


def _object_reader_raises(path):
    try:
        load_read_set(path, InputFilters.empty)
    except Exception:  # noqa: BLE001 - ValueError, MdTagError
        return True
    return False


@pytest.mark.parametrize("mutant", sam_mutants.MUTANTS, ids=lambda m: m.name)
def test_the_object_reader_and_the_native_decoder_agree(targeted, mutant):
    """Where gio/sam.py raises (fields that are no numbers; an MD tag that
    does not fit its CIGAR; a SEQ byte that is no UTF-8, a CIGAR with
    whitespace), the native decoder refuses too. The mutants it accepts
    (FLAG 70000, MAPQ 300 and -1, POS 2^31; a line that joins two records,
    whose second QNAME it skips as no tag; bytes SAMv1 excludes from QNAME,
    RNAME, RNEXT and QUAL) the native decoder refuses: ROADMAP.md section
    3, known differences."""
    for sample in ("normal", "germline"):
        path, _ = targeted[sample][1][mutant.name]
        assert _object_reader_raises(path) == mutant.object_reader_raises
        assert targeted[sample][2][path][-1][0] == -1


@pytest.mark.parametrize("sample", ["normal", "germline"])
def test_a_clean_sam_decodes_as_the_object_reader_reads_it(small, sample):
    _assert_same_as_object_reader(small[sample])


def test_random_mutants_that_both_readers_take_decode_alike(small, tmp_path):
    """The random mutants of the normal SAM: where a numeric field's new
    value makes the object reader raise, the native decoder refuses; where
    both readers take a mutant, they read the same mapped reads. (A flipped
    byte that is no UTF-8 in an optional field's value, RG's say, makes
    the object reader raise where the native decoder reads the line:
    ROADMAP.md section 3.)"""
    both = 0
    for path, what in sam_mutants.random_mutants(small["normal"],
                                                 str(tmp_path), 200):
        try:
            port_native.decode_sam_native(path)
            native_reads = True
        except ValueError:
            native_reads = False
        if _object_reader_raises(path):
            assert not (what.startswith("line ") and native_reads), what
        elif native_reads:
            both += 1
            try:
                _assert_same_as_object_reader(path)
            except AssertionError as exc:
                raise AssertionError(what) from exc
    assert both > 0


def _set_fields(text, back, values):
    """text with fields of a record line set ({field index: value}): the
    last record line, or the one `back` lines before it."""
    lines = text.split("\n")
    i = sam_mutants.target_line(lines, header=False) - back
    fields = lines[i].split("\t")
    for index, value in values.items():
        fields[index] = value
    lines[i] = "\t".join(fields)
    return "\n".join(lines)


@pytest.mark.parametrize("form", ["ends_of_ranges", "crlf"])
def test_well_formed_sam_decodes_as_before(small, tmp_path, form):
    """Values at the ends of their ranges (FLAG 65535 with the unmapped
    bit, MAPQ 255, PNEXT 2^31 - 1, TLEN -(2^31 - 1); FLAG 0, MAPQ 0, TLEN
    2^31 - 1, a signed +0 POS: an unplaced read), and CRLF line ends: the
    same columns as the JAX package's library, which read them with
    strtol."""
    with open(small["normal"]) as fh:
        text = fh.read()
    if form == "ends_of_ranges":
        text = _set_fields(text, 0, {1: "65535", 4: "255", 7: "2147483647",
                                     8: "-2147483647"})
        text = _set_fields(text, 1, {1: "0", 3: "+0", 4: "0",
                                     8: "2147483647"})
    else:
        text = text.replace("\n", "\r\n")
    path = tmp_path / f"{form}.sam"
    path.write_bytes(text.encode())
    port = port_columnar.decode_sam_columnar(str(path))
    _assert_same_columns(port, jax_columnar.decode_sam_columnar(str(path)))
    assert port.n == 250
    if form == "crlf":
        assert port.ref_lengths == [20_000]


@pytest.mark.parametrize("mutant", sam_mutants.MUTANTS, ids=lambda m: m.name)
def test_decode_sam_native_raises_naming_file_field_and_line(
        targeted, mutant):
    assert port_native.load_library() is not None
    path, line_no = targeted["germline"][1][mutant.name]
    with pytest.raises(ValueError) as refused:
        port_native.decode_sam_native(path)
    message = str(refused.value)
    assert message.startswith(f"{path}: malformed SAM ")
    assert f" at line {line_no}: " in message and mutant.field in message


@pytest.mark.parametrize("sample", ["normal", "germline"])
def test_an_md_tag_over_an_n_gap_decodes_as_the_object_reader_reads_it(
        small, tmp_path, sample):
    """The last record made 50M100N50M with MD 100: the SAM decoder takes
    it; the mapped reads' columns are the object reader's, and the read's
    reference bases are get_reference's, N over the gap."""
    with open(small[sample]) as fh:
        text = _set_fields(fh.read(), 0, {5: "50M100N50M", 11: "MD:Z:100"})
    path = tmp_path / "gap.sam"
    path.write_text(text)
    _assert_same_as_object_reader(str(path))
    read = load_read_set(str(path), InputFilters.empty).reads[-1]
    assert [e.op_char for e in read.cigar] == ["M", "N", "M"]
    assert str(read.mdtag) == "100"
    cols = port_native.decode_sam_native(str(path))
    i = len(cols["start"]) - 1
    mdref = bytes(cols["ev_mdref"][cols["ev_off"][i]:cols["ev_off"][i + 1]])
    assert mdref == get_reference(read.mdtag, read.sequence, read.cigar,
                                  allow_n_base=True)
    assert b"N" * 100 in mdref


@pytest.mark.parametrize("name", ["mapq_300", "pos_12abc", "md_deletion_length",
                                  "joined_line", "seq_0x80"])
def test_the_cli_fails_with_one_line(targeted, tmp_path, capsys, name):
    """germline-threshold on a SAM mutant: exit code 1, one error line that
    names the file, the field and the line, and no VCF."""
    from guacamole_tpu_torch import cli

    mutant = next(m for m in sam_mutants.MUTANTS if m.name == name)
    path, line_no = targeted["normal"][1][name]
    out = tmp_path / "out.vcf"
    rc = cli.main(["germline-threshold", "--reads", path, "--threshold",
                   "25", "--device", "cpu", "--out", str(out)])
    errors = [line for line in capsys.readouterr().err.splitlines()
              if line.startswith("guacamole-torch germline-threshold: error")]
    assert rc == 1
    assert len(errors) == 1, errors
    assert f"ValueError: {path}: malformed SAM record at line {line_no}: " \
        in errors[0] and mutant.field in errors[0]
    assert not out.exists()
