"""The record parser of the port's native runtime on malformed records.

parse_bam_records (runtime/csrc/guac_runtime.cpp) bounds every field of a
record by its block (and its reference ids by the header) before it uses
it, and a decoder that refuses an input says why (guac_last_error). This
file holds that:

- every targeted mutant of tests/bam_mutants.py, made from the scale-0.02
  fixture's normal and germline BAMs, through the decode harness built
  with AddressSanitizer, in the whole-file decoder, the chunk decoder over
  the whole file and over the .bai chunks of the last record's locus: no
  sanitizer report, no abort, no handle, and a reason that names the
  field (for an MD tag that cannot be expanded, one mutant per MdTagError
  of reads/mdtag.py); the legal mutants (a CIGAR op of 2^28 - 1 bases, an
  MD tag over an N gap) decode, the N gap with the reference bases the
  object reader gives it;
- where the port's object reader (gio/bam.py) raises on the same file, it
  still does, with the same error: the two readers of the port agree;
- decode_bam_native raises ValueError naming the file and the field, and
  `guacamole-torch germline-threshold --device cpu` fails with one line
  and exit code 1, without reading the file again with the object reader;
- 200 seeded byte and int32 mutations of the normal BAM's records: no
  sanitizer report and no abort (a mutant may be accepted);
- decode_bam_chunks walks each .bai chunk to its end block or to the end
  of the file: the germline BAM cut in its last data block, over the
  clean file's .bai chunks, and chunks that start past the end of a file
  are refused, naming the chunk and its two virtual offsets (under ASan,
  and in streaming germline-threshold as one error line); so are chunks
  that end past the end of a file that lost whole trailing blocks at a
  record boundary, which the whole-file decoder reads with a warning;
  every
  well-formed .bai and fine-index chunk list of the three BAMs decodes
  the whole file's reads of its regions;
- a failed build of the runtime says why, with the compiler's last lines.
"""

import os
import struct
import subprocess
import sys

import pytest

import bam_mutants
import native_build
from guacamole_tpu_torch.gio.bai import (
    BamIndex,
    FineIndex,
    build_bam_index,
    optimize_chunks,
)
from guacamole_tpu_torch.gio.bam import BamFile
from guacamole_tpu_torch.reads.mdtag import get_reference
from guacamole_tpu_torch.runtime import native as port_native
from guacamole_tpu_torch.utils.simulate import make_scale_fixture

# The mutants inflate to under 2 MB; an accepted CIGAR op of 2^28 - 1
# bases sizes each event array at 256 MiB. A larger allocation sized
# itself from a corrupt field.
_ASAN = "detect_leaks=0:max_allocation_size_mb=512"


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The decode harness with -fsanitize=address, built once with the
    port's copy: one g++ per source side by side, then the link."""
    return native_build.build(tmp_path_factory.mktemp("asan"), {
        "address": native_build.DECODE_HARNESS})["address"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The fixture at scale 0.02, depth 0.05, seed 7: a normal BAM of 250
    reads in one data block, a germline BAM of 4,306 in 15."""
    out = str(tmp_path_factory.mktemp("small"))
    manifest = make_scale_fixture(out, scale=0.02, depth_scale=0.05, seed=7)
    return {k: os.path.join(out, v) for k, v in manifest["files"].items()}


def _run(harness, chunk_lists, paths, tmp_path, name):
    """{path: [(count, reason)]} of the harness over paths: the whole-file
    decoder, the chunk decoder over [0, size << 16), over each chunk list,
    and the SAM decoder."""
    chunks_file = tmp_path / f"{name}.chunks"
    chunks_file.write_text("".join(
        " ".join(f"{b} {e}" for b, e in chunks) + "\n"
        for chunks in chunk_lists))
    run = subprocess.run(
        [harness, str(chunks_file), *paths], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, ASAN_OPTIONS=_ASAN))
    assert "AddressSanitizer" not in run.stderr, run.stderr[-6000:]
    assert run.returncode == 0, run.stderr[-6000:]
    out = native_build.parse_decodes(run.stdout)
    assert sorted(out) == sorted(paths)
    return out


@pytest.fixture(scope="module")
def targeted(small, harness, tmp_path_factory):
    """Per sample: the clean BAM's decode, its mutants and their decodes
    (whole file, whole-file chunk, the .bai chunks of the last record's
    locus in the clean file, mapped onto the mutant)."""
    out = {}
    for sample in ("normal", "germline"):
        tmp = tmp_path_factory.mktemp(sample)
        clean = small[f"{sample}_bam"]
        bam = bam_mutants.read_bam(clean)
        bai = build_bam_index(clean, str(tmp / "clean.bai"))
        raw = list(BamFile(clean).raw_records())[-1][0]
        ref_id, pos = struct.unpack_from("<ii", raw, 0)
        chunks = optimize_chunks(
            [BamIndex(bai).chunks_for_region(ref_id, pos, pos + 1)])
        paths = bam_mutants.write_mutants(clean, str(tmp))
        decodes = _run(harness, [chunks], [clean], tmp, "clean")
        for name, path in paths.items():
            mapped = bam_mutants.chunks_of(bam, chunks, os.path.getsize(path))
            decodes.update(_run(harness, [mapped], [path], tmp, name))
        out[sample] = (clean, paths, decodes)
    return out


@pytest.mark.parametrize("sample", ["normal", "germline"])
@pytest.mark.parametrize("mutant", bam_mutants.MUTANTS, ids=lambda m: m.name)
def test_a_malformed_record_is_refused_with_its_field(
        targeted, sample, mutant):
    clean, paths, decodes = targeted[sample]
    want = decodes[clean]
    n_reads = want[0][0]
    assert n_reads > 0 and [n for n, _ in want[:3]] == [n_reads] * 2 + [
        want[2][0]] and want[2][0] > 0
    got = decodes[paths[mutant.name]]
    bam_calls, sam_call = got[:3], got[3]
    assert sam_call[0] == -1  # a BAM is no SAM text
    if mutant.field is None:
        # A legal record: decoded as before, in every mode.
        assert [n for n, _ in bam_calls] == [n for n, _ in want[:3]], got
        return
    for n, reason in bam_calls:
        assert n == -1, got
        assert mutant.field in reason, got
        assert "malformed BAM record at inflated byte" in reason, got


@pytest.mark.parametrize(
    "mutant", [m for m in bam_mutants.MUTANTS if m.object_reader_raises],
    ids=lambda m: m.name)
def test_the_object_reader_refuses_the_same_records(targeted, mutant):
    """gio/bam.py's reader raises on these mutants (struct.error or
    IndexError on a record's fields, MdTagError on its MD tag): the native
    decoder now refuses them too."""
    for sample in ("normal", "germline"):
        path = targeted[sample][1][mutant.name]
        with pytest.raises(mutant.object_reader_raises):
            list(BamFile(path).records())


@pytest.mark.parametrize("sample", ["normal", "germline"])
def test_an_md_tag_over_an_n_gap_decodes_as_the_object_reader_reads_it(
        targeted, sample):
    """The last record made 50M100N50M with MD 100: no decoder refuses it,
    and its reference bases and mismatches are the object reader's
    (get_reference with N over the gap, which MD does not cover)."""
    path = targeted[sample][1]["md_over_n_gap"]
    read = list(BamFile(path).records())[-1]
    assert [e.op_char for e in read.cigar] == ["M", "N", "M"]
    cols = port_native.decode_bam_native(path)
    i = len(cols["start"]) - 1
    mdref = bytes(cols["ev_mdref"][cols["ev_off"][i]:cols["ev_off"][i + 1]])
    assert mdref == get_reference(read.mdtag, read.sequence, read.cigar,
                                  allow_n_base=True)
    assert b"N" * 100 in mdref
    assert cols["mismatches"][i] == read.mdtag.count_of_mismatches


@pytest.mark.parametrize(
    "mutant", [m for m in bam_mutants.MUTANTS if m.field is not None],
    ids=lambda m: m.name)
def test_decode_bam_native_raises_naming_file_and_field(targeted, mutant):
    assert port_native.load_library() is not None
    path = targeted["germline"][1][mutant.name]
    with pytest.raises(ValueError) as refused:
        port_native.decode_bam_native(path)
    assert str(refused.value).startswith(f"{path}: ")
    assert mutant.field in str(refused.value)


@pytest.mark.parametrize("name", ["l_seq_2e24", "cigar_op_9", "md_deletion_length"])
def test_the_cli_fails_with_one_line(targeted, tmp_path, monkeypatch,
                                     capsys, name):
    """germline-threshold on a mutant: exit code 1 and one error line that
    names the file and the field; the object reader never reads the file
    (the JAX package's caller falls back to it where the native decoder
    returns no handle)."""
    from guacamole_tpu_torch import cli
    from guacamole_tpu_torch.gio import load

    def object_path(*_args, **_kwargs):
        raise AssertionError("the object reader read the file")

    monkeypatch.setattr(load, "load_read_set", object_path)
    mutant = next(m for m in bam_mutants.MUTANTS if m.name == name)
    path = targeted["normal"][1][name]
    rc = cli.main(["germline-threshold", "--reads", path, "--threshold",
                   "25", "--device", "cpu", "--out",
                   str(tmp_path / "out.vcf")])
    errors = [line for line in capsys.readouterr().err.splitlines()
              if line.startswith("guacamole-torch germline-threshold: error")]
    assert rc == 1
    assert len(errors) == 1, errors
    assert f"ValueError: {path}: " in errors[0] and mutant.field in errors[0]


# --- .bai chunks that cannot be walked --------------------------------------


def _contig_chunks(index, references, parts):
    """Per region, (ref_id, lo, hi) and its merged .bai chunks: every
    contig cut into `parts` equal regions."""
    out = []
    for rid, (_, length) in enumerate(references):
        step = -(-length // parts)
        for lo in range(0, length, step):
            hi = min(lo + step, length)
            out.append(((rid, lo, hi), optimize_chunks(
                [index.chunks_for_region(rid, lo, hi)])))
    return out


def _read_keys(cols, region=None):
    """Multiset of (ref_id, start, end, flags, seq) of the decoded reads,
    or of those that are mapped and overlap region (ref_id, lo, hi)."""
    keys = {}
    for i in range(len(cols["start"])):
        rid, start, end = (int(cols["ref_id"][i]), int(cols["start"][i]),
                           int(cols["end"][i]))
        if region is not None and not (
                rid == region[0] and not cols["flags"][i] & 4
                and start < region[2] and end > region[1]):
            continue
        seq = bytes(cols["seq"][cols["seq_off"][i]:cols["seq_off"][i + 1]])
        key = (rid, start, end, int(cols["flags"][i]), seq)
        keys[key] = keys.get(key, 0) + 1
    return keys


@pytest.mark.parametrize("sample", ["normal", "tumor", "germline"])
def test_every_well_formed_chunk_list_decodes_the_whole_files_records(
        small, tmp_path, sample):
    """The .bai and fine-index chunks of every contig, whole and cut into
    3 and 16 regions, over the scale-0.02 BAMs: no refusal; each region's
    decode holds every mapped read of the whole-file decode that overlaps
    it, and a whole contig's chunks decode exactly its reads."""
    path = small[f"{sample}_bam"]
    bai = build_bam_index(path, str(tmp_path / "x.bai"))
    whole = port_native.decode_bam_native(path)
    references = BamFile(path).references
    for index in (BamIndex(bai), FineIndex(bai + ".gli")):
        for parts in (1, 3, 16):
            for region, chunks in _contig_chunks(index, references, parts):
                got = _read_keys(port_native.decode_bam_native(
                    path, chunks=chunks))
                want = _read_keys(whole, region)
                assert all(got.get(k, 0) >= n for k, n in want.items()), (
                    region, parts)
    every = optimize_chunks([c for _, c in _contig_chunks(
        BamIndex(bai), references, 1)])
    assert _read_keys(port_native.decode_bam_native(
        path, chunks=every)) == _read_keys(whole)


@pytest.fixture(scope="module")
def cut(small, tmp_path_factory):
    """The germline BAM cut in the middle of its last data block, with the
    clean file's .bai beside it (an index older than its BAM); the chunks
    of every contig, whole, and of the last record's locus."""
    tmp = tmp_path_factory.mktemp("cut")
    clean = small["germline_bam"]
    bam = bam_mutants.read_bam(clean)
    path = str(tmp / "cut.bam")
    with open(path, "wb") as fh:
        fh.write(bam_mutants.cut_in_last_data_block(bam))
    bai = build_bam_index(clean, path + ".bai")
    index = BamIndex(bai)
    ref_id, pos = struct.unpack_from("<ii", bam.stream, bam.records[-1] + 4)
    every = optimize_chunks([c for _, c in _contig_chunks(
        index, BamFile(clean).references, 1)])
    last = optimize_chunks([index.chunks_for_region(ref_id, pos, pos + 1)])
    return path, bam, [every, last]


def _names_a_chunk(reason, chunk_lists):
    """The reason starts with `chunk K [B, E): ` of one of the lists."""
    head, _, _ = reason.partition("): ")
    k, _, offsets = head.removeprefix("chunk ").partition(" [")
    named = tuple(int(v) for v in offsets.split(", "))
    return any(int(k) < len(chunks) and tuple(chunks[int(k)]) == named
               for chunks in chunk_lists)


def test_a_bam_cut_in_its_last_data_block_is_refused_over_its_chunks(
        cut, harness, tmp_path):
    """Every decoder refuses the cut file, under AddressSanitizer: the
    whole-file decoder (a malformed block), the chunk decoder over the
    whole file and over each .bai chunk list (the block walk stops at the
    cut block's header before it reaches the chunk's end), naming the
    chunk and its two virtual offsets. None keeps the reads before the
    cut."""
    path, _, lists = cut
    calls = _run(harness, lists, [path], tmp_path, "cut")[path]
    whole, chunked = calls[0], calls[1:-1]
    assert whole == (-1, "malformed BGZF block"), calls
    size = os.path.getsize(path)
    for (n, reason), chunks in zip(chunked, [[(0, size << 16)]] + lists):
        assert n == -1, calls
        assert _names_a_chunk(reason, [chunks]), (reason, chunks)
        assert "no readable block header at compressed offset" in reason
    with pytest.raises(ValueError) as refused:
        port_native.decode_bam_native(path, chunks=lists[0])
    assert str(refused.value).startswith(f"{path}: chunk ")


def test_a_chunk_that_starts_past_the_end_of_the_file_is_refused(
        cut, harness, tmp_path):
    """The germline BAM cut before the block of its last record: the clean
    file's chunks of that record's locus start at the end of the file, or
    past it. The chunk decoder refuses them, naming the chunk; it skipped
    them before, and the reads were lost with exit code 0."""
    _, bam, lists = cut
    last = lists[1]
    path = str(tmp_path / "short.bam")
    with open(path, "wb") as fh:
        fh.write(bam.data[:last[0][0] >> 16])
    calls = _run(harness, [last], [path], tmp_path, "short")[path]
    n, reason = calls[2]
    assert n == -1 and _names_a_chunk(reason, [last]), calls
    assert "at or past the end of the file" in reason, calls


def test_the_streaming_cli_fails_with_one_line_on_the_cut_bam(
        cut, tmp_path, monkeypatch, capsys):
    """germline-threshold in streaming mode (the .bai beside the BAM, one
    decode per task) on the cut BAM: exit code 1, one error line naming
    the file and the chunk, no VCF. The whole-file path is never taken."""
    from guacamole_tpu_torch import cli
    from guacamole_tpu_torch.callers import common

    def whole_file(*_args, **_kwargs):
        raise AssertionError("the whole-file path read the file")

    monkeypatch.setattr(common, "load_read_source", whole_file)
    path = cut[0]
    out = tmp_path / "out.vcf"
    rc = cli.main(["germline-threshold", "--reads", path, "--threshold",
                   "25", "--parallelism", "2", "--device", "cpu", "--out",
                   str(out)])
    errors = [line for line in capsys.readouterr().err.splitlines()
              if line.startswith("guacamole-torch germline-threshold: error")]
    assert rc == 1
    assert len(errors) == 1, errors
    assert f"ValueError: {path}: chunk " in errors[0], errors
    assert not out.exists()


@pytest.fixture(scope="module")
def cut_at_boundary(small, tmp_path_factory):
    """The germline BAM written with record-aligned blocks, as htslib
    writes it, then cut after a block, its last data block and the EOF
    marker short, with the whole file's .bai beside it; the chunks of
    every contig, whole, and of the last record's locus."""
    tmp = tmp_path_factory.mktemp("boundary")
    bam = bam_mutants.read_bam(small["germline_bam"])
    clean, cut = bam_mutants.cut_at_block_boundary(bam)
    clean_path, path = str(tmp / "clean.bam"), str(tmp / "cut.bam")
    for name, data in ((clean_path, clean), (path, cut)):
        with open(name, "wb") as fh:
            fh.write(data)
    index = BamIndex(build_bam_index(clean_path, path + ".bai"))
    ref_id, pos = struct.unpack_from("<ii", bam.stream, bam.records[-1] + 4)
    every = optimize_chunks([c for _, c in _contig_chunks(
        index, BamFile(clean_path).references, 1)])
    last = optimize_chunks([index.chunks_for_region(ref_id, pos, pos + 1)])
    return path, clean_path, [every, last]


def test_a_bam_cut_at_a_block_boundary_is_refused_over_its_chunks(
        cut_at_boundary, harness, tmp_path, capfd):
    """The cut file's .bai chunks end past its end (the chunk of every
    contig) or start there (the last record's): the chunk decoder refuses
    both under AddressSanitizer, naming the chunk; it took the first before
    and lost the reads of the lost block. Nothing else can tell the cut:
    the whole-file decoder and the chunk over the whole file read the kept
    records, as the object reader does, and the whole-file decoder warns
    on stderr that the EOF marker is missing."""
    path, clean_path, lists = cut_at_boundary
    kept = sum(1 for _ in BamFile(path).records())
    assert 0 < kept < sum(1 for _ in BamFile(clean_path).records())
    calls = _run(harness, lists, [path], tmp_path, "boundary")[path]
    assert calls[:2] == [(kept, ""), (kept, "")], calls
    (n_every, every), (n_last, last) = calls[2:4]
    assert n_every == -1 and _names_a_chunk(every, lists[:1]), calls
    assert "past the end of the file" in every, calls
    assert n_last == -1 and _names_a_chunk(last, lists[1:]), calls
    with pytest.raises(ValueError) as refused:
        port_native.decode_bam_native(path, chunks=lists[0])
    assert str(refused.value).startswith(f"{path}: chunk ")
    capfd.readouterr()
    assert len(port_native.decode_bam_native(path)["start"]) == kept
    assert capfd.readouterr().err == (
        f"warning: {path}: no BGZF EOF marker, the file may be truncated\n")
    port_native.decode_bam_native(clean_path)
    assert capfd.readouterr().err == ""


def test_the_streaming_cli_fails_with_one_line_on_a_bam_cut_at_a_block_boundary(
        cut_at_boundary, tmp_path, monkeypatch, capsys):
    """germline-threshold in streaming mode (one task: with more, the
    chunks' ends past the file make the streaming guard take the whole-file
    path, which cannot tell the cut) on the BAM cut at a block boundary:
    exit code 1, one error line naming the file and the chunk, no VCF
    (before, exit code 0 and a VCF without the lost reads)."""
    from guacamole_tpu_torch import cli
    from guacamole_tpu_torch.callers import common

    def whole_file(*_args, **_kwargs):
        raise AssertionError("the whole-file path read the file")

    monkeypatch.setattr(common, "load_read_source", whole_file)
    path = cut_at_boundary[0]
    out = tmp_path / "out.vcf"
    rc = cli.main(["germline-threshold", "--reads", path, "--threshold",
                   "25", "--parallelism", "1", "--device", "cpu", "--out",
                   str(out)])
    errors = [line for line in capsys.readouterr().err.splitlines()
              if line.startswith("guacamole-torch germline-threshold: error")]
    assert rc == 1
    assert len(errors) == 1, errors
    assert f"ValueError: {path}: chunk " in errors[0], errors
    assert not out.exists()


def test_random_record_mutations_read_no_byte_outside_the_record(
        small, harness, tmp_path):
    """200 seeded single-byte and int32 mutations in the normal BAM's
    record area: whatever the decoders make of them, no sanitizer report
    and no abort; a refusal always says why."""
    mutants = bam_mutants.random_mutants(
        small["normal_bam"], str(tmp_path), 200)
    decodes = _run(harness, [], [p for p, _ in mutants], tmp_path, "fuzz")
    refused = 0
    for path, what in mutants:
        calls = decodes[path]
        assert len(calls) == 3, (what, calls)  # whole, whole chunk, SAM
        for n, reason in calls:
            assert n >= 0 or reason, (what, calls)
        refused += calls[0][0] == -1
    # Most mutations of a record's fixed fields and lengths are refused;
    # one in a base or quality is not.
    assert 0 < refused < len(mutants), refused


def test_a_failed_build_says_why(tmp_path, monkeypatch, capsys):
    """_try_build with a compiler that fails: False, no library, and one
    progress message with the last 20 lines of its errors."""
    compiler = tmp_path / "cxx"
    compiler.write_text(
        "#!/bin/sh\nfor i in $(seq 1 30); do echo \"error line $i\" >&2; "
        "done\nexit 1\n")
    compiler.chmod(0o755)
    monkeypatch.setenv("CXX", str(compiler))
    lib = tmp_path / "lib.so"
    assert port_native._try_build(str(lib)) is False
    assert not lib.exists()
    err = capsys.readouterr().err
    assert "did not build" in err and "CalledProcessError" in err
    assert "error line 11\n" in err and "error line 30\n" in err
    assert "error line 10\n" not in err
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_every_refusal_says_why(harness, tmp_path):
    """A file that is neither BGZF nor SAM text: every decoder refuses,
    each with its reason."""
    decodes = _run(harness, [], [sys.executable], tmp_path, "binary")
    calls = decodes[sys.executable]
    assert [n for n, _ in calls] == [-1, -1, -1]
    assert calls[0][1] == "malformed BGZF block", calls
    assert all(reason for _, reason in calls), calls
