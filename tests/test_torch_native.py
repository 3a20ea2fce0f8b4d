"""The port's own copy of the native host runtime (runtime/csrc/).

guacamole_tpu_torch builds its BGZF/BAM/SAM decoder and tile packer from
its own copy of native/guac_runtime.cpp and native/guac_pack.cpp, shipped
in the package. This file holds that copy:

- equal to native/*.cpp after the package rename, outside the hunks of
  tests/native_repairs/*.diff, each of which states its reason;
- free of out-of-bounds reads on malformed input: a standalone harness
  (tests/native_decode_harness.cpp) built from the copy with
  AddressSanitizer runs guac_decode_bam, guac_decode_bam_chunks (one
  chunk over the whole file, .bai chunks, among them a task's list of 8
  chunks or more, and chunks that start inside a block) and
  guac_decode_sam over crafted, truncated and mutated inputs,
  with no sanitizer report, and the whole-file decoder returns no handle
  wherever the input is malformed (malformed records:
  tests/test_torch_native_records.py);
- free of data races in the packer and the event builder: a second
  harness (tests/native_pack_harness.cpp) built from the copy with
  ThreadSanitizer packs the fixture's contigs on the packer's threads in
  each of its four modes (whole contigs for the CSR mode, windows for the
  dense ones), rebuilds the event arrays with guac_build_events on 16
  threads and decodes a task's list of nine .bai chunks with
  guac_decode_bam_chunks on 16 threads, with no sanitizer report;
- equal to the JAX package's library on well-formed input, column for
  column (whole file, .bai chunks, a task's list of nine .bai chunks,
  SAM), decoded where malloc fills every allocation with a byte that is
  not 0, so that no byte a decoder sizes is left unwritten; that list, which guac_decode_bam_chunks decodes in one pass, equal
  to its chunks decoded one by one, one after another; a malformed record
  in its ninth chunk refused naming that chunk, as a decode of the chunk
  alone names it;
- enough on its own: the package, copied alone into a directory with no
  repo around it, builds its library from its own sources and decodes.
"""

import dataclasses
import itertools
import json
import os
import pickle
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

import bam_mutants
from guacamole_tpu.runtime import columnar as jax_columnar
from guacamole_tpu.runtime import native as jax_native
from guacamole_tpu.utils.simulate import make_scale_fixture
from guacamole_tpu_torch.callers.streaming import ensure_bam_index
from guacamole_tpu_torch.gio.bai import BamIndex, optimize_chunks
from guacamole_tpu_torch.runtime import columnar as port_columnar
from guacamole_tpu_torch.runtime import native as port_native
import native_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(ROOT, "guacamole_tpu_torch")

# The copy's departures from native/*.cpp are the hunks of
# tests/native_repairs/<name>.diff, each with its reason: each BGZF header
# walk is bounded by its buffer, each field of a BAM or SAM record by its
# block and by its range in the spec; a .bai chunk that cannot be walked
# to its end, or that ends past the file, is refused, and so are an MD tag
# that cannot be expanded and SAM text that is not SAM text; every refusal
# says why. On well-formed input none of the checks fails,
# so the outputs are the original's. The packer reads its table of long
# allele keys under the lock its writers hold, which orders the same
# reads. After a change to the copy, `python tests/native_build.py
# --write-repairs` writes the diffs anew, and each new hunk needs its
# reason.


@pytest.mark.parametrize("name", port_native.SOURCES)
def test_copy_equals_native_outside_the_listed_repairs(name):
    """The stored diff is the one the sources give, hunk for hunk: ranges
    and lines (the reasons are not compared)."""
    def lines(hunks):
        return [(h.ranges, h.was, h.now) for h in hunks]

    assert lines(native_build.read_repairs(name)) == lines(
        native_build.repair_hunks(name))


@pytest.mark.parametrize("name", port_native.SOURCES)
def test_every_listed_repair_says_why(name):
    hunks = native_build.read_repairs(name)
    assert hunks and [h.ranges for h in hunks if not h.reason] == []


# --- the copy under AddressSanitizer -------------------------------------

# The header bytes the decoders read: ID1 ID2 (0, 1), XLEN (10, 11), and the
# BC subfield SI1 SI2 SLEN BSIZE (12-17); of FLG (3) only FEXTRA (bit 2).
_READ_BYTES = {0, 1, *range(10, 18)}


@pytest.fixture(scope="module")
def harnesses(tmp_path_factory):
    """The decode harness with -fsanitize=address and the pack harness with
    -fsanitize=thread, each built once with the port's copy: every g++ of
    both side by side, then the two links."""
    exes = native_build.build(tmp_path_factory.mktemp("sanitized"), {
        "address": native_build.DECODE_HARNESS,
        "thread": native_build.PACK_HARNESS})
    return {"asan": exes["address"], "tsan": exes["thread"]}


@pytest.fixture(scope="module")
def harness(harnesses):
    return harnesses["asan"]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The fixture at scale 0.02, depth 0.05, seed 7. Its normal BAM
    (10,509 bytes, 250 reads) is one data block and the EOF block; its
    germline BAM (101,728 bytes, 4,306 reads) has 15 blocks, so a chunk's
    block walk crosses many headers."""
    out = str(tmp_path_factory.mktemp("small"))
    manifest = make_scale_fixture(out, scale=0.02, depth_scale=0.05, seed=7)
    assert manifest["counts"]["normal"] == 250
    return {k: os.path.join(out, v) for k, v in manifest["files"].items()}


@pytest.fixture(scope="module")
def denser(tmp_path_factory):
    """The fixture at scale 0.02, depth 0.25, seed 7: its germline BAM
    (386,829 bytes, 21,146 reads) is dense enough that reads straddle the
    .bai's 16 kbp bins, so the chunk list of a task's loci holds the
    fragments of the bins above them, as at full depth."""
    out = str(tmp_path_factory.mktemp("denser"))
    manifest = make_scale_fixture(out, scale=0.02, depth_scale=0.25, seed=7)
    assert manifest["counts"]["germline"] == 21_146
    return {k: os.path.join(out, v) for k, v in manifest["files"].items()}


def _block_offsets(data: bytes):
    """Start of every BGZF block of a well-formed file."""
    starts, off = [], 0
    while off < len(data):
        (xlen,) = struct.unpack_from("<H", data, off + 10)
        assert xlen == 6 and data[off + 12:off + 14] == b"BC"
        (bsize,) = struct.unpack_from("<H", data, off + 16)
        starts.append(off)
        off += bsize + 1
    assert off == len(data)
    return starts


def _bgzf_header(xlen: int, extra: bytes) -> bytes:
    return bytes([0x1F, 0x8B, 8, 4, 0, 0, 0, 0, 0, 0xFF]) + struct.pack(
        "<H", xlen) + extra


def _inputs(bam_path, sam_path, n_mutants, out):
    """(path, kind) of every input made from one BAM (and its SAM):
    'clean' (well-formed), 'malformed', 'read-bytes' / 'read-bytes0' (a
    mutation of header bytes the decoders read, past the header block / in
    it), 'ignored' (a mutation of bytes they skip: CM, MTIME, XFL, OS, FLG
    outside FEXTRA), 'sam' (SAM text, whole or cut)."""
    with open(bam_path, "rb") as fh:
        bam = fh.read()
    starts = _block_offsets(bam)
    inputs = [(bam_path, "clean")]

    def write(name, data, kind):
        path = os.path.join(out, name)
        with open(path, "wb") as fh:
            fh.write(data)
        inputs.append((path, kind))

    # A last header whose XLEN (0xFFFF) runs past the end of the file.
    write("xlen.bam", bam + _bgzf_header(0xFFFF, bytes(16)), "malformed")
    # A last header whose BC subfield's BSIZE lies past the end of the file.
    extra = b"XX" + struct.pack("<H", 8) + bytes(8) + b"BC" + struct.pack(
        "<H", 2)
    write("bsize.bam", bam + _bgzf_header(16, extra), "malformed")
    # A first block whose BSIZE (1) does not cover its own header: its
    # footer would lie before the buffer and its deflate data would have a
    # negative length.
    write("short.bam", bam[:16] + b"\0\0" + bam[18:], "read-bytes0")
    for cut in range(1, 65):
        kind = "clean" if len(bam) - cut in starts else "malformed"
        write(f"cut{cut}.bam", bam[:-cut], kind)
    rng = np.random.default_rng(2026)
    for i in range(n_mutants):
        data = bytearray(bam)
        picks = rng.choice(len(starts) * 18, size=int(rng.integers(1, 4)),
                           replace=False)
        hit = set()  # blocks with a mutated byte that the decoders read
        for pick in picks:
            block, byte = divmod(int(pick), 18)
            flip = int(rng.integers(1, 256))
            data[starts[block] + byte] ^= flip
            if byte in _READ_BYTES or (byte == 3 and flip & 4):
                hit.add(block)
        kind = ("ignored" if not hit else
                "read-bytes0" if 0 in hit else "read-bytes")
        write(f"mut{i}.bam", bytes(data), kind)
    with open(sam_path, "rb") as fh:
        sam = fh.read()
    inputs.append((sam_path, "sam"))
    for cut in range(1, 65):
        write(f"cut{cut}.sam", sam[:-cut], "sam")
    return inputs, bam


def _chunk_lists(bam_path, bam, tasks):
    """Chunk lists for guac_decode_bam_chunks: the merged .bai chunks of
    each task's regions, as the streaming callers build a task's list, and
    three single chunks that start inside a block (a .bai whose virtual
    offsets do not land on a block)."""
    index = BamIndex(ensure_bam_index(bam_path))
    lists = [optimize_chunks([index.chunks_for_region(*region)
                              for region in task])
             for task in tasks]
    starts = set(_block_offsets(bam))
    inside = [c for c in (1, 3_001, len(bam) // 2 + 7) if c not in starts]
    return lists + [[(c << 16, len(bam) << 16)] for c in inside]


@pytest.mark.parametrize("fixture,sample,mutants,regions", [
    # the input of the reproduction: one data block
    pytest.param("small", "normal", 300, (
        ((0, 0, 5_000),), ((0, 5_000, 12_000),), ((0, 15_000, 20_000),)),
        id="normal-300-regions0"),
    # 15 blocks, regions on both contigs
    pytest.param("small", "germline", 200, (
        ((0, 0, 5_000),), ((0, 6_000, 8_000),), ((1, 40_000, 70_000),)),
        id="germline-200-regions1"),
    # 20 blocks; a task's three 16 kbp windows, whose list of 8 chunks
    # ends in the fragments of higher bins and the file's last records
    pytest.param("denser", "germline", 240, (
        ((0, 0, 16_384), (1, 0, 16_384), (1, 147_456, 163_840)),),
        id="task-240-regions2"),
])
def test_copy_reads_no_byte_outside_its_buffers(
        harness, request, tmp_path, fixture, sample, mutants, regions):
    files = request.getfixturevalue(fixture)
    bam_path = files[f"{sample}_bam"]
    inputs, bam = _inputs(bam_path, files[sample], mutants, str(tmp_path))
    lists = _chunk_lists(bam_path, bam, regions)
    assert max(len(chunks) for chunks in lists[:len(regions)]) >= (
        8 if fixture == "denser" else 1)
    chunks_file = tmp_path / "chunks.txt"
    chunks_file.write_text("".join(
        " ".join(f"{b} {e}" for b, e in chunk_list) + "\n"
        for chunk_list in lists))
    # An allocation above 64 MiB is a report too: these inputs inflate to
    # less than 2 MB, so a larger one sized itself from a corrupt ISIZE.
    env = dict(os.environ,
               ASAN_OPTIONS="detect_leaks=0:max_allocation_size_mb=64")
    run = subprocess.run(
        [harness, str(chunks_file), *(p for p, _ in inputs)],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert "AddressSanitizer" not in run.stderr, run.stderr[-6000:]
    assert run.returncode == 0, run.stderr[-6000:]
    counts = {path: [n for n, _ in calls] for path, calls in
              native_build.parse_decodes(run.stdout).items()}
    assert len(counts) == len(inputs)
    # Per input: the whole-file decoder, the whole-file chunk, each chunk
    # list, the SAM decoder.
    clean = counts[bam_path]
    n_reads = clean[0]
    assert clean[1] == n_reads > 0 and clean[-1] == -1
    assert all(0 < n <= n_reads for n in clean[2:2 + len(regions)]), clean
    for path, kind in inputs:
        got = counts[path]
        bam_call, chunk_calls, sam_call = got[0], got[1:-1], got[-1]
        if kind == "sam":
            assert bam_call == -1 and set(chunk_calls) == {-1}, path
            assert sam_call in (-1, n_reads), (path, sam_call)
            continue
        assert sam_call == -1, path  # a BAM is no SAM text
        if kind in ("clean", "ignored"):
            assert got == clean, (path, got)
        elif kind == "read-bytes0":
            # The header block is malformed: no decoder gives a handle.
            assert bam_call == -1 and set(chunk_calls) == {-1}, (path, got)
        else:
            # Malformed past the header block: the whole-file decoder
            # refuses; a chunk decoder keeps the records of the blocks
            # before the fault, never more.
            assert bam_call == -1, (path, got)
            for n, want in zip(chunk_calls, clean[1:-1]):
                assert n == -1 or 0 <= n <= want, (path, got)
    kinds = [k for _, k in inputs]
    for kind in ("read-bytes", "read-bytes0", "ignored"):
        assert kinds.count(kind) >= 5, (kind, kinds.count(kind))


# --- the packer's threads under ThreadSanitizer ---------------------------


# The harness's arguments after the mode: WINDOW WINDOWS THREADS [START PAD
# MIN_MAPQ]. The dense modes pack windows of the dense route's smallest
# tile (4,096 loci; a full [L, D] tile of a whole deep contig is too
# large), the first eight of each contig; the tumor screen's mode packs the
# tumor BAM. Windows of 16,384 loci besides, each with 37 sentinel rows
# past its loci and the elements of reads under MAPQ 20 filtered.
_DENSE_WINDOW = ("4096", "8", "16")
_WHOLE = ("0", "0", "16")
_PADDED_WINDOWS = ("16384", "4", "16", "0", "37", "20")


@pytest.mark.parametrize("fixture,sample,mode,args", [
    pytest.param("small", "germline_bam", 1, _WHOLE, id="small"),
    pytest.param("fx", "germline_bam", 1, _WHOLE, id="fx"),
    pytest.param("small", "germline_bam", 0, _DENSE_WINDOW, id="full"),
    pytest.param("small", "germline_bam", 2, _DENSE_WINDOW, id="likelihood"),
    pytest.param("small", "tumor_bam", 3, _DENSE_WINDOW,
                 id="likelihood_mapq"),
    pytest.param("fx", "germline_bam", 1, _PADDED_WINDOWS,
                 id="csr_windows"),
    pytest.param("small", "germline_bam", 2, _PADDED_WINDOWS,
                 id="likelihood_windows"),
])
def test_copy_packs_without_a_data_race(
        harnesses, request, fixture, sample, mode, args):
    """The packer's passes run one thread per block of rows. In the CSR
    pass (mode 1) every thread interns the long keys of its insertions and
    deletions into one table; a row that reads that table while another
    block grows it read freed memory (the reference packer does, and it
    crashed the germline-standard run on the card's host). Both germline
    BAMs at scale 0.02 have such rows: the packer over each contig, twice,
    gives no ThreadSanitizer report and the same screen flags each time.
    The full tiles of the dense route (mode 0) and the dense likelihood
    tiles (mode 2, and mode 3 with the tumor's MAPQ plane) are held the
    same way, in windows, on 16 threads. Each fill pass gathers its
    block's reads on the block's own thread, and the CSR pass writes its
    rows' offsets and takes their reference bases from the reads it walks,
    the MAPQ-filtered ones too: CSR and likelihood tiles in windows with
    sentinel rows and the MAPQ filter on hold that the same way."""
    bam = request.getfixturevalue(fixture)[sample]
    run = subprocess.run(
        [harnesses["tsan"], bam, "2", str(mode), *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, TSAN_OPTIONS="halt_on_error=0"),
    )
    assert "ThreadSanitizer" not in run.stderr, run.stderr[-6000:]
    assert run.returncode == 0, run.stderr[-6000:]
    rows = {}
    for line in run.stdout.splitlines():
        got_mode, contig, *numbers = line.split()
        assert int(got_mode) == mode
        rows[contig] = tuple(map(int, numbers))
    contigs = {"deep1m"} if sample == "tumor_bam" else {"deep1m", "shallow8m"}
    assert set(rows) == contigs
    assert all(n_rows > 0 and checksum > 0
               for n_rows, _, checksum, _ in rows.values()), rows
    if mode == 1:
        # The screen flags rows on each contig; whole, one call each.
        assert all(n_flags > 0 and (n_windows == 1 or args != _WHOLE)
                   for _, n_windows, _, n_flags in rows.values()), rows
    if args == _PADDED_WINDOWS:
        assert rows["shallow8m"][:2] == (4 * (16_384 + 37), 4), rows


def test_copy_builds_events_without_a_data_race(harnesses, fx):
    """guac_build_events, the event builder of reads that were not decoded
    from a BAM (SAM and object inputs), over the germline BAM's decoded
    columns on 16 threads, twice: no ThreadSanitizer report, and the event
    arrays, mismatches and specials equal the decoder's own each time."""
    run = subprocess.run(
        [harnesses["tsan"], fx["germline_bam"], "2", "events", "16"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, TSAN_OPTIONS="halt_on_error=0"),
    )
    assert "ThreadSanitizer" not in run.stderr, run.stderr[-6000:]
    assert run.returncode == 0, run.stderr[-6000:]
    word, n_reads, n_events, n_specials = run.stdout.split()
    assert word == "events" and int(n_reads) == 84_296
    assert int(n_events) > int(n_reads) and int(n_specials) > 0


def test_copy_decodes_a_tasks_chunks_without_a_data_race(harnesses, fx):
    """guac_decode_bam_chunks over a task's nine chunks on 16 threads,
    twice: one inflate pool over every chunk's blocks and one phase 2 over
    every chunk's records, with no ThreadSanitizer report, the same columns
    both times, and the reads, events and specials of the port's decode."""
    path = fx["germline_bam"]
    chunks = _task_chunks(path)
    run = subprocess.run(
        [harnesses["tsan"], path, "2", "chunks", "16",
         *(str(v) for chunk in chunks for v in chunk)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, TSAN_OPTIONS="halt_on_error=0"),
    )
    assert "ThreadSanitizer" not in run.stderr, run.stderr[-6000:]
    assert run.returncode == 0, run.stderr[-6000:]
    word, *numbers = run.stdout.split()
    cols = port_columnar.decode_bam_columnar(path, chunks=chunks)
    assert word == "chunks" and list(map(int, numbers)) == [
        cols.n, int(cols.ev_off[-1]), len(cols.sp_read)]
    assert cols.n > 0 and len(cols.sp_read) > 0


# --- the copy against the JAX package's library ---------------------------


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sim"))
    manifest = make_scale_fixture(out, scale=0.02, seed=7)
    return {k: os.path.join(out, v) for k, v in manifest["files"].items()}


def _assert_same_columns(port, ref):
    assert port is not None and ref is not None
    assert port.n > 0
    for field in dataclasses.fields(ref):
        a, b = getattr(port, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), field.name
        else:
            assert a == b, field.name


def _bai_chunks(path):
    """The .bai chunks of two stretches of shallow8m: a pushdown that skips
    most of the file (deep1m fits in one 16 kbp bin of the index)."""
    index = BamIndex(ensure_bam_index(path))
    return optimize_chunks([index.chunks_for_region(1, 40_000, 70_000),
                            index.chunks_for_region(1, 100_000, 120_000)])


def _task_chunks(path):
    """A task's chunk list as the streaming callers build one: the merged
    .bai chunks of three 16 kbp windows and of the last record's locus.
    Nine chunks: deep1m's window (most of its reads, and its insertions),
    shallow8m's first window's bin, fragments of the bins above it, later
    in the file, among them the bin of the window at 49,152 (its
    deletions), and the last record's, ninth."""
    bam = bam_mutants.read_bam(path)
    ref_id, pos = struct.unpack_from("<ii", bam.stream, bam.records[-1] + 4)
    index = BamIndex(ensure_bam_index(path))
    chunks = optimize_chunks([index.chunks_for_region(0, 0, 16_384),
                              index.chunks_for_region(1, 0, 16_384),
                              index.chunks_for_region(1, 49_152, 65_536),
                              index.chunks_for_region(ref_id, pos, pos + 1)])
    assert len(chunks) == 9
    return chunks


_PERTURBED = r"""
import pickle, json, sys
from guacamole_tpu_torch.runtime import columnar

path, chunks, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
cols = (columnar.decode_sam_columnar(path) if path.endswith(".sam") else
        columnar.decode_bam_columnar(path, chunks=chunks))
with open(out, "wb") as fh:
    pickle.dump(cols, fh)
"""


def _perturbed_decode(path, chunks, tmp_path):
    """The port's decode of path in a process whose malloc fills every
    allocation with 0xa5 (glibc's MALLOC_PERTURB_): the decoders size their
    byte columns without a zero-fill, and a byte they leave unwritten
    shows."""
    out = tmp_path / "cols.pickle"
    run = subprocess.run(
        [sys.executable, "-c", _PERTURBED, path, json.dumps(chunks), str(out)],
        env=dict(os.environ, MALLOC_PERTURB_="90"), capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out, "rb") as fh:
        return pickle.load(fh)


@pytest.mark.parametrize("mode", ["whole", "bai", "sam", "task"])
def test_copy_decodes_what_the_jax_library_decodes(fx, tmp_path, mode):
    if mode == "sam":
        port = _perturbed_decode(fx["germline"], None, tmp_path)
        ref = jax_columnar.decode_sam_columnar(fx["germline"])
    else:
        chunks = {"bai": _bai_chunks, "task": _task_chunks}.get(
            mode, lambda _: None)(fx["germline_bam"])
        port = _perturbed_decode(fx["germline_bam"], chunks, tmp_path)
        ref = jax_columnar.decode_bam_columnar(fx["germline_bam"],
                                               chunks=chunks)
        if mode == "bai":
            assert 0 < ref.n < 84_296 // 2
        elif mode == "task":
            assert 0 < ref.n < 84_296 and set(ref.sp_kind) == {1, 2}
    _assert_same_columns(port, ref)


# Offset columns (n + 1 entries) and the column they index.
_OFFSETS = {"seq_off": "seq", "cigar_off": "cigar_len", "md_off": "md_text",
            "ev_off": "ev_kind"}


def _one_after_another(parts):
    """The ColumnarReads of decodes one after another: per-read and data
    columns joined, offsets and specials moved past the parts before."""
    joined = {}
    for field in dataclasses.fields(parts[0]):
        values = [getattr(p, field.name) for p in parts]
        if not isinstance(values[0], np.ndarray):
            assert all(v == values[0] for v in values), field.name
            joined[field.name] = values[0]
            continue
        if field.name in _OFFSETS:
            size = [len(getattr(p, _OFFSETS[field.name])) for p in parts]
            values = [values[0][:1]] + [v[1:] + before for v, before in
                                         zip(values, np.cumsum([0] + size))]
        elif field.name in ("sp_read", "sp_payload_offset"):
            size = [p.n if field.name == "sp_read" else
                    len(p.special_payload) for p in parts]
            values = [v + before for v, before in
                      zip(values, np.cumsum([0] + size))]
        joined[field.name] = np.concatenate(values).astype(values[0].dtype)
    return dataclasses.replace(parts[0], **joined)


def test_a_tasks_chunks_decode_in_one_pass_as_one_by_one(fx):
    """The one pass over a task's nine chunks gives the reads of its
    chunks decoded alone, one after another: the same reads in the same
    order, column for column, and the same specials."""
    path = fx["germline_bam"]
    chunks = _task_chunks(path)
    parts = [port_columnar.decode_bam_columnar(path, chunks=[chunk])
             for chunk in chunks]
    assert all(p.n > 0 for p in parts)
    _assert_same_columns(
        port_columnar.decode_bam_columnar(path, chunks=chunks),
        _one_after_another(parts))


@pytest.mark.parametrize("name", ["l_seq_negative", "block_size_past_end",
                                  "md_ended_early"])
def test_a_malformed_record_in_a_late_chunk_is_refused_naming_it(
        fx, tmp_path, name):
    """The germline BAM's last record made malformed (a field the scan
    refuses, a block past the chunk's bytes, an MD tag that phase 2
    refuses): the one pass over a task's nine chunks refuses naming the
    ninth, its two virtual offsets and the record's inflated byte from the
    chunk's first block: the reason a decode of that chunk alone gives."""
    clean = fx["germline_bam"]
    bam = bam_mutants.read_bam(clean)
    mutant = next(m for m in bam_mutants.MUTANTS if m.name == name)
    path = str(tmp_path / f"{name}.bam")
    with open(path, "wb") as fh:
        fh.write(bam_mutants.make_mutant(bam, mutant))
    clean_chunks = _task_chunks(clean)
    chunks = bam_mutants.chunks_of(bam, clean_chunks, os.path.getsize(path))
    last = bam.records[-1]
    block = max(i for i, u in enumerate(bam.ustarts) if u <= last)
    vlast = (bam.coffsets[block] << 16) | (last - bam.ustarts[block])
    k = next(i for i, (b, e) in enumerate(clean_chunks) if b <= vlast < e)
    assert k >= 4
    b, e = chunks[k]
    at = last - bam.ustarts[bam.coffsets.index(b >> 16)]
    with pytest.raises(ValueError) as in_the_list:
        port_native.decode_bam_native(path, chunks=chunks)
    with pytest.raises(ValueError) as alone:
        port_native.decode_bam_native(path, chunks=[(b, e)])
    reason = str(in_the_list.value)
    assert reason.startswith(f"{path}: chunk {k} [{b}, {e}): malformed BAM "
                             f"record at inflated byte {at}: "), reason
    assert mutant.field in reason
    assert reason.replace(f"chunk {k} ", "chunk 0 ", 1) == str(alone.value)


# --- the packer against the JAX package's packer --------------------------

_CONTIG = 3_000
_N_RUN = range(400, 410)  # reference Ns that no read resolves


def _pack_sam(path):
    """A coordinate-sorted SAM built to trip a read-to-row walk that went
    wrong, and the contig's reference. Seeded reads of 20-190 bases whose
    ends are out of start order (soft clips, insertions, deletions), ties
    at one start, MAPQ 0-19 on about a fifth of the reads, and MD tags
    that claim N, or another base than the reference's, at some aligned
    bases, so that a row's first read can leave it N and a later one
    resolve it; a run of Ns that no read resolves. Crafted reads besides:
    a low-MAPQ read that starts a row with a standard MD base; reads that
    lie inside the gaps of the loci below; one whose deletion spans more
    than two blocks of rows; and reads on a second contig."""
    rng = np.random.default_rng(20)
    ref = rng.choice(list("ACGT"), _CONTIG)
    ref[list(_N_RUN)] = "N"
    reads = []

    def add(pos, ops, mapq, flag=0, claim=0.04):
        seq, md, run, at = [], "", 0, pos
        for op, n in ops:
            if op == "S" or op == "I":
                seq += list(rng.choice(list("ACGT"), n))
            elif op == "D":
                md += f"{run}^{''.join(ref[at:at + n])}"
                run, at = 0, at + n
            else:
                for base in ref[at:at + n]:
                    if base != "N" and rng.random() < claim:
                        base = rng.choice(list("ACGTN"))
                    read = base if rng.random() < 0.9 else rng.choice(
                        list("ACGTN"))
                    seq.append(read)
                    if read == base and base != "N":
                        run += 1
                    else:
                        md += f"{run}{base}"
                        run = 0
                at += n
        cigar = "".join(f"{n}{op}" for op, n in ops)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 41, len(seq)))
        reads.append((pos, f"r{len(reads)}\t{flag}\tchr1\t{pos + 1}\t{mapq}\t"
                      f"{cigar}\t*\t0\t0\t{''.join(seq)}\t{qual}\t"
                      f"MD:Z:{md}{run}"))

    for pos in np.sort(rng.integers(0, _CONTIG - 220, 260)):
        ops = [("S", int(rng.integers(1, 6)))] if rng.random() < 0.3 else []
        for k in range(int(rng.integers(1, 4))):
            if k:
                ops.append((rng.choice(["I", "D"]), int(rng.integers(1, 4))))
            ops.append(("M", int(rng.integers(6, 60))))
        if rng.random() < 0.3:
            ops.append(("S", int(rng.integers(1, 6))))
        add(int(pos), ops, int(rng.integers(0, 20)) if rng.random() < 0.2
            else 60, flag=16 * int(rng.integers(0, 2)))
    for _ in range(3):  # ties: one start, three lengths
        add(1_200, [("M", int(rng.integers(10, 80)))], 60)
    add(1_000, [("M", 30)], 3, claim=0.0)  # low MAPQ, first at its rows
    add(1_000, [("M", 40)], 60, claim=1.0)  # other bases, resolve nothing
    add(640, [("M", 20), ("D", 600), ("M", 20)], 60)  # spans 3 blocks
    add(530, [("M", 40)], 60)  # inside the dense loci's gap
    add(2_003, [("M", 9)], 60)  # between two sparse loci
    reads.sort(key=lambda r: r[0])
    with open(path, "w") as fh:
        fh.write(f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:{_CONTIG}\n"
                 f"@SQ\tSN:chr2\tLN:500\n")
        for _, line in reads:
            fh.write(line + "\n")
        for pos in (5, 90):
            fh.write(f"x{pos}\t0\tchr2\t{pos + 1}\t60\t30M\t*\t0\t0\t"
                     f"{'A' * 30}\t{'I' * 30}\tMD:Z:30\n")
    return "".join(ref).encode()


@pytest.fixture(scope="module")
def pack_input(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pack") / "pack.sam")
    ref = _pack_sam(path)
    cols = jax_columnar.decode_sam_columnar(path)
    assert cols is not None and cols.n == 270 and len(cols.sp_read) > 0
    # Dense loci with an uncovered gap and a one-locus hole; sparse loci
    # every 13 bases over the contig, as the somatic confirm packs them.
    dense = np.setdiff1d(np.arange(_CONTIG),
                         np.r_[500:620, 1_500]).astype(np.int64)
    sparse = np.arange(3, _CONTIG, 13, dtype=np.int64)
    return cols, ref, {"dense": dense, "sparse": sparse}


_DEEP_CONTIG = 600
_DEEP_PAD = 32  # below the pile's depth
_MANY_ALLELES = 300  # eleven alleles: more than K = 8


def _deep_pack_sam(path, binned):
    """A SAM for the dense likelihood tiles' caps: a pile of 70 reads of 60
    bases, one starting at each locus from 100, so that its rows take
    every depth from 1 to 60, past _DEEP_PAD; every ninth at MAPQ 10;
    at locus _MANY_ALLELES the reference base, the three others, N, three
    insertions and three deletions; shallow reads besides. Base qualities
    from four levels (binned: the tile has a qual dictionary) or from 39
    (more than 16: it has none)."""
    rng = np.random.default_rng(21)
    qrng = np.random.default_rng(22)
    ref = rng.choice(list("ACGT"), _DEEP_CONTIG)
    reads = []

    def add(pos, ops, mapq=60, at_base=None, ins="", error=0.0):
        seq, md, run, at = [], "", 0, pos
        for op, n in ops:
            if op == "I":
                seq += list(ins)
            elif op == "D":
                md += f"{run}^{''.join(ref[at:at + n])}"
                run, at = 0, at + n
            else:
                for base in ref[at:at + n]:
                    read = base
                    if at_base is not None and at == _MANY_ALLELES:
                        read = at_base
                    elif rng.random() < error:
                        read = rng.choice(list("ACGTN"))
                    seq.append(read)
                    if read == base:
                        run += 1
                    else:
                        md += f"{run}{base}"
                        run = 0
                    at += 1
        levels = [2, 12, 23, 37] if binned else list(range(2, 41))
        qual = "".join(chr(33 + int(q)) for q in qrng.choice(levels, len(seq)))
        cigar = "".join(f"{n}{op}" for op, n in ops)
        reads.append((pos, f"d{len(reads)}\t0\tchr1\t{pos + 1}\t{mapq}\t"
                      f"{cigar}\t*\t0\t0\t{''.join(seq)}\t{qual}\t"
                      f"MD:Z:{md}{run}"))

    for i in range(70):
        add(100 + i, [("M", 60)], mapq=10 if i % 9 == 0 else 60,
            error=0.05)
    start = _MANY_ALLELES - 20
    for base in [ref[_MANY_ALLELES]] * 3 + sorted(
            set("ACGTN") - {ref[_MANY_ALLELES]}):
        add(start, [("M", 50)], at_base=base)
    for n, ins in zip((1, 2, 3), ("A", "CG", "TTT")):
        add(start, [("M", 21), ("I", n), ("M", 29)], ins=ins)
        add(start, [("M", 21), ("D", n), ("M", 29)])
    for pos in rng.integers(0, _DEEP_CONTIG - 80, 40):
        add(int(pos), [("M", int(rng.integers(20, 80)))], error=0.05)
    reads.sort(key=lambda r: r[0])
    with open(path, "w") as fh:
        fh.write(f"@HD\tVN:1.6\tSO:coordinate\n"
                 f"@SQ\tSN:chr1\tLN:{_DEEP_CONTIG}\n")
        for _, line in reads:
            fh.write(line + "\n")
    return "".join(ref).encode()


@pytest.fixture(scope="module")
def deep_pack_inputs(tmp_path_factory):
    out = {}
    for quals in ("binned", "raw"):
        path = str(tmp_path_factory.mktemp("deep") / f"{quals}.sam")
        ref = _deep_pack_sam(path, quals == "binned")
        cols = jax_columnar.decode_sam_columnar(path)
        assert cols is not None and cols.n == 123 and len(cols.sp_read) > 0
        loci = np.setdiff1d(np.arange(_DEEP_CONTIG),
                            np.r_[400:410]).astype(np.int64)
        out[quals] = cols, ref, {"dense": loci}
    return out


# The crafted SAM in every mode; the deep one in the dense likelihood
# modes (2, 3), with and without a qual dictionary.
_PACK_CASES = [
    pytest.param(mode, with_ref, window, "crafted",
                 id=f"{mode}-{'ref_contig' if with_ref else 'md'}-"
                    f"{'window' if window else 'all_reads'}")
    for mode in (0, 1, 2, 3) for with_ref in (False, True)
    for window in (False, True)
] + [
    pytest.param(mode, with_ref, False, f"deep_{quals}",
                 id=f"{mode}-{'ref_contig' if with_ref else 'md'}-deep_{quals}")
    for mode in (2, 3) for with_ref in (False, True)
    for quals in ("binned", "raw")
]


@pytest.mark.parametrize("mode,with_ref,window,sample", _PACK_CASES)
def test_copy_packs_what_the_jax_library_packs(request, monkeypatch,
                                               mode, with_ref, window, sample):
    """Every array guac_pack_tile returns, from the port's library and
    from the JAX package's, is the same, dtype and bytes, in each of the
    packer's four modes: the row ranges of reads found by a forward walk,
    each block's members, depth and row offsets built on its own thread,
    and in the CSR mode (1) without a reference contig each row's
    reference base taken in the CSR pass, give the rows, reference bases
    (N where no read resolves one), allele tables and screens that one
    binary search a read and a pass of its own gave. Dense and sparse
    loci, MAPQ filter on and off, sentinel rows past the loci (l_pad) or
    none; in mode 1 the likelihood screen and the fused fill too. The
    dense likelihood modes (2, 3) fill their rows in the locus-major sweep
    of the CSR mode: on the deep SAM they hold the JAX library's rows that
    overflow their D slots (depth_pad below the pile), its rows of more
    than K alleles, and its qual dictionary where the tile has one and
    where it has none. The JAX library packs on one thread: on more, its
    CSR pass reads the table of long allele keys while other threads grow
    it (the race the port's lock repairs), and may read freed memory. The
    outputs do not depend on the number of threads."""
    deep = sample != "crafted"
    cols, ref, loci_sets = (
        request.getfixturevalue("deep_pack_inputs")[sample[5:]] if deep
        else request.getfixturevalue("pack_input"))
    packs = 0
    for name, loci in loci_sets.items():
        for min_mapq, l_pad, depth_pad in (
                itertools.product((0, 20), (0, len(loci) + 37),
                                  (0, _DEEP_PAD) if deep else (0,))):
            kw = dict(
                mode=mode, min_mapq=min_mapq, l_pad=l_pad,
                depth_pad=depth_pad,
                ref_contig=ref if with_ref else None,
                scan_window=cols.read_scan_window(
                    0, int(loci[0]), int(loci[-1])) if window else None,
                ll_screen_margin=4.0 if mode == 1 else 0.0,
                ll_screen_kind=2 if mode == 3 else 1,
                skip_nibbles=mode == 1 and l_pad > 0)
            got = port_native.pack_tile_native(cols, 0, loci, 8, **kw)
            with monkeypatch.context() as one_thread:
                one_thread.setenv("GUAC_PACK_THREADS", "1")
                want = jax_native.pack_tile_native(cols, 0, loci, 8, **kw)
            assert got.keys() == want.keys()
            for key, value in want.items():
                assert np.asarray(got[key]).dtype == np.asarray(
                    value).dtype, (name, min_mapq, l_pad, depth_pad, key)
                assert np.array_equal(got[key], value), (
                    name, min_mapq, l_pad, depth_pad, key)
            ref_base = np.asarray(want["ref_base"])
            assert want["L"] == max(l_pad, len(loci))
            if not with_ref and name == "dense" and not deep:
                rows = np.searchsorted(loci, list(_N_RUN))
                assert set(ref_base[rows]) == {ord("N")}
                assert set(ref_base[:len(loci)]) > {ord("N")}
            if deep:
                # The caps this SAM is built to reach.
                n, D = len(loci), want["D"]
                depth = np.asarray(want["depth"])[:n]
                overflow = np.asarray(want["overflow"])[:n]
                assert (depth == D + 1).any() == (depth_pad > 0)
                assert overflow[depth > D].all()
                row = np.searchsorted(loci, _MANY_ALLELES)
                assert want["num_alleles"][row] == 8 and overflow[row]
                assert (np.asarray(want["ll_pack8"]).size > 0) == (
                    sample == "deep_binned")
            packs += 1
    assert packs == 8


# --- the package alone ----------------------------------------------------

_ALONE = r"""
import json, os, sys

events = []


def hook(event, args):
    if event == "open" and isinstance(args[0], str):
        events.append(["open", os.path.abspath(args[0])])
    elif event == "subprocess.Popen":
        events.append(["popen", [str(a) for a in args[1]]])
    elif event == "ctypes.dlopen":
        events.append(["dlopen", str(args[0])])


from guacamole_tpu_torch.runtime import columnar, native

sys.addaudithook(hook)
lib = native.load_library()
built = list(events)
cols = columnar.decode_bam_columnar(sys.argv[1])
print(json.dumps({"lib": lib and lib._name, "events": built,
                  "reads": cols.n, "package": native.__file__}))
"""


def test_package_alone_builds_its_library_and_decodes(fx, tmp_path):
    """The package copied alone, with no native/ beside it: load_library
    compiles the package's own sources into the package's _build/, and
    opens, runs and loads nothing outside the package to do so."""
    alone = tmp_path / "alone"
    pkg = alone / "guacamole_tpu_torch"
    shutil.copytree(PORT_PKG, pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(alone)
    run = subprocess.run(
        [sys.executable, "-c", _ALONE, fx["germline_bam"]],
        cwd=str(alone), env=env, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.splitlines()[-1])
    assert got["package"].startswith(str(pkg) + os.sep)
    assert os.path.dirname(got["lib"]) == str(pkg / "_build")
    assert got["reads"] == 84_296
    inside = str(pkg) + os.sep
    compiles = [args for kind, args in got["events"] if kind == "popen"]
    assert len(compiles) == 1
    sources = [a for a in compiles[0] if a.endswith(".cpp")]
    assert sources == [str(pkg / "runtime" / "csrc" / n)
                       for n in port_native.SOURCES]
    for kind, what in got["events"]:
        if kind == "open":
            assert what.startswith(inside) or what == "/proc/cpuinfo", what
        elif kind == "dlopen":
            assert what.startswith(inside), what
