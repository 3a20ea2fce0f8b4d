"""variant-support, vaf-histogram and structural-variant through the port's
CLI against the JAX CLI, byte for byte, and the pieces under them: the
torch EM of the VAF clustering against the JAX EM, and the per-pileup
germline-threshold API against the JAX one and against the port's tile
path.

Inputs: the simulated fixture (utils/simulate, scale 0.02, seed 7: 84k
germline and 65k tumor reads, with two overflow clumps of more than K
distinct alleles at deep1m:7000 and deep1m:7250) and a paired-end fixture
with one planted 4 kb deletion (make_sv_fixture). The JAX CLI runs every
command once, in one subprocess (`guacamole_tpu.cli.main`); the port's
runs in-process so the tests can switch screens. On the CPU, "device"
screens are the kernels' plain twins.
"""

import json
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest

from guacamole_tpu.utils.simulate import make_scale_fixture, make_sv_fixture
from guacamole_tpu_torch import cli as port_cli
from guacamole_tpu_torch.ops import dispatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The overflow clump at band[0] + 1000 (utils/simulate.make_scale_fixture):
# 12 distinct insertions on top of the reference allele and errors.
OVERFLOW_LOCUS = 7000
FILTER_ARGS = ["--min-read-depth", "10", "--min-vaf", "20", "--bins", "10"]


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    out = tmp_path_factory.mktemp("sim")
    manifest = make_scale_fixture(str(out), scale=0.02, seed=7)
    files = {k: os.path.join(str(out), v) for k, v in manifest["files"].items()}
    # Sites: the germline-threshold calls, plus one site in an overflow
    # clump so that the exact host fallback of the counting tools runs.
    sites = os.path.join(str(out), "sites.vcf")
    assert port_cli.main(
        ["germline-threshold", "--reads", files["germline_bam"],
         "--threshold", "25", "--out", sites, "--device", "cpu"]
    ) == 0
    with open(sites, "a") as fh:
        fh.write(f"deep1m\t{OVERFLOW_LOCUS + 1}\t.\tA\tAT\t.\t.\t.\tGT\t0/1\n")
    files["sites"] = sites
    sv = make_sv_fixture(
        str(out / "sv"), length=250_000, depth=16,
        deletions=((90_000, 4_000),), seed=11,
    )
    files["sv_sam"] = str(out / "sv" / sv["files"]["sv_sam"])
    files["sv_bam"] = str(out / "sv" / "sv.pairs.bam")
    _paired_bam(files["sv_sam"], files["sv_bam"])
    return files


def _paired_bam(sam_path, bam_path):
    """A BAM of every record of a SAM with its mate fields (RNEXT, PNEXT,
    TLEN), which the repo's columnar BAM writer leaves unset."""
    from guacamole_tpu_torch.gio.bamwrite import _SEQ_CODE, _reg2bin, BgzfWriter

    ops = {c: i for i, c in enumerate("MIDNSHP=X")}
    header, records = [], []
    with open(sam_path) as fh:
        for line in fh:
            (header if line.startswith("@") else records).append(line)
    refs = [
        (f[1][3:], int(f[2][3:]))
        for f in (ln.rstrip("\n").split("\t") for ln in header)
        if f[0] == "@SQ"
    ]
    ref_id = {name: i for i, (name, _) in enumerate(refs)}
    with open(bam_path, "wb") as raw:
        w = BgzfWriter(raw)
        text = "".join(header).encode()
        w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text
                + struct.pack("<i", len(refs)))
        for name, length in refs:
            nb = name.encode() + b"\x00"
            w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", length))
        for line in records:
            f = line.rstrip("\n").split("\t")
            cigar = [
                (int(n), ops[op])
                for n, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5])
            ]
            pos = int(f[3]) - 1
            end = pos + sum(n for n, op in cigar if op in (0, 2, 3, 7, 8))
            seq = np.frombuffer(f[9].encode(), np.uint8)
            codes = _SEQ_CODE[seq]
            if len(codes) & 1:
                codes = np.concatenate([codes, np.zeros(1, np.uint8)])
            qual = bytes(np.frombuffer(f[10].encode(), np.uint8) - 33)
            assert all(t[2:5] == ":Z:" for t in f[11:]), f[11:]
            tags = b"".join(
                t[:2].encode() + b"Z" + t[5:].encode() + b"\x00" for t in f[11:]
            )
            mate = ref_id[f[2]] if f[6] == "=" else ref_id.get(f[6], -1)
            body = (
                struct.pack(
                    "<iiBBHHHiiii", ref_id[f[2]], pos, len(f[0]) + 1,
                    int(f[4]), _reg2bin(pos, max(end, pos + 1)), len(cigar),
                    int(f[1]), len(seq), mate, int(f[7]) - 1, int(f[8]),
                )
                + f[0].encode() + b"\x00"
                + b"".join(struct.pack("<I", n << 4 | op) for n, op in cigar)
                + ((codes[0::2] << 4) | codes[1::2]).tobytes()
                + qual + tags
            )
            w.write(struct.pack("<i", len(body)) + body)
        w.close()


def _jax_runs(fx):
    """{label: argv} of every JAX CLI run the tests compare with."""
    germline, tumor = fx["germline_bam"], fx["tumor_bam"]
    runs = {
        "support": ["variant-support", "-v", fx["sites"], "-o", "support.csv",
                    germline, tumor],
        "vaf": ["vaf-histogram", "--bins", "20", "--out", "vaf.csv", germline],
        "vaf_filtered": ["vaf-histogram", *FILTER_ARGS,
                         "--out", "vaf_filtered.csv", germline],
    }
    for fmt in ("sam", "bam"):
        for api in ("best", "python"):
            runs[f"sv_{fmt}_{api}"] = [
                "structural-variant", "--reads", fx[f"sv_{fmt}"],
                "--bam-reader-api", api, "--output", f"sv_{fmt}_{api}.txt",
            ]
    return runs


@pytest.fixture(scope="module")
def jax_out(fx, tmp_path_factory):
    """{label: output bytes} of the JAX CLI, all runs in one process."""
    out = str(tmp_path_factory.mktemp("jax"))
    runs = _jax_runs(fx)
    code = (
        "import json, sys\n"
        "from guacamole_tpu.cli import main\n"
        "for argv in json.loads(sys.argv[1]):\n"
        "    assert main(argv) == 0, argv\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code, json.dumps(list(runs.values()))],
        env=dict(
            os.environ, JAX_PLATFORMS="cpu",
            PYTHONPATH=os.pathsep.join(
                [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        ),
        cwd=out,
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    got = {}
    for label, argv in runs.items():
        flag = next(f for f in ("-o", "--out", "--output") if f in argv)
        with open(os.path.join(out, argv[argv.index(flag) + 1]), "rb") as fh:
            got[label] = fh.read()
    return got


SCREENS = {
    "device": {"GUAC_HOST_SCREEN": "0"},
    "host": {"GUAC_HOST_SCREEN": "1"},
    "dense": {"GUAC_DENSE_TILES": "1"},
}


def _port(monkeypatch, tmp_path, env, argv):
    """Run the port's CLI on the CPU under `env`; the output's bytes. A
    run with device screens must take the full-count screen alone."""
    for key in ("GUAC_HOST_SCREEN", "GUAC_DENSE_TILES", "GUAC_NO_STREAMING"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)

    def no_compaction(*args, **kwargs):
        raise AssertionError("the counting tools never compact")

    monkeypatch.setattr(dispatch, "screen_csr_compact_launch", no_compaction)
    path = str(tmp_path / "out")
    flag = {"variant-support": "-o", "vaf-histogram": "--out"}.get(
        argv[0], "--output")
    dispatch.reset_transfer_stats()
    assert port_cli.main(
        [*argv, flag, path, "--device", "cpu", "--debug"]
    ) == 0
    if env.get("GUAC_HOST_SCREEN") == "0" or env.get("GUAC_DENSE_TILES"):
        assert dispatch.TRANSFER_STATS["launches"] > 0
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("screen", list(SCREENS))
def test_variant_support_matches_jax_cli(
    monkeypatch, tmp_path, fx, jax_out, screen
):
    got = _port(monkeypatch, tmp_path, SCREENS[screen], [
        "variant-support", "-v", fx["sites"],
        fx["germline_bam"], fx["tumor_bam"],
    ])
    assert got == jax_out["support"]
    # Both BAMs, in argument order, and the overflow site: more distinct
    # alleles than a tile's dictionary holds, counted on the host.
    at_clump = [
        ln for ln in got.decode().splitlines()
        if f", deep1m, {OVERFLOW_LOCUS}, " in ln
    ]
    assert len(at_clump) > 2 * 13
    assert len(got.decode().splitlines()) > 2 * 120


@pytest.mark.parametrize("streaming", [True, False], ids=["stream", "whole"])
@pytest.mark.parametrize("screen", list(SCREENS))
def test_vaf_histogram_matches_jax_cli(
    monkeypatch, tmp_path, fx, jax_out, screen, streaming
):
    env = dict(SCREENS[screen], GUAC_NO_STREAMING="0" if streaming else "1")
    got = _port(monkeypatch, tmp_path, env, [
        "vaf-histogram", "--bins", "20", fx["germline_bam"],
    ])
    assert got == jax_out["vaf"]
    assert len(got.decode().splitlines()) > 10


@pytest.mark.parametrize("screen", ["device", "host"])
def test_vaf_histogram_filters_match_jax_cli(
    monkeypatch, tmp_path, fx, jax_out, screen
):
    got = _port(monkeypatch, tmp_path, SCREENS[screen], [
        "vaf-histogram", *FILTER_ARGS, fx["germline_bam"],
    ])
    assert got == jax_out["vaf_filtered"]
    assert got != jax_out["vaf"] and len(got.decode().splitlines()) > 5


@pytest.mark.parametrize("api", ["best", "python"], ids=["columnar", "objects"])
@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_structural_variant_matches_jax_cli(
    monkeypatch, tmp_path, fx, jax_out, fmt, api
):
    got = _port(monkeypatch, tmp_path, {}, [
        "structural-variant", "--reads", fx[f"sv_{fmt}"],
        "--bam-reader-api", api,
    ])
    assert got == jax_out[f"sv_{fmt}_{api}"]
    assert b"GenomeRange(svcontig,89953,94056)" in got


def _inputs(command, fx, tmp_path):
    """The least arguments a run of `command` needs."""
    return {
        "variant-support": ["-v", fx["sites"], "-o", str(tmp_path / "x"),
                            fx["germline_bam"]],
        "vaf-histogram": [fx["germline_bam"]],
        "structural-variant": ["--reads", fx["sv_sam"]],
    }[command]


@pytest.mark.parametrize(
    "command", ["variant-support", "vaf-histogram", "structural-variant"]
)
def test_unported_options_fail_with_one_line(tmp_path, fx, capsys, command):
    """The mesh and the multi-process flags are ported; what they still
    refuse fails with one line: a group without its coordinator, and
    --mesh on without a CUDA device (no fallback to a CPU mesh)."""
    import torch

    inputs = _inputs(command, fx, tmp_path)
    cases = [(["--num-processes", "2"], "--coordinator")]
    if not torch.cuda.is_available():
        cases.append((["--device", "cuda", "--mesh", "on"], "--device cpu"))
    for extra, message in cases:
        rc = port_cli.main([command, *inputs, "--device", "cpu", *extra])
        assert rc == 1
        err = capsys.readouterr().err
        assert message in err and len(err.strip().splitlines()) == 1


@pytest.mark.parametrize(
    "command", ["variant-support", "vaf-histogram", "structural-variant"]
)
def test_commands_run_on_the_card_unless_asked(tmp_path, fx, capsys, command):
    """Without --device the command wants a CUDA device; with none it fails
    with one line that names --device cpu."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    inputs = _inputs(command, fx, tmp_path)
    assert port_cli.main([command, *inputs]) == 1
    err = capsys.readouterr().err
    assert "--device cpu" in err and len(err.strip().splitlines()) == 1


# --- the EM of vaf-histogram's clustering ------------------------------------


def _vaf_set(name):
    """The pinned VAF sets of tests/test_windowing_tools.py."""
    if name == "two":
        rng = np.random.RandomState(0)
        vafs = np.concatenate([
            rng.normal(0.25, 0.02, 200).clip(0.01, 0.99),
            rng.normal(0.75, 0.02, 200).clip(0.01, 0.99),
        ])
        return vafs, 2
    rng = np.random.RandomState(7)
    vafs = np.concatenate([
        rng.normal(0.25, 0.03, 300).clip(0.01, 0.99),
        rng.normal(0.50, 0.03, 300).clip(0.01, 0.99),
        rng.normal(0.98, 0.01, 150).clip(0.01, 0.99),
    ])
    return vafs, 3


def _port_fit(vafs, k, seed, monkeypatch):
    """The port's fit on the CPU and its number of EM steps."""
    from guacamole_tpu_torch.callers import vaf_histogram as port_vh

    steps = []
    real = port_vh._em_step

    def counted(*args):
        steps.append(1)
        return real(*args)

    monkeypatch.setattr(port_vh, "_em_step", counted)
    loci = [port_vh.VariantLocus("c", i, float(v)) for i, v in enumerate(vafs)]
    fit = port_vh.build_mixture_model(loci, k, seed=seed, device="cpu")
    return fit, len(steps)


def _jax_fit(vafs, k, seed, monkeypatch):
    """The JAX package's fit and its number of EM steps (calls of its
    jitted step, counted by wrapping jax.jit)."""
    import jax

    from guacamole_tpu.callers import vaf_histogram as jax_vh

    steps = []
    real_jit = jax.jit

    def counting_jit(fn):
        jitted = real_jit(fn)

        def step(*args):
            steps.append(1)
            return jitted(*args)

        return step

    monkeypatch.setattr(jax, "jit", counting_jit)
    loci = [jax_vh.VariantLocus("c", i, float(v)) for i, v in enumerate(vafs)]
    fit = jax_vh.build_mixture_model(loci, k, seed=seed)
    return fit, len(steps)


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("vaf_set", ["two", "three"])
def test_gmm_matches_the_jax_fit(monkeypatch, vaf_set, seed):
    vafs, k = _vaf_set(vaf_set)
    (w, m, v), steps = _port_fit(vafs, k, seed, monkeypatch)
    (jw, jm, jv), jax_steps = _jax_fit(vafs, k, seed, monkeypatch)
    assert steps == jax_steps and 1 < steps <= 50
    for got, want in ((w, jw), (m, jm), (v, jv)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert w.sum() == pytest.approx(1.0, abs=1e-3)


def test_gmm_pinned_convergence(monkeypatch):
    """The contract of test_windowing_tools.py's pinned fit: the same seed
    gives a bit-identical fit, the planted clusters are found, and another
    seed finds the same clusters."""
    vafs, k = _vaf_set("three")
    (w1, m1, v1), _ = _port_fit(vafs, k, 1, monkeypatch)
    (w2, m2, v2), _ = _port_fit(vafs, k, 1, monkeypatch)
    assert np.array_equal(w1, w2)
    assert np.array_equal(m1, m2)
    assert np.array_equal(v1, v2)
    order = np.argsort(m1)
    assert m1[order] == pytest.approx([0.25, 0.50, 0.98], abs=0.03)
    assert w1[order] == pytest.approx(
        [300 / 750, 300 / 750, 150 / 750], abs=0.05
    )
    assert np.all(v1 < 0.01)
    (_, m3, _), _ = _port_fit(vafs, k, 5, monkeypatch)
    assert np.sort(m3) == pytest.approx(m1[order], abs=0.05)


def test_gmm_two_clusters(monkeypatch):
    vafs, k = _vaf_set("two")
    (w, m, _), _ = _port_fit(vafs, k, 0, monkeypatch)
    assert sorted(np.round(m, 2)) == pytest.approx([0.25, 0.75], abs=0.05)
    assert w.sum() == pytest.approx(1.0, abs=1e-3)


# --- the per-pileup germline-threshold API -----------------------------------

# Three stretches at 25x around planted hets (deep1m:1803, 3025, 4792, as
# the germline-threshold calls give them) and one across the 1000x band,
# the spike's edge and the overflow clump at deep1m:7000.
PILEUP_LOCI = [(1790, 1820), (3010, 3040), (4780, 4810), (6995, 7005)]


@pytest.fixture(scope="module")
def germline_reads(fx):
    """The germline BAM's reads over PILEUP_LOCI, as each package loads
    them."""
    from guacamole_tpu.gio.load import load_read_set as jax_load
    from guacamole_tpu.reads.read import InputFilters as JaxFilters
    from guacamole_tpu_torch.gio.load import load_read_set
    from guacamole_tpu_torch.reads.read import InputFilters

    def near(reads):
        return sorted(
            (r for r in reads
             if r.reference_contig == "deep1m"
             and any(r.start < hi and r.end > lo for lo, hi in PILEUP_LOCI)),
            key=lambda r: r.start,
        )

    opts = dict(non_duplicate=True, has_mdtag=True)
    port = near(load_read_set(
        fx["germline_bam"], InputFilters.create(**opts)).mapped_reads)
    jax = near(jax_load(
        fx["germline_bam"], JaxFilters.create(**opts)).mapped_reads)
    return port, jax


@pytest.fixture(scope="module")
def pileups(germline_reads):
    """[(port pileup, JAX pileup)] at every locus of PILEUP_LOCI."""
    from guacamole_tpu.pileup.pileup import Pileup as JaxPileup
    from guacamole_tpu_torch.pileup.pileup import Pileup

    port_reads, jax_reads = germline_reads
    return [
        (Pileup.from_reads(port_reads, "deep1m", locus),
         JaxPileup.from_reads(jax_reads, "deep1m", locus))
        for lo, hi in PILEUP_LOCI
        for locus in range(lo, hi)
    ]


def _key(call):
    return (call.sample_name, call.contig, call.start,
            bytes(call.allele.ref_bases), bytes(call.allele.alt_bases),
            call.labels)


@pytest.mark.parametrize("emit", [True, False], ids=["emit", "variants"])
@pytest.mark.parametrize("threshold", [0, 8, 25])
def test_call_variants_at_locus_matches_jax(pileups, threshold, emit):
    from guacamole_tpu.callers import germline_threshold as jax_gt
    from guacamole_tpu_torch.callers import germline_threshold as port_gt

    assert port_gt.ALT_PLACEHOLDER == jax_gt.ALT_PLACEHOLDER
    n_calls = 0
    for port_pileup, jax_pileup in pileups:
        got = port_gt.call_variants_at_locus(
            port_pileup, threshold, emit_ref=emit, emit_no_call=emit
        )
        want = jax_gt.call_variants_at_locus(
            jax_pileup, threshold, emit_ref=emit, emit_no_call=emit
        )
        assert [_key(c) for c in got] == [_key(c) for c in want]
        n_calls += len(got)
    assert n_calls >= (100 if emit else 3)


@pytest.mark.parametrize("host_screen", ["0", "1"], ids=["device", "host"])
def test_call_variants_at_locus_matches_the_tile_path(
    monkeypatch, germline_reads, pileups, host_screen
):
    """The contract of test_germline_threshold.py's tile-vs-oracle test on
    the port: call_tile over the screen's counts, with the overflow
    fallback, gives the per-pileup calls."""
    import torch

    from guacamole_tpu_torch.callers import germline_threshold as port_gt
    from guacamole_tpu_torch.loci.lociset import parse_loci
    from guacamole_tpu_torch.loci.partition import partition_loci_uniformly

    monkeypatch.setenv("GUAC_HOST_SCREEN", host_screen)
    port_reads, _ = germline_reads
    loci = parse_loci(
        ",".join(f"deep1m:{lo}-{hi}" for lo, hi in PILEUP_LOCI)
    ).result()
    tile_calls = port_gt.call_variants(
        port_reads, partition_loci_uniformly(1, loci), threshold_percent=8,
        device=torch.device("cpu"),
    )
    oracle = [
        c
        for pileup, _ in pileups
        for c in port_gt.call_variants_at_locus(
            pileup, 8, emit_ref=False, emit_no_call=False
        )
    ]
    assert oracle
    assert sorted(map(_key, tile_calls)) == sorted(map(_key, oracle))
