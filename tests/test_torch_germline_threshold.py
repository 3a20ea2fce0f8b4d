"""germline-threshold through the port's CLI against the JAX CLI, record
for record, on the simulated fixture (utils/simulate, scale 0.02, seed 7:
84k reads, 120 records at --threshold 25).

The JAX CLI runs as a subprocess (`python -m guacamole_tpu.cli`); the
port's runs in-process so the tests can switch screens and the compaction
cap. On the CPU, "device" screens are the kernels' plain twins.
"""

import os
import subprocess
import sys

import pytest

from guacamole_tpu.concordance import compare_vcf_records
from guacamole_tpu.utils.simulate import make_scale_fixture
from guacamole_tpu_torch import cli as port_cli
from guacamole_tpu_torch.callers import germline_threshold as port_gt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMIT_REF_LOCI = "deep1m:6900-7600"  # across the 8000x spike's edges


@pytest.fixture(scope="module")
def fixture_bam(tmp_path_factory):
    out = tmp_path_factory.mktemp("sim")
    manifest = make_scale_fixture(str(out), scale=0.02, seed=7)
    return os.path.join(str(out), manifest["files"]["germline_bam"])


def jax_cli(out_vcf, *args):
    r = subprocess.run(
        [sys.executable, "-m", "guacamole_tpu.cli", "germline-threshold",
         *args, "--out", out_vcf],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=ROOT,
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return out_vcf


@pytest.fixture(scope="module")
def jax_default(fixture_bam, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "default.vcf")
    return jax_cli(out, "--reads", fixture_bam, "--threshold", "25")


@pytest.fixture(scope="module")
def jax_emit_ref(fixture_bam, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "emit_ref.vcf")
    return jax_cli(
        out, "--reads", fixture_bam, "--threshold", "25", "--emit-ref",
        "--loci", EMIT_REF_LOCI,
    )


def port_cli_run(out_vcf, *args):
    assert port_cli.main(
        ["germline-threshold", *args, "--out", out_vcf, "--device", "cpu",
         "--debug"]
    ) == 0
    return out_vcf


def assert_same_records(a, b, at_least):
    cmp = compare_vcf_records(a, b)
    assert cmp.record_level_identical, (cmp.only_a[:5], cmp.only_b[:5])
    assert cmp.matching >= at_least


@pytest.mark.parametrize("host_screen", ["0", "1"], ids=["device", "host"])
@pytest.mark.parametrize("streaming", [True, False], ids=["stream", "whole"])
def test_port_cli_matches_jax_cli(
    monkeypatch, tmp_path, fixture_bam, jax_default, streaming, host_screen
):
    monkeypatch.setenv("GUAC_HOST_SCREEN", host_screen)
    monkeypatch.setenv("GUAC_NO_STREAMING", "0" if streaming else "1")
    out = port_cli_run(
        str(tmp_path / "port.vcf"), "--reads", fixture_bam,
        "--threshold", "25",
    )
    assert_same_records(out, jax_default, at_least=100)


@pytest.mark.parametrize("host_screen", ["0", "1"], ids=["device", "host"])
def test_port_emit_ref_matches_jax_cli(
    monkeypatch, tmp_path, fixture_bam, jax_emit_ref, host_screen
):
    """--emit-ref takes the full-count screen (no compaction) through the
    spike: every covered locus comes back."""
    monkeypatch.setenv("GUAC_HOST_SCREEN", host_screen)
    out = port_cli_run(
        str(tmp_path / "port.vcf"), "--reads", fixture_bam,
        "--threshold", "25", "--emit-ref", "--loci", EMIT_REF_LOCI,
    )
    assert_same_records(out, jax_emit_ref, at_least=600)


@pytest.fixture(scope="module")
def jax_low_threshold(fixture_bam, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "low.vcf")
    return jax_cli(out, "--reads", fixture_bam, "--threshold", "2")


def test_compaction_overflow_refetches_full_screen(
    monkeypatch, tmp_path, fixture_bam, jax_low_threshold
):
    """With COMPACT_CAP=1 a tile overflows once it has more candidates
    than max(1, rows // 256); --threshold 2 makes every sequencing error a
    candidate, so every tile does. The caller must refetch the full screen
    and still write the JAX CLI's calls."""
    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    monkeypatch.setattr(port_gt, "COMPACT_CAP", 1)
    refetches = []
    real = port_gt.screen_tile_for

    def counting(tile, **kw):
        refetches.append(tile.L)
        return real(tile, **kw)

    monkeypatch.setattr(port_gt, "screen_tile_for", counting)
    out = port_cli_run(
        str(tmp_path / "port.vcf"), "--reads", fixture_bam,
        "--threshold", "2",
    )
    assert len(refetches) >= 2, "tiles did not overflow the compaction cap"
    assert_same_records(out, jax_low_threshold, at_least=4000)


def test_index_command_writes_a_usable_index(tmp_path, fixture_bam):
    from guacamole_tpu.gio.bai import BamIndex

    out = str(tmp_path / "x.bai")
    assert port_cli.main(["index", fixture_bam, "--out", out]) == 0
    assert BamIndex(out).chunks_for_region(0, 1000, 2000)


def test_unported_options_fail_with_one_line(tmp_path, fixture_bam, capsys):
    """The mesh and the multi-process flags are ported; what they still
    refuse fails with one line: a group without its coordinator, and
    --mesh on without a CUDA device (no fallback to a CPU mesh)."""
    import torch

    cases = [(["--device", "cpu", "--num-processes", "2"], "--coordinator")]
    if not torch.cuda.is_available():
        cases.append((["--mesh", "on"], "--device cpu"))
    for extra, message in cases:
        rc = port_cli.main(
            ["germline-threshold", "--reads", fixture_bam,
             "--out", str(tmp_path / "x.vcf"), *extra]
        )
        err = capsys.readouterr().err
        assert rc == 1
        assert message in err and len(err.strip().splitlines()) == 1
    # --recover with nothing to resume stops with its own message.
    with pytest.raises(SystemExit, match="nothing to resume"):
        port_cli.main(
            ["germline-threshold", "--reads", fixture_bam, "--device", "cpu",
             "--out", str(tmp_path / "x.vcf"), "--recover"]
        )


@pytest.mark.parametrize("host_screen", ["0", "1"], ids=["device", "host"])
@pytest.mark.parametrize("native", [False, True], ids=["objects", "columnar"])
def test_sixteen_alleles_give_the_jax_calls(monkeypatch, native, host_screen):
    """More than 15 alleles do not fit the 4-bit encodings: such tiles are
    full per-element tiles and take the dense kernel (on the CPU, its plain
    version), where the JAX package runs XLA's tile_stats. Same calls."""
    import torch

    from guacamole_tpu.callers import germline_threshold as jax_gt
    from guacamole_tpu.callers.source import ReadSource as JaxReadSource
    from guacamole_tpu.loci.lociset import LociSet as JaxLociSet
    from guacamole_tpu.loci.partition import (
        partition_loci_uniformly as jax_partition,
    )
    from guacamole_tpu.runtime.columnar import (
        columnar_from_reads as jax_columnar,
    )
    from guacamole_tpu_torch.callers.source import ReadSource
    from guacamole_tpu_torch.loci.lociset import LociSet
    from guacamole_tpu_torch.loci.partition import partition_loci_uniformly
    from guacamole_tpu_torch.ops import dispatch
    from guacamole_tpu_torch.runtime.columnar import columnar_from_reads
    from test_pack import synthetic_reads

    monkeypatch.setenv("GUAC_HOST_SCREEN", host_screen)
    reads = sorted(
        (r for r in synthetic_reads()
         if r.cigar.read_length == len(r.sequence)),
        key=lambda r: r.start,
    )
    launched = []
    real = dispatch.screen_dense_launch
    monkeypatch.setattr(
        dispatch, "screen_dense_launch",
        lambda *a, **k: launched.append(1) or real(*a, **k),
    )
    jax_source = (
        JaxReadSource.from_columnar(jax_columnar(reads, native=True))
        if native else reads
    )
    port_source = (
        ReadSource.from_columnar(columnar_from_reads(reads, native=True))
        if native else reads
    )
    want = jax_gt.call_variants(
        jax_source, jax_partition(2, JaxLociSet.of("chr1", 0, 20)),
        threshold_percent=8, max_alleles=16,
    )
    got = port_gt.call_variants(
        port_source, partition_loci_uniformly(2, LociSet.of("chr1", 0, 20)),
        threshold_percent=8, max_alleles=16, device=torch.device("cpu"),
    )
    assert launched
    key = lambda c: (  # noqa: E731
        c.contig, c.start, c.allele.ref_bases, c.allele.alt_bases, c.labels,
    )
    assert [key(c) for c in got] == [key(c) for c in want]
    assert got
