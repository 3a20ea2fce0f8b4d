"""germline-standard through the port's CLI against the JAX CLI, record
for record, on the simulated fixture (utils/simulate, scale 0.02, seed 7:
84k reads, 2,224 records, 133 with --min-likelihood 30).

The JAX CLI runs as a subprocess (`python -m guacamole_tpu.cli`); the
port's runs in-process with --device cpu, so the tests can switch between
host screens (the native packer's f64 rule) and "device" screens (on the
CPU: the plain PyTorch version of the ll_screen kernel) and between
streaming and whole-file input. The two screens flag different rows by
design; the records after the exact f64 confirm must be equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from guacamole_tpu.concordance import compare_vcf_records
from guacamole_tpu.utils.simulate import make_scale_fixture
from guacamole_tpu_torch import cli as port_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAG_SETS = {
    "default": [],
    "emit_ref": ["--emit-ref"],
    "min_likelihood": ["--min-likelihood", "30"],
}


@pytest.fixture(scope="module")
def fixture_bam(tmp_path_factory):
    out = tmp_path_factory.mktemp("sim")
    manifest = make_scale_fixture(str(out), scale=0.02, seed=7)
    return os.path.join(str(out), manifest["files"]["germline_bam"])


@pytest.fixture(scope="module")
def jax_vcfs(fixture_bam, tmp_path_factory):
    """The JAX CLI's VCF for each flag set, each made once."""
    out_dir = tmp_path_factory.mktemp("jax")
    made = {}

    def get(name):
        if name not in made:
            out = str(out_dir / f"{name}.vcf")
            r = subprocess.run(
                [sys.executable, "-m", "guacamole_tpu.cli",
                 "germline-standard", "--reads", fixture_bam, "--out", out,
                 *FLAG_SETS[name]],
                env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=ROOT,
                capture_output=True, text=True, timeout=600,
            )
            assert r.returncode == 0, r.stderr[-2000:]
            made[name] = out
        return made[name]

    return get


def port_run(out_vcf, *args):
    assert port_cli.main(
        ["germline-standard", *args, "--out", out_vcf, "--device", "cpu",
         "--debug"]
    ) == 0
    return out_vcf


def n_records(vcf):
    with open(vcf) as fh:
        return sum(1 for line in fh if not line.startswith("#"))


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("host_screen", [True, False])
def test_vcf_equals_jax_cli(
    monkeypatch, tmp_path, fixture_bam, jax_vcfs, host_screen, streaming,
    flags,
):
    monkeypatch.setenv("GUAC_HOST_SCREEN", "1" if host_screen else "0")
    monkeypatch.setenv("GUAC_NO_STREAMING", "0" if streaming else "1")
    out = port_run(
        str(tmp_path / "port.vcf"), "--reads", fixture_bam, *FLAG_SETS[flags]
    )
    cmp = compare_vcf_records(out, jax_vcfs(flags))
    assert cmp.record_level_identical, (cmp.only_a[:5], cmp.only_b[:5])
    assert n_records(out) == (133 if flags == "min_likelihood" else 2224)


def test_device_screens_run_the_likelihood_screen(
    monkeypatch, tmp_path, fixture_bam
):
    """With device screens every tile goes through ll_screen_arrays_launch
    (on the CPU, its plain version: no kernel launch is counted)."""
    from guacamole_tpu_torch.ops import cuda_kernels, dispatch

    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    dispatch.reset_transfer_stats()
    before = cuda_kernels.LAUNCHES["ll_screen"]
    port_run(str(tmp_path / "dev.vcf"), "--reads", fixture_bam)
    assert dispatch.TRANSFER_STATS["launches"] >= 1
    assert cuda_kernels.LAUNCHES["ll_screen"] == before
    monkeypatch.setenv("GUAC_HOST_SCREEN", "1")
    dispatch.reset_transfer_stats()
    port_run(str(tmp_path / "host.vcf"), "--reads", fixture_bam)
    assert dispatch.TRANSFER_STATS["launches"] == 0


@pytest.mark.parametrize(
    "extra, message",
    [
        # --mesh on without a CUDA device: no fallback to a CPU mesh.
        (["--mesh", "on"], "--device cpu"),
        (["--device", "cpu", "--num-processes", "2"], "--coordinator"),
        ([], "--device cpu"),
        (["--device", "cuda"], "--device cpu"),
    ],
)
def test_refusals_fail_with_one_line(
    tmp_path, fixture_bam, capsys, extra, message
):
    if "--num-processes" not in extra and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    out = str(tmp_path / "x.vcf")
    rc = port_cli.main(
        ["germline-standard", "--reads", fixture_bam, "--out", out, *extra]
    )
    err = capsys.readouterr().err.strip()
    assert rc == 1
    assert message in err and len(err.splitlines()) == 1
    assert not os.path.exists(out)


@pytest.mark.parametrize("prefilter", [0, 30])
@pytest.mark.parametrize("host_screen", [True, False])
def test_python_packed_tiles_take_the_likelihood_screen(
    monkeypatch, host_screen, prefilter
):
    """Reads given as objects pack in Python into full tiles with no
    native ll_pack: the port packs their uint16 form (ll_pack_of) and
    screens it, where the JAX package runs a dense counting screen. The
    calls after the exact confirm are the same."""
    from guacamole_tpu.callers import germline_standard as jax_gs
    from guacamole_tpu.loci.lociset import LociSet as JaxLociSet
    from guacamole_tpu.loci.partition import (
        partition_loci_uniformly as jax_partition,
    )
    from guacamole_tpu_torch.callers import germline_standard as port_gs
    from guacamole_tpu_torch.loci.lociset import LociSet
    from guacamole_tpu_torch.loci.partition import partition_loci_uniformly
    from test_pack import synthetic_reads

    monkeypatch.setenv("GUAC_HOST_SCREEN", "1" if host_screen else "0")
    reads = sorted(synthetic_reads(), key=lambda r: r.start)
    want = jax_gs.call_variants(
        reads, jax_partition(2, JaxLociSet.of("chr1", 0, 30)),
        prefilter_min_likelihood=prefilter,
    )
    got = port_gs.call_variants(
        reads, partition_loci_uniformly(2, LociSet.of("chr1", 0, 30)),
        prefilter_min_likelihood=prefilter, device=torch.device("cpu"),
    )
    key = lambda c: (  # noqa: E731
        c.reference_contig, c.start, c.allele.ref_bases, c.allele.alt_bases,
        c.evidence.read_depth, c.evidence.allele_read_depth,
        np.float64(c.evidence.likelihood).tobytes(),
    )
    assert [key(c) for c in got] == [key(c) for c in want]
    assert prefilter or got


def test_mesh_argument_is_refused():
    """A mesh is taken now (tests/test_torch_mesh.py holds its calls to
    the JAX package's); what is refused is a mesh with no device."""
    from guacamole_tpu_torch.callers import germline_standard as port_gs
    from guacamole_tpu_torch.parallel.mesh import loci_mesh

    with pytest.raises(ValueError, match="at least one device"):
        port_gs.call_variants(
            [], None, mesh=loci_mesh([]), device=torch.device("cpu"))
