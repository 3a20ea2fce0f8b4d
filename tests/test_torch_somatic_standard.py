"""somatic-standard through the port's CLI against the JAX CLI, record for
record, on the simulated tumor/normal pair (utils/simulate, scale 0.02,
seed 7).

The JAX CLI runs as a subprocess (`python -m guacamole_tpu.cli`); the
port's runs in-process with --device cpu, so the tests can switch between
host screens (the native packer's f64 tumor rule) and "device" screens (on
the CPU: the plain PyTorch version of the tumor form of ll_screen), between
streaming (BAM) and whole-file (SAM) input, and to the dense-tile route
(max_alleles=16 through the Python API: full tiles through the plain
version of stats_ll).
The screens flag different rows by design; the records after the exact f64
confirm must be equal.
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
    "default": ["--odds", "20"],
    "filtered": [
        "--odds", "20", "--min-likelihood", "5",
        "--min-tumor-alternate-read-depth", "2", "--filter-multi-allelic",
    ],
}


@pytest.fixture(scope="module")
def fixture_pair(tmp_path_factory):
    """{"bam": (tumor, normal), "sam": (tumor, normal)} and the manifest."""
    out = str(tmp_path_factory.mktemp("sim"))
    manifest = make_scale_fixture(out, scale=0.02, seed=7)
    files = manifest["files"]
    pair = {
        "bam": (os.path.join(out, files["tumor_bam"]),
                os.path.join(out, files["normal_bam"])),
        "sam": (os.path.join(out, files["tumor"]),
                os.path.join(out, files["normal"])),
    }
    return pair, manifest


@pytest.fixture(scope="module")
def jax_vcfs(fixture_pair, tmp_path_factory):
    """The JAX CLI's VCF for each flag set, each made once."""
    out_dir = tmp_path_factory.mktemp("jax")
    tumor, normal = fixture_pair[0]["bam"]
    made = {}

    def get(name):
        if name not in made:
            out = str(out_dir / f"{name}.vcf")
            r = subprocess.run(
                [sys.executable, "-m", "guacamole_tpu.cli",
                 "somatic-standard", "--tumor-reads", tumor,
                 "--normal-reads", normal, "--out", out, *FLAG_SETS[name]],
                env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=ROOT,
                capture_output=True, text=True, timeout=600,
            )
            assert r.returncode == 0, r.stderr[-2000:]
            made[name] = out
        return made[name]

    return get


def port_run(out_vcf, pair, *args):
    tumor, normal = pair
    assert port_cli.main(
        ["somatic-standard", "--tumor-reads", tumor, "--normal-reads",
         normal, *args, "--out", out_vcf, "--device", "cpu", "--debug"]
    ) == 0
    return out_vcf


def called_positions(vcf):
    with open(vcf) as fh:
        return [
            int(line.split("\t")[1]) - 1
            for line in fh if not line.startswith("#")
        ]


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("host_screen", [True, False])
def test_vcf_equals_jax_cli(
    monkeypatch, tmp_path, fixture_pair, jax_vcfs, host_screen, streaming,
    flags,
):
    monkeypatch.setenv("GUAC_HOST_SCREEN", "1" if host_screen else "0")
    pair = fixture_pair[0]["bam" if streaming else "sam"]
    out = port_run(str(tmp_path / "port.vcf"), pair, *FLAG_SETS[flags])
    cmp = compare_vcf_records(out, jax_vcfs(flags))
    assert cmp.record_level_identical, (cmp.only_a[:5], cmp.only_b[:5])
    assert cmp.matching == (2 if flags == "filtered" else 14)


def test_recovers_planted_somatic_snvs(tmp_path, fixture_pair):
    """The gates of tests/test_simulate.py on the port's own VCF."""
    pairs, manifest = fixture_pair
    called = set(called_positions(
        port_run(str(tmp_path / "som.vcf"), pairs["bam"], "--odds", "20")
    ))
    somatic = set(manifest["truth"]["deep1m"]["somatic_pos"])
    germline = set(manifest["truth"]["deep1m"]["snv_pos"])
    assert somatic
    assert len(called & somatic) / len(somatic) >= 0.5
    assert len(called & germline) <= max(2, len(germline) // 20)


def test_device_screens_run_the_tumor_form(monkeypatch, tmp_path, fixture_pair):
    """With device screens every tumor tile goes through
    tumor_screen_launch with its MAPQ plane (on the CPU the plain version:
    no kernel launch is counted); host screens launch nothing."""
    from guacamole_tpu_torch.ops import cuda_kernels, dispatch

    seen = []
    real = dispatch.ll_screen_arrays_launch

    def spy(ll_pack, ll_mapq, *args, **kwargs):
        seen.append(ll_mapq is not None)
        return real(ll_pack, ll_mapq, *args, **kwargs)

    monkeypatch.setattr(dispatch, "ll_screen_arrays_launch", spy)
    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    dispatch.reset_transfer_stats()
    before = dict(cuda_kernels.LAUNCHES)
    port_run(str(tmp_path / "dev.vcf"), fixture_pair[0]["bam"])
    assert seen and all(seen)
    assert dispatch.TRANSFER_STATS["launches"] >= len(seen)
    assert cuda_kernels.LAUNCHES == before
    monkeypatch.setenv("GUAC_HOST_SCREEN", "1")
    dispatch.reset_transfer_stats()
    port_run(str(tmp_path / "host.vcf"), fixture_pair[0]["bam"])
    assert dispatch.TRANSFER_STATS["launches"] == 0


def _sixteen_allele_calls(pkg, pair):
    """The calls of one package's somatic-standard at max_alleles=16 on
    the fixture's deep contig, keyed by _call_key."""
    import importlib

    common = importlib.import_module(f"{pkg}.callers.common")
    read = importlib.import_module(f"{pkg}.reads.read")
    lociset = importlib.import_module(f"{pkg}.loci.lociset")
    partition = importlib.import_module(f"{pkg}.loci.partition")
    caller = importlib.import_module(f"{pkg}.callers.somatic_standard")
    sources = [
        common.load_read_source(path, read.InputFilters.create(
            non_duplicate=True, has_mdtag=True))[0]
        for path in pair
    ]
    loci = partition.partition_loci_uniformly(
        2, lociset.parse_loci("deep1m:0-20000").result())
    extra = {} if pkg == "guacamole_tpu" else {"device": torch.device("cpu")}
    return [_call_key(c) for c in caller.call_variants(
        *sources, loci, odds_threshold=20, max_alleles=16, **extra)]


@pytest.fixture(scope="module")
def jax_sixteen_alleles(fixture_pair):
    return _sixteen_allele_calls("guacamole_tpu", fixture_pair[0]["bam"])


@pytest.mark.parametrize("host_screen", [True, False])
def test_dense_tiles_give_the_default_vcf(
    monkeypatch, fixture_pair, jax_sixteen_alleles, host_screen
):
    """max_alleles=16: full tiles, screened by the fused dense kernel
    (here its plain version) with host screens as with device screens;
    the calls are the JAX package's at the same max_alleles."""
    from guacamole_tpu_torch.ops import dispatch

    monkeypatch.setenv("GUAC_HOST_SCREEN", "1" if host_screen else "0")
    calls = []
    real = dispatch.screen_dense_launch

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(dispatch, "screen_dense_launch", spy)
    got = _sixteen_allele_calls("guacamole_tpu_torch", fixture_pair[0]["bam"])
    assert calls
    assert got == jax_sixteen_alleles and got


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
    tmp_path, fixture_pair, capsys, extra, message
):
    if "--num-processes" not in extra and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    tumor, normal = fixture_pair[0]["bam"]
    out = str(tmp_path / "x.vcf")
    rc = port_cli.main(
        ["somatic-standard", "--tumor-reads", tumor, "--normal-reads",
         normal, "--out", out, *extra]
    )
    err = capsys.readouterr().err.strip()
    assert rc == 1
    assert message in err and len(err.splitlines()) == 1
    assert not os.path.exists(out)


def _somatic_reads():
    """A tumor with a clear somatic SNV (and one noisy locus) over a clean
    normal, as object reads: tiles pack in Python, with no native
    encodings."""
    from fixtures import make_test_read

    normal = [
        make_test_read("TCGATCGA", "8M", "8", 0, alignment_quality=40 + i % 3)
        for i in range(12)
    ]
    tumor = [
        make_test_read("TCGATCGA", "8M", "8", 0, is_positive_strand=i % 2 == 0)
        for i in range(7)
    ] + [
        make_test_read("TCGGTCGA", "8M", "3A4", 0, is_positive_strand=i % 2 == 0)
        for i in range(6)
    ] + [
        make_test_read("TCGATCTA", "8M", "6G1", 0, alignment_quality=0),
    ]
    return tumor, normal


def _call_both(monkeypatch, host_screen, **kwargs):
    from guacamole_tpu.callers import somatic_standard as jax_ss
    from guacamole_tpu.loci.lociset import LociSet as JaxLociSet
    from guacamole_tpu.loci.partition import (
        partition_loci_uniformly as jax_partition,
    )
    from guacamole_tpu_torch.callers import somatic_standard as port_ss
    from guacamole_tpu_torch.loci.lociset import LociSet
    from guacamole_tpu_torch.loci.partition import partition_loci_uniformly
    monkeypatch.setenv("GUAC_HOST_SCREEN", "1" if host_screen else "0")
    tumor, normal = _somatic_reads()
    span = max(r.end for r in tumor + normal)
    want = jax_ss.call_variants(
        tumor, normal, jax_partition(2, JaxLociSet.of("chr1", 0, span)),
        **kwargs,
    )
    got = port_ss.call_variants(
        tumor, normal, partition_loci_uniformly(2, LociSet.of("chr1", 0, span)),
        device=torch.device("cpu"), **kwargs,
    )
    return got, want


def _call_key(c):
    return (
        c.reference_contig, c.start, c.allele.ref_bases, c.allele.alt_bases,
        np.float64(c.somatic_log_odds).tobytes(),
        c.tumor_variant_evidence.read_depth,
        c.tumor_variant_evidence.allele_read_depth,
        np.float64(c.tumor_variant_evidence.likelihood).tobytes(),
        c.normal_reference_evidence.read_depth,
    )


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("host_screen", [True, False])
def test_python_packed_tiles_take_the_counting_screen(
    monkeypatch, host_screen, dense
):
    """Reads given as objects pack in Python into full tiles with neither
    ll_candidates nor ll_mapq: the screen takes screen_tile_launch over
    the MAPQ-passing elements, as the JAX package does (nibble rows into
    the CSR screen, or the dense kernel at max_alleles=16). The calls
    equal the JAX package's at the same max_alleles, the somatic odds bit
    for bit."""
    from guacamole_tpu_torch.ops import dispatch

    launched, dense_launched = [], []
    for name, seen in (("screen_tile_launch", launched),
                       ("screen_dense_launch", dense_launched)):
        real = getattr(dispatch, name)
        monkeypatch.setattr(
            dispatch, name,
            lambda *a, _seen=seen, _real=real, **k: (
                _seen.append(1) or _real(*a, **k)),
        )
    got, want = _call_both(
        monkeypatch, host_screen, odds_threshold=2,
        max_alleles=16 if dense else 8,
    )
    assert launched and bool(dense_launched) == dense
    assert [_call_key(c) for c in got] == [_call_key(c) for c in want]
    assert got


def test_tile_packed_with_another_min_mapq_raises(fixture_pair):
    """--min-mapq has to reach both the packer and the screen."""
    from guacamole_tpu_torch.callers.common import load_read_source
    from guacamole_tpu_torch.ops.dispatch import tumor_screen_launch
    from guacamole_tpu_torch.reads.read import InputFilters

    tumor, _normal = fixture_pair[0]["bam"]
    source, lengths = load_read_source(
        tumor, InputFilters.create(non_duplicate=True, has_mdtag=True))
    contig = next(iter(lengths))
    from guacamole_tpu_torch.loci.lociset import LociSet

    tile = next(iter(source.iter_tiles(
        contig, LociSet.of(contig, 0, 5000).on_contig(contig),
        fields="likelihood_mapq", min_mapq=1,
    )))
    assert tile.ll_mapq is not None
    cpu = torch.device("cpu")
    assert tumor_screen_launch(tile, min_mapq=1, device=cpu).result().shape == (
        tile.L,
    )
    with pytest.raises(ValueError, match="min_mapq=1 but the screen requested"):
        tumor_screen_launch(tile, min_mapq=20, device=cpu)


def test_mesh_argument_is_refused():
    """A mesh is taken now (tests/test_torch_mesh.py holds its calls to
    the JAX package's); what is refused is a mesh with no device."""
    from guacamole_tpu_torch.callers import somatic_standard as port_ss
    from guacamole_tpu_torch.parallel.mesh import loci_mesh

    with pytest.raises(ValueError, match="at least one device"):
        port_ss.call_variants(
            [], [], None, mesh=loci_mesh([]), device=torch.device("cpu"))
