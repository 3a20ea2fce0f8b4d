"""The port's device mesh (guacamole_tpu_torch/parallel/mesh.py) against the
JAX package's, on the CPU.

A torch mesh may name one device several times (each shard then has its
own stream on a card); here [cpu] * 2 and [cpu] * 4 stand for two and four
devices, against JAX's loci_mesh over 2 and 4 of the 8 virtual CPU devices
that tests/conftest.py gives JAX. Inputs are the simulated fixture
(utils/simulate, scale 0.02, seed 7). Checked: the mesh screens (counts
and flags bit-equal, the same yield order, a partial final group and an
empty tile included, each launch on its shard's device), the sharded call
step (integers exact, likelihoods within 1e-5), dryrun_multichip's totals,
the five device callers with mesh= against the JAX callers with mesh=, and
`--mesh on --device cpu` through the port's CLI against the JAX CLI's
`--mesh on`.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from guacamole_tpu.callers.source import ReadSource as JaxReadSource  # noqa: E402
from guacamole_tpu.loci.lociset import parse_loci as jax_parse_loci  # noqa: E402
from guacamole_tpu.parallel import mesh as jax_mesh  # noqa: E402
from guacamole_tpu.reads.read import InputFilters as JaxFilters  # noqa: E402
from guacamole_tpu.utils.simulate import make_scale_fixture  # noqa: E402
from guacamole_tpu_torch import cli as port_cli  # noqa: E402
from guacamole_tpu_torch.ops import dispatch  # noqa: E402
from guacamole_tpu_torch.parallel import mesh as port_mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LOCI = "deep1m:0-20000,shallow8m:0-40000"


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    out = tmp_path_factory.mktemp("sim")
    manifest = make_scale_fixture(str(out), scale=0.02, seed=7)
    return {k: os.path.join(str(out), v) for k, v in manifest["files"].items()}


@pytest.fixture(scope="module")
def germline_source(fx):
    from guacamole_tpu.callers.common import load_read_source

    src, _ = load_read_source(
        fx["germline_bam"],
        JaxFilters.create(non_duplicate=True, has_mdtag=True),
    )
    return src


def _tiles(source, fields, tile_size=2048, **kw):
    """Seven non-empty tiles of the fixture (JAX's packer; the port's
    functions read the same attributes), with an empty tile after the
    third: the last group of 2 and of 4 is partial."""
    loci = jax_parse_loci(LOCI).result()
    tiles = []
    for contig in loci.contigs:
        tiles.extend(source.iter_tiles(
            contig, loci.on_contig(contig), tile_size=tile_size, fields=fields,
            **kw,
        ))
    tiles = [t for t in tiles if t.L][:7]
    assert len(tiles) == 7
    return tiles[:3] + [SimpleNamespace(L=0)] + tiles[3:]


def _jax_results(iterator):
    out = []
    for (i, _tile), pending in iterator:
        out.append((i, None if pending is None else pending.result()))
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("threshold", [25, None], ids=["threshold", "full"])
def test_mesh_csr_screens_equal_jax(germline_source, n, threshold, monkeypatch):
    tiles = _tiles(germline_source, "screen")
    items = list(enumerate(tiles))
    want = _jax_results(jax_mesh.mesh_csr_screens(
        items, tile_of=lambda it: it[1],
        mesh=jax_mesh.loci_mesh(jax.devices()[:n]),
        threshold_percent=threshold,
    ))
    mesh = port_mesh.loci_mesh([CPU] * n)
    launched = []
    real = dispatch.screen_csr_launch

    def spy(*args, device, **kwargs):
        launched.append(device)
        return real(*args, device=device, **kwargs)

    monkeypatch.setattr(dispatch, "screen_csr_launch", spy)
    got_pendings = list(port_mesh.mesh_csr_screens(
        items, tile_of=lambda it: it[1], mesh=mesh,
        threshold_percent=threshold,
    ))
    assert [i for (i, _t), _p in got_pendings] == [i for i, _r in want]
    live = [p for _it, p in got_pendings if p is not None]
    # Shards take the tiles of a group in turn; the partial final group
    # launches only its own tiles.
    assert [p.shard for p in live] == [k % n for k in range(len(live))]
    assert all(p.device == mesh.devices[p.shard] for p in live)
    assert launched == [p.device for p in live]
    for ((i, tile), pending), (j, res) in zip(got_pendings, want):
        assert i == j
        if res is None:
            assert pending is None and not tile.L
            continue
        got = pending.result()
        assert got.counts.dtype == np.int16 and got.counts.shape == (
            tile.L, tile.K)
        np.testing.assert_array_equal(got.counts, np.asarray(res.counts))
        np.testing.assert_array_equal(
            got.candidates, np.asarray(res.candidates))
        # ... and equal to the port's sequential screen of the same tile.
        seq = real(
            *port_mesh.csr_of(tile), np.asarray(tile.is_variant), tile.K,
            threshold_percent=threshold, device=CPU,
        ).result()
        np.testing.assert_array_equal(got.counts, seq.counts[: tile.L])


@pytest.fixture(scope="module")
def tumor_objects(fx):
    """A ReadSource of the tumor reads over deep1m:0-5000 as objects, so
    that tiles pack in Python."""
    from guacamole_tpu.gio.load import load_read_set

    return JaxReadSource.from_reads(load_read_set(
        fx["tumor_bam"], JaxFilters.create(
            non_duplicate=True, has_mdtag=True,
            overlaps_loci=jax_parse_loci("deep1m:0-5000")),
    ).mapped_reads)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", ["germline", "tumor", "tumor_objects"])
def test_mesh_ll_screens_equal_jax(fx, germline_source, tumor_objects, n,
                                   form):
    """Native tiles, and tumor tiles that objects packed in Python (full
    per-element tensors, no native ll_pack: both meshes pack the uint16
    form and the MAPQ plane from them)."""
    from guacamole_tpu.callers.common import load_read_source

    if form == "germline":
        source, fields, kw = germline_source, "likelihood", {}
        screen_kw = dict(min_mapq=1, min_phred=30.0)
    else:
        filters = JaxFilters.create(non_duplicate=True, has_mdtag=True)
        if form == "tumor":
            source, _ = load_read_source(fx["tumor_bam"], filters)
        else:
            source = tumor_objects
        fields, kw = "likelihood_mapq", {"ll_screen_kind": 2}
        screen_kw = dict(min_mapq=1, include_alignment=True)
    tiles = _tiles(source, fields, min_mapq=1,
                   tile_size=512 if form == "tumor_objects" else 2048, **kw)
    items = list(enumerate(tiles))
    want = _jax_results(jax_mesh.mesh_ll_screens(
        items, tile_of=lambda it: it[1],
        mesh=jax_mesh.loci_mesh(jax.devices()[:n]), **screen_kw,
    ))
    got = list(port_mesh.mesh_ll_screens(
        items, tile_of=lambda it: it[1],
        mesh=port_mesh.loci_mesh([CPU] * n), **screen_kw,
    ))
    assert [i for (i, _t), _p in got] == [i for i, _r in want]
    n_flags = 0
    for ((_i, tile), pending), (_j, res) in zip(got, want):
        if res is None:
            assert pending is None
            continue
        flags = pending.result()
        assert flags.dtype == bool and flags.shape == (tile.L,)
        np.testing.assert_array_equal(flags, np.asarray(res))
        n_flags += int(flags.sum())
    assert n_flags > 0


def test_groups_in_flight_bound_the_pendings_held(germline_source,
                                                 monkeypatch):
    tiles = _tiles(germline_source, "screen")
    launched = []
    real = dispatch.screen_csr_launch

    def spy(*args, **kwargs):
        launched.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(dispatch, "screen_csr_launch", spy)
    it = port_mesh.mesh_csr_screens(
        tiles, tile_of=lambda t: t, mesh=port_mesh.loci_mesh([CPU] * 2),
        groups_in_flight=1,
    )
    # The first group (two tiles) launches; the third tile waits for its
    # group, and the empty tile makes three items in flight, one more than
    # groups_in_flight * n: the first tile comes out, after two launches.
    first, pending = next(it)
    assert first is tiles[0] and pending is not None and len(launched) == 2
    assert len(list(it)) == len(tiles) - 1 and len(launched) == 7


def test_skip_nibbles_tile_never_reaches_a_launch():
    tile = SimpleNamespace(
        L=2, K=2, csr_nib=np.zeros(0, np.uint8),
        csr_off=np.array([0, 1, 2], np.int32),
        is_variant=np.zeros((2, 2), bool),
    )
    with pytest.raises(RuntimeError, match="skip_nibbles"):
        list(port_mesh.mesh_csr_screens(
            [tile], tile_of=lambda t: t, mesh=port_mesh.loci_mesh([CPU])))


def _example_tiles(n):
    from guacamole_tpu_torch.entry import _example_tile

    fields = ("allele_id", "qual", "mapq", "strand", "valid", "is_variant")
    return [
        SimpleNamespace(**dict(zip(fields, _example_tile(L=64, D=16, seed=s))))
        for s in range(n)
    ]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_call_step_equals_jax(n):
    tiles = _example_tiles(n)
    want = jax_mesh.sharded_call_step(
        tiles, mesh=jax_mesh.loci_mesh(jax.devices()[:n]))
    got = port_mesh.sharded_call_step(tiles, mesh=port_mesh.loci_mesh([CPU] * n))
    for field in ("counts", "forward_counts", "depth", "candidates"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field,
        )
    np.testing.assert_allclose(
        got.log_likelihoods.numpy(), np.asarray(want.log_likelihoods),
        rtol=1e-5, atol=1e-5,
    )
    assert int(got.total_elements) == int(want.total_elements)
    assert int(got.total_candidates) == int(want.total_candidates)
    with pytest.raises(ValueError, match="one per shard"):
        port_mesh.sharded_call_step(tiles[:1], mesh=port_mesh.loci_mesh([CPU] * n))


def test_dryrun_multichip_totals_equal_jax(capsys):
    import re

    sys.path.insert(0, ROOT)
    import __graft_entry__ as graft

    from guacamole_tpu_torch.entry import dryrun_multichip

    graft.dryrun_multichip(4)
    want = capsys.readouterr().out
    got = dryrun_multichip(4, device="cpu")
    pattern = r"(\d+) elements, (\d+) candidate loci"
    assert re.search(pattern, got).groups() == re.search(pattern, want).groups()
    assert "callers skipped" in got


def _sam_subset(src, dst, contig, start, end, rename):
    """The records of `src` on `contig` that start in [start, end), the
    contig renamed, with the header's other @SQ lines dropped."""
    with open(src) as fh, open(dst, "w") as out:
        for line in fh:
            f = line.split("\t")
            if line.startswith("@SQ"):
                if f[1] == f"SN:{contig}":
                    out.write(line.replace(f"SN:{contig}", f"SN:{rename}"))
            elif line.startswith("@"):
                out.write(line)
            elif f[2] == contig and start <= int(f[3]) - 1 < end:
                f[2] = rename
                out.write("\t".join(f))


def test_dryrun_multichip_runs_the_six_callers_where_inputs_are(
    fx, tmp_path
):
    """With a directory laid out as the reference's test resources (here
    made from the simulated fixtures, the contigs renamed chrM and 20),
    dryrun_multichip also runs the six callers over the mesh against their
    sequential runs, as the original does."""
    from guacamole_tpu.gio.bamwrite import sam_to_bam
    from test_torch_tools import _paired_bam

    from guacamole_tpu_torch.entry import dryrun_multichip

    res = tmp_path / "resources"
    res.mkdir()
    germline = fx["germline_bam"].replace(".bam", ".sam")
    _sam_subset(germline, tmp_path / "chrM.sam", "deep1m", 0, 5000, "chrM")
    sam_to_bam(str(tmp_path / "chrM.sam"), str(res / "chrM.sorted.bam"))
    for kind in ("tumor", "normal"):
        _sam_subset(fx[kind + "_bam"].replace(".bam", ".sam"),
                    res / f"{kind}.chr20.tough.sam", "deep1m", 6500, 8000,
                    "20")
    sv = make_sv_fixture_in(tmp_path / "sv")
    with open(sv) as fh:
        text = fh.read().replace("svcontig", "20")
    with open(tmp_path / "sv20.sam", "w") as fh:
        fh.write(text)
    _paired_bam(str(tmp_path / "sv20.sam"),
                str(res / "gatk_mini_bundle_extract.bam"))
    with open(res / "truth.chr20.vcf", "w") as fh:
        fh.write("##fileformat=VCFv4.1\n#CHROM\tPOS\tID\tREF\tALT\t"
                 "QUAL\tFILTER\tINFO\tFORMAT\tsim\n")
        for pos in (10_001, 50_001, 90_501, 120_001):
            fh.write(f"20\t{pos}\t.\tA\tC\t.\t.\t.\tGT\t0/1\n")
    line = dryrun_multichip(2, device="cpu", resources=str(res))
    assert "six callers mesh==sequential" in line, line


def make_sv_fixture_in(out):
    from guacamole_tpu.utils.simulate import make_sv_fixture

    m = make_sv_fixture(str(out), length=150_000, depth=12,
                        deletions=((90_000, 4_000),), seed=11)
    return os.path.join(str(out), m["files"]["sv_sam"])


def test_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="--device"):
        port_mesh.loci_mesh()


# --- the callers ------------------------------------------------------------


def _partitions(pkg_loci, pkg_partition, n=3):
    return pkg_partition(n, pkg_loci(LOCI).result())


@pytest.fixture(scope="module")
def port_sources(fx):
    from guacamole_tpu_torch.callers.common import load_read_source
    from guacamole_tpu_torch.reads.read import InputFilters

    def load(name, **kw):
        return load_read_source(
            fx[name], InputFilters.create(non_duplicate=True, has_mdtag=True,
                                          **kw))[0]

    return load


@pytest.fixture(scope="module")
def jax_sources(fx):
    from guacamole_tpu.callers.common import load_read_source

    def load(name, **kw):
        return load_read_source(
            fx[name], JaxFilters.create(non_duplicate=True, has_mdtag=True,
                                        **kw))[0]

    return load


def _both(name, call, port_sources, jax_sources, **kwargs):
    """(port result over [cpu] * 2, JAX result over 2 virtual devices) of
    one caller module's function `call`, on the same loci partitions."""
    import importlib

    from guacamole_tpu.loci.partition import partition_loci_uniformly as jp
    from guacamole_tpu_torch.loci.lociset import parse_loci
    from guacamole_tpu_torch.loci.partition import partition_loci_uniformly

    port_fn = getattr(
        importlib.import_module(f"guacamole_tpu_torch.callers.{name}"), call)
    jax_fn = getattr(
        importlib.import_module(f"guacamole_tpu.callers.{name}"), call)
    port_args, jax_args = [], []
    for src in kwargs.pop("sources"):
        port_args.append(port_sources(src))
        jax_args.append(jax_sources(src))
    if kwargs.pop("partitioned", True):
        port_args.append(_partitions(parse_loci, partition_loci_uniformly))
        jax_args.append(_partitions(jax_parse_loci, jp))
    else:
        port_args.append(parse_loci(LOCI).result())
        jax_args.append(jax_parse_loci(LOCI).result())
    got = port_fn(*port_args, mesh=port_mesh.loci_mesh([CPU] * 2),
                  device=CPU, **kwargs)
    want = jax_fn(*jax_args, mesh=jax_mesh.loci_mesh(jax.devices()[:2]),
                  **kwargs)
    return got, want


def test_germline_threshold_mesh_equals_jax(port_sources, jax_sources):
    got, want = _both("germline_threshold", "call_variants", port_sources,
                      jax_sources, sources=["germline_bam"],
                      threshold_percent=25)
    key = lambda cs: [str(c.to_vcf_record()) for c in cs]  # noqa: E731
    assert key(got) == key(want) and got


def test_germline_standard_mesh_equals_jax(port_sources, jax_sources):
    got, want = _both("germline_standard", "call_variants", port_sources,
                      jax_sources, sources=["germline_bam"],
                      min_alignment_quality=1, tile_size=0,
                      prefilter_min_likelihood=30)
    key = lambda cs: [  # noqa: E731
        (c.reference_contig, c.start, c.allele.ref_bases, c.allele.alt_bases,
         c.evidence.read_depth, np.float64(c.evidence.likelihood).tobytes())
        for c in cs
    ]
    assert key(got) == key(want) and got


def test_somatic_standard_mesh_equals_jax(port_sources, jax_sources):
    got, want = _both("somatic_standard", "call_variants", port_sources,
                      jax_sources, sources=["tumor_bam", "normal_bam"],
                      odds_threshold=20)
    key = lambda cs: [  # noqa: E731
        (c.reference_contig, c.start, c.allele.ref_bases, c.allele.alt_bases,
         np.float64(c.somatic_log_odds).tobytes())
        for c in cs
    ]
    assert key(got) == key(want) and got


def test_vaf_histogram_mesh_equals_jax(port_sources, jax_sources):
    got, want = _both("vaf_histogram", "variant_loci_from_reads",
                      port_sources, jax_sources, sources=["germline_bam"])
    key = lambda vs: [  # noqa: E731
        (v.contig, v.locus, v.variant_allele_frequency) for v in vs
    ]
    assert key(got) == key(want) and got


def test_variant_support_mesh_equals_jax(port_sources, jax_sources):
    got, want = _both("variant_support", "pileup_allele_counts",
                      port_sources, jax_sources, sources=["germline_bam"],
                      partitioned=False)
    assert [str(c) for c in got] == [str(c) for c in want] and got


@pytest.mark.parametrize(
    "wrapper, caller, sources, kwargs",
    [
        ("call_variants_mesh", "germline_threshold", ["germline_bam"],
         dict(threshold_percent=25)),
        ("call_standard_mesh", "germline_standard", ["germline_bam"],
         dict(min_alignment_quality=1)),
        ("call_somatic_mesh", "somatic_standard", ["tumor_bam", "normal_bam"],
         dict(odds_threshold=20)),
    ],
)
def test_distributed_wrappers_equal_the_sequential_callers(
    port_sources, wrapper, caller, sources, kwargs
):
    """callers/distributed.py over [cpu] * 4 (its device defaults to the
    mesh's first) against the port's caller run one tile after another."""
    import importlib

    from guacamole_tpu_torch.callers import distributed
    from guacamole_tpu_torch.loci.lociset import parse_loci
    from guacamole_tpu_torch.loci.partition import partition_loci_uniformly

    reads = [port_sources(name) for name in sources]
    parts = _partitions(parse_loci, partition_loci_uniformly)
    got = getattr(distributed, wrapper)(
        *reads, parts, mesh=port_mesh.loci_mesh([CPU] * 4), **kwargs)
    want = importlib.import_module(
        f"guacamole_tpu_torch.callers.{caller}").call_variants(
        *reads, parts, tile_size=4096, device=CPU, **kwargs)
    assert [repr(c) for c in got] == [repr(c) for c in want] and got


# --- the CLI ----------------------------------------------------------------


def _cli_runs(fx, sites):
    germline = fx["germline_bam"]
    pair = ["--tumor-reads", fx["tumor_bam"], "--normal-reads",
            fx["normal_bam"]]
    return {
        "threshold.vcf": ["germline-threshold", "--reads", germline,
                          "--threshold", "25", "--out"],
        "standard.vcf": ["germline-standard", "--reads", germline,
                         "--min-likelihood", "30", "--out"],
        "somatic.vcf": ["somatic-standard", *pair, "--odds", "20", "--out"],
        "support.csv": ["variant-support", "-v", sites, germline,
                        fx["tumor_bam"], "-o"],
        "vaf.csv": ["vaf-histogram", "--bins", "20", germline, "--out"],
    }


@pytest.fixture(scope="module")
def jax_cli_out(fx, tmp_path_factory):
    """{output name: bytes} of the JAX CLI with --mesh on (over its 8
    virtual CPU devices), every run in one subprocess."""
    out = str(tmp_path_factory.mktemp("jax"))
    sites = os.path.join(out, "sites.vcf")
    runs = [["germline-threshold", "--reads", fx["germline_bam"],
             "--threshold", "25", "--out", sites]]
    for name, argv in _cli_runs(fx, sites).items():
        runs.append([*argv, os.path.join(out, name), "--mesh", "on"])
    code = (
        "import json, sys\n"
        "from guacamole_tpu.cli import main\n"
        "for argv in json.loads(sys.argv[1]):\n"
        "    assert main(argv) == 0, argv\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code, json.dumps(runs)],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=ROOT,
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    got = {}
    for name in _cli_runs(fx, sites):
        with open(os.path.join(out, name), "rb") as fh:
            got[name] = fh.read()
    return sites, got


@pytest.mark.parametrize(
    "name", ["threshold.vcf", "standard.vcf", "somatic.vcf", "support.csv",
             "vaf.csv"],
)
def test_mesh_on_cli_equals_jax_cli(tmp_path, fx, jax_cli_out, name):
    from guacamole_tpu.concordance import compare_vcf_records

    sites, want = jax_cli_out
    argv = _cli_runs(fx, sites)[name]
    out = str(tmp_path / name)
    assert port_cli.main(
        [*argv, out, "--mesh", "on", "--device", "cpu", "--debug"]) == 0
    with open(out, "rb") as fh:
        got = fh.read()
    if name.endswith(".csv"):
        assert got == want[name] and got
    else:
        jax_vcf = str(tmp_path / ("jax_" + name))
        with open(jax_vcf, "wb") as fh:
            fh.write(want[name])
        cmp = compare_vcf_records(out, jax_vcf)
        assert cmp.record_level_identical and cmp.matching > 0, (
            cmp.only_a[:5], cmp.only_b[:5])


def test_mesh_on_without_cuda_fails_with_one_line(tmp_path, fx, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = port_cli.main(["germline-threshold", "--reads", fx["germline_bam"],
                        "--out", str(tmp_path / "x.vcf"), "--mesh", "on"])
    err = capsys.readouterr().err.strip()
    assert rc == 1 and "--device cpu" in err and len(err.splitlines()) == 1
    assert not os.path.exists(tmp_path / "x.vcf")


def test_mesh_auto_stays_off_on_the_cpu():
    args = SimpleNamespace(mesh="auto", device="cpu")
    assert port_cli._resolve_mesh(args) is None
    args.mesh = "on"
    assert port_cli._resolve_mesh(args).devices == (CPU,)
    args.mesh = "off"
    assert port_cli._resolve_mesh(args) is None
