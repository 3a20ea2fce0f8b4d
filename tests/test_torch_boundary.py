"""The port's boundary: guacamole_tpu_torch imports neither jax nor any
module of the JAX package guacamole_tpu.

A machine with a GPU need not have JAX installed, and the port stands
alone: it keeps its own copies of the host layers. A subprocess with both
`jax` and `guacamole_tpu` blocked imports every port module and runs each
of the port's caller commands (variant-support, vaf-histogram and
structural-variant too), and its forward step, to the end on the CPU.
"""

import os
import re
import subprocess
import sys

import pytest

from guacamole_tpu.utils.simulate import make_scale_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "guacamole_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def port_sources():
    paths = [SMOKE, os.path.join(ROOT, "chip_tune.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        paths += [
            os.path.join(dirpath, name)
            for name in files
            if name.endswith((".py", ".cu", ".cuh"))
        ]
    return sorted(paths)


def port_modules():
    mods = []
    for path in port_sources():
        if path.endswith(".py") and path != SMOKE:
            mod = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
            mods.append(mod[: -len(".__init__")] if mod.endswith(
                ".__init__") else mod)
    return mods


def _offenders(pattern):
    pattern = re.compile(pattern, re.MULTILINE)
    offenders = []
    for path in port_sources():
        with open(path) as fh:
            if pattern.search(fh.read()):
                offenders.append(os.path.relpath(path, ROOT))
    return offenders


def test_no_port_source_imports_jax():
    assert not _offenders(r"^\s*(import\s+jax\b|from\s+jax\b)")


def test_no_port_source_imports_the_jax_package():
    # `guacamole_tpu` followed by a dot or a space, so that
    # guacamole_tpu_torch itself does not match.
    assert not _offenders(r"^\s*(import|from)\s+guacamole_tpu(\.|\s)")


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sim"))
    manifest = make_scale_fixture(out, scale=0.02, seed=7)
    return {k: os.path.join(out, v) for k, v in manifest["files"].items()}


@pytest.fixture(scope="module")
def fixture_bam(fixture_files):
    return fixture_files["germline_bam"]


def test_port_runs_germline_threshold_with_jax_blocked(tmp_path, fixture_bam):
    _run_blocked(
        tmp_path, fixture_bam, "germline-threshold", ["--threshold", "25"], 100
    )


def test_port_runs_germline_standard_with_jax_blocked(tmp_path, fixture_bam):
    _run_blocked(tmp_path, fixture_bam, "germline-standard", [], 1000)


def test_port_runs_somatic_standard_with_jax_blocked(tmp_path, fixture_files):
    _run_blocked(
        tmp_path, None, "somatic-standard",
        ["--tumor-reads", fixture_files["tumor_bam"], "--normal-reads",
         fixture_files["normal_bam"], "--odds", "20"],
        10,
    )


def _main_blocked(*argvs):
    """Body for _run_code_blocked: run the port's CLI on each argv in
    turn, on the CPU; rc is the first non-zero exit code."""
    body = "from guacamole_tpu_torch.cli import main\nrc = 0\n"
    for argv in argvs:
        body += (
            f"rc = rc or main([*{argv!r}, '--device', 'cpu', '--debug'])\n"
        )
    return body


def _lines(path):
    with open(path) as fh:
        return fh.read().splitlines()


def test_port_runs_variant_support_with_jax_blocked(tmp_path, fixture_files):
    sites, out = str(tmp_path / "sites.vcf"), str(tmp_path / "support.csv")
    _run_code_blocked(_main_blocked(
        ["germline-threshold", "--reads", fixture_files["germline_bam"],
         "--threshold", "25", "--out", sites],
        ["variant-support", "-v", sites, "-o", out,
         fixture_files["germline_bam"], fixture_files["tumor_bam"]],
    ))
    assert len(_lines(out)) >= 200


def test_port_runs_vaf_histogram_with_jax_blocked(tmp_path, fixture_bam):
    out = str(tmp_path / "vaf.csv")
    _run_code_blocked(_main_blocked(
        ["vaf-histogram", "--cluster", "--out", out, fixture_bam],
    ))
    assert len(_lines(out)) >= 10


def test_port_runs_structural_variant_with_jax_blocked(tmp_path):
    from guacamole_tpu.utils.simulate import make_sv_fixture

    manifest = make_sv_fixture(
        str(tmp_path), length=250_000, depth=16,
        deletions=((90_000, 4_000),), seed=11,
    )
    sam, out = str(tmp_path / manifest["files"]["sv_sam"]), str(
        tmp_path / "sv.txt")
    _run_code_blocked(_main_blocked(
        ["structural-variant", "--reads", sam, "--output", out],
    ))
    assert "GenomeRange(svcontig,89953,94056)" in _lines(out)[0]


def test_port_runs_its_forward_step_with_jax_blocked():
    _run_code_blocked(
        "from guacamole_tpu_torch.entry import entry\n"
        "forward, args = entry('cpu')\n"
        "counts, candidates, ll = forward(*args)\n"
        "assert counts.shape == (128, 8) and ll.shape == (128, 36)\n"
        "assert bool(candidates.any()) and bool(ll.isfinite().all())\n"
        "rc = 0\n"
    )


def _run_code_blocked(body):
    """Run `body` (which sets rc) in a subprocess with jax and the JAX
    package blocked, after importing every module of the port."""
    modules = port_modules()
    assert "guacamole_tpu_torch.cli" in modules
    assert "guacamole_tpu_torch.callers.somatic_standard" in modules
    assert "guacamole_tpu_torch.callers.vaf_histogram" in modules
    assert "guacamole_tpu_torch.assembly.debruijn" in modules
    assert "guacamole_tpu_torch.entry" in modules
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None  # any 'import jax' now raises\n"
        "sys.modules['guacamole_tpu'] = None\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        + body +
        "leaked = sorted(\n"
        "    m for m, mod in sys.modules.items()\n"
        "    if mod is not None and (\n"
        "        m in ('jax', 'jaxlib', 'guacamole_tpu')\n"
        "        or m.startswith(('jax.', 'jaxlib.', 'guacamole_tpu.'))))\n"
        "assert not leaked, leaked\n"
        "sys.exit(rc)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]


def _run_blocked(tmp_path, fixture_bam, command, extra, min_records):
    vcf = str(tmp_path / "out.vcf")
    reads = [] if fixture_bam is None else ["--reads", fixture_bam]
    _run_code_blocked(
        "from guacamole_tpu_torch.cli import main\n"
        f"rc = main([{command!r}, *{reads!r}, *{extra!r},\n"
        f"           '--out', {vcf!r}, '--device', 'cpu', '--debug'])\n"
    )
    with open(vcf) as fh:
        records = [ln for ln in fh if not ln.startswith("#")]
    assert len(records) >= min_records
