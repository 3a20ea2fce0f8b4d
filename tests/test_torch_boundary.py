"""The port's boundary: guacamole_tpu_torch imports neither jax nor any
module of the JAX package guacamole_tpu.

A machine with a GPU need not have JAX installed, and the port stands
alone: it keeps its own copies of the host layers. A subprocess with both
`jax` and `guacamole_tpu` blocked imports every port module and runs both
of the port's caller commands to the end on the CPU.
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
    paths = [SMOKE]
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
def fixture_bam(tmp_path_factory):
    out = tmp_path_factory.mktemp("sim")
    manifest = make_scale_fixture(str(out), scale=0.02, seed=7)
    return os.path.join(str(out), manifest["files"]["germline_bam"])


def test_port_runs_germline_threshold_with_jax_blocked(tmp_path, fixture_bam):
    _run_blocked(
        tmp_path, fixture_bam, "germline-threshold", ["--threshold", "25"], 100
    )


def test_port_runs_germline_standard_with_jax_blocked(tmp_path, fixture_bam):
    _run_blocked(tmp_path, fixture_bam, "germline-standard", [], 1000)


def _run_blocked(tmp_path, fixture_bam, command, extra, min_records):
    vcf = str(tmp_path / "out.vcf")
    modules = port_modules()
    assert "guacamole_tpu_torch.cli" in modules
    assert "guacamole_tpu_torch.callers.germline_standard" in modules
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None  # any 'import jax' now raises\n"
        "sys.modules['guacamole_tpu'] = None\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        "from guacamole_tpu_torch.cli import main\n"
        f"rc = main([{command!r}, '--reads', {fixture_bam!r}, *{extra!r},\n"
        f"           '--out', {vcf!r}, '--device', 'cpu', '--debug'])\n"
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
    with open(vcf) as fh:
        records = [ln for ln in fh if not ln.startswith("#")]
    assert len(records) >= min_records
