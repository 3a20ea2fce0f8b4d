"""The port's boundary: guacamole_tpu_torch never imports jax.

A machine with a GPU need not have JAX installed, so the port shares only
guacamole_tpu's jax-free host layers. A subprocess with jax blocked
imports every port module and runs the port's germline-threshold CLI to
the end.
"""

import os
import re
import subprocess
import sys

from guacamole_tpu.utils.simulate import make_scale_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "guacamole_tpu_torch")


def port_modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(
                    ".__init__") else mod)
    return sorted(mods)


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.MULTILINE)
    offenders = []
    for dirpath, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(dirpath, name)
                with open(path) as fh:
                    if pattern.search(fh.read()):
                        offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders


def test_port_runs_germline_threshold_with_jax_blocked(tmp_path):
    manifest = make_scale_fixture(str(tmp_path / "sim"), scale=0.02, seed=7)
    bam = str(tmp_path / "sim" / manifest["files"]["germline_bam"])
    vcf = str(tmp_path / "out.vcf")
    modules = port_modules()
    assert "guacamole_tpu_torch.cli" in modules
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None  # any 'import jax' now raises\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        "from guacamole_tpu_torch.cli import main\n"
        f"rc = main(['germline-threshold', '--reads', {bam!r},\n"
        f"           '--threshold', '25', '--out', {vcf!r}, '--debug'])\n"
        "leaked = sorted(m for m in sys.modules\n"
        "                if m.startswith(('jax.', 'jaxlib', 'guacamole_tpu.ops',\n"
        "                                 'guacamole_tpu.parallel')))\n"
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
    assert len(records) >= 100
