"""somatic-standard on the benchmark's tumor/normal WGS configuration
(gpu_bench/configs/hmf-wgs-tn106x38x.json: 106x tumor, 38x normal, 150 bp)
cut to 30 kbp, against the benchmark's plain reference, record for record.

Only the scale is cut: the contig and its one target shrink to 30 kbp, and
the somatic density rises so that some 60 somatic sites exist (the f32
control needs calls whose GQ its rounding moves). Depths, read length,
qualities and the germline model are the file's. The port runs on its
normal CLI path (streaming .bai input) with --device cpu, with the host
screen (GUAC_HOST_SCREEN=1) and with the device screen on the kernels'
plain PyTorch versions (GUAC_HOST_SCREEN=0)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "gpu_bench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import sample as S  # noqa: E402  (gpu_bench/sample.py)
from run import records_differing, reference_command, vcf_records  # noqa: E402

from guacamole_tpu_torch.cli import main as program  # noqa: E402

CONFIG = os.path.join(BENCH, "configs", "hmf-wgs-tn106x38x.json")
WIDTH = 30_000
SOMATIC_PER_KBP = 2.0
SEEDS = (41, 42)
OPTIONS = {"tumor": "tumor", "normal": "normal", "odds": 20, "min_mapq": 1}


def cut_config(width=WIDTH, somatic_per_kbp=SOMATIC_PER_KBP):
    """The configuration with its scale cut: contig and target `width` bp
    (the file's 200 bp margins kept), `somatic_per_kbp` somatic SNVs."""
    cfg = copy.deepcopy(S.load_config(CONFIG))
    margin = cfg["contig_length"] - cfg["targets"]["width"]
    cfg["contig_length"] = width + margin
    cfg["targets"].update(width=width, spacing=width,
                          somatic_per_kbp=somatic_per_kbp)
    return cfg


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hmf_tn"))
    ref = reference_command("somatic-standard")
    out = {}
    for seed in SEEDS:
        smp, paths, _ = S.ensure_sample(cut_config(), seed, root)
        out[seed] = (paths, ref.call(smp, OPTIONS), ref.control(smp, OPTIONS))
    return out


def test_the_cut_keeps_the_published_shapes():
    full, cut = S.load_config(CONFIG), cut_config()
    assert full["depth"] == cut["depth"] == {"tumor": 106, "normal": 38}
    assert full["genome"] == cut["genome"]
    assert cut["genome"]["read_length"] == 150
    assert full["reduced"] == ["contig_length"]


@pytest.mark.parametrize("host_screen", ["1", "0"])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_equals_the_plain_reference(samples, seed, host_screen,
                                         tmp_path, monkeypatch):
    paths, want, control = samples[seed]
    monkeypatch.setenv("GUAC_HOST_SCREEN", host_screen)
    monkeypatch.setenv("GUAC_CACHE_DIR", str(tmp_path / "cache"))
    out = str(tmp_path / "out.vcf")
    assert program([
        "somatic-standard", "--tumor-reads", paths["tumor"],
        "--normal-reads", paths["normal"], "--odds", "20", "--out", out,
        "--device", "cpu",
    ]) == 0
    assert len(want) > 20
    assert records_differing(vcf_records(out), want) == 0
    # The reference in float32 is told apart by the same check.
    assert records_differing(control, want) > 0
