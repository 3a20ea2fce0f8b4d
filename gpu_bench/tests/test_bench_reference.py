"""The reference against the program on tiny samples (the program with
--device cpu: its plain screens), record for record; and the controls,
which the benchmark's check has to find not correct."""

import json
import os
import shutil

import pytest

import control
import run as harness
import sample as S
from conftest import BENCH, HERE
from run import records_differing, reference_command, vcf_records

CASES = [
    ("tiny_germline", 21, "germline-threshold",
     ["--reads", "{reads}", "--threshold", "25"],
     {"reads": "reads", "threshold": 25}),
    ("tiny_germline", 22, "germline-standard", ["--reads", "{reads}"],
     {"reads": "reads", "min_mapq": 1}),
    ("tiny_tumor_normal", 23, "somatic-standard",
     ["--tumor-reads", "{tumor}", "--normal-reads", "{normal}", "--odds",
      "20"], {"tumor": "tumor", "normal": "normal", "odds": 20,
              "min_mapq": 1}),
]


def _sample(name, seed, tmp_path):
    cfg = S.load_config(os.path.join(HERE, name + ".json"))
    smp, paths, _ = S.ensure_sample(cfg, seed, str(tmp_path))
    return smp, paths


@pytest.mark.parametrize("config,seed,command,args,options", CASES,
                         ids=[c[2] for c in CASES])
def test_reference_equals_the_program(config, seed, command, args, options,
                                      tmp_path, monkeypatch):
    from guacamole_tpu_torch.cli import main as program

    monkeypatch.setenv("GUAC_CACHE_DIR", str(tmp_path / "cache"))
    smp, paths = _sample(config, seed, tmp_path)
    out = str(tmp_path / "out.vcf")
    argv = [command, *[a.format(**paths) for a in args], "--out", out,
            "--device", "cpu"]
    assert program(argv) == 0
    got = vcf_records(out)
    want = reference_command(command).call(smp, options)
    assert len(want) > 0
    assert records_differing(got, want) == 0


CONTROLS = [
    ("tiny_snv_dense", "germline-threshold"),
    ("tiny_germline", "germline-standard"),
    ("tiny_tumor_normal", "somatic-standard"),
]


@pytest.mark.parametrize("config,traffic", CONTROLS,
                         ids=[c[1] for c in CONTROLS])
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_the_control_is_not_correct(config, traffic, seed, tmp_path):
    """control.py on a cell of a tiny configuration: the reference in the
    precision below the configuration's (float32 for the f64 likelihoods),
    or, for the integer percent rule, the share compared as a real number,
    judged by the run's own check, is not correct on every seed."""
    here = tmp_path / "bench"
    shutil.copytree(os.path.join(BENCH, "traffic"), here / "traffic")
    (here / "configs").mkdir()
    shutil.copy(os.path.join(HERE, config + ".json"), here / "configs")
    bench = {"workloads": [{"name": "tiny", "config": config,
                            "traffic": traffic, "chips": 1}],
             "end_to_end": [], "per_layer": []}
    cell = harness.Cell(json.loads(json.dumps(bench)), "tiny",
                        here=str(here))
    line = control.control_run(cell, seed)
    assert line["correct"] is False
    assert line["compared"]["records_differing"]["value"] > 0
