"""The harness end to end on the CPU (the program with --device cpu, its
look for a GPU skipped): a sound run is correct; a run whose timed path is
broken underneath is not, for each fault a cell of this system can have.
Also the check for modules of JAX, and the card's own run."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

import run as harness
from conftest import BENCH, HERE, ROOT

CELLS = {"wgs35x.germline-threshold": "tiny_snv_dense"}
# Cells of the likelihood callers, added here as a later change would add
# them: a configuration and an entry, on the traffic mixes germline-standard
# and somatic-standard.
ADDED = {"tiny.germline-standard": ("tiny_germline", "germline-standard"),
         "tiny.somatic-standard": ("tiny_tumor_normal", "somatic-standard")}


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """Cells of BENCHMARK.json on the tiny configurations."""
    here = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics", "rooflines"):
        shutil.copytree(os.path.join(BENCH, d), here / d)
    for name in set(CELLS.values()) | {c for c, _ in ADDED.values()}:
        shutil.copy(os.path.join(HERE, name + ".json"), here / "configs")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for w in bench["workloads"]:
        w["config"] = CELLS[w["name"]]
    for name, (config, traffic) in ADDED.items():
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1})
    monkeypatch.setattr(harness, "CACHE_DIR", str(tmp_path / "cache"))

    def run(name, trace=False, seed=41):
        cell = harness.Cell(bench, name, here=str(here))
        return harness.run_cell(
            cell, seed, 0.0, trace, device="cpu",
            samples_dir=str(tmp_path / "samples"),
            work_dir=str(tmp_path / "work"))
    return run


@pytest.mark.parametrize("name", sorted(CELLS) + sorted(ADDED))
def test_a_sound_run_is_correct(tiny, name):
    result = tiny(name)
    assert result["correct"] and result["attempted"] >= 1
    assert list(result)[-1] == "compared"
    assert result["compared"]["records_differing"]["value"] == 0
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}


def test_a_traced_run_reports_the_layers(tiny):
    result = tiny("wgs35x.germline-threshold", trace=True)
    assert result["correct"]
    for name in ("decode_s", "pack_s", "confirm_s"):
        assert result["metrics"][name]["value"] > 0
    # No device here: no device metric is read.
    assert "device_idle_share" not in result["metrics"]


def _drop_half_the_reads(monkeypatch):
    """Half of the batch left out: every other read of each partition
    task, as the streaming decode hands them on."""
    import numpy as np

    from guacamole_tpu_torch.callers import streaming
    from guacamole_tpu_torch.callers.source import ReadSource

    real = streaming.iter_task_sources

    def half(*args, **kwargs):
        it = real(*args, **kwargs)
        if it is None:
            return None
        for task, loci, src in it:
            cols = src._cols
            keep = np.arange(cols.n) % 2 == 0
            yield task, loci, ReadSource.from_columnar(cols.select(keep))
    monkeypatch.setattr(streaming, "iter_task_sources", half)


def _screen_flags_nothing(monkeypatch):
    """A step that returns its state unchanged: the screens flag no row."""
    import numpy as np

    from guacamole_tpu_torch.callers import germline_threshold
    from guacamole_tpu_torch.ops import dispatch

    real = dispatch.candidates_of
    monkeypatch.setattr(dispatch, "candidates_of",
                        lambda r: np.zeros_like(real(r)))
    monkeypatch.setattr(germline_threshold, "call_tile",
                        lambda *a, **k: [])


def _alter_answers(monkeypatch):
    """An answer altered where it is produced: every seventh record's
    genotype quality, or for the counting caller its genotype, changed."""
    from guacamole_tpu_torch.callers import (
        germline_standard,
        germline_threshold,
        somatic_standard,
    )

    def every_seventh(fn, change):
        seen = [0]

        def wrapped(call):
            rec = fn(call)
            if seen[0] % 7 == 0:
                change(rec)
            seen[0] += 1
            return rec
        return wrapped

    def gq(rec):
        rec.genotype_quality += 1

    def gt(rec):
        rec.genotype = (("Alt", "Alt") if rec.genotype != ("Alt", "Alt")
                        else ("Ref", "Alt"))

    monkeypatch.setattr(
        germline_standard, "called_allele_to_vcf_record",
        every_seventh(germline_standard.called_allele_to_vcf_record, gq))
    monkeypatch.setattr(
        somatic_standard, "called_somatic_allele_to_vcf_record",
        every_seventh(somatic_standard.called_somatic_allele_to_vcf_record,
                      gq))
    cls = germline_threshold.ThresholdCall
    monkeypatch.setattr(cls, "to_vcf_record",
                        every_seventh(cls.to_vcf_record, gt))


FAULTS = [_drop_half_the_reads, _screen_flags_nothing, _alter_answers]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
@pytest.mark.parametrize("name", sorted(CELLS) + sorted(ADDED))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, name, fault):
    fault(monkeypatch)
    result = tiny(name)
    assert not result["correct"]
    assert result["compared"]["records_differing"]["value"] > 0


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    import guacamole_tpu_torch  # noqa: F401

    assert harness.forbidden_loaded() == [] or "guacamole_tpu_torch" not in (
        harness.forbidden_loaded())
    for name in ("guacamole_tpu", "guacamole_tpu.cli", "jax", "flax.core",
                 "jaxlib"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_loaded() == ["flax", "guacamole_tpu", "jax",
                                          "jaxlib"]


def test_no_result_without_a_card():
    """Off the card the command fails and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "wgs35x.germline-threshold", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.card
def test_the_cell_on_the_card(card):
    """One short run of the counting cell, on the card."""
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "wgs35x.germline-threshold", "--seed", "7", "--seconds", "1",
         "--trace", "1"], capture_output=True, text=True, cwd=ROOT,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
