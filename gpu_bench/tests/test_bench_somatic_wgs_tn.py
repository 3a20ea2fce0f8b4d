"""The tumor/normal WGS cell (wgstn106x38x.somatic-standard) on the CPU.
Its entry in BENCHMARK.json runs the sound run and each planted fault of
test_bench_harness.py on the tiny tumor/normal configuration; its own
configuration cut to 30 kbp (as tests/test_torch_somatic_wgs_tn.py cuts it)
runs through the harness's own run; and the readers of its four program
metrics read nothing from a program without the somatic confirm's spans
and counters and a number from one with them."""

import json
import os
import shutil
import sys

import pytest
from torch.profiler import ProfilerActivity, profile

import run as harness
import sample as S
from conftest import BENCH, ROOT
from test_bench_harness import CELLS, FAULTS, tiny  # noqa: F401 (fixture)

CELL = "wgstn106x38x.somatic-standard"
METRICS = ("sparse_pack_s", "confirm_wait_s", "somatic_confirm_s",
           "flagged_per_kloci")
cut_config = harness.load_module(os.path.join(
    ROOT, "tests", "test_torch_somatic_wgs_tn.py")).cut_config


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.fixture
def cut_cell(bench, tmp_path, monkeypatch):
    """The cell with its configuration cut, in a copy of the harness's
    directories."""
    here = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics", "rooflines"):
        shutil.copytree(os.path.join(BENCH, d), here / d)
    cell = harness.Cell(bench, CELL)
    (here / "configs" / (cell.workload["config"] + ".json")).write_text(
        json.dumps(cut_config()))
    monkeypatch.setattr(harness, "CACHE_DIR", str(tmp_path / "cache"))
    return harness.Cell(bench, CELL, here=str(here))


def test_the_harness_finds_the_cells_files(bench):
    cell = harness.Cell(bench, CELL)
    assert cell.workload["config"] == "hmf-wgs-tn106x38x"
    assert cell.chips == 1 and cell.command == "somatic-standard"
    assert cell.config["depth"] == {"tumor": 106, "normal": 38}
    assert cell.config["genome"]["read_length"] == 150
    assert cell.read_sets() == ["tumor", "normal"]
    assert cell.reference()[1]["odds"] == 20


def test_a_sound_run_of_the_entry_is_correct(tiny):
    result = tiny(CELL)
    assert result["correct"] and result["attempted"] >= 1
    assert result["compared"]["records_differing"]["value"] == 0


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_broken_timed_path_of_the_entry_is_not_correct(tiny, monkeypatch,
                                                         fault):
    fault(monkeypatch)
    result = tiny(CELL)
    assert not result["correct"]
    assert result["compared"]["records_differing"]["value"] > 0


def test_a_run_of_the_cut_cell_is_correct(cut_cell, tmp_path):
    result = harness.run_cell(
        cut_cell, 2**31 + 17, 0.0, False, device="cpu",
        samples_dir=str(tmp_path / "samples"),
        work_dir=str(tmp_path / "work"))
    assert result["correct"] and result["attempted"] >= 1
    assert result["compared"]["records_differing"]["value"] == 0
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}


def _readers():
    return {name: harness.load_module(
        os.path.join(BENCH, "metrics", name + ".py")) for name in METRICS}


def _run_data(calls=2):
    run = harness.RunData()
    run.calls, run.reads_per_call, run.window_s = calls, 1000, 1.0
    return run


def test_the_readers_read_nothing_without_the_spans(monkeypatch):
    from guacamole_tpu_torch.utils import trace

    with profile(activities=[ProfilerActivity.CPU]):
        pass  # an empty session: a program that recorded nothing
    for name, reader in _readers().items():
        assert reader.read(_run_data()) is None, name
    # The spans and counters of a program without the confirm's own (the
    # somatic caller before them recorded these and no more).
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("call"):
            with trace.span("confirm"):
                trace.count("pack.rows", 4096)
    for name, reader in _readers().items():
        assert reader.read(_run_data()) is None, name
    # A program without its own tracing module.
    monkeypatch.setitem(sys.modules,
                        "guacamole_tpu_torch.utils.trace", None)
    for name, reader in _readers().items():
        assert reader.read(_run_data()) is None, name


def test_the_readers_read_a_traced_call(cut_cell, tmp_path, monkeypatch):
    """One call of the program under a CPU profiler session: every metric
    of the program's spans and counters reads a number."""
    from guacamole_tpu_torch.cli import main as program

    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    _, paths, _ = S.ensure_sample(cut_cell.config, 5, str(tmp_path))
    with profile(activities=[ProfilerActivity.CPU]):
        assert program(cut_cell.argv(paths, str(tmp_path / "o.vcf"),
                                     cpu=True)) == 0
    got = {name: reader.read(_run_data(calls=1))
           for name, reader in _readers().items()}
    assert 0 < got["flagged_per_kloci"] <= 1000
    assert got["sparse_pack_s"] > 0 and got["somatic_confirm_s"] > 0
    assert got["confirm_wait_s"] >= 0
