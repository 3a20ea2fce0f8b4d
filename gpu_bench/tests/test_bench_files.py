"""BENCHMARK.json and the files it names: they parse, keep to the
contract's characters, and each metric's cells exist; a cell added as files
alone (a configuration, a traffic mix and an entry) is picked up."""

import json
import os
import re
import shutil
import types

import pytest

import run as harness
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpu_bench"]
    assert all(PATH.match(p) for p in bench["paths"])
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["command"][1].startswith("gpu_bench/")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_names_units_and_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [
        w["name"] for w in bench["workloads"]] + [
        m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_file_parses(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("gpu_bench/configs/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        ref, options = cell.reference()
        assert callable(ref.call) and callable(ref.control) and options
        assert cell.read_sets()
    for m in bench["per_layer"]:
        mod = harness.load_module(os.path.join(BENCH, "metrics",
                                               m["name"] + ".py"))
        assert callable(mod.read)
    # Every roofline has its metric's reader; a cell that launches the
    # kernel adds the metric's entry.
    for rl in harness.rooflines():
        assert os.path.exists(os.path.join(
            BENCH, "metrics", rl.KERNEL + "_roofline.py"))
        assert callable(rl.work) and rl.DEVICE_NAME and ":" in rl.WRAPS


def test_metric_workloads_exist_and_report_their_end_to_end(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        cell = harness.Cell(bench, w)
        assert {"setup_s", "reads_per_s"} <= {m["name"] for m in
                                              cell.end_to_end}
        assert cell.per_layer


def test_a_cell_added_as_files_is_picked_up(bench, tmp_path):
    here = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics", "rooflines"):
        shutil.copytree(os.path.join(BENCH, d), here / d)
    shutil.copy(os.path.join(BENCH, "tests", "tiny_germline.json"),
                here / "configs" / "tiny_germline.json")
    (here / "traffic" / "germline-threshold-8.json").write_text(json.dumps({
        "command": "germline-threshold",
        "args": ["--reads", "{reads}", "--threshold", "8"],
        "why": "a mix added by a later change"}))
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "tiny.germline-threshold-8",
                               "config": "tiny_germline",
                               "traffic": "germline-threshold-8",
                               "chips": 1, "why": "added"})
    cell = harness.Cell(bench, "tiny.germline-threshold-8", here=str(here))
    assert cell.reference()[1] == {"threshold": 8, "reads": "reads"}
    assert cell.argv({"reads": "x.bam"}, "o.vcf", cpu=True) == [
        "germline-threshold", "--reads", "x.bam", "--threshold", "8",
        "--out", "o.vcf", "--device", "cpu"]
    # Metrics without a workloads list reach every cell.
    assert {m["name"] for m in cell.end_to_end} == {"reads_per_s",
                                                   "setup_s"}


def test_a_flag_the_reference_does_not_know_is_refused(bench):
    cell = harness.Cell(bench, bench["workloads"][0]["name"])
    cell.traffic = dict(cell.traffic, args=cell.traffic["args"] + [
        "--min-likelihood", "30"])
    with pytest.raises(harness.RunError):
        cell.reference()


def test_each_reference_command_declares_its_flags():
    """reference/commands/<command>.py, found by the command's name: the
    flags it takes with their option and type, and their defaults."""
    d = os.path.join(BENCH, "reference", "commands")
    names = sorted(f[:-3] for f in os.listdir(d) if f.endswith(".py"))
    assert names == ["germline-standard", "germline-threshold",
                     "somatic-standard"]
    for name in names:
        ref = harness.reference_command(name)
        assert all(f.startswith("--") and len(v) == 2
                   for f, v in ref.FLAGS.items())
        assert set(ref.DEFAULTS) <= {k for k, _ in ref.FLAGS.values()}
    with pytest.raises(harness.RunError):
        harness.reference_command("vaf-histogram")


def test_a_reference_file_declares_how_its_flags_parse(bench, monkeypatch):
    """The traffic's flags parse by the reference file's FLAGS alone: a
    read set in braces, a typed value, a flag that takes no value."""
    ref = types.SimpleNamespace(
        FLAGS={"--reads": ("reads", str), "--bins": ("bins", int),
               "--cluster": ("cluster", bool)},
        DEFAULTS={"bins": 10})
    monkeypatch.setattr(harness, "reference_command", lambda command: ref)
    cell = harness.Cell(bench, bench["workloads"][0]["name"])
    cell.traffic = dict(cell.traffic, args=["--reads", "{reads}",
                                            "--cluster", "--bins", "20"])
    assert cell.reference() == (ref, {"reads": "reads", "cluster": True,
                                      "bins": 20})
    cell.traffic = dict(cell.traffic, args=["--reads", "{reads}", "--bins"])
    with pytest.raises(harness.RunError):
        cell.reference()
