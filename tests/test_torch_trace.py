"""The port's spans and counters (guacamole_tpu_torch/utils/trace.py): off
without a profiler, on under a CPU torch.profiler session, on the
profiler's clock through the anchor, the device's idle time by span, and
the GUAC_PROFILE_DIR exporter. germline-threshold runs in-process on the
simulated fixture of the threshold tests (scale 0.02, seed 7), over four
partition tasks so that the decode thread streams several."""

import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from guacamole_tpu_torch import cli
from guacamole_tpu_torch.ops import dispatch
from guacamole_tpu_torch.runtime import columnar
from guacamole_tpu_torch.utils import trace
from guacamole_tpu_torch.utils.simulate import make_scale_fixture


@pytest.fixture(scope="module")
def fixture_bam(tmp_path_factory):
    out = tmp_path_factory.mktemp("sim")
    manifest = make_scale_fixture(str(out), scale=0.02, seed=7)
    return os.path.join(str(out), manifest["files"]["germline_bam"])


def run_threshold(bam, out):
    assert cli.main(
        ["germline-threshold", "--reads", bam, "--threshold", "25",
         "--parallelism", "4", "--out", out, "--device", "cpu", "--debug"]
    ) == 0


@pytest.fixture(scope="module")
def traced(fixture_bam, tmp_path_factory):
    """One germline-threshold call under a CPU profiler session, with
    device screens (the kernels' plain versions): its records, counters,
    the reads decode_bam_columnar returned, and its VCF."""
    out = str(tmp_path_factory.mktemp("traced") / "traced.vcf")
    decoded = []
    real = columnar.decode_bam_columnar

    def counting(*args, **kwargs):
        cols = real(*args, **kwargs)
        decoded.append(cols.n)
        return cols

    mp = pytest.MonkeyPatch()
    mp.setenv("GUAC_HOST_SCREEN", "0")
    mp.setattr(columnar, "decode_bam_columnar", counting)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            run_threshold(fixture_bam, out)
    finally:
        mp.undo()
    snap = trace.snapshot()
    return {"spans": snap["spans"], "counters": snap["counters"],
            "decoded": decoded, "vcf": out}


def test_no_profiler_records_nothing(fixture_bam, tmp_path, monkeypatch):
    """Off, a call opens no record_function and appends no record."""
    assert not torch.autograd.profiler._is_profiler_enabled

    def refuse(*args, **kwargs):
        raise AssertionError("tracing touched while no profiler records")

    monkeypatch.setattr(trace._profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "_buffer", refuse)
    monkeypatch.setattr(trace, "_Span", refuse)
    before = trace.snapshot()["spans"]
    run_threshold(fixture_bam, str(tmp_path / "off.vcf"))
    assert trace.snapshot()["spans"] == before


def test_traced_call_records_each_layer_on_its_thread(traced):
    by_name = {}
    for s in traced["spans"]:
        by_name.setdefault(s["name"], set()).add(s["thread"])
    main = {"MainThread"}
    for name in ("call", "plan", "tiles.get", "classify", "write", "sort",
                 "dispatch.launch", "dispatch.stage"):
        assert by_name.get(name) == main, name
    assert by_name["decode"] and all(
        t.startswith("guac-decode") for t in by_name["decode"])
    assert by_name["decode.wait"] == {"guac-prefetch"}
    assert by_name["pack"] == {"guac-prefetch"}


def test_traced_spans_lie_inside_their_call(traced):
    calls = {s["call"]: s for s in traced["spans"] if s["name"] == "call"}
    assert len(calls) == 1
    for s in traced["spans"]:
        c = calls[s["call"]]
        assert c["start_ns"] <= s["start_ns"] <= s["end_ns"] <= c["end_ns"], (
            s["name"])


def test_traced_counters_match_the_tiles_and_reads(traced):
    spans, counters = traced["spans"], traced["counters"]

    def tiles(name):
        return sorted(s["tile"] for s in spans
                      if s["name"] == name and s["tile"] is not None)

    got = tiles("tiles.get")
    assert counters["pack.tiles"] == len(got) > 1
    assert got == tiles("pack") == list(range(len(got)))
    assert counters["decode.tasks"] == len(traced["decoded"]) == 4
    assert counters["decode.reads"] == sum(traced["decoded"]) > 0
    assert counters["decode.bytes"] > 0
    # Each pack span names the task whose reads it packed, and each
    # classify span the tile it classified.
    assert {s["task"] for s in spans if s["name"] == "pack"} <= {
        s["task"] for s in spans if s["name"] == "decode"}
    assert tiles("classify") == got


def test_traced_call_writes_the_same_vcf(traced, fixture_bam, tmp_path,
                                         monkeypatch):
    monkeypatch.setenv("GUAC_HOST_SCREEN", "0")
    out = str(tmp_path / "untraced.vcf")
    run_threshold(fixture_bam, out)

    def body(path):
        with open(path) as fh:
            return [line for line in fh if not line.startswith("##")]

    assert body(out) == body(traced["vcf"])


def test_waits_read_as_seconds(traced):
    want = sum(s["end_ns"] - s["start_ns"] for s in traced["spans"]
               if s["name"] == "tiles.get")
    # Until a new session starts, the last one's records stay readable.
    assert trace.seconds("tiles.get") == pytest.approx(want / 1e9)
    assert trace.seconds("tiles.put") is not None
    assert trace.seconds("no.such.span") == 0.0


def test_a_new_session_starts_with_no_records(traced):
    assert trace.snapshot()["spans"]
    with profile(activities=[ProfilerActivity.CPU]):
        snap = trace.snapshot()
        assert snap["spans"] == [] and snap["counters"] == {}
        assert snap["anchor_ns"] is None
        assert trace.seconds("call") is None
    assert trace.snapshot()["spans"] == []


def test_anchor_puts_spans_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("call"):
            time.sleep(0.002)
            with trace.span("probe.span") as probe:
                with record_function("probe.range"):
                    pass
    starts = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in (trace.ANCHOR, "probe.range"):
            starts[ev.name()] = ev.start_ns()
    assert trace.ANCHOR in starts
    shift = starts[trace.ANCHOR] - trace.snapshot()["anchor_ns"]
    assert abs(probe.start + shift - starts["probe.range"]) < 1_000_000


# (spans, busy, lo, hi, want seconds by name), in nanoseconds.
IDLE_CASES = {
    "nested": (
        [(0, 100, "call"), (10, 50, "outer"), (20, 30, "inner")],
        [(0, 5)], 0, 100,
        {"call": 55e-9, "outer": 30e-9, "inner": 10e-9},
    ),
    "gap_split_between_two_spans": (
        [(0, 100, "call"), (0, 40, "a"), (40, 100, "b")],
        [(0, 30), (60, 100)], 0, 100,
        {"a": 10e-9, "b": 20e-9},
    ),
    "gap_under_no_span": (
        [(20, 60, "a")],
        [(30, 40), (90, 95)], 0, 100,
        {trace.UNTRACED: 55e-9, "a": 30e-9},
    ),
}


@pytest.mark.parametrize("case", sorted(IDLE_CASES))
def test_idle_time_is_put_down_to_spans_by_overlap(case):
    spans, busy, lo, hi, want = IDLE_CASES[case]
    got = trace.idle_by_span(spans, busy, lo, hi)
    assert set(got) == set(want)
    for name, seconds in want.items():
        assert got[name] == pytest.approx(seconds, abs=1e-15), name


def test_profile_dir_writes_spans_of_every_thread(fixture_bam, tmp_path,
                                                  monkeypatch):
    out_dir = tmp_path / "profile"
    monkeypatch.setenv("GUAC_PROFILE_DIR", str(out_dir))
    run_threshold(fixture_bam, str(tmp_path / "profiled.vcf"))
    with open(out_dir / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    ours = [ev for ev in events if str(ev.get("cat", "")).startswith("guac.")]
    assert len({ev["tid"] for ev in ours}) >= 2
    assert {"call", "decode", "pack", "tiles.get"} <= {
        ev["name"] for ev in ours}
    with open(out_dir / "spans.json") as fh:
        spans = json.load(fh)
    assert spans["anchor"] is not None
    assert {(row["name"], row["thread"]) for row in spans["spans"]} >= {
        ("call", "MainThread"), ("pack", "guac-prefetch")}
    assert spans["counters"]["pack.tiles"] > 1
    device = spans["device"]
    assert device["calls_s"] > 0
    # On the CPU nothing runs on a device: the whole call is idle, put
    # down to the main thread's spans.
    assert sum(device["idle_by_span_s"].values()) == pytest.approx(
        device["calls_s"])


def test_transfer_stats_keep_only_counters_with_readers():
    assert set(dispatch.TRANSFER_STATS) == {
        "h2d_bytes", "h2d_calls", "d2h_bytes", "d2h_calls", "launches",
        "ll_cells", "ll_elements", "dense_cells",
    }
