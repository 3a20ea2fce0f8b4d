"""Shared by the harness's tests under gpu_bench/tests: every cell of
BENCHMARK.json has a tiny configuration to run on. A test module's `CELLS`
maps a cell's name to a tiny configuration (test_bench_harness.py's `tiny`
fixture looks every cell up there); a cell it does not name runs on the
tiny configuration of its traffic mix."""

import json
import os

import pytest

BENCHMARK = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "BENCHMARK.json")
TINY_BY_TRAFFIC = {"germline-threshold": "tiny_snv_dense",
                   "germline-standard": "tiny_germline",
                   "somatic-standard": "tiny_tumor_normal"}


@pytest.fixture(autouse=True)
def _every_cell_has_a_tiny_configuration(request, monkeypatch):
    cells = getattr(request.module, "CELLS", None)
    if not isinstance(cells, dict):
        return
    with open(BENCHMARK) as fh:
        workloads = json.load(fh)["workloads"]
    for w in workloads:
        if w["name"] not in cells:
            monkeypatch.setitem(cells, w["name"],
                                TINY_BY_TRAFFIC[w["traffic"]])
