#!/usr/bin/env python3
"""The control of a cell: the reference put in the program's place, one
step below the configuration's arithmetic, judged by the benchmark's own
check against the reference.

    python3 gpu_bench/control.py --workload <cell> --seeds 1,2,3

Each command's control is its reference file's `control` (reference/
commands/<command>.py): float32 likelihoods where the configuration states
the exact float64 confirm; for the counting caller, whose rule is an
integer percent (count * 100 // depth > threshold), the share compared as
a real number. Each seed's sample is made at the cell's size, in memory
(no BAM is written; no GPU is used), and judged as a run judges the VCFs of
its window (run.judge); the line printed gives `correct`, which has to be
false, and records_differing beside its limit. The benchmark's runs do not
run this; its readings set the upper end of the limit (PERF.md).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run as harness  # noqa: E402
import sample as sample_mod  # noqa: E402


def control_run(cell, seed: int) -> dict:
    """The control's verdict on one seed of `cell`."""
    ref, options = cell.reference()
    smp = sample_mod.make_sample(cell.config, seed)
    want = ref.call(smp, options)
    got = ref.control(smp, options)
    correct, failed, compared = harness.judge(
        [harness.records_differing(got, want)])
    return {"workload": cell.name, "seed": seed, "correct": correct,
            "reference_records": len(want), "control_records": len(got),
            "compared": compared}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.Cell(bench, args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        line = control_run(cell, seed)
        line["seconds"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
