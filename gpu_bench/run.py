#!/usr/bin/env python3
"""One run of one benchmark cell of guacamole_tpu_torch on the GPU.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration
(configs/<name>.json: the sample to make) and a traffic mix
(traffic/<name>.json: the command and its flags). The run:

1. set-up: builds or loads the program's CUDA kernels and native runtime
   (their caches sit in the checkout), makes the cell's sample from the seed
   (BAM and .bai, cached under gpu_bench/.samples/; not counted in
   setup_s: users hold their BAM), and calls the command once on it;
2. the window: calls guacamole_tpu_torch.cli.main([command, ...]) on the
   sample again and again, in this process, each call whole from the BAM to
   the VCF, until --seconds have passed; the last call is finished and
   counted. reads_per_s = reads of all calls / the window's length;
3. with --trace 1, the window runs under torch.profiler and with spans
   around the program's layers (tracing.py), and the run reports the
   per-layer metrics (metrics/<name>.py) instead of the end-to-end ones;
4. the check: the reference (reference/, plain NumPy) works out the VCF
   from the generated reads, and every VCF the window wrote must equal it
   record for record (records_differing, limit RECORDS_DIFFERING_LIMIT).

The last line of standard output is the result as one JSON object; the
last lines of standard error give each number compared beside its limit.
The run fails, printing no result, without a CUDA device (or fewer than the
cell asks for), and when a module of jax, jaxlib, flax or guacamole_tpu
(the JAX package) has been loaded.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

# Top-level module names that a run may not load, compared whole: the port
# guacamole_tpu_torch begins with the JAX package's name and passes.
FORBIDDEN = ("jax", "jaxlib", "flax", "guacamole_tpu")
# Every VCF record of every call must equal the reference's.
RECORDS_DIFFERING_LIMIT = 0

SAMPLES_DIR = os.path.join(HERE, ".samples")
WORK_DIR = os.path.join(HERE, ".work")
CACHE_DIR = os.path.join(HERE, ".cache")


class RunError(RuntimeError):
    """A run that cannot give a result (exit code 2)."""


def forbidden_loaded() -> List[str]:
    return sorted({
        name.split(".")[0] for name, mod in list(sys.modules.items())
        if mod is not None and name.split(".")[0] in FORBIDDEN
    })


def process_age_s() -> float:
    """Seconds since this process started (from /proc; the harness's own
    import time where /proc is not there)."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


# --- the cell ----------------------------------------------------------


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """A workload of BENCHMARK.json with its configuration and traffic."""

    def __init__(self, bench: dict, name: str, here: str = HERE):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise RunError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        self.config = load_json(
            os.path.join(here, "configs", self.workload["config"] + ".json"))
        self.traffic = load_json(
            os.path.join(here, "traffic", self.workload["traffic"] + ".json"))
        self.command = self.traffic["command"]

        def applies(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]

    def argv(self, paths: Dict[str, str], out: str, cpu: bool) -> List[str]:
        args = [a.format(**paths) for a in self.traffic["args"]]
        return [self.command, *args, "--out", out] + (
            ["--device", "cpu"] if cpu else [])

    def read_sets(self) -> List[str]:
        """The read sets the command reads ({reads}, {tumor}, ...)."""
        return [a[1:-1] for a in self.traffic["args"]
                if a.startswith("{") and a.endswith("}")]

    def reference(self):
        """The reference of the cell's command (reference/commands/
        <command>.py) and the options it takes from the traffic's flags; a
        flag that the reference does not declare is refused rather than
        ignored."""
        ref = reference_command(self.command)
        opts = dict(ref.DEFAULTS)
        args, i = self.traffic["args"], 0
        while i < len(args):
            if args[i] not in ref.FLAGS:
                raise RunError(f"the reference does not take {args[i]} "
                               f"({self.command})")
            key, kind = ref.FLAGS[args[i]]
            if kind is bool:
                opts[key], i = True, i + 1
                continue
            if i + 1 == len(args):
                raise RunError(f"{args[i]} has no value ({self.command})")
            value = args[i + 1]
            opts[key] = value[1:-1] if value.startswith("{") else kind(value)
            i += 2
        return ref, opts


def reference_command(command: str):
    path = os.path.join(HERE, "reference", "commands", command + ".py")
    if not os.path.exists(path):
        raise RunError(f"the reference has no {command}")
    return load_module(path)


# --- the comparison ----------------------------------------------------


def vcf_records(path: str) -> List[str]:
    with open(path) as fh:
        return [line.rstrip("\n") for line in fh if not line.startswith("#")]


def records_differing(got: List[str], want: List[str]) -> int:
    """Records in one list and not the other, counted with multiplicity."""
    a, b = collections.Counter(got), collections.Counter(want)
    return sum(((a - b) + (b - a)).values())


def judge(differing: List[int]) -> tuple:
    """(correct, failed, compared) for the records_differing of each output
    judged: correct where there is one and none passes the limit."""
    failed = sum(d > RECORDS_DIFFERING_LIMIT for d in differing)
    compared = {"records_differing": {"value": max(differing, default=0),
                                      "limit": RECORDS_DIFFERING_LIMIT}}
    return bool(differing) and failed == 0, failed, compared


# --- what a traced window measured ----------------------------------------


class RunData:
    """What the metric readers (metrics/<name>.py) read."""

    def __init__(self):
        self.calls = 0
        self.reads_per_call = 0
        self.window_s = 0.0
        self.layer_s: Dict[str, float] = {}
        self.transfer: Dict[str, int] = {}
        self.busy_s: Optional[float] = None
        self.window_peak_bytes: Optional[int] = None
        self.kernel_s: Dict[str, float] = {}  # device seconds by trace name
        self.kernel_n: Dict[str, int] = {}
        self.roofline_work: Dict[str, list] = {}  # kernel -> [launches, bound s]
        self.roofline_device_name: Dict[str, str] = {}

    @property
    def reads_total(self) -> int:
        return self.calls * self.reads_per_call

    def layer_per_call(self, layer: str) -> Optional[float]:
        if not self.calls:
            return None
        return self.layer_s.get(layer, 0.0) / self.calls

    def roofline(self, kernel: str) -> Optional[float]:
        """100 x the least time the launches' data needs / the kernel's
        device time; None where no launch was seen, or the launches counted
        and the kernels traced do not match."""
        launches, bound_s = self.roofline_work.get(kernel, (0, 0.0))
        name = self.roofline_device_name.get(kernel)
        n = self.kernel_n.get(name, 0)
        t = self.kernel_s.get(name, 0.0)
        if not launches or n != launches or t <= 0:
            return None
        return 100.0 * bound_s / t


def load_module(path: str):
    spec = importlib.util.spec_from_file_location(
        "gpu_bench_" + os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rooflines(here: str = HERE):
    d = os.path.join(here, "rooflines")
    return [load_module(os.path.join(d, f)) for f in sorted(os.listdir(d))
            if f.endswith(".py") and not f.startswith("_")]


# --- the run -------------------------------------------------------------


def smi() -> Dict[str, str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
        return {"power_limit": out.split(",")[1].strip()}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"power_limit": "not read"}


def log(msg: str) -> None:
    print(f"gpu_bench: {msg}", file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", samples_dir: str = SAMPLES_DIR,
             work_dir: str = WORK_DIR) -> dict:
    """One run of `cell`; returns the result object ("compared" last).
    device "cpu" runs the program with --device cpu (the harness's tests:
    no device metric is read there)."""
    os.environ["GUAC_CACHE_DIR"] = os.path.join(CACHE_DIR, "guac")
    os.environ.setdefault("USE_FLAX", "0")
    cpu = device == "cpu"
    ref, options = cell.reference()
    import torch

    import sample as sample_mod

    # Set-up: the program's builds (kept in the checkout), the device.
    from guacamole_tpu_torch.cli import main as program
    from guacamole_tpu_torch.ops import cuda_kernels, dispatch
    from guacamole_tpu_torch.runtime import native

    t_build = time.perf_counter()
    if native.load_library() is None:
        raise RunError("the program's native runtime did not build")
    if not cpu:
        from guacamole_tpu_torch.ops.build import load_kernels

        load_kernels()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    log(f"set-up: {t_build - _T_IMPORT:.3f} s to import torch and the "
        f"program, {time.perf_counter() - t_build:.3f} s to build or load "
        f"its libraries and start the device ({process_age_s():.3f} s "
        "since the process started)")

    t0 = time.perf_counter()
    smp, paths, wrote = sample_mod.ensure_sample(cell.config, seed,
                                                 samples_dir)
    sample_s = time.perf_counter() - t0
    log(f"sample {cell.config['name']} seed {seed}: reads "
        f"{smp.n_reads}, truth {smp.truth}, {sample_s:.3f} s "
        f"({'written' if wrote else 'cached'}), "
        + ", ".join(f"{k} {os.path.getsize(p)} B" for k, p in paths.items()))
    reads_per_call = sum(smp.n_reads[k] for k in cell.read_sets())

    out_dir = os.path.join(work_dir, cell.name)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)

    def call(i: int) -> str:
        out = os.path.join(out_dir, f"call{i}.vcf")
        rc = program(cell.argv(paths, out, cpu))
        if rc != 0:
            raise RunError(f"{cell.command} exited {rc}")
        return out

    t_warm = time.perf_counter()
    call(0)
    if not cpu:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_warm

    run = RunData()
    run.reads_per_call = reads_per_call
    tracer = prof = None
    dispatch.reset_transfer_stats()
    cuda_kernels.reset_launches()
    setup_peak = torch.cuda.max_memory_allocated() if not cpu else 0
    if trace:
        import tracing

        tracer = tracing.Tracer()
        tracer.install()
        for rl in rooflines():
            run.roofline_work[rl.KERNEL] = [0, 0.0]
            run.roofline_device_name[rl.KERNEL] = rl.DEVICE_NAME
            tracer.patch(rl.WRAPS, _counting(rl, run, tracer))
        if not cpu:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.reset_peak_memory_stats()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        marker = torch.profiler.record_function("gpu_bench.window")
    setup_s = process_age_s() - sample_s

    # The window. Garbage of the set-up is collected before it opens.
    gc.collect()
    vcfs, call_s, call_cpu, call_host = [], [], [], []
    t_window = time.perf_counter()
    if trace:
        marker.__enter__()
        window_ns = time.perf_counter_ns()
    while True:
        t_call, cpu_call = time.perf_counter(), os.times()
        ru = resource.getrusage(resource.RUSAGE_SELF)
        vcfs.append(call(len(vcfs) + 1))
        call_s.append(time.perf_counter() - t_call)
        call_cpu.append(sum(os.times()[:2]) - sum(cpu_call[:2]))
        call_host.append(_host_use(ru, resource.getrusage(
            resource.RUSAGE_SELF)))
        if time.perf_counter() - t_window >= seconds:
            break
    if not cpu:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_window
    run.calls, run.window_s = len(vcfs), window_s
    run.transfer = dict(dispatch.TRANSFER_STATS)
    launches = dict(cuda_kernels.LAUNCHES)

    result_device = {"platform": "cpu" if cpu else "gpu",
                     "kind": "cpu" if cpu else torch.cuda.get_device_name(0),
                     "count": cell.chips}
    breakdown = None
    if trace:
        end_ns = time.perf_counter_ns()
        marker.__exit__(None, None, None)
        if prof is not None:
            prof.__exit__(None, None, None)
            run.window_peak_bytes = torch.cuda.max_memory_allocated()
        tracer.uninstall()
        run.layer_s = dict(tracer.self_s)
        if prof is not None:
            events, mark = tracing.device_events(prof)
            if mark is None:
                raise RunError("the trace has no window marker")
            shift = window_ns - mark  # trace clock -> perf_counter_ns
            events = [(s + shift, e + shift, n) for s, e, n in events]
            busy = tracing.union_intervals(events, window_ns, end_ns)
            run.busy_s = sum(e - s for s, e in busy) / 1e9
            run.window_s = (end_ns - window_ns) / 1e9
            for s, e, n in events:
                if window_ns <= s < end_ns:
                    for kname in run.roofline_device_name.values():
                        if kname in n:
                            run.kernel_s[kname] = run.kernel_s.get(
                                kname, 0.0) + (e - s) / 1e9
                            run.kernel_n[kname] = run.kernel_n.get(kname, 0) + 1
            ops, idle = tracing.breakdown(
                [ev for ev in events if window_ns <= ev[0] < end_ns], busy,
                window_ns, end_ns, tracer.name_at)
            breakdown = {"device_ops": ops, "idle_gaps": idle}
            result_device["busy_s"] = run.busy_s
            result_device["window_s"] = run.window_s
            del prof, events
    loaded = forbidden_loaded()
    if loaded:
        raise ForbiddenModules(loaded)
    result_device["memory_peak_bytes"] = (
        max(setup_peak, torch.cuda.max_memory_allocated()) if not cpu else 0)
    if not cpu:
        result_device.update(smi())

    # The metrics.
    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(os.path.join(HERE, "metrics",
                                              m["name"] + ".py"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"reads_per_s": run.reads_total / window_s,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    log(f"window: {run.calls} calls of {reads_per_call} reads in "
        f"{window_s:.4f} s ({run.reads_total / window_s:.1f} reads/s), "
        f"each {', '.join(f'{x:.3f}' for x in call_s)} s, CPU s "
        f"{', '.join(f'{x:.2f}' for x in call_cpu)}; "
        f"warm-up call {warm_s:.3f} s; setup_s {setup_s:.3f}; "
        f"launches {launches}; transfers {run.transfer}")
    log(f"host: {sum(call_cpu):.2f} CPU s of this process in the calls, "
        f"{sum(call_cpu) / sum(call_s):.2f} cores busy on average of "
        f"{os.cpu_count()}; each call's system CPU s, minor page faults "
        f"and involuntary switches: "
        f"{', '.join('%.2f/%d/%d' % h for h in call_host)}")

    # The check, once the program's state is freed.
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = ref.call(smp, options)
    ref_s = time.perf_counter() - t_ref
    seen, differing = {}, []
    for path in vcfs:
        with open(path, "rb") as fh:
            key = hashlib.sha1(fh.read()).hexdigest()
        if key not in seen:
            seen[key] = records_differing(vcf_records(path), want)
        differing.append(seen[key])
    log(f"reference: {len(want)} records in {ref_s:.3f} s; "
        f"{len(seen)} distinct VCFs among {len(vcfs)}")
    correct, failed, compared = judge(differing)
    result = {
        "correct": correct,
        "attempted": run.calls,
        "failed": failed,
        "metrics": metrics,
        "device": result_device,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def _host_use(before, after) -> tuple:
    """(system CPU s, minor page faults, involuntary context switches)
    of this process between two getrusage readings."""
    return (after.ru_stime - before.ru_stime,
            after.ru_minflt - before.ru_minflt,
            after.ru_nivcsw - before.ru_nivcsw)


def _counting(roofline, run: RunData, tracer):
    """A wrapper of the staging call `roofline.WRAPS` that adds each
    launch's least time to run.roofline_work, outside the layers' spans."""
    peaks = load_json(os.path.join(HERE, "peaks.json"))

    def make(fn):
        def staged(*args, **kwargs):
            with tracer.aside():
                n_bytes, n_ops = roofline.work(args, kwargs)
            acc = run.roofline_work[roofline.KERNEL]
            acc[0] += 1
            acc[1] += max(n_bytes / peaks["bytes_per_s"],
                          n_ops / peaks["f32_ops_per_s"])
            return fn(*args, **kwargs)
        return staged
    return make


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cell = Cell(bench, args.workload)
        import torch

        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false: no GPU")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"{cell.name} needs {cell.chips} GPUs, "
                           f"{torch.cuda.device_count()} found")
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
        if forbidden_loaded():
            raise ForbiddenModules(forbidden_loaded())
    except ForbiddenModules as exc:
        log(f"modules of JAX or of the JAX package were loaded: {exc}")
        return 3
    except (RunError, OSError, KeyError, ValueError) as exc:
        log(f"no result: {type(exc).__name__}: {exc}")
        return 2
    for name, c in result["compared"].items():
        print(f"compared: {name} {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
