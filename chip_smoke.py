#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (guacamole_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one Hopper card (compute capability 9.0), nvcc and a C++ compiler,
and nothing of JAX. In phases, it:

 1. checks the card and prints `nvidia-smi`'s name and power limit;
 2. builds the native host runtime (make -C native) and the CUDA kernels
    (nvcc, sm_90a), printing both build times;
 3. holds each CUDA kernel against its plain PyTorch twin on the card, on
    the same inputs, with tolerance 0 (every output is an integer): random
    CSR rows, a main-path megatile (about 1M rows, 70 MB of blob, timed),
    a row over 64 KB (the int32-offset wire form) and compaction with the
    cap below and above the candidate count;
 4. runs the port's germline-threshold CLI on the 2.37M-read simulated
    fixture (utils/simulate.make_scale_fixture, scale 1.0, seed 2026) with
    device screens, checks that both kernels launched, that the VCF equals
    the host-screen run's record for record and that planted-SNV recall
    and precision are >= 0.9; then the same for an --emit-ref range
    through the 8000x spike;
 5. prints one JSON line of kernel results, then, as the last line,
    {"ok": true, "device": {...}}.

Any failure exits non-zero before the last line is printed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# The port and this script import nothing of JAX, and only the jax-free
# host layers of guacamole_tpu: any import of jax fails here, even on a
# machine that has it.
sys.modules["jax"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(ROOT, ".bench_scale")
COUNT_SCREEN_SOURCE = "guacamole_tpu_torch/ops/csrc/csr_screen.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --- phase 1: the card -------------------------------------------------


def require_card():
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no GPU")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"need a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return torch.device("cuda", 0)


# --- phase 2: builds ---------------------------------------------------


def build_all():
    t0 = time.perf_counter()
    subprocess.run(["make", "-C", os.path.join(ROOT, "native")], check=True)
    native_s = time.perf_counter() - t0
    lib = os.path.join(ROOT, "guacamole_tpu", "runtime", "libguac_runtime.so")
    check(os.path.exists(lib), f"make -C native did not produce {lib}")
    from guacamole_tpu_torch.ops.build import build, load_kernels

    info = build()
    load_kernels()
    ptxas = [ln for ln in info.log.splitlines() if "ptxas info" in ln]
    for line in ptxas:
        print(line)
    print(
        f"build: native runtime {native_s:.3f} s, CUDA kernels "
        f"{info.seconds:.3f} s (0 = reused) -> {info.path}",
        flush=True,
    )


# --- phase 3: kernels against their plain twins ------------------------


def _random_csr(rng, L, max_depth, K, device):
    """CSR rows of depth 0..max_depth with nibble values 0..15 (values >= K
    and the 0xF pad are not counted), plus random variant words."""

    from guacamole_tpu_torch.ops.dispatch import wire_from_numpy

    depth = rng.integers(0, max_depth + 1, size=L)
    row_bytes = (depth + 1) // 2
    row_off = np.concatenate([[0], np.cumsum(row_bytes)]).astype(np.int32)
    blob = rng.integers(0, 256, size=int(row_off[-1]), dtype=np.uint8)
    is_variant = rng.random((L, K)) < 0.4
    wire = wire_from_numpy(blob, row_off, is_variant, device)
    return wire.blob, wire.row_off, wire.variant_words


def _megatile(device, K=8, seed=2026):
    """A main-path megatile made on the device: 1M rows at 0..30x, a
    100k-row band at 950..1050x and a 2k-row spike at 7600..8400x, with
    the 0xF pad on odd-depth rows. Allele 0 is the reference; alleles 1..3
    are variants, seen in 1% of reads (errors) and in half the reads of
    one row in 1500 (het sites)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def depths(n, lo, hi):
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device)

    depth = torch.cat(
        [depths(1_000_000, 0, 30), depths(100_000, 950, 1050),
         depths(2_000, 7600, 8400)]
    )
    depth = depth[torch.randperm(depth.numel(), generator=g, device=device)]
    L = depth.numel()
    row_bytes = (depth + 1) // 2
    row_off = torch.zeros(L + 1, dtype=torch.int64, device=device)
    row_off[1:] = torch.cumsum(row_bytes, 0)
    n_nib = int(row_off[-1]) * 2
    row_of = torch.repeat_interleave(
        torch.arange(L, device=device), 2 * row_bytes
    )
    slot = torch.arange(n_nib, device=device) - 2 * row_off[row_of]
    het = torch.rand(L, generator=g, device=device) < 1 / 1500
    u = torch.rand(n_nib, generator=g, device=device)
    alt = torch.randint(1, 4, (n_nib,), generator=g, device=device)
    nib = torch.where(
        het[row_of] & (u < 0.5), 1, torch.where(u < 0.01, alt, 0)
    )
    nib = torch.where(slot < depth[row_of], nib, 15).view(-1, 2)
    blob = (nib[:, 0] | (nib[:, 1] << 4)).to(torch.uint8)
    words = torch.full((L,), 0b1110, dtype=torch.int32, device=device)
    return blob, row_off.to(torch.int32), words.to(torch.uint16)


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a, b):
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_kernels(device) -> dict:
    """Every kernel against its plain twin at shapes (a)-(d); returns the
    per-kernel record for the JSON line (launches filled in later)."""

    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import kernels as plain
    from guacamole_tpu_torch.ops.dispatch import wire_from_numpy

    err = {"csr_count_screen": 0, "csr_compact": 0}

    def screen_both(blob, off, words, K, t):
        kc, kf = ck.csr_count_screen(blob, off, words, K, t)
        pc, pf = plain.csr_count_screen(blob, off, words, K, t)
        e = max(_max_err(kc, pc), _max_err(kf, pf))
        check(e == 0, f"csr_count_screen != plain (K={K}, t={t}): {e}")
        err["csr_count_screen"] = max(err["csr_count_screen"], e)
        return kc, kf

    def compact_both(flags, counts, cap):
        got = ck.csr_compact(flags, counts, cap)
        want = plain.compact_candidates(flags, counts, cap)
        e = _max_err(got, want)
        check(e == 0, f"csr_compact != plain (cap={cap}): {e}")
        err["csr_compact"] = max(err["csr_compact"], e)
        return got

    rng = np.random.default_rng(2026)
    # (a) random rows, depth 0..64, and (d) compaction around the count.
    for K in (2, 8, 15):
        blob, off, words = _random_csr(rng, 4096, 64, K, device)
        for t in (None, 8, 25):
            counts, flags = screen_both(blob, off, words, K, t)
            n = int(flags.sum())
            for cap in (0, max(n - 1, 0), n, n + 8):
                raw = compact_both(flags, counts, cap)
                check(int(raw[cap, 0]) == n, "compact footer != total")
    # (c) one row over 64 KB: the int32-offset wire form.
    depth = np.array([3, 140_001, 0, 7])
    row_off = np.concatenate([[0], np.cumsum((depth + 1) // 2)]).astype(np.int32)
    blob_np = rng.integers(0, 4, size=int(row_off[-1]), dtype=np.uint8) * 0x11
    iv = np.zeros((4, 8), bool)
    iv[:, 1:] = True
    wire = wire_from_numpy(blob_np, row_off, iv, device)
    blob, off, words = wire.blob, wire.row_off, wire.variant_words
    check(off.tolist() == row_off.tolist(), "int32-offset wire form")
    screen_both(blob, off, words, 8, None)
    # (b) the main-path megatile, timed.
    blob, off, words = _megatile(device)
    L = off.numel() - 1
    cap = max(512, L // 256)
    counts, flags = screen_both(blob, off, words, 8, 25)
    compact_both(flags, counts, cap)
    compact_both(flags, counts, max(int(flags.sum()) - 1, 0))

    def kscreen():
        ck.csr_count_screen(blob, off, words, 8, 25)

    def pscreen():
        plain.csr_count_screen(blob, off, words, 8, 25)

    def kcompact():
        ck.csr_compact(flags, counts, cap)

    def pcompact():
        plain.compact_candidates(flags, counts, cap)

    times = {}
    for name, kfn, pfn in (
        ("csr_count_screen", kscreen, pscreen),
        ("csr_compact", kcompact, pcompact),
    ):
        p1 = _time_ms(pfn, 3)
        k1 = _time_ms(kfn, 50)
        k2 = _time_ms(kfn, 50)
        p2 = _time_ms(pfn, 3)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
    print(
        f"megatile: {L} rows, {blob.numel()} blob bytes, "
        f"{int(flags.sum())} candidates at --threshold 25, cap {cap}; "
        + "; ".join(
            f"{n} kernel {k:.4f} ms, plain {p:.4f} ms"
            for n, (k, p) in times.items()
        ),
        flush=True,
    )
    return {
        "csr_count_screen": {
            "name": "csr_count_screen", "route": "cuda",
            "source": COUNT_SCREEN_SOURCE,
            "replaces": "guacamole_tpu/ops/pallas_kernels.py:268",
            "launches": 0, "max_abs_err": err["csr_count_screen"],
            "ms": times["csr_count_screen"][0],
            "plain_ms": times["csr_count_screen"][1],
        },
        "csr_compact": {
            "name": "csr_compact", "route": "cuda",
            "source": COUNT_SCREEN_SOURCE,
            "replaces": "guacamole_tpu/ops/kernels.py:251",
            "launches": 0, "max_abs_err": err["csr_compact"],
            "ms": times["csr_compact"][0],
            "plain_ms": times["csr_compact"][1],
        },
    }


# --- phase 4: the slice ------------------------------------------------


def _run_cli(argv, host_screen: bool) -> float:
    from guacamole_tpu_torch.cli import main as port_main

    os.environ["GUAC_HOST_SCREEN"] = "1" if host_screen else "0"
    t0 = time.perf_counter()
    rc = port_main(["germline-threshold", *argv, "--debug"])  # raise, don't mask
    wall = time.perf_counter() - t0
    check(rc == 0, f"germline-threshold {argv} exited {rc}")
    return wall


def _snv_sites(vcf):
    called, n = set(), 0
    with open(vcf) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            n += 1
            f = line.split("\t")
            if len(f[3]) == 1 and len(f[4]) == 1:
                called.add((f[0], int(f[1]) - 1))
    return called, n


def run_slice(kernel_records: dict) -> None:
    from guacamole_tpu.concordance import compare_vcf_records
    from guacamole_tpu.utils.simulate import make_scale_fixture
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import dispatch

    t0 = time.perf_counter()
    manifest = make_scale_fixture(FIXTURE_DIR, scale=1.0, seed=2026)
    print(f"fixture: {time.perf_counter() - t0:.3f} s "
          f"({manifest['counts']['germline']} reads)", flush=True)
    bam = os.path.join(FIXTURE_DIR, manifest["files"]["germline_bam"])
    out = tempfile.mkdtemp(prefix="chip_smoke_")

    def vcf(name):
        return os.path.join(out, name)

    args = ["--reads", bam, "--threshold", "25"]
    dispatch.reset_transfer_stats()
    ck.reset_launches()
    wall = _run_cli(args + ["--out", vcf("device.vcf")], host_screen=False)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    transfers = dict(dispatch.TRANSFER_STATS)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
        kernel_records[name]["launches"] = n
    # Device and host screens in turns (device, host, host, device), so
    # neither side gets the warmer page cache and allocator alone.
    host_walls = [
        _run_cli(args + ["--out", vcf(f"host{i}.vcf")], host_screen=True)
        for i in range(2)
    ]
    device_walls = [
        wall,
        _run_cli(args + ["--out", vcf("device1.vcf")], host_screen=False),
    ]
    for other in ("host0.vcf", "host1.vcf", "device1.vcf"):
        cmp = compare_vcf_records(vcf("device.vcf"), vcf(other))
        check(cmp.record_level_identical,
              f"device.vcf vs {other} differ: {cmp.only_a[:5]} / "
              f"{cmp.only_b[:5]}")
    called, n_records = _snv_sites(vcf("device.vcf"))
    planted = {
        (contig, pos)
        for contig in ("deep1m", "shallow8m")
        for pos in manifest["truth"][contig]["snv_pos"]
    }
    hits = len(called & planted)
    recall = hits / max(1, len(planted))
    precision = hits / max(1, len(called))
    check(recall >= 0.9, f"recall {hits}/{len(planted)}")
    check(precision >= 0.9, f"precision {hits}/{len(called)}")
    reads = manifest["counts"]["germline"]
    print(
        f"slice: germline-threshold --threshold 25: {n_records} records, "
        f"device screens {wall:.3f} s wall ({reads / wall:.1f} reads/s); "
        f"in turns: device {device_walls[0]:.3f} s, host "
        f"{host_walls[0]:.3f} s, host {host_walls[1]:.3f} s, device "
        f"{device_walls[1]:.3f} s; launches {launches}; "
        f"transfers {transfers}; "
        f"recall {recall:.4f} precision {precision:.4f}; equal to host "
        f"screens ({cmp.matching} records)",
        flush=True,
    )
    spike = manifest["bands"]["spike"][0]  # 350000 at scale 1.0
    loci = f"deep1m:{max(0, spike - 10_000)}-{spike + 10_000}"
    region = ["--reads", bam, "--threshold", "25", "--emit-ref",
              "--loci", loci]
    before = dict(ck.LAUNCHES)
    _run_cli(region + ["--out", vcf("ref_device.vcf")], host_screen=False)
    check(ck.LAUNCHES["csr_count_screen"] > before["csr_count_screen"],
          "--emit-ref did not launch csr_count_screen")
    _run_cli(region + ["--out", vcf("ref_host.vcf")], host_screen=True)
    cmp = compare_vcf_records(vcf("ref_device.vcf"), vcf("ref_host.vcf"))
    check(cmp.record_level_identical and cmp.matching > 0,
          f"--emit-ref device vs host differ: {cmp.only_a[:5]} / "
          f"{cmp.only_b[:5]}")
    print(f"emit-ref {loci}: {cmp.matching} records, equal to "
          "host screens", flush=True)


def main() -> int:
    device = require_card()
    build_all()
    records = check_kernels(device)
    run_slice(records)
    torch.cuda.synchronize()
    leaked = sorted(
        m for m in sys.modules
        if m.startswith(("jax.", "jaxlib", "guacamole_tpu.ops",
                         "guacamole_tpu.parallel"))
    )
    check(not leaked, f"modules that need jax were imported: {leaked}")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
