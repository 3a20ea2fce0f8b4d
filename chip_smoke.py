#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (guacamole_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one Hopper card (compute capability 9.0), nvcc and a C++ compiler,
and nothing of JAX or of the JAX package guacamole_tpu. In phases, it:

 1. checks the card and prints `nvidia-smi`'s name and power limit;
 2. builds the port's native host runtime (g++, through the port's own
    loader) and the CUDA kernels (nvcc, sm_90a, one compiler per source,
    side by side), printing the build times;
 3. holds each CUDA kernel against its plain PyTorch version on the card,
    on the same inputs.
    The counting kernels, with tolerance 0 (every output is an integer):
    random CSR rows, a main-path megatile (about 1M rows, 70 MB of blob,
    timed), a row over 64 KB (the int32-offset wire form), compaction with
    the cap below and above the candidate count, and the tiles of
    ops/edge_shapes.py at the edges of the counting kernel's routes (row
    lengths on and beside every threshold, empty rows only, long rows
    only, one row, row counts around a warp's and a block's, unpadded
    blobs, blobs that start at an odd byte of a larger tensor) and of the
    compaction's (no row, one row, lengths on and beside a thread's, a
    tile's, the one-block route's and a chunk's, no, all, first and last
    flags set, cap 0, below, at and above the total, flags and counts as
    views that start 1, 3 and 15 bytes or rows into larger tensors).
    The likelihood screen ll_screen, whose flags come out of f32 sums: all
    four forms (germline/tumor x uint16/uint8) at K in {2, 8, 15}, D in
    {8, 15, 16, 32, 48, 64, 128, 1024, 16384}, min_phred 0 and 40, with
    all-empty rows and q = 0 elements, row counts that are no multiple of
    32, and tiles with no, 22% and only live rows. The kernel's flags must (a) equal the plain f32
    version's on every row whose decision is not within LL_REL_TOL of its
    boundary (such rows are counted and may be at most 0.1% of the rows),
    (b) be a superset of an f64 evaluation of the same rule with margin 0
    and no safety band, and (c) be the same from the uint8 and the uint16
    form of one tile. Then one main-path shape (1M rows x D = 32, uint8),
    timed in the germline form and in the tumor form (with its MAPQ plane).
    Both screens are also timed at one row: the launch floor.
    The fused dense kernel stats_ll: K in {1, 2, 8, 15, 16, 17, 20, 128,
    256}, D in {8, 15, 64, 1024, 16384}, with and without alignment,
    thresholds None, 0, 8 and 50, with and without the likelihood output,
    all-empty rows, q = 0 elements, and the tiles of ops/edge_shapes.py at
    the edges of its routes (D on and beside every step, batch and team
    size, row counts around a warp's and a block's share, row slices and
    views that break the 16-byte alignment). Integers with tolerance 0;
    likelihoods within the tolerance stated at STATS_LL_RTOL, with an f64
    evaluation as the arbiter. Then one main-path shape (1M rows x D = 32,
    K = 8), timed. The compaction and the dense kernel are timed at one
    row as well;
 4. runs the port's germline-threshold CLI on the 2.37M-read simulated
    fixture (utils/simulate.make_scale_fixture, scale 1.0, seed 2026) with
    device screens, checks that both counting kernels launched, that the
    VCF equals the host-screen run's record for record and that
    planted-SNV recall and precision are >= 0.9; then the same for an
    --emit-ref range through the 8000x spike;
 5. runs the counting tools on the same fixture, each with device screens
    (the full-count form of csr_count_screen: no threshold, no compaction)
    and with host screens, and checks that the outputs are equal byte for
    byte, that csr_count_screen launched and no other kernel did:
    variant-support at the germline-threshold calls of phase 4 (or of one
    host-screen run) plus one site in an overflow clump, over the germline
    and the tumor BAM; vaf-histogram --bins 20 --print-stats --cluster over
    the germline BAM, whose clustering is then fitted once more on the CPU
    (the largest difference of weights, means and variances is printed and
    must stay below 1e-3); then structural-variant, which launches nothing,
    on the paired-end fixture (utils/simulate.make_sv_fixture: 2 Mbp at
    20x, two planted deletions), where the columnar fast path must equal
    the object path byte for byte and every planted deletion must be
    called;
 6. runs the port's germline-standard CLI on the same fixture with device
    screens, checks that ll_screen launched, that the VCF equals the
    host-screen run's record for record and that planted-SNV recall is
    >= 0.9; then again with --min-likelihood 30 and 40 (the GQ gate on
    the device), where at 40 precision must be >= 0.9 too;
 7. runs the port's somatic-standard CLI (--odds 20) on the fixture's
    tumor/normal pair with device screens, checks that ll_screen launched
    and launched its tumor form only, that the VCF equals the host-screen
    run's record for record, that at least half of the planted somatic
    SNVs are called and that at most one germline het in 20 is called
    somatic;
 8. runs germline-threshold and somatic-standard once more with
    GUAC_DENSE_TILES=1 (full per-element tiles), checks that stats_ll
    launched and no other screen kernel did, and that each VCF equals its
    default run's; then runs the forward step of guacamole_tpu_torch.entry
    on its example tile and on the timed shape against the plain version;
 9. drives the device mesh (parallel/mesh.py): mesh_csr_screens (threshold
    25 and full counts) and mesh_ll_screens (germline uint8, tumor) over a
    mesh of cuda:0 and of cuda:0 twice (two shards, two streams) on seven
    fixture tiles each (a partial last group), every output equal to the
    sequential dispatch's on the same tiles with tolerance 0, in its
    order, with its launches and no others; then the CLI with --mesh on
    for germline-threshold, germline-standard, somatic-standard,
    variant-support and vaf-histogram on the full fixture, each output
    equal to that command's default run (record for record, the CSVs byte
    for byte), with its wall, launches and H2D/D2H bytes; then
    dryrun_multichip(2) on the card;
10. drives the multi-process runtime (parallel/multihost.py): two CLI
    processes in a gloo group on localhost, both on cuda:0, for
    germline-threshold and somatic-standard on the full fixture, each
    merged output equal to the single-process run's, with both walls; then
    a run whose process 1 dies before the merge (exit 43) and whose
    process 0 must exit 42, and --recover in one process, whose output
    must equal the single-process run's byte for byte;
11. times all four kernels once more at the median launch of their main
    path in this run (each main-path run prints the shapes its kernels
    were launched at: min / median / max), back to back and with a cold
    L2 cache, and csr_count_screen also at vaf-histogram's median launch
    in its full-count form;
12. prints one JSON line of kernel results, then, as the last line,
    {"ok": true, "device": {...}}.

Every launch count in the JSON line is read after a main-path run that
began with all counts at 0. Any failure exits non-zero before the last
line is printed.

    python3 chip_smoke.py --phases build,kernels    # a subset, for work on
                                                    # the kernels
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

# The port and this script import nothing of JAX and nothing of the JAX
# package: any import of either fails here, even on a machine that has
# them.
sys.modules["jax"] = None
sys.modules["guacamole_tpu"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(ROOT, ".bench_scale")
COUNT_SCREEN_SOURCE = "guacamole_tpu_torch/ops/csrc/csr_screen.cu"
LL_SCREEN_SOURCE = "guacamole_tpu_torch/ops/csrc/ll_screen.cu"
# Published peaks of one H100 SXM: device memory rate, and the f32 rate
# outside the tensor cores (none of these kernels has a matrix product).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# ll_screen against its plain version: a row may differ only where the
# plain version's own decision lies this close to its boundary, relative
# to the size of the scores compared (the two sum f32 terms in different
# orders; 1e-5 is about 80 ulp). For the GQ boundary the slack is in phred:
# an error e in a score difference moves gq by about 4.3 e.
LL_REL_TOL = 1e-5
LL_MAX_BOUNDARY_SHARE = 1e-3


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
    from guacamole_tpu_torch.ops.build import BUILD_DIR, build, load_kernels
    from guacamole_tpu_torch.runtime import native

    t0 = time.perf_counter()
    infos = build()
    cuda_s = time.perf_counter() - t0
    load_kernels()
    for info in infos:
        entry = ""
        for line in info.log.splitlines():
            # One line per kernel: its name (the mangled name without the
            # file prefix) and its registers, stack and shared memory.
            if "Compiling entry function" in line:
                entry = line.split("'")[1].rsplit("_cu_", 1)[-1][8:]
            elif "ptxas info" in line and "Used" in line:
                print(f"{info.source}: {entry}: {line.split(':', 1)[1].strip()}")
    t0 = time.perf_counter()
    lib = native.load_library()
    native_s = time.perf_counter() - t0
    check(lib is not None, "the port's native host runtime did not build")
    check(os.path.dirname(lib._name) == BUILD_DIR,
          f"native runtime loaded from {lib._name}, not from {BUILD_DIR}")
    print(
        f"build: native runtime {native_s:.3f} s -> {lib._name}; CUDA "
        f"kernels {cuda_s:.3f} s in all (0 = reused): "
        + ", ".join(f"{i.source} {i.seconds:.3f} s" for i in infos),
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


def _csr_tile(device, n_short, n_band, n_spike, seed=2026):
    """A main-path CSR tile made on the device: n_short rows at 0..30x,
    n_band rows at 950..1050x and n_spike rows at 7600..8400x, shuffled,
    with the 0xF pad on odd-depth rows. Allele 0 is the reference; alleles
    1..3 are variants, seen in 1% of reads (errors) and in half the reads
    of one row in 1500 (het sites)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def depths(n, lo, hi):
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device)

    depth = torch.cat(
        [depths(n_short, 0, 30), depths(n_band, 950, 1050),
         depths(n_spike, 7600, 8400)]
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


def _megatile(device):
    """1M rows at 0..30x, a 100k-row band at about 1000x and a 2k-row
    spike at about 8000x: 1,102,000 rows, 66 MB of blob."""
    return _csr_tile(device, 1_000_000, 100_000, 2_000)


def _csr_tile_of(device, rows, blob_bytes):
    """A tile of about `rows` rows and `blob_bytes` bytes: short rows (7.75
    bytes on average) and as many band rows (500 bytes) as the bytes need,
    one spike row (4,000 bytes) to 50 band rows as in the megatile."""
    heavy = max(0.0, blob_bytes - 7.75 * rows) / (500 - 7.75 + (4000 - 7.75) / 50)
    n_band, n_spike = int(heavy), int(heavy / 50)
    return _csr_tile(device, max(1, rows - n_band - n_spike), n_band, n_spike)


def _time_ms(fn, reps):
    """Device time of one call, from events around runs of calls. The card
    first spins for as long as the host may take to enqueue a run (twice
    what a few calls just took it, at least 60 us a call), so the calls run
    back to back on the device and a kernel shorter than its wrapper's host
    time is not timed by the host. With 50 calls or more they are made in
    five runs and the median run counts, so one stall of the host does not
    show."""
    fn()
    torch.cuda.synchronize()
    runs = 5 if reps >= 50 else 1
    per_run = reps // runs
    t0 = time.perf_counter()
    for _ in range(min(per_run, 10)):
        fn()
    host_s = (time.perf_counter() - t0) / min(per_run, 10)
    torch.cuda.synchronize()
    spin_s = min(0.2, per_run * max(60e-6, 2 * host_s))
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * 2e9))
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return float(np.median(times))


def _host_call_ms(fn, reps=200):
    """Host time of one call of a wrapper (allocations, checks, the
    launch), the device not waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


L2_FLUSH_BYTES = 128 << 20  # above the card's 50 MB of L2


def _time_cold_ms(fn, device, reps=15):
    """The median time of one call that finds none of its inputs in the L2
    cache, as a launch of the main path does after its tile was staged: a
    128 MB buffer is overwritten before every call, and each call has its
    own pair of events."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(400_000)  # the host gets ahead; the L2 stays cold
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _max_err(a, b):
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# The largest |kernel - plain| any check of the counting kernels has seen.
COUNTING_ERR = {"csr_count_screen": 0, "csr_compact": 0}


def screen_both(blob, off, words, K, t):
    """csr_count_screen on the card, held to its plain version."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import kernels as plain

    kc, kf = ck.csr_count_screen(blob, off, words, K, t)
    pc, pf = plain.csr_count_screen(blob, off, words, K, t)
    e = max(_max_err(kc, pc), _max_err(kf, pf))
    COUNTING_ERR["csr_count_screen"] = max(COUNTING_ERR["csr_count_screen"], e)
    check(e == 0, f"csr_count_screen != plain (L={off.numel() - 1}, K={K}, "
          f"t={t}): {e}")
    return kc, kf


def compact_both(flags, counts, cap):
    """csr_compact on the card, held to its plain version."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import kernels as plain

    got = ck.csr_compact(flags, counts, cap)
    e = _max_err(got, plain.compact_candidates(flags, counts, cap))
    COUNTING_ERR["csr_compact"] = max(COUNTING_ERR["csr_compact"], e)
    check(e == 0, f"csr_compact != plain (L={flags.numel()}, cap={cap}): {e}")
    return got


def check_kernels(device) -> dict:
    """Every kernel against its plain twin at shapes (a)-(d); returns the
    per-kernel record for the JSON line (launches filled in later)."""

    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import edge_shapes
    from guacamole_tpu_torch.ops import kernels as plain
    from guacamole_tpu_torch.ops.dispatch import wire_from_numpy

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
    # (e) the edges of the kernel's routes (ops/edge_shapes.py): each tile
    # unpadded, so its last row ends at the blob's last byte, and again as
    # a slice that starts 1, 3 and 15 bytes into a larger tensor whose
    # leading bytes would count as allele 0 if they were read.
    n_edge = 0
    for K in (1, 8, 15):
        for name, blob_np, off_np, iv in edge_shapes.csr_edge_cases(K):
            off = torch.from_numpy(off_np).to(device)
            words = torch.from_numpy(plain.pack_variant_words16(iv)).to(device)
            for lead in (0, 1, 3, 15) if K == 8 else (0, 3):
                blob = torch.cat([
                    torch.zeros(lead, dtype=torch.uint8),
                    torch.from_numpy(blob_np),
                ]).to(device)[lead:]
                check(blob.numel() == 0 or blob.data_ptr() % 16 == lead,
                      f"edge tile {name!r}: slice not {lead} bytes in")
                for t in (None, 25):
                    screen_both(blob, off, words, K, t)
                    n_edge += 1
    # (f) the edges of the compaction's routes (ops/edge_shapes.py): every
    # length with cap 0, below, at and above the total, the flags as a view
    # that starts 0, 1, 3 and 15 bytes into a larger tensor and the counts
    # as one that starts as many rows into theirs.
    n_compact_edge = 0
    for K in (1, 8, 15):
        for name, flags_np, counts_np in edge_shapes.compact_edge_cases(
                K, big=K == 8):
            total = int(flags_np.sum())
            big = len(flags_np) > 1 << 20
            for lead in (0, 15) if big or K != 8 else edge_shapes.COMPACT_LEADS:
                flags = edge_shapes.view_into_larger(
                    torch.from_numpy(flags_np).to(device), lead, True)
                counts = edge_shapes.view_into_larger(
                    torch.from_numpy(counts_np).to(device), lead, 77)
                check(flags.numel() == 0 or flags.data_ptr() % 16 == lead,
                      f"compaction edge {name!r}: view not {lead} bytes in")
                for cap in edge_shapes.compact_caps(total):
                    raw = compact_both(flags, counts, cap)
                    check(int(raw[cap, 0]) == total,
                          f"compaction edge {name!r}: footer != total")
                    n_compact_edge += 1
    # A two-pass length with a cap that its candidates overflow.
    flags_np, counts_np = edge_shapes.compact_tile(rng, 50_000, 8)
    flags, counts = (torch.from_numpy(a).to(device)
                     for a in (flags_np, counts_np))
    check(torch.equal(ck.csr_compact(flags, counts, 600),
                      plain.compact_candidates(flags, counts, 600)),
          "csr_compact at 50,000 rows")
    torch.cuda.synchronize()
    # (b) the main-path megatile, timed.
    mega = _time_counting(device, *_megatile(device))
    # The launch floor: one row of 8 bytes.
    blob1, off1, words1 = (
        torch.full((8,), 0x10, dtype=torch.uint8, device=device),
        torch.tensor([0, 8], dtype=torch.int32, device=device),
        torch.tensor([2], dtype=torch.int32, device=device).to(torch.uint16),
    )
    screen_both(blob1, off1, words1, 8, 25)
    floor_ms = _time_ms(
        lambda: ck.csr_count_screen(blob1, off1, words1, 8, 25), 200)
    host_ms = _host_call_ms(
        lambda: ck.csr_count_screen(blob1, off1, words1, 8, 25))
    counts1, flags1 = ck.csr_count_screen(blob1, off1, words1, 8, None)
    compact_both(flags1, counts1, 512)
    compact_floor_ms = _time_ms(
        lambda: ck.csr_compact(flags1, counts1, 512), 200)
    compact_host_ms = _host_call_ms(
        lambda: ck.csr_compact(flags1, counts1, 512))
    print(
        f"megatile: {mega['rows']} rows, {mega['blob_bytes']} blob bytes, "
        f"{mega['candidates']} candidates at --threshold 25, cap "
        f"{mega['cap']}; "
        + "; ".join(
            f"{n} kernel {mega[n]['ms']:.4f} ms, plain "
            f"{mega[n]['plain_ms']:.4f} ms, bound {mega[n]['bound_ms']:.4f} "
            f"ms ({mega[n]['bound_by']})"
            for n in ("csr_count_screen", "csr_compact")
        )
        + f"; csr_count_screen moves "
        f"{mega['csr_count_screen']['bytes'] / mega['csr_count_screen']['ms'] / 1e6:.1f}"
        f" GB/s; at L = 1 (the launch floor) {floor_ms:.4f} ms on the "
        f"device, {host_ms:.4f} ms of host time a call; "
        f"{n_edge} edge launches equal to the plain version; csr_compact "
        f"at L = 1 (cap 512) {compact_floor_ms:.4f} ms on the device, "
        f"{compact_host_ms:.4f} ms of host time a call; "
        f"{n_compact_edge} edge launches equal to the plain version",
        flush=True,
    )
    # No single PyTorch call counts nibbles per CSR row, and torch.nonzero
    # plus a gather are two calls (the plain version): no library_ms.
    records = {
        name: {
            "name": name, "route": "cuda", "source": COUNT_SCREEN_SOURCE,
            "replaces": replaces, "launches": 0,
            "max_abs_err": COUNTING_ERR[name],
            "ms": mega[name]["ms"], "plain_ms": mega[name]["plain_ms"],
            "bound_ms": mega[name]["bound_ms"],
            "bound_by": mega[name]["bound_by"], "library_ms": None,
        }
        for name, replaces in (
            ("csr_count_screen", "guacamole_tpu/ops/pallas_kernels.py:268"),
            ("csr_compact", "guacamole_tpu/ops/kernels.py:251"),
        )
    }
    records["csr_count_screen"]["floor_ms"] = floor_ms
    records["csr_count_screen"]["host_call_ms"] = host_ms
    records["csr_count_screen"]["edge_launches"] = n_edge
    records["csr_compact"]["floor_ms"] = compact_floor_ms
    records["csr_compact"]["host_call_ms"] = compact_host_ms
    records["csr_compact"]["edge_launches"] = n_compact_edge
    return records


def _time_counting(device, blob, off, words, cold=False, threshold=25):
    """Both counting kernels on one tile (K = 8, --threshold 25, or the
    full-count form with threshold None): checked against their plain
    versions, then timed in turns (plain, kernel, kernel, plain), with their
    bounds. With cold, also the time of a launch that finds nothing in the
    L2 cache."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import kernels as plain

    L = off.numel() - 1
    cap = max(512, L // 256)
    counts, flags = screen_both(blob, off, words, 8, threshold)
    compact_both(flags, counts, cap)
    compact_both(flags, counts, max(int(flags.sum()) - 1, 0))
    n_cand = int(flags.sum())
    K = counts.shape[1]
    calls = {
        "csr_count_screen": (
            lambda: ck.csr_count_screen(blob, off, words, 8, threshold),
            lambda: plain.csr_count_screen(blob, off, words, 8, threshold),
            # One add per nibble for the counts.
            blob.numel() + off.numel() * 4 + words.numel() * 2
            + L * K * 2 + L,
            2 * blob.numel(),
        ),
        "csr_compact": (
            lambda: ck.csr_compact(flags, counts, cap),
            lambda: plain.compact_candidates(flags, counts, cap),
            # One add per flag for the scan; the counts of candidate rows
            # only.
            L + n_cand * K * 2 + (cap + 1) * (K + 1) * 4,
            L,
        ),
    }
    out = {"rows": L, "blob_bytes": blob.numel(), "candidates": n_cand,
           "cap": cap}
    for name, (kfn, pfn, n_bytes, n_ops) in calls.items():
        p1 = _time_ms(pfn, 3)
        k1 = _time_ms(kfn, 50)
        k2 = _time_ms(kfn, 50)
        p2 = _time_ms(pfn, 3)
        bound_ms, bound_by = _bound_ms(n_bytes, n_ops)
        out[name] = {
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
        }
        if cold:
            out[name]["cold_ms"] = _time_cold_ms(kfn, device)
    return out


# --- phase 3, continued: the likelihood screen ---------------------------

def _ll_decisions(plain, wire, K, min_phred, dtype):
    """(parts, any_valid) of the plain version in `dtype`."""
    iv, sa = plain.unpack_flag_words(wire.flag_words, K)
    qvals = None if wire.qvals is None else torch.from_numpy(wire.qvals)
    c, g, any_valid = plain.ll_allele_sums(
        wire.pack, K, qvals, wire.mapq, dtype=dtype
    )
    gate = 0.0 if wire.mapq is not None else min_phred
    return plain.screen_parts(c, g, iv, sa, K, gate), any_valid


def _check_ll_case(ck, plain, wire, K, margin, min_phred, what):
    """The kernel's flags against the plain f32 version (a) and the f64
    rule (b). Returns (flags, rows excused at the boundary)."""
    got = ck.ll_screen(
        wire.pack, wire.flag_words, K, margin, min_phred,
        ll_qvals=wire.qvals, ll_mapq=wire.mapq,
    )
    torch.cuda.synchronize()
    want = plain.ll_screen(
        wire.pack, wire.flag_words, K, margin, min_phred,
        None if wire.qvals is None else torch.from_numpy(wire.qvals),
        wire.mapq,
    )
    check(got.dtype == torch.bool and got.shape == want.shape,
          f"ll_screen {what}: shape/dtype")
    parts, _ = _ll_decisions(plain, wire, K, min_phred, torch.float32)
    finite = torch.nan_to_num(
        torch.maximum(parts.best_variant.abs(), parts.best_ref.abs()),
        nan=0.0, posinf=0.0, neginf=0.0,
    )
    tol = LL_REL_TOL * finite.clamp_min(1.0)
    slack = (parts.best_variant - (parts.best_ref - margin)).abs()
    near = torch.nan_to_num(slack, nan=float("inf")) < tol
    if parts.gq is not None:
        gq_slack = (parts.gq - (min_phred - plain.GQ_SAFETY_BAND)).abs()
        near |= gq_slack < 10.0 * tol + 1e-4
    differ = got != want
    bad = differ & ~near
    check(not bool(bad.any()),
          f"ll_screen {what}: {int(bad.sum())} rows differ from the plain "
          f"version away from the boundary (first rows "
          f"{torch.nonzero(bad).flatten()[:5].tolist()})")
    excused = int(differ.sum())
    # (b) the exact rule: margin 0, no safety band, in f64.
    p64, valid64 = _ll_decisions(plain, wire, K, min_phred, torch.float64)
    exact = p64.has_var & valid64 & (p64.best_variant >= p64.best_ref)
    if p64.gq is not None:
        exact &= ~p64.smax_finite | (p64.gq >= min_phred)
    missed = exact & ~got
    check(not bool(missed.any()),
          f"ll_screen {what}: missed {int(missed.sum())} rows that the f64 "
          f"rule flags (first rows {torch.nonzero(missed).flatten()[:5].tolist()})")
    return got, excused


def _main_path_ll_tile(device, L=1 << 20, D=32, K=8, seed=2026):
    """A main-path likelihood tile made on the device, in the uint8
    qual-dictionary form native tiles ship: 1M rows at about 25x (depth
    capped at D = 32; at another D the mean depth is 25/32 of it, as full
    as the main path's tiles are), allele 0 the reference, errors to alleles 1..3 in
    1% of reads, one het row in 1500, quals 20..41 from a 16-entry
    dictionary. A row's flag word marks the alleles it holds as standard
    and its non-reference ones as variant, as the packer's allele tables
    do, so most rows have no variant allele at all."""
    g = torch.Generator(device=device).manual_seed(seed)
    depth = torch.poisson(
        torch.full((L,), 25.0 * D / 32, device=device), generator=g
    ).clamp_(0, D).to(torch.int32)
    valid = torch.arange(D, device=device)[None, :] < depth[:, None]
    u = torch.rand((L, D), generator=g, device=device)
    alt = torch.randint(1, 4, (L, D), generator=g, device=device)
    het = torch.rand(L, generator=g, device=device) < 1 / 1500
    aid = torch.where(het[:, None] & (u < 0.5), 1, torch.where(u < 0.01, alt, 0))
    qidx = torch.randint(0, 16, (L, D), generator=g, device=device)
    pack8 = torch.where(valid, aid | (qidx << 4), 0xFF).to(torch.uint8)
    present = torch.zeros((L, K), dtype=torch.int32, device=device).scatter_add_(
        1, torch.where(valid, aid, 0), valid.to(torch.int32)
    ) > 0
    bits = (present.to(torch.int32) << torch.arange(K, device=device)).sum(1)
    words = ((bits & ~1) | (bits << 16)).to(torch.int32)
    qvals = np.arange(20, 42, dtype=np.uint8)[:16]
    return pack8, words, qvals


def _time_ll(device, pack8, words, qvals, mapq8, what, cold=False):
    """ll_screen on one uint8 tile (K = 8, no GQ gate; the tumor form when
    mapq8 is given): held to contracts (a) and (b), then timed in turns
    (plain, kernel, kernel, plain), with its bound."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import kernels as plain

    L, D = pack8.shape
    wire = SimpleNamespace(
        pack=pack8, flag_words=words, qvals=qvals, mapq=mapq8)
    flags, excused = _check_ll_case(ck, plain, wire, 8, 0.5, 0.0, what)
    check(excused <= max(1, LL_MAX_BOUNDARY_SHARE * L),
          f"ll_screen {what}: {excused} rows differ at the boundary")
    qv = torch.from_numpy(qvals)

    def kfn():
        ck.ll_screen(pack8, words, 8, 0.5, 0.0, ll_qvals=qvals, ll_mapq=mapq8)

    def pfn():
        plain.ll_screen(pack8, words, 8, 0.5, 0.0, qv, mapq8)

    p1 = _time_ms(pfn, 3)
    k1 = _time_ms(kfn, 50)
    k2 = _time_ms(kfn, 50)
    p2 = _time_ms(pfn, 3)
    # The least the card could do: rows with a standard variant allele are
    # read in full (the others cannot be candidates, whatever they hold),
    # every row's flag word is read and its flag written; two f32 adds per
    # valid element of a row that is read.
    has_var = (words & (words >> 16) & 0x7FFF) != 0
    read_rows = int(has_var.sum())
    planes = 1 if mapq8 is None else 2
    n_bytes = read_rows * D * planes + L * 4 + L
    n_ops = 2 * int((pack8[has_var] != 0xFF).sum())
    bound_ms, bound_by = _bound_ms(n_bytes, n_ops)
    out = {
        "rows": L, "D": D, "read_rows": read_rows,
        "candidates": int(flags.sum()), "excused": excused,
        "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
        "ops": n_ops,
    }
    if cold:
        out["cold_ms"] = _time_cold_ms(kfn, device)
    return out


def check_ll_screen(device) -> dict:
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import kernels as plain
    from guacamole_tpu_torch.ops.dispatch import ll_wire_from_numpy
    from guacamole_tpu_torch.ops.edge_shapes import LL_EDGE_DEPTHS, ll_tile

    rng = np.random.default_rng(2026)
    rows = excused = 0

    def both_forms(tile, K, tumor, min_phred, what):
        """Contracts (a), (b) on each encoding and (c) between them."""
        p16, p8, qvals, mapq, iv, sa = tile
        mq = mapq if tumor else None
        w16 = ll_wire_from_numpy(p16, mq, iv, sa, None, device)
        w8 = ll_wire_from_numpy(p8, mq, iv, sa, qvals, device)
        f16, e16 = _check_ll_case(
            ck, plain, w16, K, 0.5, min_phred, what + " uint16")
        f8, e8 = _check_ll_case(
            ck, plain, w8, K, 0.5, min_phred, what + " uint8")
        check(bool((f16 == f8).all()),
              f"ll_screen {what}: the uint8 and uint16 forms differ on "
              f"{int((f16 != f8).sum())} rows")
        return 2 * len(p16), e16 + e8

    # Every route: one thread per row (D <= 64) in steps of 16, 8 and 1
    # elements, teams of 4 to 32 lanes, a warp per row.
    for K in (2, 8, 15):
        for D, L in ((8, 8192), (15, 4099), (16, 4099), (32, 4099),
                     (48, 4099), (64, 4096), (128, 2051), (1024, 512),
                     (16384, 64)):
            tile = ll_tile(rng, L, D, K)
            for tumor in (False, True):
                for min_phred in (0.0,) if tumor else (0.0, 40.0):
                    what = (f"K={K} D={D} {'tumor' if tumor else 'germline'} "
                            f"min_phred={min_phred:g}")
                    n, e = both_forms(tile, K, tumor, min_phred, what)
                    rows += n
                    excused += e
    # Tiles with no, some and only live rows (the kernel reads the live
    # ones only), L not a multiple of 32, at the edge depths.
    for D in LL_EDGE_DEPTHS:
        for live_share in (0.0, 0.22, 1.0):
            tile = ll_tile(rng, 1000 + D, D, 8, live_share)
            for tumor in (False, True):
                what = (f"D={D} live={live_share:g} "
                        f"{'tumor' if tumor else 'germline'}")
                n, e = both_forms(tile, 8, tumor, 0.0, what)
                rows += n
                excused += e
    check(excused <= LL_MAX_BOUNDARY_SHARE * rows,
          f"ll_screen: {excused} of {rows} rows differ at the boundary")
    # A tile of nothing but empty slots, and an empty tile.
    empty = ll_wire_from_numpy(
        np.full((300, 32), 0xFF, np.uint8), None, np.ones((300, 8), bool),
        np.ones((300, 8), bool), np.asarray([30], np.uint8), device)
    check(not bool(ck.ll_screen(empty.pack, empty.flag_words, 8,
                                ll_qvals=empty.qvals).any()),
          "ll_screen flagged an all-empty row")
    check(ck.ll_screen(empty.pack[:0], empty.flag_words[:0], 8,
                       ll_qvals=empty.qvals).shape == (0,),
          "ll_screen on an empty tile")
    # The main-path shape, timed: germline uint8, K = 8, no GQ gate; then
    # the tumor form at the shape somatic-standard ships most: the same
    # tile with its [L, D] uint8 MAPQ plane.
    pack8, words, qvals = _main_path_ll_tile(device)
    L, D = pack8.shape
    main = _time_ll(device, pack8, words, qvals, None, "main-path tile")
    g = torch.Generator(device=device).manual_seed(7)
    mapq8 = torch.randint(
        20, 61, pack8.shape, generator=g, device=device).to(torch.uint8)
    tumor = _time_ll(device, pack8, words, qvals, mapq8,
                     "main-path tile, tumor form")
    # The launch floor: one live row.
    floors = {}
    for form, mq in (("germline", None), ("tumor", mapq8[:1])):
        _check_ll_case(
            ck, plain, SimpleNamespace(pack=pack8[:1], flag_words=words[:1],
                                       qvals=qvals, mapq=mq),
            8, 0.5, 0.0, f"one row, {form}")
        floors[form] = _time_ms(
            lambda: ck.ll_screen(pack8[:1], words[:1], 8, 0.5, 0.0,
                                 ll_qvals=qvals, ll_mapq=mq), 200)
    host_ms = _host_call_ms(
        lambda: ck.ll_screen(pack8[:1], words[:1], 8, 0.5, 0.0,
                             ll_qvals=qvals))
    n_excused = excused + main["excused"] + tumor["excused"]
    print(
        f"ll tile, tumor form (uint8 + MAPQ plane): {tumor['candidates']} "
        f"candidates; ll_screen kernel {tumor['ms']:.4f} ms, plain "
        f"{tumor['plain_ms']:.4f} ms, bound {tumor['bound_ms']:.4f} ms "
        f"({tumor['bound_by']}: {tumor['bytes']} bytes, {tumor['ops']} "
        f"operations); at L = 1 (the launch floor) {floors['tumor']:.4f} ms",
        flush=True,
    )
    print(
        f"ll tile: {L} rows x D={D} uint8, {main['read_rows']} rows with a "
        f"standard variant allele, {main['candidates']} candidates; "
        f"ll_screen kernel {main['ms']:.4f} ms, plain {main['plain_ms']:.4f} "
        f"ms, bound {main['bound_ms']:.4f} ms ({main['bound_by']}: "
        f"{main['bytes']} bytes, {main['ops']} operations); at L = 1 (the "
        f"launch floor) {floors['germline']:.4f} ms on the device, "
        f"{host_ms:.4f} ms of host time a call; {n_excused} of "
        f"{rows + 2 * L} checked rows differed from the plain version, all "
        f"within {LL_REL_TOL:g} of their boundary",
        flush=True,
    )
    return {
        "ll_screen": {
            "name": "ll_screen", "route": "cuda", "source": LL_SCREEN_SOURCE,
            "replaces": "guacamole_tpu/ops/pallas_kernels.py:370",
            "launches": 0,
            # Flags are 0/1, so the error is 1 as soon as one row differs
            # from the plain version; every such row lies within LL_REL_TOL
            # of its decision boundary, and their count is given beside it.
            "max_abs_err": float(n_excused > 0),
            "rows_checked": rows + 2 * L,
            "rows_differing_at_boundary": n_excused,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "floor_ms": floors["germline"], "host_call_ms": host_ms,
            "tumor_form_ms": tumor["ms"],
            "tumor_form_plain_ms": tumor["plain_ms"],
            "tumor_form_bound_ms": tumor["bound_ms"],
            "tumor_form_floor_ms": floors["tumor"],
        },
    }


# --- phase 3, continued: the fused dense-tile kernel ----------------------

STATS_LL_SOURCE = "guacamole_tpu_torch/ops/csrc/stats_ll.cu"
# stats_ll against its plain version. Counts, forward counts, depth and
# flags are integers: tolerance 0. The likelihoods are f32 sums of D terms
# taken in another order (the kernel sums three terms per allele in lanes
# and adds them up per pair; the plain version sums one log per element and
# pair): |kernel - plain| <= LL_ATOL(D) + STATS_LL_RTOL * |plain|, with the
# JAX tests' rtol = atol = 2e-5 up to D = 16 and an absolute part that grows
# in proportion to the depth beyond it, since each term added can round the
# running sum by half an ulp. Where the two disagree by more, an f64
# evaluation of the plain version is the arbiter and the kernel must lie
# within the same tolerance of it. Entries that are not finite (q = 0 gives
# log 0) must be the same infinity in both.
STATS_LL_RTOL = 2e-5


def _stats_ll_atol(D: int) -> float:
    return 2e-5 * max(1.0, D / 16)


def _check_stats_ll_case(ck, plain, wire, K, align, thr, with_ll, what, err):
    """One launch against the plain version; updates err in place."""
    got = ck.stats_ll(
        wire.allele_id, wire.qual, wire.mapq, wire.strand, wire.valid,
        wire.is_variant, K, include_alignment=align, threshold_percent=thr,
        with_likelihoods=with_ll,
    )
    torch.cuda.synchronize()
    args = (wire.allele_id, wire.qual, wire.mapq, wire.strand, wire.valid,
            wire.is_variant, K, align, thr, with_ll)
    want = plain.stats_ll_math(*args)
    for name in ("counts", "forward_counts", "depth", "candidates"):
        e = _max_err(getattr(got, name), getattr(want, name))
        check(e == 0, f"stats_ll {what}: {name} differs from the plain "
              f"version by {e}")
    if not with_ll:
        check(got.log_likelihoods is None, f"stats_ll {what}: unasked output")
        return
    k, p = got.log_likelihoods, want.log_likelihoods
    check(k.shape == p.shape and k.dtype == torch.float32,
          f"stats_ll {what}: likelihood shape/dtype")
    check(not bool(torch.isnan(k).any()), f"stats_ll {what}: NaN")
    finite = torch.isfinite(k) & torch.isfinite(p)
    check(bool((k[~finite] == p[~finite]).all()),
          f"stats_ll {what}: infinities differ")
    D = wire.allele_id.shape[1]
    tol = _stats_ll_atol(D) + STATS_LL_RTOL * p.abs()
    diff = torch.where(finite, (k - p).abs(), torch.zeros_like(k))
    err["abs"] = max(err["abs"], float(diff.max()))
    err["entries"] += int(finite.sum())
    over = finite & (diff > tol)
    if bool(over.any()):
        exact = plain.stats_ll_math(*args, dtype=torch.float64).log_likelihoods
        off = (k.double() - exact).abs()
        bad = over & (off > _stats_ll_atol(D) + STATS_LL_RTOL * exact.abs())
        err["arbitrated"] += int(over.sum())
        check(not bool(bad.any()),
              f"stats_ll {what}: {int(bad.sum())} likelihoods beyond "
              f"tolerance of both the plain f32 and the f64 evaluation "
              f"(largest {float(off[bad].max()) if bad.any() else 0:g})")


def _main_path_dense_tile(device, L=1 << 20, D=32, K=8, seed=2026):
    """A main-path dense tile made on the device: 1M rows at about 25x
    (depth capped at D = 32; at another D the mean depth is 25/32 of it, as
    the likelihood tile's is), allele 0 the reference, errors to alleles
    1..3 in 1% of reads, one het row in 1500, quals 20..41, MAPQ 60,
    alleles 1..3 variants."""
    g = torch.Generator(device=device).manual_seed(seed)
    depth = torch.poisson(
        torch.full((L,), 25.0 * D / 32, device=device), generator=g
    ).clamp_(0, D).to(torch.int32)
    valid = torch.arange(D, device=device)[None, :] < depth[:, None]
    u = torch.rand((L, D), generator=g, device=device)
    alt = torch.randint(1, 4, (L, D), generator=g, device=device)
    het = torch.rand(L, generator=g, device=device) < 1 / 1500
    aid = torch.where(het[:, None] & (u < 0.5), 1, torch.where(u < 0.01, alt, 0))
    aid = torch.where(valid, aid, -1).to(torch.int16)
    qual = torch.where(
        valid, torch.randint(20, 42, (L, D), generator=g, device=device), 0
    ).to(torch.int16)
    mapq = torch.where(valid, 60, 0).to(torch.int16)
    strand = valid & (torch.rand((L, D), generator=g, device=device) < 0.5)
    is_variant = torch.zeros((L, K), dtype=torch.bool, device=device)
    is_variant[:, 1:4] = True
    return SimpleNamespace(
        allele_id=aid, qual=qual, mapq=mapq, strand=strand, valid=valid,
        is_variant=is_variant,
    )


_DENSE_PLANES = ("allele_id", "qual", "mapq", "strand", "valid", "is_variant")


def _stats_ll_bound(rows, D, K, n_valid, with_ll):
    """(bound_ms, bound_by, bytes, operations) of stats_ll without
    alignment on a tile with n_valid elements. Bytes: the valid plane in
    full (1 B a slot), allele_id and strand (3 B) of the valid elements
    only, with likelihoods their qual too (2 B; mapq is not needed without
    alignment), is_variant, and the outputs: counts, forward counts, depth
    and flag, and the P pair likelihoods. Operations: three integer
    additions an element; with likelihoods 1 subtraction, 3 sums and 3 logs
    for the terms, 3 f32 and 3 integer additions an element, and K
    additions per row and pair."""
    P = K * (K + 1) // 2
    n_bytes = rows * D + 3 * n_valid + rows * K + rows * (8 * K + 5)
    n_ops = n_valid * 3
    if with_ll:
        n_bytes += 2 * n_valid + rows * 4 * P
        n_ops = n_valid * 13 + rows * P * K
    return (*_bound_ms(n_bytes, n_ops), n_bytes, n_ops)


def check_stats_ll(device) -> dict:
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import kernels as plain
    from guacamole_tpu_torch.ops.dispatch import dense_wire_from_numpy
    from guacamole_tpu_torch.ops.edge_shapes import (
        dense_edge_cases, dense_tile, view_into_larger)

    rng = np.random.default_rng(2026)
    err = {"abs": 0.0, "entries": 0, "arbitrated": 0}
    thresholds = (None, 0, 8, 50)
    launches = 0
    for K in (1, 2, 8, 15, 16, 17):
        for D, L in ((8, 8192), (15, 4096), (64, 4096), (1024, 512),
                     (16384, 64)):
            wire = dense_wire_from_numpy(
                *dense_tile(rng, L, D, K), device=device)
            for a, align in enumerate((False, True)):
                for i, thr in enumerate(thresholds):
                    what = f"K={K} D={D} alignment={align} threshold={thr}"
                    # Every threshold without likelihoods; with them, two
                    # thresholds per case (all four over the two modes).
                    _check_stats_ll_case(
                        ck, plain, wire, K, align, thr, False, what, err)
                    if i % 2 == a:
                        _check_stats_ll_case(
                            ck, plain, wire, K, align, thr, True, what, err)
                        launches += 1
                    launches += 1
    # More alleles than the screens take, up to the wrapper's limit: only
    # the threads of a block change.
    wire = dense_wire_from_numpy(*dense_tile(rng, 512, 64, 20), device=device)
    _check_stats_ll_case(ck, plain, wire, 20, True, 8, True, "K=20 D=64", err)
    wire = dense_wire_from_numpy(*dense_tile(rng, 40, 32, 256), device=device)
    _check_stats_ll_case(ck, plain, wire, 256, False, 8, False, "K=256", err)
    wire = dense_wire_from_numpy(*dense_tile(rng, 40, 32, 128), device=device)
    _check_stats_ll_case(ck, plain, wire, 128, False, 8, True, "K=128", err)
    launches += 3
    # The edges of the kernel's routes (ops/edge_shapes.py): each tile with
    # and without likelihoods and alignment, then as row slices and as views
    # that start 1 and 3 elements into larger tensors, which break the
    # 16-byte alignment of the vector loads.
    for name, K, tile in dense_edge_cases():
        wire = dense_wire_from_numpy(*tile, device=device)
        for with_ll, align, thr in ((False, False, 25), (True, False, None),
                                    (True, True, 8)):
            _check_stats_ll_case(
                ck, plain, wire, K, align, thr, with_ll, name, err)
            launches += 1
        views = [("rows 1..", SimpleNamespace(**{
            key: getattr(wire, key)[1:] for key in _DENSE_PLANES}))]
        for lead in (1, 3):
            views.append((f"{lead} elements in", SimpleNamespace(**{
                key: view_into_larger(
                    getattr(wire, key).reshape(-1), lead
                ).view(getattr(wire, key).shape)
                for key in _DENSE_PLANES})))
        for what, view in views:
            _check_stats_ll_case(ck, plain, view, K, True, 8, True,
                                 f"{name}, {what}", err)
            _check_stats_ll_case(ck, plain, view, K, False, None, False,
                                 f"{name}, {what}", err)
            launches += 2
    # A tile of nothing but empty slots, and an empty tile.
    blank = dense_wire_from_numpy(
        np.full((300, 32), -1, np.int16), np.zeros((300, 32), np.int16),
        np.zeros((300, 32), np.int16), np.zeros((300, 32), bool),
        np.zeros((300, 32), bool), np.ones((300, 8), bool), device=device)
    out = ck.stats_ll(blank.allele_id, blank.qual, blank.mapq, blank.strand,
                      blank.valid, blank.is_variant, 8, threshold_percent=0)
    check(not bool(out.candidates.any()) and not bool(out.depth.any())
          and not bool(out.counts.any())
          and bool((out.log_likelihoods == 0).all()),
          "stats_ll on all-empty rows: expected depth 0, no candidate and "
          "likelihoods 0")
    none = ck.stats_ll(blank.allele_id[:0], blank.qual[:0], blank.mapq[:0],
                       blank.strand[:0], blank.valid[:0],
                       blank.is_variant[:0], 8)
    check(none.log_likelihoods.shape == (0, 36), "stats_ll on an empty tile")
    # The main-path shape, timed: the forward step's call (likelihoods, no
    # alignment, no threshold), and the screens' call (no likelihoods).
    tile = _main_path_dense_tile(device)
    L, D = tile.allele_id.shape
    K = tile.is_variant.shape[1]
    _check_stats_ll_case(
        ck, plain, tile, K, False, None, True, "main-path tile", err)
    _check_stats_ll_case(
        ck, plain, tile, K, False, 25, False, "main-path tile, screen", err)

    def call(fn, with_ll):
        return lambda: fn(
            tile.allele_id, tile.qual, tile.mapq, tile.strand, tile.valid,
            tile.is_variant, K, False, None, with_ll)

    p1 = _time_ms(call(plain.stats_ll_math, True), 3)
    k1 = _time_ms(call(ck.stats_ll, True), 50)
    s1 = _time_ms(call(ck.stats_ll, False), 50)
    k2 = _time_ms(call(ck.stats_ll, True), 50)
    p2 = _time_ms(call(plain.stats_ll_math, True), 3)
    ps = _time_ms(call(plain.stats_ll_math, False), 3)
    # The launch floor: one row, as the screens call it and with likelihoods.
    one = SimpleNamespace(**{
        key: getattr(tile, key)[:1] for key in _DENSE_PLANES})
    floors = {}
    for with_ll in (False, True):
        _check_stats_ll_case(ck, plain, one, K, False, 25, with_ll,
                             "one row", err)
        floors[with_ll] = _time_ms(
            lambda: ck.stats_ll(one.allele_id, one.qual, one.mapq, one.strand,
                                one.valid, one.is_variant, K, False, 25,
                                with_ll), 200)
    host_ms = _host_call_ms(
        lambda: ck.stats_ll(one.allele_id, None, None, one.strand, one.valid,
                            one.is_variant, K, False, 25, False))
    n_valid = int(tile.valid.sum())
    bound_ms, bound_by, n_bytes, n_ops = _stats_ll_bound(
        L, D, K, n_valid, True)
    screen_bound, screen_by, screen_bytes, _ = _stats_ll_bound(
        L, D, K, n_valid, False)
    print(
        f"dense tile: {L} rows x D={D}, K={K}, {n_valid} valid elements; "
        f"stats_ll kernel {(k1 + k2) / 2:.4f} ms, plain "
        f"{(p1 + p2) / 2:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{n_bytes} bytes, {n_ops} operations); without likelihoods (the "
        f"screens' call) kernel {s1:.4f} ms, plain {ps:.4f} ms, bound "
        f"{screen_bound:.4f} ms ({screen_by}: {screen_bytes} bytes); at "
        f"L = 1 (the launch floor) {floors[False]:.4f} ms on the device "
        f"({floors[True]:.4f} with likelihoods), {host_ms:.4f} ms of host "
        f"time a call; "
        f"integers equal to the plain version in {launches + 6} launches; "
        f"likelihoods: largest |kernel - plain| {err['abs']:.3g} over "
        f"{err['entries']} finite entries, tolerance "
        f"{STATS_LL_RTOL:g} * |x| + 2e-5 * max(1, D/16), "
        f"{err['arbitrated']} entries taken to the f64 arbiter",
        flush=True,
    )
    return {
        "stats_ll": {
            "name": "stats_ll", "route": "cuda", "source": STATS_LL_SOURCE,
            "replaces": "guacamole_tpu/ops/pallas_kernels.py:31",
            "launches": 0, "max_abs_err": err["abs"],
            "entries_checked": err["entries"],
            "entries_arbitrated_in_f64": err["arbitrated"],
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ms_without_likelihoods": s1,
            "plain_ms_without_likelihoods": ps,
            "bound_ms_without_likelihoods": screen_bound,
            "floor_ms": floors[False],
            "floor_ms_with_likelihoods": floors[True],
            "host_call_ms": host_ms, "launches_checked": launches + 6,
            # No single PyTorch call computes counts, flags and pair
            # likelihoods of a tile.
            "library_ms": None,
        },
    }


def _bound_ms(n_bytes: int, n_ops: int):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the f32 rate."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# --- phase 4: the slice ------------------------------------------------


def _run_cli(command, argv, host_screen: bool) -> float:
    from guacamole_tpu_torch.cli import main as port_main

    os.environ["GUAC_HOST_SCREEN"] = "1" if host_screen else "0"
    t0 = time.perf_counter()
    rc = port_main([command, *argv, "--debug"])  # raise, don't mask
    wall = time.perf_counter() - t0
    check(rc == 0, f"{command} {argv} exited {rc}")
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


def _recall_precision(vcf, manifest):
    called, n_records = _snv_sites(vcf)
    planted = {
        (contig, pos)
        for contig in ("deep1m", "shallow8m")
        for pos in manifest["truth"][contig]["snv_pos"]
    }
    hits = len(called & planted)
    return (hits / max(1, len(planted)), hits / max(1, len(called)),
            n_records)


def _check_equal_vcfs(a, b):
    from guacamole_tpu_torch.concordance import compare_vcf_records

    cmp = compare_vcf_records(a, b)
    check(cmp.record_level_identical and cmp.matching > 0,
          f"{os.path.basename(a)} vs {os.path.basename(b)} differ: "
          f"{cmp.only_a[:5]} / {cmp.only_b[:5]}")
    return cmp.matching


def _main_path_run(command, argv, kernels, kernel_records,
                   record_as="launches", path=None):
    """One run of a main path with device screens, the launch counts and
    transfer counters set to 0 just before it and read just after. The
    counts of `kernels` must be above 0 and go into their records under
    `record_as` (a kernel that several paths launch keeps its first path's
    count under "launches" and the others beside it). Its launch shapes
    are kept under `path` (by default the command, " dense" added with
    the dense switch)."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import dispatch

    dispatch.reset_transfer_stats()
    ck.reset_launches()
    wall = _run_cli(command, argv, host_screen=False)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    transfers = dict(dispatch.TRANSFER_STATS)
    if path is None:
        path = command + (
            " dense" if os.environ.get("GUAC_DENSE_TILES") else "")
    MAIN_PATH_SHAPES[path] = {
        name: list(shapes) for name, shapes in ck.LAUNCH_SHAPES.items()
        if shapes
    }
    for name, shapes in MAIN_PATH_SHAPES[path].items():
        check(len(shapes) == launches[name],
              f"{name}: {len(shapes)} shapes recorded for {launches[name]} "
              "launches")
    for name in kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {command} path")
        if name in kernel_records:  # absent when its check was not run
            kernel_records[name][record_as] = launches[name]
    return wall, launches, transfers


# The launch shapes of each main path's last run: path -> kernel -> shapes,
# as the wrappers recorded them (cuda_kernels.LAUNCH_SHAPES).
MAIN_PATH_SHAPES = {}
# What phase `kernels` times when a path was not run in this call: the
# median launches of the scale-1.0 fixture's runs.
DEFAULT_LAUNCH_SHAPES = {
    ("germline-threshold", "csr_count_screen"): (1_048_576, 7_340_032),
    ("germline-standard", "ll_screen"): (114_688, 32, "germline_u8"),
    ("somatic-standard", "ll_screen"): (10_240, 1024, "tumor_u8"),
    ("germline-threshold dense", "stats_ll"): (114_688, 32, False),
    ("somatic-standard dense", "stats_ll"): (16_384, 1024, False),
}


def _launch_size(kernel, shape):
    """What orders a kernel's launches: blob bytes, rows, or cells."""
    if kernel == "csr_count_screen":
        return shape[1]
    return shape[0] if kernel == "csr_compact" else shape[0] * shape[1]


def _median_launch(kernel, shapes):
    """The launch in the middle by size: a shape that was launched."""
    return sorted(shapes, key=lambda sh: _launch_size(kernel, sh))[
        (len(shapes) - 1) // 2]


def _describe_shapes(path) -> str:
    """min / median / max of what each kernel was launched at on a path."""
    columns = {"csr_count_screen": ("rows", "blob bytes"),
               "csr_compact": ("rows", "cap"), "ll_screen": ("rows", "D"),
               "stats_ll": ("rows", "D")}
    parts = []
    for kernel, shapes in MAIN_PATH_SHAPES.get(path, {}).items():
        text = []
        for i, column in enumerate(columns[kernel]):
            values = sorted(sh[i] for sh in shapes)
            text.append(f"{column} {values[0]} / "
                        f"{values[(len(values) - 1) // 2]} / {values[-1]}")
        smallest = min(shapes, key=lambda sh: _launch_size(kernel, sh))
        parts.append(
            f"{kernel} x{len(shapes)}: " + ", ".join(text)
            + f", smallest launch {smallest}"
            + f", median launch {_median_launch(kernel, shapes)}")
    return "launch shapes (min / median / max): " + "; ".join(parts)


def time_at_launch_shapes(device, records: dict) -> None:
    """Each kernel once more at the median launch of its main path (of this
    call's run, else the default above): checked against its plain version,
    timed back to back as the larger shapes are and with the L2 cache
    flushed before every launch, as a launch of the main path finds it.
    The numbers go into the kernels' records beside their bounds."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import kernels as plain

    def median_of(path, kernel):
        shapes = MAIN_PATH_SHAPES.get(path, {}).get(kernel)
        if shapes:
            return _median_launch(kernel, shapes), "this run's median launch"
        return DEFAULT_LAUNCH_SHAPES[(path, kernel)], "default shape"

    def keep(record, prefix, shape, origin, timed):
        record[prefix + "launch_shape"] = list(shape)
        record[prefix + "launch_shape_from"] = origin
        for key in ("ms", "cold_ms", "plain_ms", "bound_ms"):
            record[f"{prefix}launch_shape_{key}"] = timed[key]

    def line(name, shape, origin, timed, floor=None):
        print(
            f"launch shape: {name} at {tuple(shape)} ({origin}): kernel "
            f"{timed['ms']:.4f} ms back to back, {timed['cold_ms']:.4f} ms "
            f"with a cold L2, plain {timed['plain_ms']:.4f} ms, bound "
            f"{timed['bound_ms']:.4f} ms ({timed['bound_by']}: "
            f"{timed['bytes']} bytes)"
            + (f", launch floor {floor:.4f} ms" if floor is not None else ""),
            flush=True,
        )

    # The counting kernels: germline-threshold.
    shape, origin = median_of("germline-threshold", "csr_count_screen")
    timed = _time_counting(
        device, *_csr_tile_of(device, *shape), cold=True)
    made = (timed["rows"], timed["blob_bytes"])
    for name in ("csr_count_screen", "csr_compact"):
        if name in records:
            keep(records[name], "", made, origin + f" {tuple(shape)}",
                 timed[name])
        line(name, made, origin + f" {tuple(shape)}", timed[name],
             records.get(name, {}).get("floor_ms"))
    # The counting screen in its full-count form, as vaf-histogram launches
    # it (only when that path ran in this call).
    shapes = MAIN_PATH_SHAPES.get("vaf-histogram", {}).get("csr_count_screen")
    if shapes:
        shape = _median_launch("csr_count_screen", shapes)
        timed = _time_counting(
            device, *_csr_tile_of(device, *shape), cold=True, threshold=None)
        made = (timed["rows"], timed["blob_bytes"])
        origin = f"vaf-histogram's median launch {tuple(shape)}"
        if "csr_count_screen" in records:
            keep(records["csr_count_screen"], "vaf_histogram_", made, origin,
                 timed["csr_count_screen"])
        line("csr_count_screen (full counts)", made, origin,
             timed["csr_count_screen"])
    # The likelihood screen: germline-standard and somatic-standard.
    for path, prefix in (("germline-standard", ""),
                         ("somatic-standard", "tumor_form_")):
        (rows, D, form), origin = median_of(path, "ll_screen")
        pack8, words, qvals = _main_path_ll_tile(device, L=rows, D=D)
        mapq8 = None
        if form.startswith("tumor"):
            g = torch.Generator(device=device).manual_seed(7)
            mapq8 = torch.randint(
                20, 61, pack8.shape, generator=g, device=device
            ).to(torch.uint8)
        timed = _time_ll(device, pack8, words, qvals, mapq8,
                         f"launch shape of {path}", cold=True)
        if "ll_screen" in records:
            keep(records["ll_screen"], prefix, (rows, D, form), origin, timed)
        line(f"ll_screen ({path})", (rows, D, form), origin, timed,
             records.get("ll_screen", {}).get(prefix + "floor_ms"))
    # The fused dense kernel as the dense route's screens call it.
    for path, prefix in (("germline-threshold dense", ""),
                         ("somatic-standard dense", "somatic_")):
        (rows, D, with_ll), origin = median_of(path, "stats_ll")
        timed = _time_stats_ll(device, rows, D, with_ll)
        if "stats_ll" in records:
            keep(records["stats_ll"], prefix, (rows, D, with_ll), origin,
                 timed)
        line(f"stats_ll ({path})", (rows, D, with_ll), origin, timed,
             records.get("stats_ll", {}).get(
                 "floor_ms_with_likelihoods" if with_ll else "floor_ms"))


def _time_stats_ll(device, rows, D, with_ll):
    """stats_ll on one main-path dense tile (K = 8, --threshold 25, no
    alignment): held to its plain version, then timed in turns (plain,
    kernel, kernel, plain) and with a cold L2, with its bound."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import kernels as plain

    tile = _main_path_dense_tile(device, L=rows, D=D)
    K = tile.is_variant.shape[1]
    err = {"abs": 0.0, "entries": 0, "arbitrated": 0}
    _check_stats_ll_case(ck, plain, tile, K, False, 25, with_ll,
                         "launch shape", err)

    def call(fn):
        return lambda: fn(
            tile.allele_id, tile.qual, tile.mapq, tile.strand, tile.valid,
            tile.is_variant, K, False, 25, with_ll)

    p1 = _time_ms(call(plain.stats_ll_math), 3)
    k1 = _time_ms(call(ck.stats_ll), 50)
    k2 = _time_ms(call(ck.stats_ll), 50)
    p2 = _time_ms(call(plain.stats_ll_math), 3)
    bound_ms, bound_by, n_bytes, _ = _stats_ll_bound(
        rows, D, K, int(tile.valid.sum()), with_ll)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "cold_ms": _time_cold_ms(call(ck.stats_ll), device),
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes}


def make_fixture():
    from guacamole_tpu_torch.utils.simulate import make_scale_fixture

    t0 = time.perf_counter()
    manifest = make_scale_fixture(FIXTURE_DIR, scale=1.0, seed=2026)
    print(f"fixture: {time.perf_counter() - t0:.3f} s "
          f"({manifest['counts']['germline']} reads)", flush=True)
    return manifest


def run_threshold_slice(kernel_records: dict, manifest, out) -> None:
    from guacamole_tpu_torch.ops import cuda_kernels as ck

    bam = os.path.join(FIXTURE_DIR, manifest["files"]["germline_bam"])
    command = "germline-threshold"

    def vcf(name):
        return os.path.join(out, name)

    args = ["--reads", bam, "--threshold", "25"]
    wall, launches, transfers = _main_path_run(
        command, args + ["--out", vcf("device.vcf")],
        ("csr_count_screen", "csr_compact"), kernel_records,
    )
    # Device and host screens in turns (device, host, host, device), so
    # neither side gets the warmer page cache and allocator alone.
    host_walls = [
        _run_cli(command, args + ["--out", vcf(f"host{i}.vcf")],
                 host_screen=True)
        for i in range(2)
    ]
    device_walls = [
        wall,
        _run_cli(command, args + ["--out", vcf("device1.vcf")],
                 host_screen=False),
    ]
    for other in ("host0.vcf", "host1.vcf", "device1.vcf"):
        matching = _check_equal_vcfs(vcf("device.vcf"), vcf(other))
    recall, precision, n_records = _recall_precision(
        vcf("device.vcf"), manifest)
    check(recall >= 0.9, f"germline-threshold recall {recall:.4f}")
    check(precision >= 0.9, f"germline-threshold precision {precision:.4f}")
    reads = manifest["counts"]["germline"]
    print(
        f"slice: germline-threshold --threshold 25: {n_records} records, "
        f"device screens {wall:.3f} s wall ({reads / wall:.1f} reads/s); "
        f"in turns: device {device_walls[0]:.3f} s, host "
        f"{host_walls[0]:.3f} s, host {host_walls[1]:.3f} s, device "
        f"{device_walls[1]:.3f} s; launches {launches}; "
        f"transfers {transfers}; "
        f"recall {recall:.4f} precision {precision:.4f}; equal to host "
        f"screens ({matching} records); "
        + _describe_shapes("germline-threshold"),
        flush=True,
    )
    spike = manifest["bands"]["spike"][0]  # 350000 at scale 1.0
    loci = f"deep1m:{max(0, spike - 10_000)}-{spike + 10_000}"
    region = ["--reads", bam, "--threshold", "25", "--emit-ref",
              "--loci", loci]
    before = dict(ck.LAUNCHES)
    _run_cli(command, region + ["--out", vcf("ref_device.vcf")],
             host_screen=False)
    check(ck.LAUNCHES["csr_count_screen"] > before["csr_count_screen"],
          "--emit-ref did not launch csr_count_screen")
    _run_cli(command, region + ["--out", vcf("ref_host.vcf")],
             host_screen=True)
    matching = _check_equal_vcfs(vcf("ref_device.vcf"), vcf("ref_host.vcf"))
    print(f"emit-ref {loci}: {matching} records, equal to "
          "host screens", flush=True)


def _check_equal_files(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        check(fa.read() == fb.read(),
              f"{os.path.basename(a)} and {os.path.basename(b)} differ")


def _n_lines(path):
    with open(path) as fh:
        return sum(1 for _ in fh)


def _only_full_counts(command, launches):
    """The counting tools take the full-count screen alone."""
    check(launches["csr_compact"] == 0 and launches["ll_screen"] == 0
          and launches["stats_ll"] == 0,
          f"{command} launched more than csr_count_screen: {launches}")


def run_tools_slice(kernel_records: dict, manifest, out) -> None:
    """variant-support and vaf-histogram on the full fixture, each with
    device screens (the full-count form of csr_count_screen: no threshold,
    no compaction) against host screens, byte for byte; the VAF clustering
    fitted on the card and on the CPU; then structural-variant, which
    launches nothing, on the paired-end fixture with the columnar fast path
    against the object path."""
    from guacamole_tpu_torch.callers import vaf_histogram
    from guacamole_tpu_torch.utils.simulate import make_sv_fixture

    files = manifest["files"]
    germline = os.path.join(FIXTURE_DIR, files["germline_bam"])
    tumor = os.path.join(FIXTURE_DIR, files["tumor_bam"])

    def path(name):
        return os.path.join(out, name)

    # variant-support: the germline-threshold calls as sites (the threshold
    # phase's VCF, else one host-screen run), plus one site in the overflow
    # clump at band[0] + 1000, whose alleles outnumber a tile's dictionary
    # and are counted on the host.
    calls = path("device.vcf")
    if not os.path.exists(calls):
        calls = path("tools_calls.vcf")
        _run_cli("germline-threshold",
                 ["--reads", germline, "--threshold", "25", "--out", calls],
                 host_screen=True)
    clump = manifest["bands"]["band"][0] + 1000
    sites = path("tools_sites.vcf")
    with open(calls) as fh, open(sites, "w") as out_fh:
        out_fh.write(fh.read())
        out_fh.write(f"deep1m\t{clump + 1}\t.\tA\tAT\t.\t.\t.\tGT\t0/1\n")
    with open(sites) as fh:
        n_sites = sum(1 for ln in fh if not ln.startswith("#"))
    args = ["-v", sites, germline, tumor]
    wall, launches, transfers = _main_path_run(
        "variant-support", args + ["-o", path("support_device.csv")],
        ("csr_count_screen",), kernel_records,
        record_as="launches_variant_support",
    )
    _only_full_counts("variant-support", launches)
    host_wall = _run_cli(
        "variant-support", args + ["-o", path("support_host.csv")],
        host_screen=True)
    _check_equal_files(path("support_device.csv"), path("support_host.csv"))
    with open(path("support_device.csv")) as fh:
        rows = fh.read().splitlines()
    at_clump = sum(1 for ln in rows if f", deep1m, {clump}, " in ln)
    check(len(rows) > n_sites and at_clump > 2 * 8,
          f"variant-support: {len(rows)} rows, {at_clump} at the clump")
    print(
        f"slice: variant-support, {n_sites} sites, germline and tumor BAMs: "
        f"{len(rows)} allele counts ({at_clump} at the overflow clump "
        f"deep1m:{clump}), device screens {wall:.3f} s wall, then host "
        f"{host_wall:.3f} s; equal to host screens byte for byte; launches "
        f"{launches}; transfers {transfers}; "
        + _describe_shapes("variant-support"),
        flush=True,
    )

    # vaf-histogram, with the fit of its clustering kept for the comparison
    # of the card's EM with the CPU's.
    fitted = []
    fit = vaf_histogram.build_mixture_model

    def fit_and_keep(variant_loci, num_clusters, **kwargs):
        t0 = time.perf_counter()
        result = fit(variant_loci, num_clusters, **kwargs)
        fitted.append((variant_loci, num_clusters, result,
                       time.perf_counter() - t0))
        return result

    args = ["--bins", "20", "--print-stats", "--cluster", germline]
    vaf_histogram.build_mixture_model = fit_and_keep
    try:
        wall, launches, transfers = _main_path_run(
            "vaf-histogram", args + ["--out", path("vaf_device.csv")],
            ("csr_count_screen",), kernel_records,
            record_as="launches_vaf_histogram",
        )
    finally:
        vaf_histogram.build_mixture_model = fit
    _only_full_counts("vaf-histogram", launches)
    host_wall = _run_cli(
        "vaf-histogram", args + ["--out", path("vaf_host.csv")],
        host_screen=True)
    _check_equal_files(path("vaf_device.csv"), path("vaf_host.csv"))
    check(len(fitted) == 1, f"vaf-histogram fitted {len(fitted)} models")
    variant_loci, k, on_card, card_s = fitted[0]
    t0 = time.perf_counter()
    on_cpu = fit(variant_loci, k, device=torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    diffs = [float(np.abs(a - b).max()) for a, b in zip(on_card, on_cpu)]
    check(all(np.isfinite(x).all() for x in on_card) and max(diffs) < 1e-3,
          f"the EM on the card and on the CPU differ by {diffs}")
    print(
        f"slice: vaf-histogram --bins 20 --cluster: "
        f"{_n_lines(path('vaf_device.csv')) - 1} bins over "
        f"{len(variant_loci)} variant loci, device screens {wall:.3f} s "
        f"wall, then host {host_wall:.3f} s; equal to host screens byte for "
        f"byte; launches {launches}; transfers {transfers}; EM of {k} "
        f"clusters on the card {card_s:.3f} s, on the CPU {cpu_s:.3f} s, "
        f"largest |difference| of weights {diffs[0]:.3g}, means "
        f"{diffs[1]:.3g}, variances {diffs[2]:.3g}; "
        + _describe_shapes("vaf-histogram"),
        flush=True,
    )

    # structural-variant on the paired-end fixture (2 Mbp, 20x, two planted
    # heterozygous deletions).
    t0 = time.perf_counter()
    sv = make_sv_fixture(os.path.join(FIXTURE_DIR, "sv"))
    sv_s = time.perf_counter() - t0
    sam = os.path.join(FIXTURE_DIR, "sv", sv["files"]["sv_sam"])
    walls = {}
    for api in ("best", "python"):
        walls[api], launches, transfers = _main_path_run(
            "structural-variant",
            ["--reads", sam, "--bam-reader-api", api,
             "--output", path(f"sv_{api}.txt")],
            (), kernel_records,
        )
        check(not any(launches.values()) and not transfers["h2d_bytes"],
              f"structural-variant launched kernels: {launches}, "
              f"{transfers}")
    _check_equal_files(path("sv_best.txt"), path("sv_python.txt"))
    with open(path("sv_best.txt")) as fh:
        text = fh.read()
    found = [
        (int(a), int(b))
        for a, b in re.findall(r"GenomeRange\(\w+,(\d+),(\d+)\)", text)
    ]
    missed = [
        (s, e) for s, e in sv["truth_deletions"]
        if not any(a < e and b > s for a, b in found)
    ]
    check(found and not missed,
          f"structural-variant: called {found}, missed {missed}")
    print(
        f"slice: structural-variant on {sv['counts']['records']} records "
        f"(fixture {sv_s:.3f} s): {len(found)} ranges {found}, every planted "
        f"deletion {sv['truth_deletions']} overlapped; columnar fast path "
        f"{walls['best']:.3f} s, object path {walls['python']:.3f} s, equal "
        f"byte for byte; launches {launches}; transfers {transfers}",
        flush=True,
    )


def run_standard_slice(kernel_records: dict, manifest, out) -> None:
    """germline-standard on the full fixture: device screens (ll_screen on
    the card, f32) against host screens (the native packer's f64 rule).
    The two screens flag different rows by design; the calls after the
    exact f64 confirm must be equal."""
    from guacamole_tpu_torch.ops import dispatch

    bam = os.path.join(FIXTURE_DIR, manifest["files"]["germline_bam"])
    command = "germline-standard"
    reads = manifest["counts"]["germline"]

    def vcf(name):
        return os.path.join(out, name)

    # --min-likelihood turns the GQ gate of the device screen on. The
    # caller without it emits every locus whose best genotype is variant,
    # sequencing errors included, so precision is held only where the
    # filter is tight enough for this fixture (phred 40).
    for tag, extra, hold_precision in (
        ("std", [], False),
        ("std30", ["--min-likelihood", "30"], False),
        ("std40", ["--min-likelihood", "40"], True),
    ):
        args = ["--reads", bam, *extra]
        wall, launches, transfers = _main_path_run(
            command, args + ["--out", vcf(f"{tag}_device.vcf")],
            ("ll_screen",), kernel_records,
        )
        host_wall = _run_cli(
            command, args + ["--out", vcf(f"{tag}_host.vcf")],
            host_screen=True)
        # Once more on the device, now also counting the valid elements
        # staged (a pass over every tile, kept out of the run timed above).
        dispatch.reset_transfer_stats()
        os.environ["GUAC_TRANSFER_STATS"] = "1"
        try:
            device_wall = _run_cli(
                command, args + ["--out", vcf(f"{tag}_device1.vcf")],
                host_screen=False)
        finally:
            del os.environ["GUAC_TRANSFER_STATS"]
        counted = dict(dispatch.TRANSFER_STATS)
        check(counted["h2d_bytes"] == transfers["h2d_bytes"],
              "two device runs staged different byte counts")
        matching = _check_equal_vcfs(
            vcf(f"{tag}_device.vcf"), vcf(f"{tag}_host.vcf"))
        _check_equal_vcfs(vcf(f"{tag}_device.vcf"), vcf(f"{tag}_device1.vcf"))
        recall, precision, n_records = _recall_precision(
            vcf(f"{tag}_device.vcf"), manifest)
        check(recall >= 0.9, f"germline-standard {extra} recall {recall:.4f}")
        if hold_precision:
            check(precision >= 0.9,
                  f"germline-standard {extra} precision {precision:.4f}")
        per_element = counted["h2d_bytes"] / max(1, counted["ll_elements"])
        print(
            f"slice: germline-standard {' '.join(extra) or '(defaults)'}: "
            f"{n_records} records, device screens {wall:.3f} s wall "
            f"({reads / wall:.1f} reads/s); then host {host_wall:.3f} s, "
            f"device {device_wall:.3f} s; launches {launches}; transfers "
            f"{transfers} ({per_element:.4f} H2D bytes per valid element, "
            f"{counted['ll_elements']} elements in {counted['ll_cells']} "
            f"staged slots); recall "
            f"{recall:.4f} precision {precision:.4f}; equal to host screens "
            f"({matching} records); " + _describe_shapes("germline-standard"),
            flush=True,
        )


def run_somatic_slice(kernel_records: dict, manifest, out) -> None:
    """somatic-standard on the full tumor/normal pair: device screens (the
    tumor form of ll_screen on the card, f32 with the MAPQ plane) against
    host screens (the native packer's f64 tumor rule). The calls after the
    exact f64 confirm must be equal."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import dispatch

    command = "somatic-standard"
    args = [
        "--tumor-reads",
        os.path.join(FIXTURE_DIR, manifest["files"]["tumor_bam"]),
        "--normal-reads",
        os.path.join(FIXTURE_DIR, manifest["files"]["normal_bam"]),
        "--odds", "20",
    ]
    reads = manifest["counts"]["tumor"] + manifest["counts"]["normal"]

    def vcf(name):
        return os.path.join(out, name)

    wall, launches, transfers = _main_path_run(
        command, args + ["--out", vcf("som_device.vcf")], ("ll_screen",),
        kernel_records, record_as="launches_somatic_standard",
    )
    forms = dict(ck.LL_FORM_LAUNCHES)
    tumor_launches = forms["tumor_u8"] + forms["tumor_u16"]
    check(tumor_launches == launches["ll_screen"] and tumor_launches > 0,
          f"somatic-standard must launch the tumor forms of ll_screen only, "
          f"got {forms}")
    host_wall = _run_cli(
        command, args + ["--out", vcf("som_host.vcf")], host_screen=True)
    # Once more on the device, now also counting the valid elements staged.
    dispatch.reset_transfer_stats()
    os.environ["GUAC_TRANSFER_STATS"] = "1"
    try:
        device_wall = _run_cli(
            command, args + ["--out", vcf("som_device1.vcf")],
            host_screen=False)
    finally:
        del os.environ["GUAC_TRANSFER_STATS"]
    counted = dict(dispatch.TRANSFER_STATS)
    check(counted["h2d_bytes"] == transfers["h2d_bytes"],
          "two device runs staged different byte counts")
    matching = _check_equal_vcfs(vcf("som_device.vcf"), vcf("som_host.vcf"))
    _check_equal_vcfs(vcf("som_device.vcf"), vcf("som_device1.vcf"))
    # The gates of tests/test_simulate.py: the planted somatic SNVs are
    # found; germline hets (in the normal too) are not called somatic.
    called = {
        pos for contig, pos in _snv_sites(vcf("som_device.vcf"))[0]
        if contig == "deep1m"
    }
    somatic = set(manifest["truth"]["deep1m"]["somatic_pos"])
    germline = set(manifest["truth"]["deep1m"]["snv_pos"])
    check(len(somatic) > 0, "the fixture plants no somatic sites")
    recall = len(called & somatic) / len(somatic)
    miscalled = len(called & germline)
    check(recall >= 0.5, f"somatic recall {recall:.4f}")
    check(miscalled <= max(2, len(germline) // 20),
          f"{miscalled} of {len(germline)} germline hets called somatic")
    per_element = counted["h2d_bytes"] / max(1, counted["ll_elements"])
    print(
        f"slice: somatic-standard --odds 20: {matching} records, device "
        f"screens {wall:.3f} s wall ({reads / wall:.1f} reads/s); then host "
        f"{host_wall:.3f} s, device {device_wall:.3f} s; launches "
        f"{launches}, by form {forms}; transfers {transfers} "
        f"({per_element:.4f} H2D bytes per valid tumor element, "
        f"{counted['ll_elements']} elements in {counted['ll_cells']} staged "
        f"slots); somatic recall {recall:.4f} "
        f"({len(called & somatic)}/{len(somatic)}), {miscalled} of "
        f"{len(germline)} germline hets called somatic; equal to host "
        f"screens; " + _describe_shapes("somatic-standard"),
        flush=True,
    )


def run_dense_slice(kernel_records: dict, manifest, out, device) -> None:
    """GUAC_DENSE_TILES=1: full per-element tiles through the fused dense
    kernel stats_ll, for germline-threshold and somatic-standard on the
    full fixtures; each VCF must equal its default run's. Then the forward
    step of guacamole_tpu_torch.entry."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import kernels as plain

    def vcf(name):
        return os.path.join(out, name)

    files = manifest["files"]
    paths = (
        ("germline-threshold",
         ["--reads", os.path.join(FIXTURE_DIR, files["germline_bam"]),
          "--threshold", "25"],
         "device.vcf", "dense_threshold.vcf", "launches"),
        ("somatic-standard",
         ["--tumor-reads", os.path.join(FIXTURE_DIR, files["tumor_bam"]),
          "--normal-reads", os.path.join(FIXTURE_DIR, files["normal_bam"]),
          "--odds", "20"],
         "som_device.vcf", "dense_somatic.vcf",
         "launches_somatic_standard"),
    )
    for command, args, default_vcf, dense_vcf, record_as in paths:
        default_wall = None
        if not os.path.exists(vcf(default_vcf)):  # its own phase was not run
            default_wall = _run_cli(
                command, args + ["--out", vcf(default_vcf)],
                host_screen=False)
        os.environ["GUAC_DENSE_TILES"] = "1"
        try:
            wall, launches, transfers = _main_path_run(
                command, args + ["--out", vcf(dense_vcf)], ("stats_ll",),
                kernel_records, record_as=record_as,
            )
        finally:
            del os.environ["GUAC_DENSE_TILES"]
        others = {k: v for k, v in launches.items() if k != "stats_ll" and v}
        check(not others,
              f"dense {command}: other screen kernels launched: {others}")
        matching = _check_equal_vcfs(vcf(dense_vcf), vcf(default_vcf))
        print(
            f"slice: dense tiles, {command}: {matching} records equal to "
            f"the default run, {wall:.3f} s wall"
            + (f" (default run just before: {default_wall:.3f} s)"
               if default_wall is not None else "")
            + f"; launches {launches}; transfers {transfers} "
            f"({transfers['h2d_bytes'] / max(1, transfers['dense_cells']):.4f}"
            f" H2D bytes per staged slot); "
            + _describe_shapes(command + " dense"),
            flush=True,
        )
    # The forward step, on its example tile and on the timed shape.
    from guacamole_tpu_torch.entry import entry

    forward, example = entry()
    tile = _main_path_dense_tile(device)
    big = (tile.allele_id, tile.qual, tile.mapq, tile.strand, tile.valid,
           tile.is_variant)
    before = ck.LAUNCHES["stats_ll"]
    for what, planes in (("example tile", example), ("timed shape", big)):
        counts, candidates, ll = forward(*planes)
        torch.cuda.synchronize()
        on_device = tuple(
            p if isinstance(p, torch.Tensor) else torch.from_numpy(p).to(device)
            for p in planes
        )
        want = plain.stats_ll_math(*on_device, 8)
        check(counts.device.type == "cuda" and
              _max_err(counts, want.counts) == 0 and
              _max_err(candidates, want.candidates) == 0,
              f"entry() on its {what}: counts or candidates differ")
        check(ll.shape == want.log_likelihoods.shape and
              bool(torch.isfinite(ll).all()),
              f"entry() on its {what}: likelihoods not finite")
        D = planes[0].shape[1]
        off = (ll - want.log_likelihoods).abs()
        tol = _stats_ll_atol(D) + STATS_LL_RTOL * want.log_likelihoods.abs()
        check(bool((off <= tol).all()),
              f"entry() on its {what}: likelihoods differ by {float(off.max()):g}")
        print(f"entry(): {what} {tuple(planes[0].shape)}: counts and "
              f"candidates equal to the plain version, likelihoods within "
              f"{float(off.max()):.3g}", flush=True)
    check(ck.LAUNCHES["stats_ll"] == before + 2,
          "entry() did not launch stats_ll once per call")


# --- the mesh and the multi-process runtime -----------------------------


def _mesh_screen_tiles(manifest, sample, fields, region, tile_size, **kw):
    """The first seven non-empty tiles of one fixture BAM over `region`,
    packed by the port."""
    from guacamole_tpu_torch.callers.common import load_read_source
    from guacamole_tpu_torch.loci.lociset import parse_loci
    from guacamole_tpu_torch.reads.read import InputFilters

    loci = parse_loci(region)
    source, _ = load_read_source(
        os.path.join(FIXTURE_DIR, manifest["files"][sample]),
        InputFilters.create(overlaps_loci=loci, non_duplicate=True,
                            has_mdtag=True),
    )
    loci_set = loci.result()
    tiles = [
        t for contig in loci_set.contigs
        for t in source.iter_tiles(contig, loci_set.on_contig(contig),
                                   tile_size=tile_size, fields=fields, **kw)
        if t.L
    ]
    check(len(tiles) >= 7, f"{region}: {len(tiles)} tiles, expected 7")
    return tiles[:7]


def _check_mesh_screens(device, manifest) -> str:
    """mesh_csr_screens (threshold 25 and full counts) and mesh_ll_screens
    (germline uint8, tumor) over a mesh of cuda:0 and of cuda:0 twice
    (two streams), on seven fixture tiles each (the last group of two is
    partial): every output equal to the sequential dispatch's on the same
    tiles (tolerance 0: integers and flags), in the sequential order, and
    only the expected kernel launched, as many times as sequentially."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import dispatch
    from guacamole_tpu_torch.parallel.mesh import (
        csr_of,
        loci_mesh,
        mesh_csr_screens,
        mesh_ll_screens,
    )

    spike = manifest["bands"]["spike"][0] // 4096 * 4096
    ll_region = f"deep1m:{spike - 3 * 4096}-{spike + 4 * 4096}"
    # Seven CSR tiles of 64k rows from the contig's start (through the band
    # and the spike at scale 1.0).
    step = min(1 << 16, manifest["contigs"]["deep1m"] // 7 // 4096 * 4096)
    csr_tiles = _mesh_screen_tiles(
        manifest, "germline_bam", "screen", f"deep1m:0-{7 * step}", step)
    germline_tiles = _mesh_screen_tiles(
        manifest, "germline_bam", "likelihood", ll_region, 4096, min_mapq=1)
    tumor_tiles = _mesh_screen_tiles(
        manifest, "tumor_bam", "likelihood_mapq", ll_region, 4096,
        min_mapq=1, ll_screen_kind=2)
    cases = [
        ("csr threshold 25", csr_tiles, "csr_count_screen", None,
         lambda t, dev: dispatch.screen_csr_launch(
             *csr_of(t), np.asarray(t.is_variant), t.K, threshold_percent=25,
             device=dev),
         lambda items, mesh: mesh_csr_screens(
             items, lambda t: t, mesh, threshold_percent=25)),
        ("csr full counts", csr_tiles, "csr_count_screen", None,
         lambda t, dev: dispatch.screen_csr_launch(
             *csr_of(t), np.asarray(t.is_variant), t.K, device=dev),
         lambda items, mesh: mesh_csr_screens(items, lambda t: t, mesh)),
        ("ll germline", germline_tiles, "ll_screen", "germline_",
         lambda t, dev: dispatch.germline_screen_launch(
             t, min_mapq=1, min_phred=30.0, device=dev),
         lambda items, mesh: mesh_ll_screens(
             items, lambda t: t, mesh, min_mapq=1, min_phred=30.0)),
        ("ll tumor", tumor_tiles, "ll_screen", "tumor_",
         lambda t, dev: dispatch.tumor_screen_launch(t, min_mapq=1,
                                                     device=dev),
         lambda items, mesh: mesh_ll_screens(
             items, lambda t: t, mesh, include_alignment=True, min_mapq=1)),
    ]
    meshes = (loci_mesh([device]), loci_mesh([device, device]))
    notes = []
    for what, tiles, kernel, form, sequential, meshed in cases:
        ck.reset_launches()
        want = [sequential(t, device).result() for t in tiles]
        seq_launches = dict(ck.LAUNCHES)
        for mesh in meshes:
            ck.reset_launches()
            got = list(meshed(tiles, mesh))
            torch.cuda.synchronize()
            check([item for item, _p in got] == tiles,
                  f"mesh {what} over {mesh}: not in the sequential order")
            check([p.shard for _t, p in got]
                  == [k % mesh.size for k in range(len(tiles))],
                  f"mesh {what} over {mesh}: shards not taken in turn")
            for (tile, pending), res in zip(got, want):
                out = pending.result()
                if kernel == "csr_count_screen":
                    check(np.array_equal(out.counts, res.counts[: tile.L])
                          and np.array_equal(out.candidates,
                                             res.candidates[: tile.L]),
                          f"mesh {what} over {mesh}: outputs differ")
                else:
                    check(np.array_equal(out, res[: tile.L]),
                          f"mesh {what} over {mesh}: flags differ")
            launches = dict(ck.LAUNCHES)
            check(launches == seq_launches and launches[kernel] > 0
                  and not any(n for k, n in launches.items() if k != kernel),
                  f"mesh {what} over {mesh}: launches {launches}, "
                  f"sequentially {seq_launches}")
            if form is not None:
                forms = sum(n for f, n in ck.LL_FORM_LAUNCHES.items()
                            if f.startswith(form))
                check(forms == launches["ll_screen"],
                      f"mesh {what}: forms {ck.LL_FORM_LAUNCHES}")
        notes.append(f"{what} {len(tiles)} tiles, {seq_launches[kernel]} "
                     f"{kernel} launches"
                     + (f" {dict(ck.LL_FORM_LAUNCHES)}" if form else ""))
    return "; ".join(notes)


def run_mesh_slice(kernel_records: dict, manifest, out, device) -> None:
    """The mesh (parallel/mesh.py): (a) the mesh screens against the
    sequential dispatch on fixture tiles, over one and two shards of
    cuda:0; (b) the CLI with --mesh on for the five device commands on the
    full fixture, each output equal to its default run's; (c)
    dryrun_multichip(2) on the card."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    note = _check_mesh_screens(device, manifest)
    print(f"mesh screens over [cuda:0] and [cuda:0, cuda:0] equal to the "
          f"sequential dispatch, in its order, with its launches: {note} "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)

    def path(name):
        return os.path.join(out, name)

    files = manifest["files"]
    germline = os.path.join(FIXTURE_DIR, files["germline_bam"])
    tumor = os.path.join(FIXTURE_DIR, files["tumor_bam"])
    pair = ["--tumor-reads", tumor, "--normal-reads",
            os.path.join(FIXTURE_DIR, files["normal_bam"])]
    sites = path("tools_sites.vcf")
    runs = [
        ("germline-threshold", ["--reads", germline, "--threshold", "25",
                                "--out"], "device.vcf", "csr_count_screen"),
        ("germline-standard", ["--reads", germline, "--out"],
         "std_device.vcf", "ll_screen"),
        ("somatic-standard", [*pair, "--odds", "20", "--out"],
         "som_device.vcf", "ll_screen"),
        ("variant-support", ["-v", sites, germline, tumor, "-o"],
         "support_device.csv", "csr_count_screen"),
        ("vaf-histogram", ["--bins", "20", "--print-stats", "--cluster",
                           germline, "--out"],
         "vaf_device.csv", "csr_count_screen"),
    ]
    if not os.path.exists(sites):  # the tools phase was not run
        calls = path("device.vcf")
        if not os.path.exists(calls):
            _run_cli("germline-threshold", runs[0][1] + [calls],
                     host_screen=False)
        with open(calls) as fh, open(sites, "w") as out_fh:
            out_fh.write(fh.read())
    for command, args, default_out, kernel in runs:
        default_wall = None
        if not os.path.exists(path(default_out)):  # its phase was not run
            default_wall = _run_cli(command, args + [path(default_out)],
                                    host_screen=False)
        mesh_out = path("mesh_" + default_out)
        wall, launches, transfers = _main_path_run(
            command, args + [mesh_out, "--mesh", "on"], (kernel,),
            kernel_records, path=command + " mesh",
            record_as="launches_mesh_" + command.replace("-", "_"),
        )
        others = {k: v for k, v in launches.items() if k != kernel and v}
        check(not others,
              f"{command} --mesh on launched other kernels: {others}")
        if default_out.endswith(".csv"):
            _check_equal_files(mesh_out, path(default_out))
            same = "byte for byte"
        else:
            same = f"{_check_equal_vcfs(mesh_out, path(default_out))} records"
        print(
            f"slice: {command} --mesh on (a mesh of cuda:0): equal to the "
            f"default run ({same}), {wall:.3f} s wall"
            + (f" (default run just before: {default_wall:.3f} s)"
               if default_wall is not None else "")
            + f"; launches {launches}; H2D {transfers['h2d_bytes']} B in "
            f"{transfers['h2d_calls']} copies, D2H {transfers['d2h_bytes']} B "
            f"in {transfers['d2h_calls']} copies; "
            + _describe_shapes(command + " mesh"),
            flush=True,
        )
    from guacamole_tpu_torch.entry import dryrun_multichip

    ck.reset_launches()
    t0 = time.perf_counter()
    line = dryrun_multichip(2)
    wall = time.perf_counter() - t0
    check(line.startswith("dryrun_multichip(2): OK")
          and "'cuda:0', 'cuda:0'" in line, f"dryrun_multichip: {line}")
    check(ck.LAUNCHES["stats_ll"] == 2,
          f"dryrun_multichip(2) launched {ck.LAUNCHES}")
    if "stats_ll" in kernel_records:
        kernel_records["stats_ll"]["launches_dryrun_multichip"] = 2
    print(f"dryrun_multichip(2) on the card: {wall:.3f} s, launches "
          f"{dict(ck.LAUNCHES)}", flush=True)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _two_processes(argv, logs, env1=None, timeout=300):
    """Run `python -m guacamole_tpu_torch.cli argv` as processes 0 and 1 of
    a gloo group on localhost, both on cuda:0 with device screens. Returns
    their exit codes and walls (s); kills both if they outlive `timeout`."""
    coordinator = f"127.0.0.1:{_free_port()}"
    procs, starts = [], []
    env = dict(os.environ, GUAC_HOST_SCREEN="0")
    try:
        for pid in range(2):
            with open(logs[pid], "w") as log:
                starts.append(time.perf_counter())
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "guacamole_tpu_torch.cli", *argv,
                     "--coordinator", coordinator, "--num-processes", "2",
                     "--process-id", str(pid), "--timeout", "60"],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                    env=dict(env, **(env1 or {})) if pid else env,
                ))
        codes, walls = [], []
        for proc, start in zip(procs, starts):
            codes.append(proc.wait(timeout=timeout))
            walls.append(time.perf_counter() - start)
        return codes, walls
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def _tail(path, n=5):
    with open(path) as fh:
        return "".join(fh.readlines()[-n:])


def run_multiprocess_slice(manifest, out) -> None:
    """Two processes of the port's CLI in a gloo group on localhost, both
    on cuda:0: germline-threshold and somatic-standard on the full
    fixture, each merged output equal to the single-process default run's;
    then a run whose process 1 dies before the merge (exit 43), whose
    process 0 must exit 42, and --recover in one process, which must write
    output byte-equal to the single-process run and remove the shards."""
    files = manifest["files"]

    def path(name):
        return os.path.join(out, name)

    germline = ["--reads", os.path.join(FIXTURE_DIR, files["germline_bam"]),
                "--threshold", "25"]
    somatic = ["--tumor-reads", os.path.join(FIXTURE_DIR, files["tumor_bam"]),
               "--normal-reads",
               os.path.join(FIXTURE_DIR, files["normal_bam"]), "--odds", "20"]
    for command, args, default_out in (
        ("germline-threshold", germline, "device.vcf"),
        ("somatic-standard", somatic, "som_device.vcf"),
    ):
        if not os.path.exists(path(default_out)):  # its phase was not run
            _run_cli(command, args + ["--out", path(default_out)],
                     host_screen=False)
        merged = path("mp_" + default_out)
        logs = [path(f"mp_{command}_p{i}.log") for i in range(2)]
        codes, walls = _two_processes(
            [command, *args, "--out", merged], logs)
        check(codes == [0, 0],
              f"two-process {command} exited {codes}: "
              f"{_tail(logs[0])} / {_tail(logs[1])}")
        matching = _check_equal_vcfs(merged, path(default_out))
        check(not os.path.exists(merged + ".shards"),
              f"two-process {command} left its shard files")
        print(f"slice: {command}, two processes on cuda:0 over gloo: merged "
              f"output equal to the single-process run ({matching} "
              f"records); walls {walls[0]:.3f} s (process 0) and "
              f"{walls[1]:.3f} s (process 1), start-up included", flush=True)
    # Recovery: process 1 dies before it persists or merges anything.
    rec = path("mp_recover.vcf")
    logs = [path(f"mp_recover_p{i}.log") for i in range(2)]
    codes, walls = _two_processes(
        ["germline-threshold", *germline, "--out", rec], logs,
        env1={"GUAC_TEST_EXIT_BEFORE_MERGE": "1"})
    check(codes == [42, 43],
          f"killed run: exit codes {codes}, expected [42, 43]: "
          f"{_tail(logs[0])} / {_tail(logs[1])}")
    check(not os.path.exists(rec) and os.path.isdir(rec + ".shards")
          and os.listdir(rec + ".shards") == ["shard-0-of-2.pkl"],
          "the survivor did not leave its shard alone on disk")
    wall = _run_cli("germline-threshold", germline + ["--out", rec,
                                                      "--recover"],
                    host_screen=False)
    _check_equal_files(rec, path("device.vcf"))
    check(not os.path.exists(rec + ".shards"),
          "--recover left the shard files")
    print(f"slice: recovery: process 1 exited 43 (fault hook) after "
          f"{walls[1]:.3f} s, process 0 exited 42 after {walls[0]:.3f} s "
          f"with its shard on disk; --recover in one process {wall:.3f} s, "
          f"output equal to the single-process run byte for byte, shard "
          f"files removed", flush=True)


def _loaded_forbidden():
    return sorted(
        m for m, mod in sys.modules.items()
        if mod is not None and (
            m in ("jax", "jaxlib", "guacamole_tpu")
            or m.startswith(("jax.", "jaxlib.", "guacamole_tpu."))
        )
    )


def profile_callers(manifest, out) -> None:
    """Not part of the default run: one more germline-standard, one more
    somatic-standard and one more vaf-histogram run (the full-count screen,
    every row's counts brought back) with device screens under
    torch.profiler, to say how long the card was busy and with what."""
    files = manifest["files"]
    _profile_run(
        "germline-standard",
        ["--reads", os.path.join(FIXTURE_DIR, files["germline_bam"])], out)
    _profile_run(
        "somatic-standard",
        ["--tumor-reads", os.path.join(FIXTURE_DIR, files["tumor_bam"]),
         "--normal-reads", os.path.join(FIXTURE_DIR, files["normal_bam"]),
         "--odds", "20"],
        out)
    _profile_run(
        "vaf-histogram",
        ["--bins", "20", os.path.join(FIXTURE_DIR, files["germline_bam"])],
        out)


def _profile_run(command, args, out) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def argv(name):
        return [*args, "--out", os.path.join(out, f"{command}_{name}")]

    _run_cli(command, argv("warm.vcf"), host_screen=False)
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        wall = _run_cli(command, argv("profiled.vcf"), host_screen=False)
        torch.cuda.synchronize()
    on_device, on_host = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "device_time", None)
            if us is None:
                us = e.cuda_time
            table = on_device
        else:
            us, table = e.self_cpu_time_total, on_host
        n, total = table.get(e.name, (0, 0.0))
        table[e.name] = (n + 1, total + us)
    busy_ms = sum(total for _n, total in on_device.values()) / 1e3
    check(busy_ms > 0, "the profiler saw no device activity")

    def top(table):
        return "; ".join(
            f"{name[:60]} x{n}: {total / 1e3:.3f} ms"
            for name, (n, total) in sorted(
                table.items(), key=lambda kv: -kv[1][1])[:6]
        )

    print(
        f"profile: {command} with device screens, {wall:.3f} s wall "
        f"under the profiler, device busy {busy_ms:.3f} ms (idle share "
        f"{1 - busy_ms / 1e3 / wall:.4%}); on the device: {top(on_device)}; "
        f"PyTorch and CUDA runtime calls on the host, self time: "
        f"{top(on_host)}",
        flush=True,
    )


PHASES = ("build", "kernels", "threshold", "tools", "standard", "somatic",
          "dense", "mesh", "multiprocess")
EXTRA_PHASES = ("profile", "stats_ll")


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated subset of %(default)s, or with 'profile' "
        "added; the last line is printed only after all of the default ones",
    )
    phases = parser.parse_args(argv).phases.split(",")
    check(set(phases) <= set(PHASES + EXTRA_PHASES),
          f"unknown phase in {phases}")
    check(not _loaded_forbidden(), f"loaded at start: {_loaded_forbidden()}")
    device = require_card()
    build_all()
    records = {}
    if "kernels" in phases:
        records.update(check_kernels(device))
        records.update(check_ll_screen(device))
    if set(phases) & {"kernels", "stats_ll"}:
        records.update(check_stats_ll(device))
    if set(phases) & {"threshold", "tools", "standard", "somatic", "dense",
                      "mesh", "multiprocess", "profile"}:
        manifest = make_fixture()
        out = tempfile.mkdtemp(prefix="chip_smoke_")
        if "threshold" in phases:
            run_threshold_slice(records, manifest, out)
        if "tools" in phases:
            run_tools_slice(records, manifest, out)
        if "standard" in phases:
            run_standard_slice(records, manifest, out)
        if "somatic" in phases:
            run_somatic_slice(records, manifest, out)
        if "dense" in phases:
            run_dense_slice(records, manifest, out, device)
        if "mesh" in phases:
            run_mesh_slice(records, manifest, out, device)
        if "multiprocess" in phases:
            run_multiprocess_slice(manifest, out)
        if "profile" in phases:
            profile_callers(manifest, out)
    if "kernels" in phases:
        time_at_launch_shapes(device, records)
    torch.cuda.synchronize()
    check(not _loaded_forbidden(),
          f"modules of jax or of the JAX package were imported: "
          f"{_loaded_forbidden()}")
    print(json.dumps({"kernels": list(records.values())}))
    if not set(PHASES) <= set(phases):
        print(f"chip_smoke: ran only {phases}: no result line")
        return 1
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
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
