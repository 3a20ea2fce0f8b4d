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
    timed), a row over 64 KB (the int32-offset wire form) and compaction
    with the cap below and above the candidate count.
    The likelihood screen ll_screen, whose flags come out of f32 sums: all
    four forms (germline/tumor x uint16/uint8) at K in {2, 8, 15}, D in
    {8, 64, 1024, 16384}, min_phred 0 and 40, with all-empty rows and
    q = 0 elements. The kernel's flags must (a) equal the plain f32
    version's on every row whose decision is not within LL_REL_TOL of its
    boundary (such rows are counted and may be at most 0.1% of the rows),
    (b) be a superset of an f64 evaluation of the same rule with margin 0
    and no safety band, and (c) be the same from the uint8 and the uint16
    form of one tile. Then one main-path shape (1M rows x D = 32, uint8),
    timed;
 4. runs the port's germline-threshold CLI on the 2.37M-read simulated
    fixture (utils/simulate.make_scale_fixture, scale 1.0, seed 2026) with
    device screens, checks that both counting kernels launched, that the
    VCF equals the host-screen run's record for record and that
    planted-SNV recall and precision are >= 0.9; then the same for an
    --emit-ref range through the 8000x spike;
 5. runs the port's germline-standard CLI on the same fixture with device
    screens, checks that ll_screen launched, that the VCF equals the
    host-screen run's record for record and that planted-SNV recall is
    >= 0.9; then again with --min-likelihood 30 and 40 (the GQ gate on
    the device), where at 40 precision must be >= 0.9 too;
 6. prints one JSON line of kernel results, then, as the last line,
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
    n_cand = int(flags.sum())
    K = counts.shape[1]
    # One add per nibble for the counts; one add per flag for the scan.
    # The compaction reads the counts of candidate rows only.
    bounds = {
        "csr_count_screen": _bound_ms(
            blob.numel() + off.numel() * 4 + words.numel() * 2
            + L * K * 2 + L,
            2 * blob.numel(),
        ),
        "csr_compact": _bound_ms(
            L + n_cand * K * 2 + (cap + 1) * (K + 1) * 4, L
        ),
    }
    print(
        f"megatile: {L} rows, {blob.numel()} blob bytes, "
        f"{int(flags.sum())} candidates at --threshold 25, cap {cap}; "
        + "; ".join(
            f"{n} kernel {k:.4f} ms, plain {p:.4f} ms"
            for n, (k, p) in times.items()
        )
        + "; "
        + "; ".join(
            f"{n} bound {b:.4f} ms ({by})" for n, (b, by) in bounds.items()
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
            "bound_ms": bounds["csr_count_screen"][0],
            "bound_by": bounds["csr_count_screen"][1],
            # No single PyTorch call counts nibbles per CSR row.
            "library_ms": None,
        },
        "csr_compact": {
            "name": "csr_compact", "route": "cuda",
            "source": COUNT_SCREEN_SOURCE,
            "replaces": "guacamole_tpu/ops/kernels.py:251",
            "launches": 0, "max_abs_err": err["csr_compact"],
            "ms": times["csr_compact"][0],
            "plain_ms": times["csr_compact"][1],
            "bound_ms": bounds["csr_compact"][0],
            "bound_by": bounds["csr_compact"][1],
            # torch.nonzero plus a gather are two calls (the plain version).
            "library_ms": None,
        },
    }


# --- phase 3, continued: the likelihood screen ---------------------------

QUAL_DICTIONARY = (0, 2, 8, 15, 20, 25, 30, 33, 37, 41, 50, 60, 70, 80, 90, 93)


def _ll_tile(rng, L, D, K, device):
    """A random likelihood tile as the numpy arrays the dispatch stages,
    in both encodings: rows of depth 0..D (one row in 16 is all empty), a
    row's alleles drawn with an alt share of 0, 1%, 20%, 50% or 100%,
    quals from a 16-entry dictionary that includes q = 0, a MAPQ plane,
    and random allele planes (allele 0 the reference; four in five alleles
    standard)."""
    depth = rng.integers(0, D + 1, size=L)
    depth[rng.random(L) < 1 / 16] = 0
    valid = np.arange(D)[None, :] < depth[:, None]
    alt_share = rng.choice([0.0, 0.01, 0.2, 0.5, 1.0], size=(L, 1))
    alt = rng.integers(1, max(2, min(K, 5)), size=(L, D))
    aid = np.where(rng.random((L, D)) < alt_share, alt, 0)
    aid[rng.random((L, D)) < 0.002] = 14  # an id beyond most K: no allele
    qidx = rng.integers(0, len(QUAL_DICTIONARY), size=(L, D))
    qvals = np.asarray(QUAL_DICTIONARY, np.uint8)
    qual = qvals[qidx].astype(np.uint16)
    pack16 = np.where(valid, aid | (qual << 4), 0xFFFF).astype(np.uint16)
    pack8 = np.where(valid, aid | (qidx << 4), 0xFF).astype(np.uint8)
    mapq = rng.choice([0, 10, 37, 60, 254], size=(L, D)).astype(np.uint8)
    is_variant = np.zeros((L, K), bool)
    is_variant[:, 1:] = rng.random((L, K - 1)) < 0.8
    is_standard = rng.random((L, K)) < 0.8
    return pack16, pack8, qvals, mapq, is_variant, is_standard


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
    capped at D = 32), allele 0 the reference, errors to alleles 1..3 in
    1% of reads, one het row in 1500, quals 20..41 from a 16-entry
    dictionary. A row's flag word marks the alleles it holds as standard
    and its non-reference ones as variant, as the packer's allele tables
    do, so most rows have no variant allele at all."""
    g = torch.Generator(device=device).manual_seed(seed)
    depth = torch.poisson(
        torch.full((L,), 25.0, device=device), generator=g
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


def check_ll_screen(device) -> dict:
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import kernels as plain
    from guacamole_tpu_torch.ops.dispatch import ll_wire_from_numpy

    rng = np.random.default_rng(2026)
    rows = excused = 0
    for K in (2, 8, 15):
        for D, L in ((8, 8192), (64, 4096), (1024, 512), (16384, 64)):
            p16, p8, qvals, mapq, iv, sa = _ll_tile(rng, L, D, K, device)
            for tumor in (False, True):
                mq = mapq if tumor else None
                w16 = ll_wire_from_numpy(p16, mq, iv, sa, None, device)
                w8 = ll_wire_from_numpy(p8, mq, iv, sa, qvals, device)
                for min_phred in (0.0,) if tumor else (0.0, 40.0):
                    what = (f"K={K} D={D} {'tumor' if tumor else 'germline'} "
                            f"min_phred={min_phred:g}")
                    f16, e16 = _check_ll_case(
                        ck, plain, w16, K, 0.5, min_phred, what + " uint16")
                    f8, e8 = _check_ll_case(
                        ck, plain, w8, K, 0.5, min_phred, what + " uint8")
                    # (c) one tile, two encodings, the same flags.
                    check(bool((f16 == f8).all()),
                          f"ll_screen {what}: the uint8 and uint16 forms "
                          f"differ on {int((f16 != f8).sum())} rows")
                    rows += 2 * L
                    excused += e16 + e8
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
    # The main-path shape, timed: germline uint8, K = 8, no GQ gate.
    pack8, words, qvals = _main_path_ll_tile(device)
    L, D = pack8.shape
    wire = SimpleNamespace(pack=pack8, flag_words=words, qvals=qvals, mapq=None)
    flags, e_main = _check_ll_case(
        ck, plain, wire, 8, 0.5, 0.0, "main-path tile")
    check(e_main <= LL_MAX_BOUNDARY_SHARE * L,
          f"ll_screen main-path tile: {e_main} rows differ at the boundary")
    qv = torch.from_numpy(qvals)

    def kfn():
        ck.ll_screen(pack8, words, 8, 0.5, 0.0, ll_qvals=qvals)

    def pfn():
        plain.ll_screen(pack8, words, 8, 0.5, 0.0, qv)

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
    n_bytes = read_rows * D * pack8.element_size() + L * 4 + L
    n_ops = 2 * int((pack8[has_var] != 0xFF).sum())
    bound_ms, bound_by = _bound_ms(n_bytes, n_ops)
    print(
        f"ll tile: {L} rows x D={D} uint8, {read_rows} rows with a standard "
        f"variant allele, {int(flags.sum())} candidates; ll_screen kernel "
        f"{(k1 + k2) / 2:.4f} ms, plain {(p1 + p2) / 2:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {n_bytes} bytes, {n_ops} "
        f"operations); {excused + e_main} of {rows + L} checked rows "
        f"differed from the plain version, all within {LL_REL_TOL:g} of "
        "their boundary",
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
            "max_abs_err": float(excused + e_main > 0),
            "rows_checked": rows + L,
            "rows_differing_at_boundary": excused + e_main,
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
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


def _main_path_run(command, argv, kernels, kernel_records):
    """One run of a main path with device screens, the launch counts and
    transfer counters set to 0 just before it and read just after."""
    from guacamole_tpu_torch.ops import cuda_kernels as ck
    from guacamole_tpu_torch.ops import dispatch

    dispatch.reset_transfer_stats()
    ck.reset_launches()
    wall = _run_cli(command, argv, host_screen=False)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    transfers = dict(dispatch.TRANSFER_STATS)
    for name in kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {command} path")
        kernel_records[name]["launches"] = launches[name]
    return wall, launches, transfers


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
        f"screens ({matching} records)",
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
            f"({matching} records)",
            flush=True,
        )


def _loaded_forbidden():
    return sorted(
        m for m, mod in sys.modules.items()
        if mod is not None and (
            m in ("jax", "jaxlib", "guacamole_tpu")
            or m.startswith(("jax.", "jaxlib.", "guacamole_tpu."))
        )
    )


def profile_standard(manifest, out) -> None:
    """Not part of the default run: one more germline-standard run with
    device screens under torch.profiler (device activity only), to say how
    long the card was busy and with what."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bam = os.path.join(FIXTURE_DIR, manifest["files"]["germline_bam"])
    def argv(name):
        return ["--reads", bam, "--out", os.path.join(out, name)]

    _run_cli("germline-standard", argv("warm.vcf"), host_screen=False)
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        wall = _run_cli(
            "germline-standard", argv("profiled.vcf"), host_screen=False)
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
        f"profile: germline-standard with device screens, {wall:.3f} s wall "
        f"under the profiler, device busy {busy_ms:.3f} ms (idle share "
        f"{1 - busy_ms / 1e3 / wall:.4%}); on the device: {top(on_device)}; "
        f"PyTorch and CUDA runtime calls on the host, self time: "
        f"{top(on_host)}",
        flush=True,
    )


PHASES = ("build", "kernels", "threshold", "standard")
EXTRA_PHASES = ("profile",)


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
    if set(phases) & {"threshold", "standard", "profile"}:
        manifest = make_fixture()
        out = tempfile.mkdtemp(prefix="chip_smoke_")
        if "threshold" in phases:
            run_threshold_slice(records, manifest, out)
        if "standard" in phases:
            run_standard_slice(records, manifest, out)
        if "profile" in phases:
            profile_standard(manifest, out)
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
