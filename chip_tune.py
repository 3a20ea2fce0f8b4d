#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels against the sources as they
stand, on one GPU, in one call.

    python3 chip_tune.py --set csr_screen.cu:kChunkBytes=4096 \\
        --set csr_screen.cu:kChunkBytes=16384,kThreadRowBytes=32
    python3 chip_tune.py --dir .tune        # .tune/<label>.<source>.cu

A variant is a source of guacamole_tpu_torch/ops/csrc/ with some of its
`constexpr int NAME = value;` lines rewritten (--set), or a whole file kept
beside the repository's sources (--dir; the directory is git-ignored).
Every variant is compiled with the flags of ops/build.py (all at once),
must give the same outputs as the base on the timed tiles, and is timed in
turns with it (base, variants, base, variants, ...) at the shapes
chip_smoke.py times: the megatile and a main-path launch shape for the
counting screen and the compaction, 1M x 32 and the launch shapes for both
forms of the likelihood screen, and for the fused dense kernel 1M x 32,
114,688 x 32, two deep tiles, K = 20 and tiles of 2,048, 128 and one row,
each with and without likelihoods. Times are device times, back to back
and with a cold L2 cache (see chip_smoke._time_ms and _time_cold_ms). Two
cards differ, so compare only within one call: the card's name and power
limit are printed first.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import re
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import chip_smoke  # blocks jax and the JAX package, as the smoke run does
import numpy as np
import torch

from guacamole_tpu_torch.ops import build
from guacamole_tpu_torch.ops import cuda_kernels as ck


def _variants(args):
    """[(source, label, text)] with the base of every source named first."""
    wanted = {}
    for spec in args.set or []:
        source, assignments = spec.split(":", 1)
        with open(os.path.join(build.CSRC_DIR, source)) as fh:
            text = fh.read()
        for assignment in assignments.split(","):
            name, value = assignment.split("=")
            text, n = re.subn(
                rf"(constexpr int {name} = )[^;]+;", rf"\g<1>{value};", text)
            if n != 1:
                raise SystemExit(f"{source}: no constexpr int {name}")
        wanted.setdefault(source, []).append((assignments, text))
    for path in sorted(glob.glob(os.path.join(args.dir or "", "*.cu"))):
        label, source = os.path.basename(path).split(".", 1)
        with open(path) as fh:
            wanted.setdefault(source, []).append((label, fh.read()))
    out = []
    for source, variants in wanted.items():
        with open(os.path.join(build.CSRC_DIR, source)) as fh:
            out.append((source, "base", fh.read()))
        out += [(source, label, text) for label, text in variants]
    return out


def _compile_all(variants, tmp):
    running = []
    for i, (source, label, text) in enumerate(variants):
        src = os.path.join(tmp, f"v{i}_{source}")
        with open(src, "w") as fh:
            fh.write(text)
        lib = src[:-3] + ".so"
        running.append((lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for (source, label, _text), (lib, proc) in zip(variants, running):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{source} [{label}] did not compile:\n{log}")
        used = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "ptxas info" in ln and "Used" in ln]
        print(f"{source} [{label}]: registers "
              f"{sorted({int(u.split()[1]) for u in used})}", flush=True)
        libs.append(ctypes.CDLL(lib))
    return libs


def _use(base, source, lib):
    """Make the wrappers launch `lib`'s kernels of `source`."""
    names = {"csr_screen.cu": ("guac_csr_count_screen", "guac_csr_compact"),
             "ll_screen.cu": ("guac_ll_screen",),
             "stats_ll.cu": ("guac_stats_ll",)}[source]
    ns = SimpleNamespace(**vars(base))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = getattr(base, name).argtypes
        fn.restype = getattr(base, name).restype
        setattr(ns, name, fn)
    ck.load_kernels = lambda: ns


def _cases(device, source):
    """[(what, call)]: each call launches once and returns its outputs."""
    if source == "csr_screen.cu":
        tiles = {
            "megatile": chip_smoke._megatile(device),
            "launch shape": chip_smoke._csr_tile_of(
                device, *chip_smoke.DEFAULT_LAUNCH_SHAPES[
                    ("germline-threshold", "csr_count_screen")]),
        }
        out = []
        for what, t in tiles.items():
            out.append((f"csr_count_screen, {what}",
                        lambda t=t: ck.csr_count_screen(*t, 8, 25)))
            counts, flags = ck.csr_count_screen(*t, 8, 25)
            cap = max(512, flags.numel() // 256)
            out.append((f"csr_compact, {what} ({flags.numel()} rows, cap "
                        f"{cap})",
                        lambda f=flags, c=counts, cap=cap: (
                            ck.csr_compact(f, c, cap),)))
        # One row (the launch floor), and around the length where the
        # one-block route ends.
        counts, flags = ck.csr_count_screen(*tiles["launch shape"], 8, 25)
        for rows in (1, 14_336, 32_768, 32_769, 65_536, 196_608):
            out.append((f"csr_compact, {rows} rows",
                        lambda f=flags[:rows], c=counts[:rows]: (
                            ck.csr_compact(f, c, 512),)))
        return out
    if source == "ll_screen.cu":
        out = []
        shapes = {"1M x 32": (1 << 20, 32)}
        for path in ("germline-standard", "somatic-standard"):
            rows, D, _form = chip_smoke.DEFAULT_LAUNCH_SHAPES[
                (path, "ll_screen")]
            shapes[f"{rows} x {D}"] = (rows, D)
        shapes.update({"40000 x 128": (40000, 128), "20000 x 256": (20000, 256)})
        for what, (rows, D) in shapes.items():
            pack8, words, qvals = chip_smoke._main_path_ll_tile(
                device, L=rows, D=D)
            g = torch.Generator(device=device).manual_seed(7)
            mapq8 = torch.randint(
                20, 61, pack8.shape, generator=g, device=device
            ).to(torch.uint8)
            for form, mq in (("germline", None), ("tumor", mapq8)):
                out.append((
                    f"ll_screen {form}, {what}",
                    lambda p=pack8, w=words, q=qvals, m=mq: (ck.ll_screen(
                        p, w, 8, 0.5, 0.0, ll_qvals=q, ll_mapq=m),),
                ))
        return out
    if source == "stats_ll.cu":
        out = []
        shapes = {"1M x 32": (1 << 20, 32, 8), "114688 x 32": (114_688, 32, 8),
                  "10240 x 1024": (10_240, 1024, 8),
                  "16384 x 1024": (16_384, 1024, 8),
                  "114688 x 32, K=20": (114_688, 32, 20),
                  "6144 x 16": (6144, 16, 8), "12288 x 16": (12_288, 16, 8),
                  "2048 x 8": (2048, 8, 8), "2048 x 32": (2048, 32, 8),
                  "2048 x 1024": (2048, 1024, 8),
                  "one row": (1, 32, 8), "128 x 32": (128, 32, 8)}
        for what, (rows, D, K) in shapes.items():
            tile = chip_smoke._main_path_dense_tile(device, L=rows, D=D, K=K)
            for with_ll in (False, True):
                out.append((
                    f"stats_ll {'with' if with_ll else 'without'} "
                    f"likelihoods, {what}",
                    lambda t=tile, K=K, w=with_ll: ck.stats_ll(
                        t.allele_id, t.qual, t.mapq, t.strand, t.valid,
                        t.is_variant, K, False, 25, w),
                ))
        return out
    raise SystemExit(f"no timed case for {source}")


def _same(got, want) -> bool:
    """Integers and flags equal; floats (the likelihoods of stats_ll, whose
    sums two variants may take in another order) within rtol 2e-5 and atol
    1e-3."""
    for a, b in zip(got, want):
        if a is None or b is None:
            if a is not b:
                return False
        elif a.is_floating_point():
            if not torch.allclose(a, b, rtol=2e-5, atol=1e-3):
                return False
        elif not torch.equal(a, b):
            return False
    return True


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--set", action="append",
                        help="source.cu:NAME=value[,NAME=value]")
    parser.add_argument("--dir", help="directory of <label>.<source>.cu")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument(
        "--no-check", action="store_true",
        help="do not compare outputs: for variants that leave work out, "
        "to see what that work costs")
    args = parser.parse_args(argv)
    device = chip_smoke.require_card()
    base = build.load_kernels()
    variants = _variants(args)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _compile_all(variants, tmp)
        for source in dict.fromkeys(v[0] for v in variants):
            mine = [(label, lib) for (s, label, _t), lib in zip(variants, libs)
                    if s == source]
            for what, call in _cases(device, source):
                want, times = None, {label: [] for label, _ in mine}
                cold = {}
                for _ in range(args.rounds):
                    for label, lib in mine:
                        _use(base, source, lib)
                        got = call()
                        torch.cuda.synchronize()
                        if want is None:
                            want = got
                        elif not args.no_check and not _same(got, want):
                            raise SystemExit(
                                f"{what} [{label}]: outputs differ from base")
                        times[label].append(chip_smoke._time_ms(call, 50))
                        cold[label] = chip_smoke._time_cold_ms(call, device)
                print(f"{what}: " + "; ".join(
                    f"[{label}] {np.median(ts):.4f} ms "
                    f"({min(ts):.4f}-{max(ts):.4f}), cold L2 "
                    f"{cold[label]:.4f} ms"
                    for label, ts in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
