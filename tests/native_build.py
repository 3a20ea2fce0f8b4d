"""Builds the sanitized harnesses of the port's native runtime, and reads
what the decode harness prints.

A harness (tests/native_decode_harness.cpp, tests/native_pack_harness.cpp)
is linked with the port's own sources (guacamole_tpu_torch/runtime/csrc/),
all compiled with one sanitizer: one g++ per source, the sources of every
harness at once, then the links.

Used by tests/test_torch_native.py, tests/test_torch_native_records.py,
tests/test_torch_native_sam.py and chip_smoke.py's `native` phase; it
imports nothing of JAX.
"""

from __future__ import annotations

import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

from guacamole_tpu_torch.runtime import native

TESTS = os.path.dirname(os.path.abspath(__file__))
DECODE_HARNESS = os.path.join(TESTS, "native_decode_harness.cpp")
PACK_HARNESS = os.path.join(TESTS, "native_pack_harness.cpp")
_FLAGS = ("-O1", "-g", "-fno-omit-frame-pointer", "-std=c++17")


def _commands(out: str, sanitizer: str, harness: str):
    """(compiles, link, exe) of one harness with the port's sources."""
    sources = [os.path.join(native.CSRC_DIR, n) for n in native.SOURCES]
    sources.append(harness)
    objects = [os.path.join(out, f"{sanitizer}{i}.o")
               for i in range(len(sources))]
    exe = os.path.join(out, f"{sanitizer}_{os.path.basename(harness)[:-4]}")
    compiles = [["g++", *_FLAGS, f"-fsanitize={sanitizer}", "-c", src, "-o",
                 obj] for src, obj in zip(sources, objects)]
    link = ["g++", f"-fsanitize={sanitizer}", *objects, "-o", exe, "-lz",
            "-pthread", "-ldl"]
    return compiles, link, exe


def _run(args):
    return args, subprocess.run(args, capture_output=True, text=True,
                                timeout=600)


def build(out: str, harnesses: Dict[str, str]) -> Dict[str, str]:
    """{sanitizer: harness source} -> {sanitizer: executable}, built in
    out. Raises RuntimeError with the failed command and its last output."""
    builds = {s: _commands(str(out), s, h) for s, h in harnesses.items()}
    compiles = [c for cs, _, _ in builds.values() for c in cs]
    with ThreadPoolExecutor(len(compiles)) as pool:
        for group in (compiles, [link for _, link, _ in builds.values()]):
            for args, run in pool.map(_run, group):
                if run.returncode != 0:
                    raise RuntimeError(f"{' '.join(args[-3:])} failed: "
                                       f"{(run.stdout + run.stderr)[-4000:]}")
    return {s: exe for s, (_, _, exe) in builds.items()}


def parse_decodes(stdout: str) -> Dict[str, List[Tuple[int, str]]]:
    """{input: [(count, reason)]} of the decode harness's output, one
    pair per call on the input: the reads decoded and "", or -1 and the
    library's reason for the refusal."""
    out = {}
    for line in stdout.splitlines():
        path, *calls = line.split("\t")
        out[path] = [(int(count), reason) for count, _, reason in
                     (call.partition(" ") for call in calls)]
    return out
