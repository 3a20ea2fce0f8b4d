"""Builds the sanitized harnesses of the port's native runtime, reads
what the decode harness prints, and keeps the diffs that hold the port's
C++ sources against the JAX package's.

A harness (tests/native_decode_harness.cpp, tests/native_pack_harness.cpp)
is linked with the port's own sources (guacamole_tpu_torch/runtime/csrc/),
all compiled with one sanitizer: one g++ per source, the sources of every
harness at once, then the links.

The port's copy (guacamole_tpu_torch/runtime/csrc/<name>) departs from
native/<name>, after the package rename, by the repairs in
tests/native_repairs/<name>.diff: a unified diff without context, one hunk
per departure, its reason after the hunk header
(`@@ -a,b +c,d @@ <reason>`, text that `git apply` and `patch` ignore).
After an edit of the copy,

    python tests/native_build.py --write-repairs

writes the diffs anew: a hunk whose lines did not change keeps its
reason, a new one has none, and tests/test_torch_native.py fails until
someone writes it.

Used by tests/test_torch_native.py, tests/test_torch_native_records.py,
tests/test_torch_native_sam.py and chip_smoke.py's `native` phase; it
imports nothing of JAX.
"""

from __future__ import annotations

import difflib
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Tuple

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
if __name__ == "__main__":
    sys.path.insert(0, ROOT)  # run as a script from anywhere

from guacamole_tpu_torch.runtime import native  # noqa: E402

REPAIRS_DIR = os.path.join(TESTS, "native_repairs")
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


# --- the repairs of the copy, as diffs -------------------------------------


class Hunk(NamedTuple):
    """One departure of the copy: its unified-diff header ranges
    (`-a,b +c,d`), the original's lines it replaces and the copy's lines,
    and why."""

    ranges: str
    was: Tuple[str, ...]
    now: Tuple[str, ...]
    reason: str


def _range(start: int, length: int) -> str:
    """A unified-diff range of [start, start + length) (0-based), as diff
    -U0 writes it: an empty range names the line before it."""
    return f"{start + (length > 0)},{length}"


def original(name: str) -> str:
    """native/<name> after the package rename the host copies take."""
    from test_torch_host_copies import _REWRITE

    with open(os.path.join(ROOT, "native", name)) as fh:
        text = fh.read()
    for pattern, replacement in _REWRITE:
        text = pattern.sub(replacement, text)
    return text


def repair_hunks(name: str) -> List[Hunk]:
    """The copy's departures from the original, computed, without
    reasons."""
    with open(os.path.join(native.CSRC_DIR, name)) as fh:
        copy = fh.read()
    a, b = original(name).splitlines(True), copy.splitlines(True)
    assert a[-1].endswith("\n") and b[-1].endswith("\n"), name
    matcher = difflib.SequenceMatcher(None, a, b, autojunk=False)
    return [Hunk(f"-{_range(i0, i1 - i0)} +{_range(j0, j1 - j0)}",
                 tuple(a[i0:i1]), tuple(b[j0:j1]), "")
            for tag, i0, i1, j0, j1 in matcher.get_opcodes()
            if tag != "equal"]


def repairs_path(name: str) -> str:
    return os.path.join(REPAIRS_DIR, name + ".diff")


def read_repairs(name: str) -> List[Hunk]:
    """The stored diff's hunks, with their reasons."""
    hunks: List[Hunk] = []
    with open(repairs_path(name)) as fh:
        lines = fh.read().splitlines(True)
    for line in lines:
        if line.startswith("@@ "):
            ranges, _, reason = line[3:].partition(" @@")
            hunks.append(Hunk(ranges, (), (), reason.strip()))
        elif hunks and line[:1] in "-+":
            h = hunks[-1]
            side = "was" if line[0] == "-" else "now"
            hunks[-1] = h._replace(**{side: getattr(h, side) + (line[1:],)})
    return hunks


def format_repairs(name: str, hunks: List[Hunk]) -> str:
    head = (f"The port's repairs of native/{name}, after the package rename\n"
            f"(tests/test_torch_host_copies.py's _REWRITE): one hunk per\n"
            f"departure, its reason after the header. Written by\n"
            f"`python tests/native_build.py --write-repairs`.\n"
            f"--- a/native/{name}\n"
            f"+++ b/guacamole_tpu_torch/runtime/csrc/{name}\n")
    body = "".join(
        f"@@ {h.ranges} @@ {h.reason}".rstrip() + "\n"
        + "".join("-" + line for line in h.was)
        + "".join("+" + line for line in h.now)
        for h in hunks)
    return head + body


def write_repairs(name: str) -> List[Hunk]:
    """Writes <name>.diff from the sources as they stand: a hunk whose
    lines are those of a stored hunk keeps its reason, in order; a new
    one has none. Returns the hunks written."""
    kept: Dict[Tuple, List[str]] = {}
    if os.path.exists(repairs_path(name)):
        for h in read_repairs(name):
            kept.setdefault((h.was, h.now), []).append(h.reason)
    hunks = [h._replace(reason=(kept.get((h.was, h.now)) or [""]).pop(0))
             for h in repair_hunks(name)]
    os.makedirs(REPAIRS_DIR, exist_ok=True)
    with open(repairs_path(name), "w") as fh:
        fh.write(format_repairs(name, hunks))
    return hunks


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-repairs"]:
        sys.exit(f"usage: {sys.argv[0]} --write-repairs")
    for source in native.SOURCES:
        written = write_repairs(source)
        missing = sum(not h.reason for h in written)
        print(f"{repairs_path(source)}: {len(written)} hunks, {missing} "
              f"without a reason")
