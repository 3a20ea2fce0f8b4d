"""Spans and counters of the program's layers, recorded while a
torch.profiler session records in the process.

    with trace.span("pack", tile=i):     # work
        ...
    with trace.wait("tiles.get", tile=i):  # time spent waiting for a layer
        ...
    trace.count("pack.rows", tile.L)

Recording is on exactly while torch.profiler records (the module-level
bool torch.autograd.profiler._is_profiler_enabled): the benchmark's traced
runs, and GUAC_PROFILE_DIR (cli.py). Off, opening a span costs that one
test and returns a shared object that does nothing.

A record is the span itself once closed: its name, its kind ("work" or
"wait"), start and end from time.perf_counter_ns(), its parent on the same
thread, and the ids of the request it serves: `call` (one per command,
cli._dispatch), `task` (a partition task) and `tile` (a tile's sequence
number in its call). A span takes the tile of its parent unless it names
one, and the task its thread last named, at its end, unless it names one:
the packing thread's spans take the task whose decode it last waited for.
Records go into a list per thread and session; one lock registers a thread
in a session.

Sessions: each start of a profiler session starts an empty set of records
(this module hooks torch.autograd.profiler._run_on_profiler_start), and a
session's records stay readable after it ends, until the next starts.

Clock: torch.profiler's events are not on perf_counter_ns. A session's first
span on the main thread opens one record_function("guac.trace.anchor") and
keeps the perf_counter_ns at which it opened; the anchor's event in the
profiler's trace converts any span to the profiler's timeline and back.
(A record_function opened on another thread does not reach the profiler's
events, so the helper threads' spans are these records.)

Readers: seconds(name) (the benchmark's per-layer waits), snapshot(), and
export() (GUAC_PROFILE_DIR: the spans of every thread into the profiler's
trace.json, and spans.json with seconds per span, the counters and the
device's idle time put down to the main thread's spans by overlap,
idle_by_span()).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from torch.autograd import profiler as _profiler

ANCHOR = "guac.trace.anchor"
UNTRACED = "untraced"

_now = time.perf_counter_ns
_lock = threading.Lock()
_local = threading.local()


class _Session:
    """The records of one profiler session."""

    def __init__(self, gen: int):
        self.gen = gen
        self.buffers: List[_Buffer] = []
        self.anchor_ns: Optional[int] = None
        self.call = -1  # the id of the last `call` span opened
        # Span ids, unique in the session (a thread's id may be reused).
        self.ids = itertools.count()


class _Buffer:
    """One thread's records and counters in one session."""

    __slots__ = ("gen", "thread", "tid", "main", "records", "counters",
                 "stack", "task")

    def __init__(self, gen: int):
        th = threading.current_thread()
        self.gen = gen
        self.thread = th.name
        self.tid = threading.get_native_id()
        self.main = th is threading.main_thread()
        self.records: List[_Span] = []
        self.counters: Dict[str, int] = {}
        self.stack: List[_Span] = []
        self.task = None


_session = _Session(0)


def _new_session() -> None:
    global _session
    with _lock:
        _session = _Session(_session.gen + 1)


_start_profiler = _profiler._run_on_profiler_start


def _run_on_profiler_start() -> None:
    _new_session()
    _start_profiler()


_profiler._run_on_profiler_start = _run_on_profiler_start


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None or buf.gen != _session.gen:
        with _lock:
            buf = _Buffer(_session.gen)
            _session.buffers.append(buf)
        _local.buf = buf
    return buf


def _anchor() -> None:
    # The range's start is stamped early in its enter, whose first call in
    # a session may then take a millisecond more: the time before it is
    # the anchor's, within tens of microseconds.
    rf = _profiler.record_function(ANCHOR)
    t0 = _now()
    rf.__enter__()
    rf.__exit__(None, None, None)
    _session.anchor_ns = t0


class _Span:
    __slots__ = ("name", "kind", "task", "tile", "call", "id", "parent",
                 "start", "end", "_buf")

    def __init__(self, name, kind, task, tile):
        self.name, self.kind, self.task, self.tile = name, kind, task, tile

    def __enter__(self):
        buf = self._buf = _buffer()
        session = _session
        if self.name == "call":
            session.call += 1
        self.call = session.call if session.call >= 0 else None
        if self.task is not None:
            buf.task = self.task
        parent = buf.stack[-1] if buf.stack else None
        self.parent = parent.id if parent is not None else None
        if self.tile is None and parent is not None:
            self.tile = parent.tile
        self.id = next(session.ids)
        if session.anchor_ns is None and buf.main:
            _anchor()
        buf.stack.append(self)
        self.start = _now()
        return self

    def __exit__(self, *exc):
        self.end = _now()
        buf = self._buf
        buf.stack.pop()
        if self.task is None:
            self.task = buf.task
        buf.records.append(self)
        return False


class _Off:
    """What span() and wait() return while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, task=None, tile=None):
    """A context manager timing work of the layer `name`."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, "work", task, tile)


def wait(name: str, task=None, tile=None):
    """A context manager timing a wait for another layer."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, "wait", task, tile)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    if not _profiler._is_profiler_enabled:
        return
    c = _buffer().counters
    c[name] = c.get(name, 0) + n


# --- readers -----------------------------------------------------------------


def _buffers() -> List[_Buffer]:
    with _lock:
        return list(_session.buffers)


def _counters() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for b in _buffers():
        for k, v in list(b.counters.items()):
            out[k] = out.get(k, 0) + v
    return out


def seconds(name: str) -> Optional[float]:
    """Seconds of the spans named `name`, summed over threads; None where
    the session recorded nothing at all."""
    bufs = _buffers()
    if not any(b.records for b in bufs):
        return None
    return sum(r.end - r.start for b in bufs for r in list(b.records)
               if r.name == name) / 1e9


def _as_dict(r: _Span, buf: _Buffer) -> dict:
    return {"name": r.name, "kind": r.kind, "thread": buf.thread,
            "tid": buf.tid, "main": buf.main, "id": r.id, "parent": r.parent,
            "start_ns": r.start, "end_ns": r.end, "call": r.call,
            "task": r.task, "tile": r.tile}


def snapshot() -> dict:
    """The current (or last) session's spans of every thread and its
    counters, with the dispatch's transfer counters and the kernels' launch
    counts as they stand, and the perf_counter_ns of the anchor."""
    from guacamole_tpu_torch.ops import cuda_kernels, dispatch

    return {
        "anchor_ns": _session.anchor_ns,
        "spans": [_as_dict(r, b) for b in _buffers() for r in list(b.records)],
        "counters": _counters(),
        "transfer": dict(dispatch.TRANSFER_STATS),
        "launches": dict(cuda_kernels.LAUNCHES),
    }


def span_seconds(spans: Iterable[dict]) -> List[dict]:
    """Seconds per span name and thread: count, total, and self (the total
    less the spans opened inside it on the same thread)."""
    spans = list(spans)
    child: Dict[int, int] = {}
    for s in spans:
        if s["parent"] is not None:
            child[s["parent"]] = (child.get(s["parent"], 0)
                                  + s["end_ns"] - s["start_ns"])
    rows: Dict[Tuple[str, str], dict] = {}
    for s in spans:
        total = s["end_ns"] - s["start_ns"]
        row = rows.setdefault((s["name"], s["thread"]), {
            "name": s["name"], "kind": s["kind"], "thread": s["thread"],
            "count": 0, "total_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += total / 1e9
        row["self_s"] += (total - child.get(s["id"], 0)) / 1e9
    return sorted(rows.values(), key=lambda r: -r["total_s"])


# --- idle time by span ---------------------------------------------------------


def _union(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _innermost(spans, lo: int, hi: int) -> List[Tuple[int, int, str]]:
    """[lo, hi) cut into stretches, each named by the innermost of
    `spans` ((start, end, name) of one thread, nested) open there, or
    UNTRACED where none is."""
    out: List[Tuple[int, int, str]] = []
    t = lo

    def emit(end: int, name: str) -> None:
        nonlocal t
        end = min(end, hi)
        if end > t:
            out.append((t, end, name))
            t = end

    stack: List[Tuple[int, str]] = []  # (end, name)
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, open_name = stack.pop()
            emit(end, open_name)
        emit(s, stack[-1][1] if stack else UNTRACED)
        stack.append((e, name))
    while stack:
        end, open_name = stack.pop()
        emit(end, open_name)
    emit(hi, UNTRACED)
    return out


def idle_by_span(spans, busy, lo: int, hi: int) -> Dict[str, float]:
    """Seconds of [lo, hi) in which the device was idle (outside every
    `busy` (start, end)), each nanosecond put down to the innermost of
    `spans` open at it, or to UNTRACED. By overlap: a gap that two spans
    share is split between them."""
    busy = _union(busy, lo, hi)
    idle, prev = [], lo
    for s, e in busy:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        idle.append((prev, hi))
    out: Dict[str, float] = {}
    i = 0
    for s, e, name in _innermost(spans, lo, hi):
        while i < len(idle) and idle[i][1] <= s:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < e:
            overlap = min(e, idle[j][1]) - max(s, idle[j][0])
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap / 1e9
            j += 1
    return out


# --- the operator's exporter ---------------------------------------------------

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def export(trace_path: str, spans_path: str) -> None:
    """Add the session's spans of every thread to the profiler's Chrome
    trace at `trace_path` (complete events on its timeline, through the
    anchor) and write `spans_path`: seconds per span and thread, the
    counters, and the device's idle time within the calls put down to the
    main thread's spans by overlap."""
    snap = snapshot()
    with open(trace_path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"]
    mark = next((ev for ev in events if ev.get("name") == ANCHOR
                 and ev.get("ph") == "X"), None)
    anchor = snap["anchor_ns"]
    spans = snap["spans"]
    out = {"anchor": None, "spans": span_seconds(spans),
           "counters": snap["counters"], "transfer": snap["transfer"],
           "launches": snap["launches"], "device": None}
    if mark is not None and anchor is not None:
        base_us = float(mark["ts"])
        out["anchor"] = {"perf_counter_ns": anchor, "trace_ts_us": base_us}

        def us(ns: int) -> float:
            return base_us + (ns - anchor) / 1e3

        pid = os.getpid()
        named = set()
        for s in spans:
            if s["tid"] not in named:
                named.add(s["tid"])
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": s["tid"],
                               "args": {"name": s["thread"]}})
            args = {k: s[k] for k in ("call", "task", "tile")
                    if s[k] is not None}
            events.append({"ph": "X", "cat": "guac." + s["kind"],
                           "name": s["name"], "pid": pid, "tid": s["tid"],
                           "ts": us(s["start_ns"]),
                           "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                           "args": args})
        with open(trace_path, "w") as fh:
            json.dump(doc, fh)

        def ns(t_us: float) -> int:
            return anchor + int(round((t_us - base_us) * 1e3))

        busy = [(ns(float(ev["ts"])), ns(float(ev["ts"]) + float(ev["dur"])))
                for ev in events
                if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES]
        main = [s for s in spans if s["main"]]
        calls = [(s["start_ns"], s["end_ns"]) for s in main
                 if s["name"] == "call"]
        idle: Dict[str, float] = {}
        busy_s = window_s = 0.0
        for lo, hi in calls:
            window_s += (hi - lo) / 1e9
            busy_s += sum(e - s for s, e in _union(busy, lo, hi)) / 1e9
            for k, v in idle_by_span(
                    [(s["start_ns"], s["end_ns"], s["name"]) for s in main],
                    busy, lo, hi).items():
                idle[k] = idle.get(k, 0.0) + v
        out["device"] = {
            "calls_s": window_s, "busy_s": busy_s,
            "idle_s": window_s - busy_s,
            "idle_by_span_s": dict(sorted(idle.items(),
                                          key=lambda kv: -kv[1])),
        }
    with open(spans_path, "w") as fh:
        json.dump(out, fh, indent=1)
