"""Spans around the program's layers, and what the profiler's trace says.

Spans: during a traced run the harness replaces functions of the program's
modules (module attributes, looked up at call time) with timed wrappers and
puts them back afterwards; no file of the program changes. A span's self
time is its length less the spans of other layers that ran inside it on the
same thread; a span inside another of the same layer counts once. Spans of
all threads are summed. Spans on the main thread are also kept in order, to
say what the host was doing while the device was idle.

Trace: the device's activity (kernels, copies, sets) from torch.profiler,
its union over the window, the time of each kernel, and the idle gaps.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# Layer -> the program's functions whose calls are its spans, as
# "module:attribute" or "module:Class.method".
LAYERS: Dict[str, Tuple[str, ...]] = {
    "decode": (
        "guacamole_tpu_torch.runtime.columnar:decode_bam_columnar",
        "guacamole_tpu_torch.runtime.columnar:filter_columnar",
        "guacamole_tpu_torch.runtime.native:decode_bam_native",
    ),
    "pack": (
        "guacamole_tpu_torch.pack.columnar:iter_tiles_columnar",
        "guacamole_tpu_torch.pack.columnar:pack_tile_columnar",
        "guacamole_tpu_torch.pack.tiles:pack_tiles",
        "guacamole_tpu_torch.runtime.native:pack_tile_native",
        "guacamole_tpu_torch.runtime.native:build_events_native",
    ),
    "dispatch": (
        "guacamole_tpu_torch.ops.dispatch:screen_csr_launch",
        "guacamole_tpu_torch.ops.dispatch:screen_csr_compact_launch",
        "guacamole_tpu_torch.ops.dispatch:screen_tile_launch",
        "guacamole_tpu_torch.ops.dispatch:screen_tile_for",
        "guacamole_tpu_torch.ops.dispatch:germline_screen_launch",
        "guacamole_tpu_torch.ops.dispatch:tumor_screen_launch",
        "guacamole_tpu_torch.ops.dispatch:PendingScreen.result",
        "guacamole_tpu_torch.ops.dispatch:PendingCompact.result",
        "guacamole_tpu_torch.ops.dispatch:PendingCandidates.result",
        "guacamole_tpu_torch.ops.dispatch:PendingDense.result",
    ),
    "confirm": (
        "guacamole_tpu_torch.callers.germline_threshold:call_tile",
        "guacamole_tpu_torch.callers.germline_standard:calls_from_tile_rows",
        "guacamole_tpu_torch.callers.germline_standard:call_variants_at_locus",
        "guacamole_tpu_torch.callers.somatic_standard:"
        "somatic_calls_from_row_pairs",
        "guacamole_tpu_torch.callers.somatic_standard:"
        "find_potential_variant_at_locus",
    ),
    # No metric reads these layers' time; they name the idle gaps: writing
    # the VCF, and the rest of a call (argument parsing, partitioning, the
    # main thread waiting for packed tiles, sorting the calls).
    "write": ("guacamole_tpu_torch.callers.common:write_variants",),
    "cli": ("guacamole_tpu_torch.cli:_dispatch",),
}


def _resolve(target: str):
    module_name, attr = target.split(":")
    owner = importlib.import_module(module_name)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, name


class Tracer:
    """Spans of the program's layers over one traced window."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.self_s: Dict[str, float] = {}
        self.main: List[Tuple[int, int, str]] = []  # (start ns, end ns, layer)
        self._main_ident = threading.main_thread().ident
        self._restore: List[Tuple[object, str, object]] = []

    # -- spans -------------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _enter(self, layer: str):
        st = self._stack()
        if any(f[0] == layer for f in st):
            return None  # nested in its own layer: counted by the outer
        frame = [layer, time.perf_counter_ns(), 0]
        st.append(frame)
        return frame

    def _exit(self, frame) -> None:
        if frame is None:
            return
        end = time.perf_counter_ns()
        st = self._stack()
        st.pop()
        total = end - frame[1]
        if st:
            st[-1][2] += total
        with self._lock:
            self.self_s[frame[0]] = self.self_s.get(frame[0], 0.0) + (
                total - frame[2]) / 1e9
        if threading.get_ident() == self._main_ident:
            self.main.append((frame[1], end, frame[0]))

    @contextlib.contextmanager
    def aside(self):
        """Time the harness's own work inside a span apart (as the layer
        "bench"), so that no layer counts it."""
        frame = self._enter("bench")
        try:
            yield
        finally:
            self._exit(frame)

    def span(self, layer: str, fn: Callable) -> Callable:
        if inspect.isgeneratorfunction(fn):
            @functools.wraps(fn)
            def gen(*args, **kwargs):
                it = fn(*args, **kwargs)
                while True:
                    frame = self._enter(layer)
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    finally:
                        self._exit(frame)
                    yield item
            return gen

        @functools.wraps(fn)
        def call(*args, **kwargs):
            frame = self._enter(layer)
            try:
                return fn(*args, **kwargs)
            finally:
                self._exit(frame)
        return call

    # -- installing ----------------------------------------------------------

    def patch(self, target: str, make: Callable[[Callable], Callable]):
        owner, name = _resolve(target)
        original = owner.__dict__[name] if isinstance(owner, type) else (
            getattr(owner, name))
        self._restore.append((owner, name, original))
        setattr(owner, name, make(original))

    def install(self, layers: Dict[str, Tuple[str, ...]] = LAYERS) -> None:
        for layer, targets in layers.items():
            for target in targets:
                self.patch(target, lambda fn, layer=layer: self.span(layer, fn))

    def uninstall(self) -> None:
        while self._restore:
            owner, name, original = self._restore.pop()
            setattr(owner, name, original)

    def name_at(self, t_ns: int) -> str:
        """The innermost main-thread span open at t_ns."""
        best = None
        for start, end, layer in self.main:
            if start <= t_ns < end and (best is None or start >= best[0]):
                best = (start, layer)
        return best[1] if best else "between calls"


# --- the device trace -------------------------------------------------------


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")() * 1000)


def device_events(prof) -> Tuple[List[Tuple[int, int, str]], Optional[int]]:
    """([(start ns, end ns, name)] of the device's activity, the start ns
    of the CPU event 'gpu_bench.window' in the same clock)."""
    from torch.autograd import DeviceType

    out, marker = [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name == "gpu_bench.window":
            # The window's own range, which the trace shows on the device's
            # timeline too: not device activity.
            if ev.device_type() != DeviceType.CUDA:
                marker = _ns(ev, "start")
            continue
        if ev.device_type() == DeviceType.CUDA:
            start = _ns(ev, "start")
            out.append((start, start + _ns(ev, "duration"), name))
    out.sort()
    return out, marker


def union_intervals(events, lo: int, hi: int) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e, _ in events:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def breakdown(events, busy, lo: int, hi: int, name_at, top: int = 10):
    """(device ops by total seconds, idle seconds by what the host's main
    thread was doing), each the `top` largest."""
    ops: Dict[str, float] = {}
    for s, e, name in events:
        key = name if len(name) <= 96 else name[:93] + "..."
        ops[key] = ops.get(key, 0.0) + (e - s) / 1e9
    gaps: Dict[str, float] = {}
    prev = lo
    for s, e in busy + [(hi, hi)]:
        if s > prev:
            what = name_at((prev + s) // 2)
            gaps[what] = gaps.get(what, 0.0) + (s - prev) / 1e9
        prev = max(prev, e)
    order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v] for k, v in order], [[k, v] for k, v in idle]
