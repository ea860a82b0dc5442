"""Observability: phase timers, run metrics, structured JSONL logging
(port of `mobileraytracer_tpu/utils/metrics.py`), and the port's tracer.

Mirrors the reference's measurement surface (SURVEY.md §5.1/§5.5):
phase latencies for load / scene-fill / shader+accelerator build / render
(reference C_wrapper.cpp:103-130, 248-251), the casted-ray throughput
metric "Total Millions rays per second" (C_wrapper.cpp:256), and the live
stats-line fields (RenderTask.kt:169-260) — here as a metrics dict that
can be printed and appended to a JSONL file.

The tracer: `span(name)` marks a layer boundary (a context manager, or a
decorator).  It is off until `enable()`; off, a span is a shared null
context that reads no clock.  On, each span records its name, start, end
(`time.perf_counter_ns`), parent and unit, and adds to its name's count,
total and self time (the duration less what its child spans cover).  A
unit is one frame, sample, gradient call or recovery step: it opens at
the outermost of the ROOTS spans, and every span beneath carries its id.
The last UNITS_KEPT units' spans stay in memory for `export`; the
per-name sums cover every span since `reset()`.  Each thread has its own
stack of open spans.  While a torch.profiler session runs, each span also
opens a `record_function` range of its name, so the spans sit on the
profiler's timeline beside the device's kernels.

Host syncs: `host_value(x, layer)` reads a device scalar and counts the
read in `SYNCS[layer]`, always; with the tracer on it also times the wait
as the span `<layer>.sync`.  The counters of the other modules (LOOPS,
LAUNCHES, WALK, FULL) are registered here by `counters`, so `summary()` and
`export()` list every counter in one place, and `counted_apart()` can
set a block's counts aside and replay them later.
"""
from __future__ import annotations

import collections
import functools
import itertools
import json
import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch
from torch.autograd import _profiler_enabled

logger = logging.getLogger("mobileraytracer_tpu_torch")

# Spans that open a unit when no unit is open: a frame, one sample of the
# progressive Renderer, one vertex-gradient call, one recovery step.
ROOTS = frozenset({"frame.render_frame", "frame.render_sample",
                   "gradients.vertex_grad", "recover.step"})
UNITS_KEPT = 16          # units whose spans stay in memory for export
LOOSE_KEPT = 4096        # spans outside any unit that stay in memory

clock = time.perf_counter_ns     # the tracer's clock, in ns

_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_unit_ids = itertools.count(1)
_sums: Dict[str, list] = {}      # name -> [count, total ns, self ns]
_units = collections.deque(maxlen=UNITS_KEPT)   # (unit id, [record])
_loose = collections.deque(maxlen=LOOSE_KEPT)   # records outside units
_counters: Dict[str, dict] = {}


def counters(name: str, values: dict) -> dict:
    """Registers the dict of counts `values` under `name` (by reference:
    the owner keeps updating it) and returns it."""
    _counters[name] = values
    return values


class CountChange:
    """The change a block made to the registered counters (`counted_apart`);
    `replay()` adds it to them again."""

    def __init__(self):
        self.change: Dict[str, dict] = {}

    def replay(self) -> None:
        for name, diff in self.change.items():
            values = _counters[name]
            for k, v in diff.items():
                values[k] = values.get(k, 0) + v


@contextmanager
def counted_apart():
    """Records the change the block makes to every registered counter into
    the CountChange it yields, and restores the counters as they were
    before the block.  Used around a CUDA graph's capture, whose launches
    count only when the graph is replayed."""
    before = {name: dict(v) for name, v in _counters.items()}
    out = CountChange()
    try:
        yield out
    finally:
        for name, values in _counters.items():
            old = before.get(name, {})
            diff = {k: v - old.get(k, 0) for k, v in values.items()
                    if v != old.get(k, 0)}
            if diff:
                out.change[name] = diff
            values.clear()
            values.update(old)


# Explicit host reads of device values since the process started, by the
# layer that makes them.
SYNCS = counters("metrics.SYNCS", {"frame": 0, "walker": 0, "traversal": 0})


def enable() -> None:
    """Turns the tracer on for every thread."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drops the recorded spans and the per-name sums (not the
    counters, which their owners reset)."""
    with _lock:
        _sums.clear()
        _units.clear()
        _loose.clear()


class _Span:
    """One open span; with `events` (a dict) also CUDA events around it,
    appended to events[<last part of the name>] as (start, end)."""
    __slots__ = ("name", "events", "on", "rf", "ev", "id", "parent", "unit",
                 "sink", "t0", "child")

    def __init__(self, name, events=None):
        self.name, self.events = name, events

    def __enter__(self):
        self.on = _on
        if self.events is not None:
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
        if self.on:
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            parent = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = parent.id if parent is not None else None
            if parent is not None and parent.unit is not None:
                self.unit, self.sink = parent.unit, parent.sink
            elif self.name in ROOTS:
                self.unit, self.sink = next(_unit_ids), []
            else:
                self.unit = self.sink = None
            self.child = 0
            stack.append(self)
            self.rf = None
            if _profiler_enabled():
                self.rf = torch.autograd.profiler.record_function(self.name)
                self.rf.__enter__()
            self.t0 = clock()
        return self

    def __exit__(self, *exc):
        if self.on:
            t1 = clock()
            if self.rf is not None:
                self.rf.__exit__(*exc)
            stack = _local.stack
            stack.pop()
            dur = t1 - self.t0
            parent = stack[-1] if stack else None
            if parent is not None:
                parent.child += dur
            rec = (self.id, self.name, self.t0, t1, self.parent, self.unit,
                   threading.get_ident())
            with _lock:
                s = _sums.get(self.name)
                if s is None:
                    s = _sums[self.name] = [0, 0, 0]
                s[0] += 1
                s[1] += dur
                s[2] += dur - self.child
                if self.sink is None:
                    _loose.append(rec)
                else:
                    self.sink.append(rec)
                    if parent is None or parent.unit != self.unit:
                        _units.append((self.unit, self.sink))
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.setdefault(self.name.rpartition(".")[2], []).append(
                (self.ev, end))
        return False

    def __call__(self, fn):
        return _spanned(self.name, fn)


def _spanned(name, fn):
    """fn, each call of it in the span `name`."""
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        if not _on:
            return fn(*args, **kwargs)
        with _Span(name):
            return fn(*args, **kwargs)
    return spanned


class _Null:
    """What `span` returns while the tracer is off: enters and exits doing
    nothing, and as a decorator wraps a function in its span."""
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __call__(self, fn):
        return _spanned(self.name, fn)


_nulls: Dict[str, _Null] = {}


def span(name: str, events: Optional[dict] = None, device=None):
    """The span `name` around a block (`with span(...)`) or a function
    (`@span(...)`).  With `events` (a dict) and a CUDA `device`, CUDA
    events around the block are recorded into events[<last part of the
    name>] as (start, end) pairs, whether the tracer is on or off."""
    if events is None or torch.device(device).type != "cuda":
        if not _on:
            null = _nulls.get(name)
            if null is None:
                null = _nulls.setdefault(name, _Null(name))
            return null
        return _Span(name)
    return _Span(name, events)


def host_value(x: torch.Tensor, layer: str):
    """x.item(): the Python value of the device scalar x (x.tolist() of a
    small vector), which waits for the device.  Counts the read in
    SYNCS[layer] and, with the tracer on, times it as the span
    `<layer>.sync`."""
    SYNCS[layer] += 1
    read = x.item if x.dim() == 0 else x.tolist
    if not _on:
        return read()
    with _Span(layer + ".sync"):
        return read()


def summary() -> dict:
    """{"spans": {name: {count, total_ms, self_ms}}, "counters": {name:
    {key: count}}} since the last reset (counters: as their owners keep
    them)."""
    with _lock:
        sums = {k: list(v) for k, v in _sums.items()}
    return {"spans": {k: {"count": c, "total_ms": t / 1e6,
                          "self_ms": s / 1e6}
                      for k, (c, t, s) in sorted(sums.items())},
            "counters": {k: dict(v) for k, v in _counters.items()}}


def units() -> list:
    """The kept units, oldest first: [(unit id, [(span id, name, start ns,
    end ns, parent span id, unit id, thread id)])], each unit's spans in
    the order they ended."""
    with _lock:
        return [(u, list(recs)) for u, recs in _units]


def export(path: str) -> None:
    """Writes the kept spans (every kept unit's, then those outside any
    unit) as Chrome-trace JSON (chrome://tracing, Perfetto), with
    `summary()` as the trace's metadata ("otherData")."""
    with _lock:
        recs = [r for _, rs in _units for r in rs] + list(_loose)
    events = [{"name": name, "ph": "X", "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
               "pid": 0, "tid": tid,
               "args": {"id": sid, "parent": parent, "unit": unit}}
              for sid, name, t0, t1, parent, unit, tid in recs]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": summary()}, f)


class PhaseTimer:
    """Named wall-clock phases (loading / filling / creating / rendering)."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0)

    def log(self):
        for name, secs in self.seconds.items():
            logger.info("Time in %s: %.3f secs", name, secs)


class RunMetrics:
    """Accumulates per-run metrics and emits them as one JSON object."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self.data: Dict[str, object] = {}
        self.jsonl_path = jsonl_path

    def update(self, **kwargs):
        self.data.update(kwargs)

    def rays_per_second(self, total_rays: int, render_seconds: float):
        rps = total_rays / max(render_seconds, 1e-12)
        self.update(total_rays=total_rays, render_seconds=render_seconds,
                    rays_per_second=rps,
                    mrays_per_second=rps / 1e6)
        # The reference's log line (C_wrapper.cpp:256).
        logger.info("Total Millions rays per second = %s", rps / 1e6)
        return rps

    def emit(self) -> str:
        line = json.dumps(self.data)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(line + "\n")
        return line
