"""The traced sub-window: a few units under torch.profiler after the
measured window, with host spans around the calls into each layer.

Spans are `record_function` ranges put around the port's functions that
the driver names (its `spans`); they add no synchronisation, so the
device's idle time is the program's own.  From the trace:

  * busy_s: the union of the device's activity (kernels, copies, sets)
    inside the sub-window; window_s: the sub-window's length;
  * device_ops: device seconds by operation name, largest first;
  * idle_gaps: the device's idle seconds inside the sub-window, summed by
    the innermost benchmark span open on the host at each gap's middle.
"""
from __future__ import annotations

import contextlib
import importlib

SUBWINDOW = "bench.subwindow"
UNIT = "bench.unit"
TOP = 10
NAME_CHARS = 120     # device operation names are cut to this length


@contextlib.contextmanager
def spans(targets):
    """Wraps each (module, function, span name) in a record_function range
    for the duration of the block."""
    from torch.profiler import record_function

    saved = []
    for mod_name, fn_name, label in targets:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def wrapped(*a, __fn=fn, __label=label, **k):
            with record_function(__label):
                return __fn(*a, **k)
        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, wrapped)
    try:
        yield
    finally:
        for mod, fn_name, fn in reversed(saved):
            setattr(mod, fn_name, fn)


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def summarize(device_events, host_spans, window):
    """busy/idle/breakdown of one sub-window from plain tuples: device
    events (name, start, end), host spans (name, start, end) and the
    window (start, end), all in one clock's seconds."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1)) for _, s, e in device_events
               if e > w0 and s < w1]
    busy = merge(clipped)
    busy_s = sum(e - s for s, e in busy)
    by_name = {}
    for name, s, e in device_events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < w1:
        gaps.append((cur, w1))
    idle = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        open_ = [(s, name) for name, s, e in host_spans if s <= mid <= e]
        label = max(open_)[1] if open_ else "none"
        idle[label] = idle.get(label, 0.0) + (g1 - g0)
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": w1 - w0, "device_by_name": by_name,
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def idle_share(run):
    """The share of the traced sub-window in which no operation ran on the
    card: 1 - (union of device activity) / (the sub-window's length), in
    percent; None where the run was not traced or saw no device work."""
    tr = run.trace
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def profile_units(driver, first: int, n: int) -> dict:
    """Units first .. first + n - 1 of the driver under the profiler, with
    the driver's scene queries recorded; returns summarize()'s dict plus
    the sub-window's units."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    labels = {label for _, _, label in driver.spans} | {SUBWINDOW, UNIT}
    driver.record_queries(True)
    with spans(driver.spans), profile(activities=acts) as prof:
        with record_function(SUBWINDOW):
            for i in range(first, first + n):
                with record_function(UNIT):
                    driver.unit(i, keep=False)
    device, host, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) \
                    and e.name not in labels:
                device.append((e.name[:NAME_CHARS], s, t))
        elif e.name in labels:
            host.append((e.name, s, t))
            if e.name == SUBWINDOW:
                window = (s, t)
    out = summarize(device, host, window)
    out["units"] = n
    out["queries"] = driver.queries
    driver.record_queries(False)
    return out
