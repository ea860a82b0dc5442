#!/usr/bin/env python3
"""What the port's tracer (mobileraytracer_tpu_torch/utils/metrics.py)
costs and covers on one NVIDIA GPU, on the benchmark's two cells
(benchmark/entries: the conference Whitted frame and the vertex_grad
call, set up as the benchmark sets them up), in one process:

    python scripts/torch_tracer_cost.py [--frames 60] [--calls 4]
        [--out build/tracer_cost.json]

  * off: ns a span (`with span(...)`, a decorated call) against the bare
    statement, micro-benchmarked; on, without a profiler, the same;
  * on against off: pairs of frames (calls), one unit of each pair with
    the tracer off and one with it on, each timed as the benchmark times it
    (from the call until its result is on the host); the median of the
    pairs' differences, in ms and %;
  * with the tracer on: the share of the units' wall time that the root
    spans cover, the largest gap between a kept unit's summed self times
    and its root's duration, the per-layer numbers the benchmark reads
    (per sample or call), and the spans of the last units as Chrome-trace
    JSON beside --out;
  * one unit of each cell under torch.cuda.set_sync_debug_mode("warn"):
    every synchronizing operation, by the port's innermost source line
    that led to it, beside the explicit reads that SYNCS counted.

Prints one JSON line a section and writes them all to --out, with the
card's name and power limit.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
import traceback
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]
# In place of this script's directory, whose profile.py would shadow the
# standard library's module that torch imports on demand.
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from mobileraytracer_tpu_torch.utils import metrics  # noqa: E402

CELLS = {"whitted": "conference-512.whitted",
         "grad": "conference-vgrad-512.grad"}
PORT = str(ROOT / "mobileraytracer_tpu_torch")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip()


def per_op_ns(stmt, n=200_000) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        stmt()
    return (time.perf_counter_ns() - t0) / n


def micro() -> dict:
    """ns a span, tracer off and on (no profiler), less the bare call."""
    def bare():
        pass

    def with_span():
        with metrics.span("bench.micro"):
            pass

    decorated = metrics.span("bench.micro")(bare)
    out = {}
    for state in ("off", "on"):
        (metrics.enable if state == "on" else metrics.disable)()
        for _ in range(2):                       # warm
            base = per_op_ns(bare)
            ctx = per_op_ns(with_span)
            deco = per_op_ns(decorated)
        out[state] = {"bare_call_ns": base, "with_span_ns": ctx - base,
                      "decorated_call_ns": deco - base}
    metrics.disable()
    metrics.reset()
    return out


def driver(name: str, seed: int):
    cell = harness.cell(CELLS[name])
    d = cell.entry().Driver(cell.config, cell.traffic, seed, "cuda")
    d.setup()
    return d


def timed(d, i) -> float:
    t0 = time.perf_counter_ns()
    d.unit(i, keep=False)
    return (time.perf_counter_ns() - t0) / 1e6


def unit_gaps(kept) -> float:
    """The largest |sum of a unit's self times - its root's duration|
    over the root's duration, over the kept units."""
    worst = 0.0
    for _, recs in kept:
        dur = {r[0]: r[3] - r[2] for r in recs}
        child = {}
        for r in recs:
            child[r[4]] = child.get(r[4], 0) + dur[r[0]]
        selfs = sum(dur[r[0]] - child.get(r[0], 0) for r in recs)
        root = next(r for r in recs if r[4] is None)
        worst = max(worst, abs(selfs - dur[root[0]]) / dur[root[0]])
    return worst


def layer_numbers(spans: dict, syncs: int, n: int) -> dict:
    def tot(pred, kind):
        return sum(v[kind] for k, v in spans.items() if pred(k)) / n

    def layer(name):
        return lambda k: k.startswith(name + ".") and k != name + ".sync"
    return {
        "frame.pixel_order_ms": tot(lambda k: k == "frame._pixel_order",
                                    "total_ms"),
        "frame.self_ms": tot(lambda k: k == "frame.render_frame", "self_ms"),
        "walker.self_ms": tot(layer("walker"), "self_ms"),
        "block_traversal.self_ms": tot(layer("traversal"), "self_ms"),
        "block_traversal.sync_wait_ms": tot(lambda k: k == "traversal.sync",
                                            "total_ms"),
        "block_traversal.syncs": syncs / n,
        "kernels.self_ms": tot(lambda k: k.startswith("kernels."),
                               "self_ms"),
        "gradients.self_ms": tot(layer("gradients"), "self_ms"),
        "walker.sync_ms": tot(lambda k: k == "walker.sync", "total_ms"),
        "frame.sync_ms": tot(lambda k: k == "frame.sync", "total_ms"),
    }


def ab(name, d, pairs, export) -> dict:
    """`pairs` pairs of units, one with the tracer off and one with it on,
    which goes first alternating, so that the host's drift over minutes
    cancels within a pair."""
    root = "gradients.vertex_grad" if name == "grad" else \
        "frame.render_frame"
    off, on, diff = [], [], []
    metrics.reset()
    syncs0 = metrics.SYNCS["traversal"]
    i = 1
    for k in range(pairs):
        t = {}
        for state in (("off", "on") if k % 2 == 0 else ("on", "off")):
            (metrics.enable if state == "on" else metrics.disable)()
            t[state] = timed(d, i)
            i += 1
        metrics.disable()
        off.append(t["off"])
        on.append(t["on"])
        diff.append(t["on"] - t["off"])
    s = metrics.summary()["spans"]
    spans = sum(v["count"] for v in s.values()) / pairs
    q = statistics.quantiles(diff, n=4)
    m_off = statistics.median(off)
    res = {"cell": CELLS[name], "pairs": pairs, "units_off": off,
           "units_on": on, "median_off_ms": m_off,
           "median_on_ms": statistics.median(on),
           "on_cost_ms": statistics.median(diff), "on_cost_q_ms": [q[0], q[2]],
           "on_cost_pct": 100.0 * statistics.median(diff) / m_off,
           "spans_per_unit": spans,
           "root_cover": s[root]["total_ms"] / sum(on),
           "self_sum_gap": unit_gaps(metrics.units()),
           # SYNCS counts in both units of a pair.
           "layers": layer_numbers(
               s, (metrics.SYNCS["traversal"] - syncs0) / 2, pairs)}
    metrics.export(export)
    return res


def sync_sites(d, i) -> dict:
    """One unit under set_sync_debug_mode("warn"): each synchronizing
    operation by the innermost frame of the port (or of the caller) on
    the stack when it warned."""
    sites = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if f.filename.startswith(PORT)
                and not f.filename.endswith("metrics.py")]
        f = (port or [f for f in stack
                      if "site-packages" not in f.filename
                      and "warnings" not in f.filename] or stack)[-1]
        key = (f"{pathlib.Path(f.filename).relative_to(ROOT)}:{f.lineno} "
               f"{f.name}: {f.line}") if f.filename.startswith(str(ROOT)) \
            else f"{f.filename}:{f.lineno}"
        if any(g.name == "host_value" for g in stack):
            key += " [host_value]"
        sites[key] = sites.get(key, 0) + 1

    before = dict(metrics.SYNCS)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            d.unit(i, keep=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counted = {k: metrics.SYNCS[k] - before[k] for k in before}
    return {"sites": dict(sorted(sites.items(), key=lambda kv: -kv[1])),
            "warnings": sum(sites.values()), "syncs_counted": counted}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--seed", type=int, default=2**31 + 4242)
    ap.add_argument("--out", default="build/tracer_cost.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    res = {"card": card(), "torch": torch.__version__}
    print(json.dumps(res), flush=True)
    res["micro"] = micro()
    print(json.dumps({"micro": res["micro"]}), flush=True)
    for name, per_block in (("whitted", args.frames), ("grad", args.calls)):
        d = driver(name, args.seed)
        export = str(out.with_name(f"{out.stem}_{name}_spans.json"))
        res[name] = ab(name, d, per_block, export)
        res[name]["sync_debug"] = sync_sites(d, 10_000)
        d.release()
        del d
        torch.cuda.empty_cache()
        print(json.dumps({name: {k: v for k, v in res[name].items()
                                 if k not in ("units_off", "units_on")}}),
              flush=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
