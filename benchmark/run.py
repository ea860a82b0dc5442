"""Runs one benchmark cell once and prints its result as the last line of
standard output, one JSON object:

    python3 -m benchmark.run --workload conference-512.whitted \
        --seed 7 --seconds 45 --trace 0

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for; without them it prints nothing on standard output and
exits with 2.  `--trace 0` reports the cell's end-to-end metrics, `--trace
1` its per-layer metrics, from a traced sub-window after the window.
Earlier lines give the kernel library's build seconds and the card's name,
power limit and clocks; the last lines of standard error give each number
that the check compared, beside its limit.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Fixed cache directories inside the checkout, so that only a checkout's
# first run builds or compiles anything.
CACHES = {"TRITON_CACHE_DIR": "build/triton_cache",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions"}


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> str:
    """The card's name, power limit and clocks from nvidia-smi."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return f"{q}: {out.stdout.strip()}"


def main(argv=None) -> int:
    args = parse(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    from benchmark import harness, trace

    import torch
    spec = harness.load_spec(ROOT)
    cell = harness.cell(args.workload, ROOT, spec)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)

    def profile(driver, first):
        return trace.profile_units(driver, first,
                                   cell.traffic["profile_units"])

    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", STARTED, device_kind=kind,
                           profile=profile)
    from mobileraytracer_tpu_torch.ops import _build
    print(f"# kernel library: built={_build.BUILD_INFO['built']} "
          f"seconds={_build.BUILD_INFO['seconds']}", flush=True)
    ms = sorted((e - s) * 1e3 for s, e, _ in res["run"].units)
    print(f"# window: {len(ms)} units, unit ms min {ms[0]:.3f} median "
          f"{ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}; run "
          f"{time.perf_counter() - STARTED:.3f} s from start", flush=True)
    print(f"# {card_line()}", flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    tr = res["run"].trace
    if tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
        print(f"# traced sub-window: {tr['units']} units after the window",
              flush=True)
    line["checks"] = res["checks"]
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
