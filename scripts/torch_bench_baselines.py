#!/usr/bin/env python3
"""Runs the PyTorch port's measuring commands on the CUDA card, each as a
user runs it and three times, and prints every JSON line beside the card's
name and power limit.

    python scripts/torch_bench_baselines.py [--runs N] [--timeout S] [NAME ...]

NAME is one of (default: all, in this order):
  whitted    python -m mobileraytracer_tpu_torch.bench           (BASELINE #3)
  pathtracer python -m mobileraytracer_tpu_torch.bench --shader 2 --spp 16
             --reps 2                  (BASELINE #4, 2 chunks a sample)
  grid       python -m mobileraytracer_tpu_torch.bench --acc 2 --size 256
  grad       python -m mobileraytracer_tpu_torch.bench_grad       (BASELINE #5)
  grad1920   python -m mobileraytracer_tpu_torch.bench_grad --size 1920

Each line printed is one JSON object {"name", "run", "argv", "seconds" (the
invocation's host clock, start-up included), "card", "line" (the command's
JSON line; null when it failed), "stdout" (the lines before it), "rc"}.
Imports no jax.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import card_name  # noqa: E402
COMMANDS = {
    "whitted": ("bench", []),
    "pathtracer": ("bench", ["--shader", "2", "--spp", "16", "--reps", "2"]),
    "grid": ("bench", ["--acc", "2", "--size", "256"]),
    "grad": ("bench_grad", []),
    "grad1920": ("bench_grad", ["--size", "1920"]),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", help=" ".join(COMMANDS))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds an invocation may take")
    args = ap.parse_args()
    names = args.names or list(COMMANDS)
    if set(names) - set(COMMANDS):
        ap.error(f"unknown names {sorted(set(names) - set(COMMANDS))}")
    failed = 0
    for name in names:
        module, flags = COMMANDS[name]
        argv = [sys.executable, "-m", f"mobileraytracer_tpu_torch.{module}",
                *flags]
        for run in range(args.runs):
            t0 = time.perf_counter()
            try:
                p = subprocess.run(argv, cwd=ROOT, capture_output=True,
                                   text=True, timeout=args.timeout)
                rc, lines, err = (p.returncode, p.stdout.strip().splitlines(),
                                  p.stderr)
            except subprocess.TimeoutExpired:
                rc, lines, err = "timeout", [], ""
            rec = dict(name=name, run=run, argv=argv[1:],
                       seconds=time.perf_counter() - t0, card=card_name(),
                       line=json.loads(lines[-1]) if rc == 0 else None,
                       stdout=lines[:-1] if rc == 0 else lines, rc=rc)
            print(json.dumps(rec), flush=True)
            if rc != 0:
                failed += 1
                print(err[-3000:], file=sys.stderr, flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
