"""Readings that the check's limits are set from, for one cell, in one
process: the program's counts on many seeds (a few frames each, compared
with the plain reference as a run compares them), and the control's: the
reference computed in bfloat16, the precision below the configuration's
float32, put in the program's place.

    python3 -m benchmark.calibrate --workload conference-512.whitted \
        --seeds 11 12 13 --control-seeds 21 22 23 --frames 3

The cell's entry gives the units (`unit`), the check (`check`) and the
control's numbers (`control`).

Prints one JSON line per seed, then a summary line with the largest
program reading and the smallest control reading of each count.
"""
import argparse
import json
import sys
import time

import torch

from benchmark import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--frames", type=int, default=3,
                    help="units a seed (frames or calls)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    seeds = args.seeds + args.control_seeds
    driver = cell.entry().Driver(cell.config, cell.traffic, seeds[0],
                                 "cuda")
    driver.setup()
    prog, ctrl = {}, {}
    for seed in args.seeds:
        driver.reseed(seed)
        for i in range(args.frames):
            driver.unit(i)
        t0 = time.perf_counter()
        counts = driver.check()
        print(json.dumps({"seed": seed, "program": counts,
                          "check_s": time.perf_counter() - t0}), flush=True)
        for k, v in counts.items():
            prog[k] = max(prog.get(k, 0), v)
    for seed in args.control_seeds:
        driver.reseed(seed)
        worst = {}
        t0 = time.perf_counter()
        for i in range(args.frames):
            for k, v in driver.control(i).items():
                worst[k] = max(worst.get(k, 0), v)
        print(json.dumps({"seed": seed, "control": worst,
                          "control_s": time.perf_counter() - t0}), flush=True)
        for k, v in worst.items():
            ctrl[k] = min(ctrl.get(k, v), v)
    print(json.dumps({"program_max": prog, "control_min": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
