#!/usr/bin/env python3
"""The conference PathTracer frame of the PyTorch port at 16 spp on one
NVIDIA GPU (bench.py --shader 2 --spp 16), and where one sample's host
time goes.  chip_smoke.py phase 8 renders the same frame (its
`pathtracer_frame`) but cuts it to 4 spp when 16 would take over a
minute, and profiles the device; this script renders every sample and
times the walk's parts.

    python scripts/torch_pathtracer_frame.py

Prints, one line each, beside the card's name and power limit
(nvidia-smi):
  1. after a 1-spp warm-up, one 16-spp frame timed by CUDA events: ms/frame,
     rays, rays/s, walk steps, refill and dense loops and kernel launches
     (counters reset just before), and whether the image is finite;
  2. one 1-spp frame with the walk's parts timed on the host clock with
     the device synchronised around each call (so the frame runs slower):
     each part's own time, its callees' taken out, and its calls.
"""
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


class PartTimer:
    """Wraps functions so that each call's host time, the device
    synchronised at entry and exit, is charged to its part less the time
    of the wrapped calls inside it."""

    def __init__(self):
        self.own = {}
        self.calls = {}
        self.stack = []
        self.undo = []

    def wrap(self, owner, attr, name):
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.stack.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
                inner = self.stack.pop()
                self.own[name] = self.own.get(name, 0.0) + total - inner
                self.calls[name] = self.calls.get(name, 0) + 1
                if self.stack:
                    self.stack[-1] += total

        setattr(owner, attr, timed)
        self.undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self.undo):
            setattr(owner, attr, fn)


def main():
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import bench_scenes, sampling
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.ops import intersect
    from mobileraytracer_tpu_torch.ops import kernels as K
    from mobileraytracer_tpu_torch.shaders import common, engine

    if not torch.cuda.is_available():
        raise SystemExit("torch_pathtracer_frame: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    dev = torch.device("cuda:0")
    scene, cam, _ = bench_scenes.conference_proxy()
    scene = bt.build(scene, device=dev)
    key = sampling.prng_key(0, dev)

    # 1: the frame.
    t0 = time.perf_counter()
    chip_smoke.pathtracer_frame(scene, cam, key, 1)
    warm_s = time.perf_counter() - t0
    f = chip_smoke.pathtracer_frame(scene, cam, key, chip_smoke.PT_SPP)
    print(f"[frame] {chip_smoke.pathtracer_line(f)}; 1-spp warm-up "
          f"{warm_s:.2f} s [{card}]", flush=True)

    # 2: the walk's parts on the host clock.
    one_ms = chip_smoke.pathtracer_frame(scene, cam, key, 1)["ms"]
    timer = PartTimer()
    timer.wrap(engine, "trace_radiance", "walk: pops, pushes, sampling")
    timer.wrap(engine.WalkState, "map", "chunk gather")
    timer.wrap(engine, "_scatter_back", "chunk scatter-back")
    timer.wrap(engine, "_coherence_order", "coherence argsort")
    timer.wrap(engine, "_close_buckets", "close buckets")
    timer.wrap(common, "direct_lighting", "NEE sampling and shading")
    timer.wrap(common, "bind_material", "bind material")
    timer.wrap(intersect, "_fill_hit", "hit record")
    timer.wrap(bt, "_candidates", "candidate windows")
    timer.wrap(bt, "_refill_exact", "refill bookkeeping")
    timer.wrap(bt, "_banded_balanced", "banded kernel and its packing")
    timer.wrap(K, "traverse_tilemt", "tile-MT kernel")
    try:
        t0 = time.perf_counter()
        mrt.render_frame(scene, cam, chip_smoke.pt_config(1), key)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        timer.restore()
    parts = sorted(timer.own.items(), key=lambda kv: -kv[1])
    print(f"[parts] one 1-spp frame with synchronised parts: {wall:.1f} ms "
          f"(without: {one_ms:.1f} ms by CUDA events); own ms (calls): "
          + "; ".join(f"{name} {s * 1e3:.1f} ({timer.calls[name]})"
                      for name, s in parts) + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
