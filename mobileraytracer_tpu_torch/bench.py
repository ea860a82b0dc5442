"""Rays/s of a conference frame, printed as one JSON line (port of the JAX
package's bench.py, with its flags and its estimator).

    python -m mobileraytracer_tpu_torch.bench                     # BASELINE #3
    python -m mobileraytracer_tpu_torch.bench --shader 2 --spp 16 # BASELINE #4
    python -m mobileraytracer_tpu_torch.bench --acc 2 --size 256  # the grid
    python -m mobileraytracer_tpu_torch.bench --cpu --size 16     # no card

The metric is the reference's: casted rays (camera, secondary and shadow)
over frame time (C_wrapper.cpp:256).  The scene is the procedural
conference proxy (331,179 triangles, 2 area lights), Whitted over the block
BVH at 512x512, 1 spp, nee_share 128 and secondary sharing on, unless the
flags say otherwise.  Frames render through render_frame_auto: one pass
a sample up to renderer.DISPATCH_UNIT_BUDGET, lane chunks above it, as the
JAX bench renders them, so the frame is the JAX package's.  Unlike the JAX
bench, a --size that is not a multiple of 16 is rounded down below the
budget too (RenderConfig.rounded).

Frame i has key fold_in(prng_key(0), i).  Timing: one warm-up frame, then
T(1) and T(reps) by the host clock, each between two synchronizes of the
card; frame time = (T(reps) - T(1)) / (reps - 1), which removes the cost a
timed call pays once.  It runs on the CUDA card, and raises where there is
none, unless --cpu asks for the CPU.  The JSON line's vs_baseline is null:
no target is set for the card; it also carries the rays per frame, the
seconds per frame and the device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from . import constants as C
from . import sampling
from .bench_scenes import conference_proxy
from .ops import block_traversal, grid
from .renderer import render_frame_auto
from .types import RenderConfig, entry_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mobileraytracer_tpu_torch.bench",
        description="rays/s of a conference proxy frame, one JSON line")
    ap.add_argument("--shader", type=int, default=None,
                    help="shader id (default Whitted=1; 2=PathTracer)")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--spl", type=int, default=1)
    ap.add_argument("--acc", type=int, default=None,
                    help="accelerator id (default BVH=3; 2=RegularGrid)")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=None,
                    help="frames per timing (default: 9 at 1 spp, 3 "
                         "otherwise)")
    ap.add_argument("--no-share2", action="store_true",
                    help="disable secondary-bounce NEE sharing (default on)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    return ap


def synchronizer(device: torch.device):
    """Waits for the device's queued work; nothing to wait for on the CPU."""
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run(args: argparse.Namespace):
    """The bench's frames for parsed flags.  Returns (rays per frame,
    seconds per frame, the last timed frame's dict)."""
    device = entry_device("cpu" if args.cpu else None)
    shader = C.SHADER_WHITTED if args.shader is None else args.shader
    acc = C.ACC_BVH if args.acc is None else args.acc

    scene, cam, _ = conference_proxy()
    if acc == C.ACC_BVH:
        scene = block_traversal.build(scene, device=device)
    elif acc == C.ACC_REGULAR_GRID:
        scene = grid.build_grid(scene, device=device)
    else:
        scene = scene.to(device)
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       samples_light=args.spl, shader=shader,
                       accelerator=acc, nee_share=128,
                       nee_share_secondary=not args.no_share2)
    key = sampling.prng_key(0, device)
    sync = synchronizer(device)

    def frames(n):
        rays = torch.zeros((), dtype=torch.int32, device=device)
        for i in range(n):
            out = render_frame_auto(scene, cam, cfg, sampling.fold_in(key, i))
            rays = rays + out["rays"]
        return out, rays

    def timed(n):
        sync()
        t0 = time.perf_counter()
        out, rays = frames(n)
        sync()
        return time.perf_counter() - t0, out, int(rays)

    frames(1)
    t1, _, _ = timed(1)
    reps = args.reps or (9 if args.spp <= 1 else 3)
    tn, out, total_rays = timed(reps)
    return total_rays // reps, (tn - t1) / (reps - 1), out


def main(argv=None):
    """Prints the JSON line; returns run()'s result."""
    args = build_parser().parse_args(argv)
    rays, dt, out = run(args)
    print(json.dumps({
        "metric": "rays_per_second",
        "value": rays / dt,
        "unit": "rays/s",
        "vs_baseline": None,
        "rays_per_frame": rays,
        "seconds_per_frame": dt,
        "device": device_name(out["image"].device),
    }), flush=True)
    return rays, dt, out


if __name__ == "__main__":
    main()
