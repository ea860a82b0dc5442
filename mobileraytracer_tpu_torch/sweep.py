"""Scenes x shaders x accelerators through the Renderer, one .dat row each
(port of the JAX package's scripts/sweep.py, with its flags and its file).

    python -m mobileraytracer_tpu_torch.sweep          # 8 rows at 256x256
    python -m mobileraytracer_tpu_torch.sweep --scenes 0 --accs 1 2 3
    python -m mobileraytracer_tpu_torch.sweep --cpu --size 16 --reps 1

It is the analogue of the reference's scripts/profile.sh (sweeps
REPETITIONS x SHADERS x SCENES x ACCELERATORS at a fixed resolution and
parses the output into .dat files; profile.sh:181-205, 354-385).  Each
configuration builds a Renderer on a builtin scene with the scene's
DepthMap far point, renders once outside the timing, then `reps` times
reset() + render(), and keeps the median render_seconds and the last
rep's total_rays.  The file has one whitespace-delimited row per
configuration:

    # scene shader accelerator spp spl width height rep render_s mrays_s
    0 1 3 1 1 256 256 3 0.0123 1.2345

It runs on the CUDA card, and raises where there is none, unless --cpu
asks for the CPU.
"""
from __future__ import annotations

import argparse
from typing import NamedTuple, Sequence

from . import scenes
from .renderer import Renderer
from .types import RenderConfig, entry_device

HEADER = ("# scene shader accelerator spp spl width height rep render_s "
          "mrays_s\n")


class Row(NamedTuple):
    scene: int
    shader: int
    accelerator: int
    spp: int
    spl: int
    width: int
    height: int
    rep: int
    render_s: float
    mrays_s: float
    total_rays: int


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mobileraytracer_tpu_torch.sweep",
        description="median render seconds and M rays/s of builtin scenes "
                    "x shaders x accelerators, one .dat row each")
    ap.add_argument("--scenes", type=int, nargs="+", default=[0, 2])
    ap.add_argument("--shaders", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--accs", type=int, nargs="+", default=[1, 3])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--spl", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="sweep.dat")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    return ap


def sweep(scene_ids: Sequence[int], shaders: Sequence[int],
          accs: Sequence[int], size: int, spp: int, spl: int, reps: int,
          device=None) -> list[Row]:
    """One Row per (scene, shader, accelerator), in that nesting order,
    each printed as a line as it finishes."""
    device = entry_device(device)
    rows = []
    for scene_id in scene_ids:
        scene, cam = scenes.load_builtin(scene_id, 1.0)
        for shader in shaders:
            for acc in accs:
                cfg = RenderConfig(width=size, height=size, spp=spp,
                                   samples_light=spl, shader=shader,
                                   accelerator=acc, scene_id=scene_id)
                r = Renderer(scene, cam, cfg,
                             max_point=scenes.DEPTHMAP_MAX_POINT[scene_id],
                             device=device)
                r.render()                  # warm-up, outside the reps
                times, rays = [], 0
                for _ in range(reps):
                    r.reset()
                    r.render()
                    times.append(r.render_seconds)
                    rays = r.total_rays
                med = sorted(times)[len(times) // 2]
                mrays = rays / med / 1e6
                rows.append(Row(scene_id, shader, acc, spp, spl, cfg.width,
                                cfg.height, reps, med, mrays, rays))
                print(f"scene={scene_id} shader={shader} acc={acc}: "
                      f"median {med:.3f}s, {mrays:.3f} Mrays/s", flush=True)
    return rows


def write_dat(rows: Sequence[Row], path: str):
    """The JAX sweep's file: eight integer columns, then render_s and
    mrays_s to 4 decimals."""
    with open(path, "w") as f:
        f.write(HEADER)
        for row in rows:
            f.write(" ".join(str(x) for x in row[:8])
                    + f" {row.render_s:.4f} {row.mrays_s:.4f}\n")


def main(argv=None):
    """Runs the sweep for the command line's flags, writes the file and
    returns the rows."""
    args = build_parser().parse_args(argv)
    rows = sweep(args.scenes, args.shaders, args.accs, args.size, args.spp,
                 args.spl, args.reps, device="cpu" if args.cpu else None)
    write_dat(rows, args.out)
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
