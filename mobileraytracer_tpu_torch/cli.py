"""Command-line front end (port of the JAX package's cli.py) with the
reference's 15-value positional contract (reference
app/System_dependent/Native/Qt/MobileRT/main.cpp:9-63: THREADS SHADER
SCENE SPP SPL WIDTH HEIGHT ACC REP OBJ MTL CAM PRINT ASYNC SHOWIMAGE) and
the same named flags.

Positional mode, as the reference's benchmark scripts call it:

    python -m mobileraytracer_tpu_torch.cli 1 1 0 1 1 512 512 3 1 - - - true false out.png

Named mode, an OBJ scene:

    python -m mobileraytracer_tpu_torch.cli --scene 4 --obj scene.obj \
        --shader 1 --spp 1 --width 512 --height 512 --acc 3 --out scene.png

It renders on the CUDA card, and raises when there is none, unless
`--cpu` asks for the CPU.  THREADS is accepted and ignored: the card owns
the parallelism.  The metrics line (one JSON object, with the
reference's rays_per_second) goes to stdout unless PRINT is false
(--quiet), and is appended to --metrics-jsonl.  `--spans PATH` turns the
tracer on (utils/metrics.py), writes its spans to PATH as Chrome-trace
JSON, and adds its summary to the metrics line under "trace".
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np

from . import constants as C
from .types import RenderConfig
from .utils import metrics as tracer
from .utils.metrics import PhaseTimer, RunMetrics

logger = logging.getLogger("mobileraytracer_tpu_torch")


def _parse_bool(s: str) -> bool:
    return str(s).strip().lower() in ("true", "1", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mobileraytracer_tpu_torch",
        description="The ray tracer on PyTorch and CUDA "
                    "(MobileRT capability surface)")
    p.add_argument("positional", nargs="*",
                   help="reference-compatible 15 positional values: THREADS "
                        "SHADER SCENE SPP SPL WIDTH HEIGHT ACC REP OBJ MTL "
                        "CAM PRINT ASYNC SHOWIMAGE|OUT.png")
    p.add_argument("--threads", type=int, default=1,
                   help="ignored; the card owns parallelism")
    p.add_argument("--shader", type=int, default=C.SHADER_WHITTED,
                   help="0=NoShadows 1=Whitted 2=PathTracer 3=DepthMap "
                        "4=DiffuseMaterial")
    p.add_argument("--scene", type=int, default=C.SCENE_CORNELL,
                   help="0=Cornell 1=Spheres 2=Cornell2 3=Spheres2 "
                        "else=OBJ")
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--spl", type=int, default=1)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--acc", type=int, default=C.ACC_BVH,
                   help="0/1=Naive 2=RegularGrid 3=BVH")
    p.add_argument("--rep", type=int, default=1)
    p.add_argument("--obj", default="")
    p.add_argument("--mtl", default="")
    p.add_argument("--cam", default="")
    p.add_argument("--out", default="",
                   help="output PNG path ('' = don't save)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (default: the CUDA card)")
    p.add_argument("--metrics-jsonl", default="",
                   help="append run metrics to this JSONL file")
    p.add_argument("--spans", default="",
                   help="trace the run: write its spans to this file as "
                        "Chrome-trace JSON ('' = no tracing)")
    return p


def _apply_positional(args) -> None:
    pos = args.positional
    if not pos:
        return
    if len(pos) != 15:
        raise SystemExit(
            f"positional mode needs exactly 15 values, got {len(pos)} "
            "(THREADS SHADER SCENE SPP SPL WIDTH HEIGHT ACC REP OBJ MTL CAM "
            "PRINT ASYNC SHOWIMAGE)")
    (threads, shader, scene, spp, spl, width, height, acc, rep,
     obj, mtl, cam, print_out, _async, show) = pos
    args.threads = int(threads)
    args.shader = int(shader)
    args.scene = int(scene)
    args.spp = int(spp)
    args.spl = int(spl)
    args.width = int(width)
    args.height = int(height)
    args.acc = int(acc)
    args.rep = int(rep)
    args.obj = "" if obj in ("-", "") else obj
    args.mtl = "" if mtl in ("-", "") else mtl
    args.cam = "" if cam in ("-", "") else cam
    args.quiet = not _parse_bool(print_out)
    # SHOWIMAGE slot doubles as the output path when it is not a boolean.
    if show.lower() not in ("true", "false", "0", "1", "yes", "no"):
        args.out = show


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _apply_positional(args)
    logging.basicConfig(
        level=logging.WARNING if args.quiet else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s")

    from . import scenes as builtin_scenes
    from .loaders import load_camera_file
    from .loaders.obj import load_obj_scene_ex
    from .renderer import Renderer

    timer = PhaseTimer()
    metrics = RunMetrics(args.metrics_jsonl or None)
    if args.spans:
        tracer.reset()
        tracer.enable()

    ratio = args.width / max(args.height, 1)
    max_point = None
    if args.scene in (C.SCENE_CORNELL, C.SCENE_SPHERES, C.SCENE_CORNELL2,
                      C.SCENE_SPHERES2) and not args.obj:
        with timer.phase("filling"):
            scene, camera = builtin_scenes.load_builtin(args.scene, ratio)
        max_point = builtin_scenes.DEPTHMAP_MAX_POINT[args.scene]
        info = {"builtin": args.scene}
    else:
        if not args.obj:
            raise SystemExit("OBJ scene selected but no --obj path given")
        with timer.phase("loading"):
            scene, info = load_obj_scene_ex(args.obj, args.mtl or None)
        with timer.phase("filling"):
            camera = load_camera_file(args.cam, ratio) if args.cam else \
                builtin_scenes.cornell_box_camera(ratio)
        max_point = builtin_scenes.DEPTHMAP_MAX_POINT[C.SCENE_OBJ]

    config = RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        samples_light=args.spl, shader=args.shader, accelerator=args.acc,
        scene_id=args.scene, repeats=args.rep, seed=args.seed).rounded()

    with timer.phase("creating"):
        renderer = Renderer(scene, camera, config, max_point=max_point,
                            device="cpu" if args.cpu else None)

    image = None
    total_rays = 0
    render_secs = 0.0
    for rep in range(max(args.rep, 1)):
        renderer.reset()
        with timer.phase("rendering"):
            image = renderer.render()
        total_rays += renderer.total_rays
        render_secs += renderer.render_seconds
        logger.info("repetition %d: %d rays in %.3fs",
                    rep + 1, renderer.total_rays, renderer.render_seconds)

    timer.log()
    metrics.update(shader=args.shader, scene=args.scene, spp=args.spp,
                   spl=args.spl, width=config.width, height=config.height,
                   accelerator=args.acc, repeats=args.rep, **info,
                   **{f"secs_{k}": v for k, v in timer.seconds.items()})
    metrics.rays_per_second(total_rays, render_secs)
    if args.spans:
        tracer.disable()
        tracer.export(args.spans)
        metrics.update(trace=tracer.summary())
    line = metrics.emit()
    if not args.quiet:
        print(line)

    if args.out and image is not None:
        try:
            from PIL import Image
        except ImportError:
            logger.warning("PIL missing; cannot save %s", args.out)
        else:
            Image.fromarray(
                (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)
            ).save(args.out)
            logger.info("wrote %s", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
