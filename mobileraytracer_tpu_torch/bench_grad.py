"""Vertex-gradient throughput (Mpixel-grads/s), printed as one JSON line
(port of the JAX package's bench_grad.py, with its flags and its
estimator).

    python -m mobileraytracer_tpu_torch.bench_grad               # BASELINE #5
    python -m mobileraytracer_tpu_torch.bench_grad --size 1920   # 1920^2
    python -m mobileraytracer_tpu_torch.bench_grad --small       # cornell2
    python -m mobileraytracer_tpu_torch.bench_grad --cpu --small --size 16

Default workload: the conference proxy (331,179 triangles), Whitted over
the block BVH at 512x512, nee_share 128: diff.vertex_grad of the mean
image with 8 samples an edge, silhouette edges drawn by length importance
(--edge-budget) under the edge_topology mask, and the NEE shadow-edge term
(--shadow-budget).  The mask is taken before the block build reorders the
triangles, as the JAX bench_grad.py takes it, so it indexes other rows
than the ones it culls; the frames stay the JAX bench's.  `--small` is
cornell2 over the naive scan at 256x256 with every edge.  Frames above
512x512 run the interior in chunks of 256k pixels unless --chunk says
otherwise.

Call i has key fold_in(prng_key(0), i).  Timing: one warm-up call, then
T(1) and T(5) by the host clock, each between two synchronizes of the
card; seconds per call = (T(5) - T(1)) / 4, and the metric is pixels over
that.  It runs on the CUDA card, and raises where there is none, unless
--cpu asks for the CPU.  The JSON line also carries the seconds per call,
the device and the peak device memory allocated over the run (null on
the CPU).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from . import constants as C
from . import sampling, scenes
from .bench import device_name, synchronizer
from .bench_scenes import conference_proxy
from .diff.geom import edge_topology, vertex_grad
from .ops import block_traversal
from .types import RenderConfig, entry_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mobileraytracer_tpu_torch.bench_grad",
        description="vertex-gradient Mpixel-grads/s, one JSON line")
    ap.add_argument("--small", action="store_true",
                    help="cornell2, naive scan, 256^2")
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--edge-budget", type=int, default=4096)
    ap.add_argument("--shadow-budget", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=None,
                    help="interior pixel chunk (default: 256k pixels for "
                         "frames above 512^2)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    return ap


def workload(args: argparse.Namespace, device: torch.device):
    """(scene, camera, config, vertex_grad keyword arguments) of the
    flags; prints the kept edges of the default workload."""
    if args.small:
        scene, cam = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
        scene = scene.to(device)
        size = args.size or 256
        cfg = RenderConfig(width=size, height=size, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_NAIVE,
                           scene_id=C.SCENE_CORNELL2)
        kwargs = {}
    else:
        scene, cam, _ = conference_proxy()
        keep = edge_topology(scene.triangles)
        scene = block_traversal.build(scene, device=device)
        size = args.size or 512
        cfg = RenderConfig(width=size, height=size, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                           nee_share=128)
        kwargs = dict(edge_keep=keep, edge_budget=args.edge_budget,
                      shadow_edges=True, shadow_budget=args.shadow_budget)
        print(f"# edges kept: {int(keep.sum())} / {keep.size}", flush=True)
    chunk = args.chunk
    if chunk is None and size * size > 512 * 512:
        chunk = 256 * 1024
    if chunk:
        kwargs["pixel_chunk"] = chunk
    return scene, cam, cfg, kwargs


def run(args: argparse.Namespace):
    """The bench's calls for parsed flags.  Returns (the last timed call's
    loss, its gradients, seconds per call, the config)."""
    device = entry_device("cpu" if args.cpu else None)
    scene, cam, cfg, kwargs = workload(args, device)
    key = sampling.prng_key(0, device)
    sync = synchronizer(device)

    def calls(n):
        for i in range(n):
            loss, grads = vertex_grad(scene, cam, cfg,
                                      sampling.fold_in(key, i),
                                      edge_samples=8, **kwargs)
        return loss, grads

    def timed(n):
        sync()
        t0 = time.perf_counter()
        out = calls(n)
        sync()
        return time.perf_counter() - t0, out

    calls(1)
    t1, _ = timed(1)
    reps = 4
    tn, (loss, grads) = timed(reps + 1)
    return loss, grads, max((tn - t1) / reps, 1e-9), cfg


def main(argv=None):
    """Prints the JSON line; returns run()'s result."""
    args = build_parser().parse_args(argv)
    loss, grads, dt, cfg = run(args)
    dev = loss.device
    mpx = cfg.width * cfg.height / dt / 1e6
    print(json.dumps({
        "metric": "mpixel_grads_per_second",
        "value": mpx,
        "unit": "Mpixel-grads/s",
        "vs_baseline": mpx,
        "seconds_per_call": dt,
        "device": device_name(dev),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    }), flush=True)
    return loss, grads, dt, cfg


if __name__ == "__main__":
    main()
