#!/usr/bin/env python3
"""Drives the PyTorch port's main path once on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

The main path is what bench.py renders by default: the 331,179-triangle
conference proxy, Whitted shader over the block BVH, 512x512, 1 spp,
nee_share=128, reversed NEE and nee_share_secondary=True, rendered through
`mobileraytracer_tpu_torch.render_frame`.  Phases, one line each (a failure
raises and the script exits nonzero):

  1. a CUDA device is required; the card's name and power limit;
  2. the CUDA kernels are built from csrc/ (nvcc, seconds printed);
  3. each kernel against its plain PyTorch version, bitwise, on the inputs
     the main path gives it (recorded during one 512x512 frame), plus a
     batch of mirror-bounce rays for the banded kernel's closest-hit mode;
  4. the 512x512 frame through render_frame with the launch counters reset
     just before: finite image, rays > 0, every kernel launched; and the
     tile-MT primary hits against the naive oracle on 2,048 sampled rays;
  5. the 64x64 frame of the 20,000-triangle proxy against the JAX
     package's frame committed as tests/data/torch_port_golden_conference64.npy;
  6. timing with CUDA events: ms/frame and rays/s, each kernel against its
     plain version; then one frame under torch.profiler: device busy time,
     idle share and the largest device ops.
The card's name and power limit and then the kernels' JSON record come
just before the last line, {"ok": true, "device": {...}}.
"""
import json
import pathlib
import statistics
import subprocess
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden_conference64.npy"
# Held as in tests/test_torch_render.py: the golden comes from XLA's CPU
# code (FMA-contracted arithmetic), the port rounds every operation.
IMG_ATOL = 1e-4
IMG_FRACTION = 0.999
FRAMES = 5

KERNELS = {
    "tilemt": dict(name="traverse_tilemt", route="cuda",
                   source="mobileraytracer_tpu_torch/csrc/traverse_tilemt.cu",
                   replaces="mobileraytracer_tpu/ops/pallas_bvh.py:1317"),
    "banded": dict(name="traverse_banded", route="cuda",
                   source="mobileraytracer_tpu_torch/csrc/traverse_banded.cu",
                   replaces="mobileraytracer_tpu/ops/pallas_bvh.py:441"),
}


def say(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean ms per call of fn() over `reps` calls, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_frame(render):
    """Device busy time of one frame under torch.profiler, summed over the
    device's own kernel and copy rows.  Returns (busy ms, {name: ms} of the
    largest rows)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.key] = rows.get(e.key, 0.0) + e.self_device_time_total / 1e3
    busy = sum(rows.values())
    top = dict(sorted(rows.items(), key=lambda kv: -kv[1])[:6])
    return busy, top


def main():
    # The package is imported first: a copy of this script without the
    # repository fails here, before it prints anything.
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import (bench_scenes, cameras, renderer,
                                           sampling)
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.ops import _build
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.ops import intersect as nv
    from mobileraytracer_tpu_torch.ops import kernels as K
    from mobileraytracer_tpu_torch.shaders import common, engine

    # -- 1 ------------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    dev = torch.device("cuda:0")
    say(1, f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
           f" cuda {torch.version.cuda}; nvidia-smi: {card}")

    # -- 2 ------------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    info = _build.BUILD_INFO
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    say(2, f"kernels built in {time.perf_counter() - t0:.2f} s (nvcc "
           f"{info['seconds']:.2f} s, new build: {info['built']}): "
           f"{'; '.join(regs)}")

    # -- 3 ------------------------------------------------------------------
    t0 = time.perf_counter()
    scene, cam, _ = bench_scenes.conference_proxy()
    scene = bt.build(scene, device=dev)
    cfg = mrt.RenderConfig(width=512, height=512, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                           nee_share=128, nee_share_secondary=True)
    key = sampling.prng_key(0, dev)
    say(3, f"conference proxy {int(scene.triangles.valid.sum())} triangles,"
           f" {tuple(scene.bvh.tb.shape)} blocks, built in "
           f"{time.perf_counter() - t0:.2f} s")

    captured = {}
    wrapped = {"tilemt": K.traverse_tilemt, "banded": K.traverse_banded}

    def recorder(kind, tag_fn):
        fn = wrapped[kind]

        def rec(tb, cg, ce, rays, m, any_hit):
            tag = tag_fn(any_hit)
            old = captured.get(tag)
            if old is None or rays.shape[0] > old[3].shape[0]:
                captured[tag] = (tb, cg.clone(), ce.clone(), rays.clone(), m,
                                 any_hit)
            return fn(tb, cg, ce, rays, m, any_hit)
        return rec

    K.traverse_tilemt = recorder("tilemt", lambda a: ("tilemt", "primary"))
    K.traverse_banded = recorder(
        "banded", lambda a: ("banded", "shadow (any-hit)" if a
                             else "refill (closest)"))
    try:
        out = mrt.render_frame(scene, cam, cfg, key)
        # Mirror bounces of the primary hits: the walker tail's closest-hit
        # batches (the proxy's materials are all diffuse, so the frame has
        # none of its own).
        b = cfg.width * cfg.height
        u, v, _, _ = renderer._pixel_order(cfg, dev)
        zero = torch.zeros_like(u)
        o, d = cameras.generate_rays(cam.to(dev), u, v, zero, zero)
        pk = torch.zeros(b, dtype=torch.int32, device=dev)
        pi = torch.full((b,), -1, dtype=torch.int32, device=dev)
        hit = bt.intersect_scene_blocks(scene, o, d, pk, pi, mode="tilemt")
        alive = ~hit.missed
        o2, d2 = common.park_dead_lanes(hit.point,
                                        common.reflect(d, hit.normal), alive)
        K.traverse_banded = recorder("banded",
                                     lambda a: ("banded", "mirror (closest)"))
        bt.traverse(scene.bvh, scene.triangles, o2, d2, C.RAY_LENGTH_MAX,
                    hit.prim_kind, hit.prim_id)
    finally:
        K.traverse_tilemt, K.traverse_banded = (wrapped["tilemt"],
                                                wrapped["banded"])
    torch.cuda.synchronize()

    plain = {"tilemt": K.tilemt_plain, "banded": K.banded_plain}
    err = {"tilemt": 0.0, "banded": 0.0}
    for (kind, what), args in sorted(captured.items()):
        got = wrapped[kind](*args)
        want = plain[kind](*args)
        if kind == "banded":
            got, want = torch.stack(got), torch.stack(want)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err[kind] = max(err[kind], e)
        rounds = got[:, 2] if kind == "tilemt" else got[2]
        say(3, f"{KERNELS[kind]['name']} {what}: rays {args[3].shape[0]} "
               f"m {args[4]}, rounds mean {float(rounds.mean()):.2f} max "
               f"{int(rounds.max())}; bitwise equal to plain: "
               f"{torch.equal(got, want)} (max abs err {e})")
        if not torch.equal(got, want):
            raise AssertionError(f"{kind} {what}: kernel != plain version")

    # -- 4 ------------------------------------------------------------------
    K.reset_launches()
    bt.LOOPS.update(refill=0, dense=0)
    engine.WALK["steps"] = 0
    out = mrt.render_frame(scene, cam, cfg, key)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    loops = dict(bt.LOOPS)
    img = out["image"].cpu().numpy()
    rays = int(out["rays"])
    say(4, f"512x512 frame: image {img.shape} finite {np.isfinite(img).all()}"
           f" mean {img.mean():.6f}; rays {rays}; launches {launches}; "
           f"walk steps {engine.WALK['steps']}; refill loops {loops}")
    if not (np.isfinite(img).all() and img.shape == (512, 512, 3)
            and rays > 0 and all(n > 0 for n in launches.values())):
        raise AssertionError("main path frame failed its checks")
    # Exactness of the main path's primary traversal: tile-MT plus refill
    # against the naive oracle on a sample of the frame's rays.
    t_k, id_k = bt.traverse_tilemt(scene.bvh, scene.triangles, o, d,
                                   C.RAY_LENGTH_MAX, pk, pi)
    sample = torch.randperm(b, generator=torch.Generator().manual_seed(0))[
        :2048].to(dev)
    t_n, id_n = nv.closest_triangles(
        scene.triangles, o[sample], d[sample],
        torch.full((2048,), C.RAY_LENGTH_MAX, device=dev), pk[sample],
        pi[sample])
    mism = torch.nonzero(id_k[sample] != id_n)[:, 0]
    # Coincident triangles (PARITY.md section 7) may swap ids at equal t.
    ties = int((t_k[sample][mism] == t_n[mism]).sum())
    say(4, f"tile-MT primary hits vs naive oracle on 2048 sampled rays: "
           f"{len(mism)} differ, {ties} of them coincident-triangle ties")
    if len(mism) != ties:
        raise AssertionError("primary hits disagree with the naive oracle")

    # -- 5 ------------------------------------------------------------------
    small, scam, _ = bench_scenes.conference_proxy(target_prims=20000)
    small = bt.build(small, device=dev)
    cfg64 = mrt.RenderConfig(width=64, height=64, spp=1,
                             shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                             nee_share=128, nee_share_secondary=True)
    out64 = mrt.render_frame(small, scam, cfg64, key)
    img64 = out64["image"].cpu().numpy()
    golden = np.load(GOLDEN)
    gerr = np.abs(img64 - golden).max(-1)
    frac = float((gerr <= IMG_ATOL).mean())
    say(5, f"64x64 frame vs JAX golden: max abs err {gerr.max():.3e}, "
           f"{frac:.6f} of pixels within {IMG_ATOL}; rays "
           f"{int(out64['rays'])} (JAX: 7658)")
    if frac < IMG_FRACTION or int(out64["rays"]) != 7658:
        raise AssertionError("64x64 frame disagrees with the JAX golden")

    # -- 6 ------------------------------------------------------------------
    def frame():
        return mrt.render_frame(scene, cam, cfg, key)

    frame_ms = cuda_ms(frame, FRAMES)
    walls = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    say(6, f"512x512 Whitted frame: {frame_ms:.3f} ms/frame, "
           f"{rays / (frame_ms / 1e3) / 1e6:.4f} M rays/s ({rays} rays, "
           f"mean of {FRAMES} frames by CUDA events; host clock per frame "
           f"min {min(walls):.3f} median {statistics.median(walls):.3f} ms)"
           f" [{card}]")
    busy, top = profile_frame(frame)
    say(6, f"one frame under torch.profiler: device busy {busy:.3f} ms of "
           f"{frame_ms:.3f} ms, idle share {1.0 - busy / frame_ms:.3f}; "
           f"largest device rows (ms): "
           + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top.items())
           + f" [{card}]")
    records = []
    for kind in ("tilemt", "banded"):
        cases = {w: a for (k, w), a in captured.items() if k == kind}
        what = "primary" if kind == "tilemt" else "shadow (any-hit)"
        args = cases[what]
        k_ms = cuda_ms(lambda: wrapped[kind](*args), 10)
        p_ms = cuda_ms(lambda: plain[kind](*args), 3)
        say(6, f"{KERNELS[kind]['name']} on the frame's {what} batch "
               f"({args[3].shape[0]} rays): kernel {k_ms:.4f} ms, plain "
               f"PyTorch {p_ms:.4f} ms [{card}]")
        records.append(dict(KERNELS[kind], launches=launches[kind],
                            max_abs_err=err[kind], ms=k_ms, plain_ms=p_ms))

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
