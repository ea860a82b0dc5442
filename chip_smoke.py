#!/usr/bin/env python3
"""Drives the PyTorch port's main path once on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

The main path is what bench.py renders by default: the 331,179-triangle
conference proxy, Whitted shader over the block BVH, 512x512, 1 spp,
nee_share=128, reversed NEE and nee_share_secondary=True, rendered through
`mobileraytracer_tpu_torch.render_frame`.  Phases, one line each (a failure
raises and the script exits nonzero):

  1. a CUDA device is required; the card's name and power limit;
  2. the CUDA kernels are built from csrc/ (one nvcc per source, all at
     once; seconds printed), and for each kernel its registers, shared
     memory, spills and resident blocks per SM (cudaFuncGetAttributes and
     cudaOccupancyMaxActiveBlocksPerMultiprocessor, through the library);
  3. each kernel against its plain PyTorch version, bitwise, on the inputs
     the main path gives it (recorded during one 512x512 frame), plus a
     batch of mirror-bounce rays for the banded kernel's closest-hit mode,
     with each batch's mean and max rounds (banded: lockstep rounds) and
     its tested pairs counted by the exit of the test each takes;
  4. the 512x512 frame through render_frame with the launch counters reset
     just before: finite image, rays > 0, every kernel launched; and the
     tile-MT primary hits against the naive oracle on 2,048 sampled rays;
  5. the 64x64 frame of the 20,000-triangle proxy against the JAX
     package's frame committed as tests/data/torch_port_golden_conference64.npy;
  6. timing with CUDA events: ms/frame and rays/s, each kernel against its
     plain version and its bound (kernels.traversal_bound: the larger of
     the f32 operations its tested pairs need, each up to the exit it
     takes as counted by the plain version's walk of the same batch, over
     the H100's published FP32 rate, and its bytes over the HBM rate; the
     share at the unfused rate beside it), and five calls
     of each under torch.profiler with its kernels apart; then one frame
     under torch.profiler: device busy time, idle share and the largest
     device ops;
  7. the two other traversal modes at full width, with the launch counters
     reset just before: the 262,144 patch-major primaries of phase 4
     through intersect_scene_blocks(mode="tilebw") against mode="tilemt"
     (and the naive oracle on 2,048 sampled rays), then reversed shared-
     light NEE on those hits with the occlusion through the "banded",
     "resident", "tilebw" and "tilemt" modes (scripts/shadow_ab4.py's
     harness): banded and resident must agree, tilebw and tilemt must
     agree, and the two pairs may differ only on blockers within one ulp
     of the segment end, which the JAX package's tile windows miss too.  Each new kernel
     against its plain version, bitwise, on the batches it was given, and
     CUDA-event timings of the passes and kernels with their bounds, and
     five calls of each under torch.profiler with its kernels apart;
  8. the other shaders and accelerators: the cornell2 PathTracer (2 spp)
     and the 20k proxy's DepthMap and DiffuseMaterial frames at 64x64
     against the JAX package's, committed as
     tests/data/torch_port_golden_shaders64.npz (ray counts exact); the
     conference PathTracer at 512x512: a 1-spp warm-up whose largest
     tile-MT and banded batches of each kind (the primary step's, the
     bounce chunks' closest-hit and shadow passes, and their refill loops)
     are held bitwise against the plain versions, then 16 spp (bench.py
     --shader 2 --spp 16; 4 spp when 16 would take over a minute), with
     the launch counters reset just before: ms/frame, rays/s, walk steps,
     refill loops, launches, and one 1-spp frame under torch.profiler
     (with the host operators whose kernels take longest); DepthMap and
     DiffuseMaterial at 512x512 (banded launches); the 20k proxy's regular
     grid and escape-index BVH against the naive oracle on 2,048 sampled
     primaries; and the five shaders over the naive scan, the grid, the
     escape-index tree and the block BVH at 32x32 on cornell, each frame
     against the naive scan's.  Each kernel's record gains its launches in
     the PathTracer frame.
The script's seconds, the card's name and power limit and then the
kernels' JSON record come just before the last line, {"ok": true,
"device": {...}}.
"""
import json
import pathlib
import statistics
import subprocess
import time

import numpy as np
import torch

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden_conference64.npy"
GOLDEN_SHADERS = ROOT / "tests" / "data" / "torch_port_golden_shaders64.npz"
# Held as in tests/test_torch_render.py: the golden comes from XLA's CPU
# code (FMA-contracted arithmetic), the port rounds every operation.
IMG_ATOL = 1e-4
IMG_FRACTION = 0.999
# The PathTracer's, as in tests/test_torch_pathtracer.py: a pixel holds
# when |port - golden| <= 1e-4 + 1e-3 |golden| (the Russian roulette boost
# drives pixels up to ~30), and 99.9% of pixels hold.
PT_RTOL = 1e-3
FRAMES = 5
# Phase 8's PathTracer frame: 16 spp, cut to 4 when 16 times one 1-spp
# frame exceeds a minute.
PT_SPP, PT_SPP_CUT, PT_FRAME_S = 16, 4, 60.0

KERNELS = {
    "tilemt": dict(name="traverse_tilemt", route="cuda",
                   source="mobileraytracer_tpu_torch/csrc/traverse_tilemt.cu",
                   replaces="mobileraytracer_tpu/ops/pallas_bvh.py:1317"),
    "banded": dict(name="traverse_banded", route="cuda",
                   source="mobileraytracer_tpu_torch/csrc/traverse_banded.cu",
                   replaces="mobileraytracer_tpu/ops/pallas_bvh.py:441"),
    "tilebw": dict(name="traverse_tilebw", route="cuda",
                   source="mobileraytracer_tpu_torch/csrc/traverse_tilebw.cu",
                   replaces="mobileraytracer_tpu/ops/pallas_bvh.py:1096"),
    "resident": dict(name="traverse_resident", route="cuda",
                     source="mobileraytracer_tpu_torch/csrc/"
                            "traverse_resident.cu",
                     replaces="mobileraytracer_tpu/ops/pallas_bvh.py:848"),
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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_bound(K, kind, args, got, walk):
    """Bound of one kernel call (kernels.traversal_bound) from the call's
    inputs and outputs and its plain version's statistics of the same walk
    (`walk`: the tested pairs counted by the exit each takes; for resident
    also its rounds and blocks read before them): the operations each pair
    needs up to its exit, the bytes the call reads and writes and the
    distinct blocks it walks.  Returns (bound, per-program rounds)."""
    stage_ops = K.BW_STAGE_OPS if kind == "tilebw" else K.MT_STAGE_OPS
    if kind == "resident":
        rounds, blocks, exits = walk
        io = nbytes(args[3], got, args[1], args[2])
        return K.traversal_bound(exits, stage_ops, io, blocks,
                                 K.MT_BLOCK_BYTES), rounds.double()
    cg, ce, rays = args[1], args[2], args[3]
    io = nbytes(rays, got, cg, ce)
    if kind == "banded":                 # steps per program and per band
        rounds = got[2].reshape(-1, K.TILE)[:, 0]
        walked = got[2].reshape(-1, K.ST)[:, 0]
    else:                                # rounds per tile
        rounds = walked = got[:, 2 if kind == "tilemt" else 7].reshape(
            -1, K.TILE)[:, 0]
    if kind != "banded":
        io += 4 * cg.shape[0]            # the tile order
    block = K.BW_BLOCK_BYTES if kind == "tilebw" else K.MT_BLOCK_BYTES
    return K.traversal_bound(walk, stage_ops, io,
                             K.visited_blocks(cg, walked),
                             block), rounds.double()


def record(kind, launches, err, k_ms, p_ms, bound, rounds, card):
    """One kernel's entry of the kernels line."""
    return dict(KERNELS[kind], launches=launches, max_abs_err=err, ms=k_ms,
                plain_ms=p_ms, bound_ms=bound["ms"],
                bound_by="operations" if bound["by"] == "compute"
                else "bytes", library_ms=None, bound=bound["by"],
                share=bound["ms"] / k_ms,
                share_unfused=bound["unfused_ms"] / k_ms,
                rounds_mean=float(rounds.mean()), card=card)


def say_bound(phase, kind, what, n, k_ms, p_ms, bound, rounds, card):
    say(phase, f"{KERNELS[kind]['name']} on the {what} batch ({n} rays, "
               f"{bound['tests']} tests, {float(rounds.mean()):.4f} mean "
               f"rounds per program): kernel {k_ms:.4f} ms, plain PyTorch "
               f"{p_ms:.4f} ms, bound {bound['ms']:.4f} ms "
               f"({bound['by']}: {bound['ops']} f32 ops, {bound['bytes']} "
               f"bytes), share {bound['ms'] / k_ms:.4f}; at the unfused f32 "
               f"rate {bound['unfused_ms']:.4f} ms, share "
               f"{bound['unfused_ms'] / k_ms:.4f}; no PyTorch call "
               f"computes a candidate-list traversal [{card}]")


def profile_device(run):
    """Device busy time of run() under torch.profiler, summed over the
    device's own kernel and copy rows.  Returns (busy ms, device events
    recorded, {name: (ms, events)} of the largest rows, {aten operator:
    (ms, calls)} of the host operators whose own device kernels took
    longest)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows, ops = {}, {}
    for e in prof.key_averages():
        into = (rows if e.device_type == torch.autograd.DeviceType.CUDA
                else ops if e.key.startswith("aten::") else None)
        if into is not None:
            ms, n = into.get(e.key, (0.0, 0))
            into[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    busy = sum(ms for ms, _ in rows.values())
    events = sum(n for _, n in rows.values())

    def top(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1][0])[:6])
    return busy, events, top(rows), top(ops)


def recording(captured, tag_fn):
    """Replaces the tile-MT and banded wrappers with recorders that keep,
    under tag_fn(kind, any_hit), the arguments of the largest batch each
    was given (most rays, then the widest candidate list).  Returns the
    function that puts the wrappers back."""
    from mobileraytracer_tpu_torch.ops import kernels as K
    wrapped = {"tilemt": K.traverse_tilemt, "banded": K.traverse_banded}

    def recorder(kind):
        fn = wrapped[kind]

        def rec(tb, cg, ce, rays, m, any_hit):
            tag = tag_fn(kind, any_hit)
            old = captured.get(tag)
            if old is None or (rays.shape[0], m) > (old[3].shape[0], old[4]):
                captured[tag] = (tb, cg.clone(), ce.clone(), rays.clone(), m,
                                 any_hit)
            return fn(tb, cg, ce, rays, m, any_hit)
        return rec

    def restore():
        K.traverse_tilemt, K.traverse_banded = (wrapped["tilemt"],
                                                wrapped["banded"])
    K.traverse_tilemt, K.traverse_banded = (recorder("tilemt"),
                                            recorder("banded"))
    return restore


def check_batches(phase, captured):
    """Each captured batch through its kernel and its plain version,
    printed and held bitwise equal (a mismatch raises).  Returns ({kind:
    max abs err}, {tag: kernel output}, {tag: the plain version's tested
    pairs by exit})."""
    from mobileraytracer_tpu_torch.ops import kernels as K
    kernel = {"tilemt": K.traverse_tilemt, "banded": K.traverse_banded}
    plain = {"tilemt": K.tilemt_plain, "banded": K.banded_plain}
    err, outs, exits = {}, {}, {}
    for (kind, what), args in sorted(captured.items()):
        got = kernel[kind](*args)
        *want, exits[(kind, what)] = plain[kind](*args, stats=True)
        if kind == "banded":
            got, want = torch.stack(got), torch.stack(want)
        else:
            want = want[0]
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err[kind] = max(err.get(kind, 0.0), e)
        outs[(kind, what)] = got
        rounds = got[:, 2] if kind == "tilemt" else got[2]
        say(phase, f"{KERNELS[kind]['name']} {what}: rays {args[3].shape[0]}"
                   f" m {args[4]}, "
                   f"{'rounds' if kind == 'tilemt' else 'lockstep rounds'}"
                   f" per program mean {float(rounds.mean()):.4f} max "
                   f"{int(rounds.max())}; tested pairs by exit (lane, det, "
                   f"u, v, u + v, t) {exits[(kind, what)].tolist()}; "
                   f"bitwise equal to plain: {torch.equal(got, want)} (max "
                   f"abs err {e})")
        if not torch.equal(got, want):
            raise AssertionError(f"{kind} {what}: kernel != plain version")
    return err, outs, exits


def say_profile(phase, kind, args, card, reps=5):
    """`reps` calls of kernel `kind`'s wrapper under torch.profiler: the mean
    ms of each of its launch's own kernels (the tile kernels: the tile
    order's two passes, then the walk) over the events the profiler
    recorded, which are sometimes fewer than the calls."""
    from mobileraytracer_tpu_torch.ops import kernels as K
    wrapper = {"tilemt": K.traverse_tilemt, "banded": K.traverse_banded,
               "tilebw": K.traverse_tile, "resident": K.traverse_resident}

    def run():
        for _ in range(reps):
            wrapper[kind](*args)

    _, _, rows, _ = profile_device(run)
    name = lambda k: k.replace("(anonymous namespace)::", "").split(
        "(")[0].split()[-1]
    say(phase, f"{KERNELS[kind]['name']}, {reps} calls under torch.profiler,"
               f" mean ms per recorded launch: " + ("; ".join(
                   f"{name(k)} {ms / n:.4f} ({n} recorded)"
                   for k, (ms, n) in rows.items())
                   or "no device rows recorded") + f" [{card}]")


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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind in KERNELS:
        ki = _build.kernel_info(kind)
        warps = ki["blocks_per_sm"] * ki["threads"] // 32
        smem = ki["static_smem"] + ki["dynamic_smem"]
        say(2, f"{KERNELS[kind]['name']}: {ki['regs']} registers, "
               f"{ki['local_bytes']} spilled bytes per thread, {smem} B of "
               f"shared memory and {ki['threads']} threads per block -> "
               f"{ki['blocks_per_sm']} blocks per SM = {warps} of 64 warps, "
               f"{ki['blocks_per_sm'] * smem} B of shared memory; "
               f"{ki['blocks_per_sm'] * sms} blocks at once on {sms} SMs "
               f"[{card}]")

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
    stage = {"mirror": False}

    def tag(kind, any_hit):
        if kind == "tilemt":
            return kind, "primary"
        if stage["mirror"]:
            return kind, "mirror (closest)"
        return kind, "shadow (any-hit)" if any_hit else "refill (closest)"

    restore = recording(captured, tag)
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
        stage["mirror"] = True
        bt.traverse(scene.bvh, scene.triangles, o2, d2, C.RAY_LENGTH_MAX,
                    hit.prim_kind, hit.prim_id)
    finally:
        restore()
    torch.cuda.synchronize()
    err, outs, exits = check_batches(3, captured)
    wrapped = {"tilemt": K.traverse_tilemt, "banded": K.traverse_banded}
    plain = {"tilemt": K.tilemt_plain, "banded": K.banded_plain}

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
            and rays > 0
            and all(launches[k] > 0 for k in ("tilemt", "banded"))):
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
    busy, _, top, _ = profile_device(frame)
    say(6, f"one frame under torch.profiler: device busy {busy:.3f} ms of "
           f"{frame_ms:.3f} ms, idle share {1.0 - busy / frame_ms:.3f}; "
           f"largest device rows (ms): "
           + "; ".join(f"{k[:60]} {ms:.3f}" for k, (ms, _) in top.items())
           + f" [{card}]")
    records = []
    for kind in ("tilemt", "banded"):
        cases = {w: a for (k, w), a in captured.items() if k == kind}
        what = "primary" if kind == "tilemt" else "shadow (any-hit)"
        args = cases[what]
        k_ms = cuda_ms(lambda: wrapped[kind](*args), 10)
        p_ms = cuda_ms(lambda: plain[kind](*args), 3)
        bound, rounds = kernel_bound(K, kind, args, outs[(kind, what)],
                                     exits[(kind, what)])
        say_bound(6, kind, f"frame's {what}", args[3].shape[0], k_ms, p_ms,
                  bound, rounds, card)
        say_profile(6, kind, args, card)
        records.append(record(kind, launches[kind], err[kind], k_ms, p_ms,
                              bound, rounds, card))

    # -- 7 ------------------------------------------------------------------
    records += traversal_modes(scene, cfg, key, o, d, pk, pi, b, card)

    # -- 8 ------------------------------------------------------------------
    pt_launches, pt_err = shaders_phase(scene, cam, small, scam, key, card)
    for rec in records:
        kind = next(k for k, v in KERNELS.items() if v["name"] == rec["name"])
        rec["launches_pathtracer"] = pt_launches[kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], pt_err.get(kind, 0.0))

    say(8, f"chip_smoke.py took {time.perf_counter() - T_START:.1f} s")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def traversal_modes(scene, cfg, key, o, d, pk, pi, b, card):
    """Phase 7: the "tilebw" and "resident" modes on the 512x512 primaries
    and their NEE shadow batch.  Returns the two kernels' JSON records."""
    from mobileraytracer_tpu_torch import renderer, sampling
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.ops import intersect as nv
    from mobileraytracer_tpu_torch.ops import kernels as K
    from mobileraytracer_tpu_torch.shaders import common

    dev = o.device
    wrapped = {"tilebw": K.traverse_tile, "resident": K.traverse_resident}
    plain = {"tilebw": K.tile_plain, "resident": K.resident_plain}
    captured = {}
    stage = {"what": None}

    def recorder(kind):
        fn = wrapped[kind]

        def rec(*args):
            tag = (kind, stage["what"])
            if tag not in captured:
                captured[tag] = tuple(a.clone() if torch.is_tensor(a) else a
                                      for a in args)
            return fn(*args)
        return rec

    pids = renderer._pixel_order(cfg, dev)[2]
    keys = sampling.event_key(sampling.ray_key(key, pids, 0), 0, 1)

    def closest(mode):
        return bt.intersect_scene_blocks(scene, o, d, pk, pi, mode=mode)

    masks = {}
    shadow = {}

    def nee(hit, mode):
        def occ(scene_, o_, d_, md, pk_, pi_):
            blocked = bt.occluded_blocks(scene_, o_, d_, md, pk_, pi_,
                                         mode=mode)
            masks[mode] = blocked
            shadow["rays"] = (o_, d_, md, pk_, pi_)
            return blocked
        return common.direct_lighting(
            scene, hit, keys, cfg.samples_light, shadows=True,
            occluded_fn=occ, mask=~hit.missed, share_mask=None,
            share_width=cfg.nee_share, reverse=True, share_all=True)

    K.reset_launches()
    K.traverse_tile = recorder("tilebw")
    K.traverse_resident = recorder("resident")
    try:
        stage["what"] = "primary (closest)"
        hit_bw = closest("tilebw")
        hit_mt = closest("tilemt")
        stage["what"] = "shadow (any-hit)"
        light = {mode: nee(hit_bw, mode)
                 for mode in ("banded", "tilebw", "resident", "tilemt")}
    finally:
        K.traverse_tile = wrapped["tilebw"]
        K.traverse_resident = wrapped["resident"]
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)

    # Closest hits: tilebw against tilemt on every ray, and against the
    # naive oracle on a sample, coincident-triangle ties aside.
    n_mt, ties_mt = hits_differ(hit_bw, hit_mt)
    sample = torch.randperm(b, generator=torch.Generator().manual_seed(0))[
        :2048].to(dev)
    naive = nv.intersect_scene_naive(scene, o[sample], d[sample],
                                     pk[sample], pi[sample])
    n_nv, ties_nv = hits_differ(hit_bw, naive, sample)
    say(7, f"tilebw closest on {b} primaries: {n_mt} hits differ from "
           f"tilemt ({ties_mt} coincident-triangle ties); {n_nv} of 2048 "
           f"sampled differ from the naive oracle ({ties_nv} ties); "
           f"launches {launches}")
    if n_mt != ties_mt or n_nv != ties_nv:
        raise AssertionError("tilebw primary hits disagree")
    # Occlusion: the subtile modes (banded, resident) agree, and so do the
    # tile modes (tilebw, tilemt: same windows and refill).  The two pairs
    # may differ only where the naive oracle's blocker lies within one ulp
    # of the segment's end: the tile windows' exact per-ray slab bound
    # rounds onto the end and prunes it, in the JAX package too (ROADMAP.md
    # Queue 3, tests/test_torch_traversal_edge.py).
    def same(a, b):
        return (torch.equal(masks[a], masks[b])
                and torch.equal(light[a][0], light[b][0]))

    base = masks["banded"]
    lanes = torch.nonzero(masks["tilebw"] != base)[:, 0]
    so, sd, md, spk, spi = shadow["rays"]
    md = torch.as_tensor(md, device=dev).expand(b)
    t_n, id_n = nv.closest_triangles(scene.triangles, so[lanes], sd[lanes],
                                     md[lanes], spk[lanes], spi[lanes])
    edge = bool(((id_n >= 0) & base[lanes]
                 & (torch.nextafter(t_n, torch.full_like(t_n, torch.inf))
                    >= md[lanes])).all())
    keep = torch.ones(b, dtype=torch.bool, device=dev)
    keep[lanes] = False
    rad_eq = torch.equal(light["tilebw"][0][keep], light["banded"][0][keep])
    sub_eq, tile_eq = same("resident", "banded"), same("tilebw", "tilemt")
    say(7, f"reversed shared-light NEE: {b} shadow rays, {int(base.sum())} "
           f"occluded; occlusion and radiance equal banded = resident: "
           f"{sub_eq}, tilebw = tilemt: {tile_eq}; tilebw vs banded: "
           f"{len(lanes)} lanes differ, each a blocker within one ulp of "
           f"the segment end that the tile windows prune as the JAX "
           f"package does: {edge}; radiance equal elsewhere: {rad_eq}")
    if not (sub_eq and tile_eq and edge and rad_eq):
        raise AssertionError("the occluders disagree")
    if not (launches["tilebw"] > 0 and launches["resident"] > 0):
        raise AssertionError(f"phase 7 missed a kernel: {launches}")

    err = {"tilebw": 0.0, "resident": 0.0}
    outs, walks = {}, {}
    for (kind, what), args in sorted(captured.items()):
        got = wrapped[kind](*args)
        if kind == "resident":
            t, slot, rounds, blocks, pairs = plain[kind](*args, stats=True)
            walks[(kind, what)] = (rounds, blocks, pairs)
            got, want = torch.stack(got), torch.stack((t, slot))
            stats = (f"partitions {args[5]}, occluded in some partition "
                     f"{int((got[0] < args[3][:, 6]).any(0).sum())}, rounds "
                     f"per (program, partition) mean "
                     f"{float(rounds.double().mean()):.4f} max "
                     f"{int(rounds.max())}")
        else:
            want, pairs = plain[kind](*args, stats=True)
            walks[(kind, what)] = pairs
            stats = (f"rounds mean {float(got[:, 7].mean()):.2f} max "
                     f"{int(got[:, 7].max())}, flagged amb "
                     f"{int(got[:, 8].sum())}")
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err[kind] = max(err[kind], e)
        outs[(kind, what)] = got
        say(7, f"{KERNELS[kind]['name']} {what}: rays {args[3].shape[0]} "
               f"m {args[4]}, {stats}, tested pairs by exit "
               f"{pairs.tolist()}; bitwise equal to plain: "
               f"{torch.equal(got, want)} (max abs err {e})")
        if not torch.equal(got, want):
            raise AssertionError(f"{kind} {what}: kernel != plain version")

    for mode in ("tilemt", "tilebw"):
        say(7, f"closest pass mode={mode}: "
               f"{cuda_ms(lambda: closest(mode), 5):.3f} ms [{card}]")
    for mode in ("banded", "tilebw", "resident"):
        ms = cuda_ms(lambda: nee(closest("tilemt"), mode), 5)
        say(7, f"closest (tilemt) + NEE with occluder mode={mode}: "
               f"{ms:.3f} ms [{card}]")
    records = []
    for kind, what in (("tilebw", "primary (closest)"),
                       ("resident", "shadow (any-hit)")):
        args = captured[(kind, what)]
        k_ms = cuda_ms(lambda: wrapped[kind](*args), 10)
        p_ms = cuda_ms(lambda: plain[kind](*args), 3)
        bound, rounds = kernel_bound(K, kind, args, outs[(kind, what)],
                                     walks[(kind, what)])
        say_bound(7, kind, what, args[3].shape[0], k_ms, p_ms, bound, rounds,
                  card)
        say_profile(7, kind, args, card)
        records.append(record(kind, launches[kind], err[kind], k_ms, p_ms,
                              bound, rounds, card))
    args = captured[("tilebw", "shadow (any-hit)")]
    say(7, f"traverse_tilebw on the shadow (any-hit) batch "
           f"({args[3].shape[0]} rays): kernel "
           f"{cuda_ms(lambda: wrapped['tilebw'](*args), 10):.4f} ms, plain "
           f"PyTorch {cuda_ms(lambda: plain['tilebw'](*args), 3):.4f} ms "
           f"[{card}]")
    return records


def event_ms(fn):
    """ms of one call of fn() by CUDA events (no warm-up)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def pt_config(spp):
    """bench.py --shader 2: the PathTracer at 512x512 over the block BVH,
    nee_share=128, nee_share_secondary=True."""
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import constants as C
    return mrt.RenderConfig(width=512, height=512, spp=spp,
                            shader=C.SHADER_PATHTRACER, accelerator=C.ACC_BVH,
                            nee_share=128, nee_share_secondary=True)


def pathtracer_frame(scene, cam, key, spp):
    """One pt_config(spp) frame timed by CUDA events, with the launch, loop
    and walk counters reset just before.  Returns its ms, rays, image,
    launches, refill loops and walk steps."""
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.ops import kernels as K
    from mobileraytracer_tpu_torch.shaders import engine
    held = {}
    K.reset_launches()
    bt.LOOPS.update(refill=0, dense=0)
    engine.WALK["steps"] = 0
    ms = event_ms(lambda: held.update(
        out=mrt.render_frame(scene, cam, pt_config(spp), key)))
    return dict(spp=spp, ms=ms, rays=int(held["out"]["rays"]),
                image=held["out"]["image"].cpu().numpy(),
                launches=dict(K.LAUNCHES), loops=dict(bt.LOOPS),
                steps=engine.WALK["steps"])


def pathtracer_line(f):
    img = f["image"]
    return (f"512x512 PathTracer frame, {f['spp']} spp: {f['ms']:.3f} "
            f"ms/frame by CUDA events, {f['rays']} rays, "
            f"{f['rays'] / (f['ms'] / 1e3) / 1e6:.4f} M rays/s; walk steps "
            f"{f['steps']}; refill loops {f['loops']}; launches "
            f"{f['launches']}; image {img.shape} finite "
            f"{np.isfinite(img).all()} mean {img.mean():.6f}")


def frames_match(img, ref, rtol=0.0):
    """(holds, max abs err, share of pixels within |img - ref| <= IMG_ATOL +
    rtol |ref|): a frame holds when it is finite and IMG_FRACTION of its
    pixels are within."""
    err = np.abs(img - ref)
    within = float((err <= IMG_ATOL + rtol * np.abs(ref)).all(-1).mean())
    return (bool(np.isfinite(img).all()) and within >= IMG_FRACTION,
            float(err.max()), within)


def hits_differ(h, ref, sel=slice(None)):
    """(hits of h[sel] whose primitive differs from ref's, how many of them
    are coincident-triangle ties: both triangles at the same t)."""
    from mobileraytracer_tpu_torch import constants as C
    mism = torch.nonzero((h.prim_kind[sel] != ref.prim_kind)
                         | (h.prim_id[sel] != ref.prim_id))[:, 0]
    tri = C.PRIM_TRIANGLE
    ties = int(((h.prim_kind[sel][mism] == tri)
                & (ref.prim_kind[mism] == tri)
                & (h.t[sel][mism] == ref.t[mism])).sum())
    return len(mism), ties


def shaders_phase(scene, cam, small, scam, key, card):
    """Phase 8: the PathTracer, DepthMap and DiffuseMaterial shaders and the
    regular grid and escape-index BVH.  Returns the kernels' launches in
    the 512x512 PathTracer frame and their largest errors against their
    plain versions on its batches."""
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import (bench_scenes, cameras, renderer,
                                           scenes)
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.ops import bvh, grid
    from mobileraytracer_tpu_torch.ops import intersect as nv
    from mobileraytracer_tpu_torch.ops import kernels as K
    from mobileraytracer_tpu_torch.shaders import engine

    dev = key.device
    mp_obj = torch.from_numpy(scenes.DEPTHMAP_MAX_POINT[C.SCENE_OBJ])

    # The three 64x64 goldens.
    golden = np.load(GOLDEN_SHADERS)
    cornell2, c2cam = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
    cases = {
        "pathtracer": (bt.build(cornell2, device=dev), c2cam,
                       dict(shader=C.SHADER_PATHTRACER, spp=2, nee_share=128,
                            nee_share_secondary=True), None, PT_RTOL),
        "depthmap": (small, scam, dict(shader=C.SHADER_DEPTHMAP), mp_obj,
                     0.0),
        "diffuse": (small, scam, dict(shader=C.SHADER_DIFFUSE), None, 0.0),
    }
    for name, (sc, cm, kw, mp, rtol) in cases.items():
        cfg = mrt.RenderConfig(width=64, height=64, accelerator=C.ACC_BVH,
                               **kw)
        out = mrt.render_frame(sc, cm, cfg, key, mp)
        ok, err, within = frames_match(out["image"].cpu().numpy(),
                                       golden[name], rtol)
        rays, want = int(out["rays"]), int(golden[name + "_rays"])
        say(8, f"64x64 {name} frame vs JAX golden: max abs err {err:.3e}, "
               f"{within:.6f} of pixels within {IMG_ATOL} + {rtol} |golden|;"
               f" rays {rays} (JAX: {want})")
        if not ok or rays != want:
            raise AssertionError(f"64x64 {name} frame disagrees with the JAX "
                                 f"golden")

    # The 512x512 PathTracer frame (bench.py --shader 2 --spp 16).  The
    # 1-spp warm-up records the kernels' largest batches of each kind: the
    # primary step's, and the bounce chunks' incoherent closest-hit and
    # shadow passes and their refill loops.
    captured = {}
    stage = {"refill": False}
    refill = bt._refill_exact

    def in_refill(*args):
        stage["refill"] = True
        try:
            return refill(*args)
        finally:
            stage["refill"] = False

    def tag(kind, any_hit):
        return kind, (f"PathTracer "
                      f"{'primary step' if engine.WALK['steps'] == 0 else 'bounce chunk'}"
                      f" {'refill' if stage['refill'] else 'pass'} "
                      f"({'any-hit' if any_hit else 'closest'})")

    engine.WALK["steps"] = 0
    restore = recording(captured, tag)
    bt._refill_exact = in_refill
    t0 = time.perf_counter()
    try:
        mrt.render_frame(scene, cam, pt_config(1), key)
        torch.cuda.synchronize()
    finally:
        bt._refill_exact = refill
        restore()
    warm_s = time.perf_counter() - t0
    pt_err, _, _ = check_batches(8, captured)
    sample_ms = pathtracer_frame(scene, cam, key, 1)["ms"]
    spp = PT_SPP if PT_SPP * sample_ms <= PT_FRAME_S * 1e3 else PT_SPP_CUT
    f = pathtracer_frame(scene, cam, key, spp)
    launches = f["launches"]
    cut = ("" if spp == PT_SPP else
           f" (cut from {PT_SPP}: one sample took {sample_ms:.1f} ms, so "
           f"{PT_SPP} would take over {PT_FRAME_S:.0f} s)")
    say(8, f"{pathtracer_line(f)}{cut}; 1-spp warm-up {warm_s:.2f} s, one "
           f"1-spp frame {sample_ms:.3f} ms [{card}]")
    img = f["image"]
    if not (np.isfinite(img).all() and img.shape == (512, 512, 3)
            and f["rays"] > 0
            and all(launches[k] > 0 for k in ("tilemt", "banded"))):
        raise AssertionError("the PathTracer frame failed its checks")
    busy, events, top, ops = profile_device(
        lambda: mrt.render_frame(scene, cam, pt_config(1), key))
    say(8, f"one 1-spp PathTracer frame under torch.profiler: device busy "
           f"{busy:.3f} ms over {events} device events, of {sample_ms:.3f}"
           f" ms, idle share {1.0 - busy / sample_ms:.3f}; largest device "
           f"rows (ms, events):"
           + "; ".join(f" {k[:60]} {ms:.3f} ({n})"
                       for k, (ms, n) in top.items())
           + "; host operators by their own kernels' device time (ms, "
             "calls):" + "; ".join(f" {k} {ms:.3f} ({n})"
                                   for k, (ms, n) in ops.items())
           + f" [{card}]")

    # DepthMap and DiffuseMaterial at 512x512: one banded closest pass.
    for shader, mp in ((C.SHADER_DEPTHMAP, mp_obj), (C.SHADER_DIFFUSE, None)):
        cfgs = mrt.RenderConfig(width=512, height=512, shader=shader,
                                accelerator=C.ACC_BVH)
        mrt.render_frame(scene, cam, cfgs, key, mp)
        K.reset_launches()
        out = mrt.render_frame(scene, cam, cfgs, key, mp)
        torch.cuda.synchronize()
        sl = dict(K.LAUNCHES)
        ms = cuda_ms(lambda: mrt.render_frame(scene, cam, cfgs, key, mp), 3)
        simg = out["image"].cpu().numpy()
        say(8, f"512x512 shader {shader} frame: {ms:.3f} ms/frame (mean of 3"
               f" by CUDA events), rays {int(out['rays'])}, launches {sl}, "
               f"image finite {np.isfinite(simg).all()} mean "
               f"{simg.mean():.6f} [{card}]")
        if not (np.isfinite(simg).all()
                and int(out["rays"]) == cfgs.width * cfgs.height
                and sl["banded"] > 0):
            raise AssertionError(f"the shader {shader} frame failed")

    # The regular grid and the escape-index BVH.
    proxy, pcam, _ = bench_scenes.conference_proxy(target_prims=20000)
    t0 = time.perf_counter()
    gscene = grid.build_grid(proxy, device=dev)
    g_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tscene = bvh.build(proxy, device=dev)
    t_s = time.perf_counter() - t0
    say(8, f"20k proxy: grid built in {g_s:.2f} s ({gscene.bvh.size}^3 "
           f"cells, {gscene.bvh.item_id.numel()} items), escape-index BVH "
           f"in {t_s:.2f} s ({tscene.bvh.node_min.shape[0]} nodes)")
    u, v, _, _ = renderer._pixel_order(mrt.RenderConfig(width=512,
                                                        height=512), dev)
    zero = torch.zeros_like(u)
    o, d = cameras.generate_rays(pcam.to(dev), u, v, zero, zero)
    sample = torch.randperm(o.shape[0], generator=torch.Generator(
    ).manual_seed(0))[:2048].to(dev)
    o, d = o[sample], d[sample]
    pk = torch.zeros(2048, dtype=torch.int32, device=dev)
    pi = torch.full((2048,), -1, dtype=torch.int32, device=dev)
    for name, sc, fn in (("grid", gscene, grid.intersect_scene_grid),
                         ("escape-index BVH", tscene,
                          bvh.intersect_scene_bvh)):
        t0 = time.perf_counter()
        h = fn(sc, o, d, pk, pi)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n, ties = hits_differ(h, nv.intersect_scene_naive(sc, o, d, pk, pi))
        say(8, f"{name} on 2048 sampled primaries of the 20k proxy: {n} hits"
               f" differ from the naive oracle, {ties} of them "
               f"coincident-triangle ties; {int((~h.missed).sum())} hit; "
               f"{ms:.1f} ms by the host clock [{card}]")
        if n != ties:
            raise AssertionError(f"{name} hits disagree with the naive oracle")

    # The reference's render matrix at 32x32 on cornell: each shader over
    # each accelerator against its ACC_NAIVE frame.
    cornell, ccam = scenes.load_builtin(C.SCENE_CORNELL, 1.0)
    mp_c = torch.from_numpy(scenes.DEPTHMAP_MAX_POINT[C.SCENE_CORNELL])
    builds = {"naive": (C.ACC_NAIVE, cornell.to(dev)),
              "grid": (C.ACC_REGULAR_GRID, grid.build_grid(cornell,
                                                           device=dev)),
              "BVH tree": (C.ACC_BVH, bvh.build(cornell, device=dev)),
              "BVH blocks": (C.ACC_BVH, bt.build(cornell, device=dev))}
    for shader in (C.SHADER_NOSHADOWS, C.SHADER_WHITTED, C.SHADER_PATHTRACER,
                   C.SHADER_DEPTHMAP, C.SHADER_DIFFUSE):
        row = {}
        for label, (acc, sc) in builds.items():
            cfgm = mrt.RenderConfig(width=32, height=32, shader=shader,
                                    accelerator=acc, nee_share=128,
                                    nee_share_secondary=True)
            t0 = time.perf_counter()
            out = mrt.render_frame(sc, ccam, cfgm, key, mp_c)
            row[label] = (out["image"].cpu().numpy(), int(out["rays"]),
                          time.perf_counter() - t0)
        ref, ref_rays, _ = row["naive"]
        rtol = PT_RTOL if shader == C.SHADER_PATHTRACER else 0.0
        held = {label: frames_match(img, ref, rtol) + (rays == ref_rays,)
                for label, (img, rays, _) in row.items() if label != "naive"}
        say(8, f"32x32 cornell, shader {shader}: naive {ref_rays} rays, "
               f"{row['naive'][2]:.2f} s; "
           + "; ".join(f"{label} holds {ok and same} (max abs err {err:.2e},"
                       f" rays equal {same}, {row[label][2]:.2f} s)"
                       for label, (ok, err, _, same) in held.items()))
        if not all(ok and same for ok, _, _, same in held.values()):
            raise AssertionError(f"shader {shader}: an accelerator's frame "
                                 f"disagrees with the naive scan's")
    return launches, pt_err


if __name__ == "__main__":
    main()
