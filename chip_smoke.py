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
     five calls of each under torch.profiler with its kernels apart.
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
    device's own kernel and copy rows.  Returns (busy ms, {name: (ms,
    events recorded)} of the largest rows)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = rows.get(e.key, (0.0, 0))
            rows[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    busy = sum(ms for ms, _ in rows.values())
    top = dict(sorted(rows.items(), key=lambda kv: -kv[1][0])[:6])
    return busy, top


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

    _, rows = profile_device(run)
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
    outs, exits = {}, {}
    for (kind, what), args in sorted(captured.items()):
        got = wrapped[kind](*args)
        *want, exits[(kind, what)] = plain[kind](*args, stats=True)
        if kind == "banded":
            got, want = torch.stack(got), torch.stack(want)
        else:
            want = want[0]
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err[kind] = max(err[kind], e)
        outs[(kind, what)] = got
        rounds = got[:, 2] if kind == "tilemt" else got[2]
        say(3, f"{KERNELS[kind]['name']} {what}: rays {args[3].shape[0]} "
               f"m {args[4]}, {'rounds' if kind == 'tilemt' else 'lockstep rounds'}"
               f" per program mean {float(rounds.mean()):.4f} max "
               f"{int(rounds.max())}; tested pairs by exit (lane, det, u, "
               f"v, u + v, t) {exits[(kind, what)].tolist()}; bitwise equal "
               f"to plain: "
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
    busy, top = profile_device(frame)
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

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def traversal_modes(scene, cfg, key, o, d, pk, pi, b, card):
    """Phase 7: the "tilebw" and "resident" modes on the 512x512 primaries
    and their NEE shadow batch.  Returns the two kernels' JSON records."""
    from mobileraytracer_tpu_torch import renderer, sampling
    from mobileraytracer_tpu_torch import constants as C
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
    def differ(h, ref, sel=slice(None)):
        mism = torch.nonzero((h.prim_kind[sel] != ref.prim_kind)
                             | (h.prim_id[sel] != ref.prim_id))[:, 0]
        tri = C.PRIM_TRIANGLE
        ties = int(((h.prim_kind[sel][mism] == tri)
                    & (ref.prim_kind[mism] == tri)
                    & (h.t[sel][mism] == ref.t[mism])).sum())
        return len(mism), ties

    n_mt, ties_mt = differ(hit_bw, hit_mt)
    sample = torch.randperm(b, generator=torch.Generator().manual_seed(0))[
        :2048].to(dev)
    naive = nv.intersect_scene_naive(scene, o[sample], d[sample],
                                     pk[sample], pi[sample])
    n_nv, ties_nv = differ(hit_bw, naive, sample)
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


if __name__ == "__main__":
    main()
