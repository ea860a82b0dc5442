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
     --shader 2 --spp 16; 2 spp when 16 would take over a minute), with
     the launch counters reset just before: ms/frame, rays/s, walk steps,
     refill loops, launches, and one 1-spp frame under torch.profiler
     (with the host operators whose kernels take longest); DepthMap and
     DiffuseMaterial at 512x512 (banded launches); the 20k proxy's regular
     grid and escape-index BVH against the naive oracle on 2,048 sampled
     primaries; and the five shaders over the naive scan, the grid, the
     escape-index tree and the block BVH at 32x32 on cornell, each frame
     against the naive scan's.  Each kernel's record gains its launches in
     the PathTracer frame.
  9. the user's way in: the conference proxy written to OBJ+MTL by
     loaders.obj.save_obj_scene and loaded back through the native parser
     (parse and fill seconds); the 512x512 Whitted frame of phase 4
     through Renderer on the loaded scene, whose rays and image must equal
     phase 4's bit for bit; the command line (cli.main) on that OBJ at
     512x512, 1 spp, --acc 3, with the launch counters reset just before:
     tile-MT and banded launched, every batch they were given held bitwise
     against the plain versions, the frame bitwise equal to the same
     command line run with the plain versions in the kernels' place, and
     its metrics line; the eight analytic
     refgold captures of the C++ reference at 256x256 (int_parity,
     ACC_NAIVE) within test_golden.py's tolerance; render_async stopped
     by a poller (STOPPED, every polled bitmap a whole frame) and a
     checkpoint resume bitwise equal to an uninterrupted render; and the
     eight pixel samplers' and the Halton sequence's draws on the card,
     bitwise equal to the CPU's.  Each kernel's record gains its launches
     in the command line's frame.
 10. gradients: BASELINE #5 (bench_grad.py's defaults) through
     diff.vertex_grad at 512x512 on the phase-3 scene, Whitted, nee_share
     128, edge_keep from edge_topology, 4,096 silhouette and 1,024 shadow
     edge draws, 8 samples an edge: a warm-up call under torch.profiler
     (device busy ms; idle share against the timed call) whose banded
     batches (the largest of each kind) are held bitwise against the
     plain version; one call timed by CUDA events with the launch
     counters reset just before (banded > 0, tile-MT none), its peak
     memory, Mpixel-grads/s, and its parts by CUDA events recorded inside
     it (geom.EVENTS: the interior forward + backward, the silhouette and
     shadow terms, the two Gumbel-max draws); the whole call
     bitwise equal, under torch.use_deterministic_algorithms, to the same
     call with the plain versions in the kernels' place; the 32x32
     cornell2 gradients (material loss, kd and le gradients, vertex
     gradients; naive and block BVH) within the CPU tests' tolerance of
     the JAX package's, committed as tests/data/torch_port_golden_grads.npz;
     the card's Gumbel-max draws bitwise equal to the CPU's; and
     recover_materials for 3 steps at 512x512 (kd from flat 0.5
     toward the frame at the true materials, lr 0.05): finite losses,
     s/step, a non-zero kd gradient for every material the frame sees,
     and a run resumed from its step-2 checkpoint equal to the
     uninterrupted one at step 3.  Each kernel's record gains its
     launches in the gradient call.
 11. the sharded forms (parallel/mesh.py) on the one card, each job's
     ranks spawned as processes that share cuda:0 (so backend gloo; a
     rank that raises fails the phase): a 2-rank gloo job and a 1-rank
     NCCL job.  Each rank builds the conference proxy itself and checks
     it equal on every rank by an all-gathered digest; then the main
     path's 512x512 frame through render_frame_sharded on the 1-D mesh
     (and, in the gloo job, on the (2, 1) mesh of make_mesh_2d), driven
     with the launch counters reset just before: image, bitmap and rays
     bitwise equal to phase 4's, tile-MT and banded launched on every
     rank, each rank's largest batches bitwise equal to the plain
     versions, ms/frame by CUDA events per rank and the host clock of the
     whole sharded frame.  The gloo job then takes train_step_sharded at
     512x512 from phase 10's kd0 (loss and kd, le gradients within the
     CPU tests' tolerance of the one-device step), 3 recover_materials
     steps over the mesh (losses within tolerance of phase 10's, kd
     bitwise equal on both ranks, a resume from the step-2 checkpoint
     equal at step 3) and BASELINE #5 through vertex_grad(mesh=)
     (gradients within the CPU tests' tolerance of phase 10's call; ms by
     CUDA events, Mpixel-grads/s and each rank's peak memory).  Each
     kernel's record gains `launches_sharded`, its launches in the 2-rank
     1-D frame summed over the ranks.
 12. the measuring commands: render_frame_auto on the main path's config
     with a budget of a quarter of its cost (four 65,536-lane chunks),
     with the launch counters reset just before: rays, image and bitmap
     bitwise equal to phase 4's, tile-MT and banded launched in every
     chunk, each chunk's largest batches bitwise equal to the plain
     versions; `python -m mobileraytracer_tpu_torch.bench` (BASELINE #3)
     as a subprocess, its lines echoed with the card, then its run() in
     this process with the counters reset just before: rays per frame
     equal to render_frame's over the bench's 9 frame keys, the last
     frame bitwise equal; bench --shader 2 --spp 1 --reps 2 in this
     process (the chunked path of BASELINE #4: 2 chunks of 131,072 lanes)
     with the counters reset just before: a finite image, rays, both
     kernels launched in every chunk, and each chunk's largest batches of
     its primary step and bounces bitwise equal to the plain versions;
     and `python -m mobileraytracer_tpu_torch.bench_grad` (BASELINE #5),
     whose line must parse with a finite value > 0.  Each kernel's record
     gains `launches_auto` (the chunked frame), `launches_bench` (the
     in-process bench run) and `launches_bench_pt` (the in-process
     chunked PathTracer bench run).
 13. the sweep: `python -m mobileraytracer_tpu_torch.sweep` at its
     defaults (scenes 0 and 2 x Whitted and the PathTracer x ACC_NAIVE and
     ACC_BVH, 256x256, 3 reps) as a subprocess, its lines and .dat rows
     echoed: 8 rows in the JAX sweep's layout, finite positive render_s
     and mrays_s; then the same sweep in this process through sweep.sweep
     with the launch counters reset just before: each scene and shader's
     ACC_NAIVE and ACC_BVH rows cast the same rays, tile-MT and banded
     launched on every ACC_BVH row and no kernel on the others, and the
     largest batch of each kernel and query kind in each row held bitwise
     against the plain versions; and MobileRT's two statistical captures
     through render_frame (cornell2 at 256x256, int_parity, ACC_NAIVE,
     key 0): Whitted at 16 spp within test_golden.py's Monte-Carlo
     tolerance, and the PathTracer at 64 spp by its 16x16 block means and
     global channel bias.  Each kernel's record gains `launches_sweep`,
     its launches in the in-process sweep.
 14. the two-level block BVH and the window knobs: the conference proxy
     through block_bvh.build (build seconds) and the 512x512 Whitted frame
     over it with the launch counters reset just before (finite, rays > 0,
     no kernel launched: the module is plain PyTorch), ms/frame by CUDA
     events (mean of 5 after a warm-up) and one profiled frame's device
     busy time and idle share; its primaries against the exact block
     traversal (never a closer hit; at equal t the same triangle, ties
     aside; the lanes the budgets miss counted) and the first 4,096 of them
     against the CPU (ids on 99.9% of lanes, t within 1e-5); then, with the
     launch counters reset just before, phase 7's primaries and reversed
     shadow rays through traverse under the JAX package's three window
     settings, traverse_tilemt(top_s=16, top_m=64) and traverse_resident at
     res_group 4, 8 and 16: hits and occlusion equal to the default
     windows' (ids may differ only where t is bit-identical, coincident
     triangles, or one ulp farther, the cut's rounding; occlusion only
     where the default windows' blocker lies within one ulp of the
     segment's end, as in phase 7), banded,
     tile-MT and resident launched, each recorded batch
     bitwise equal to its plain version, and the resident kernel's ms,
     bound, registers and shared memory at each g_n.  Each kernel's record
     gains `launches_block_bvh` and `launches_knobs`, and the resident
     record `by_g_n`.
 15. the candidate-window kernel (csrc/candidate_windows.cu) at the main
     path's three shapes (window_shapes): the refill's call, 65,536 rays
     each duplicated into a 16-ray subtile with cap and floor; banded
     window 1 of phase 7's reversed shadow query; the tile-MT window of
     the primaries, 2,048 tiles of 128 at 48/64.  At each, all four
     outputs bitwise equal to block_traversal._candidates_plain (floats by
     their bits), kernel and plain ms by CUDA events, its bound
     (kernels.window_bound) and its registers, shared memory and blocks
     per SM.  Its record gains its launches in the phase-4 frame, the
     PathTracer frame and the gradient call.
The script's seconds, the card's name and power limit and then the
kernels' JSON record come just before the last line, {"ok": true,
"device": {...}}.
"""
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

# cuBLAS's deterministic workspace (phase 10 runs gradients under
# torch.use_deterministic_algorithms); set before the first CUDA call.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden_conference64.npy"
GOLDEN_SHADERS = ROOT / "tests" / "data" / "torch_port_golden_shaders64.npz"
GOLDEN_GRADS = ROOT / "tests" / "data" / "torch_port_golden_grads.npz"
# Held as in tests/test_torch_render.py: the golden comes from XLA's CPU
# code (FMA-contracted arithmetic), the port rounds every operation.
IMG_ATOL = 1e-4
IMG_FRACTION = 0.999
# The PathTracer's, as in tests/test_torch_pathtracer.py: a pixel holds
# when |port - golden| <= 1e-4 + 1e-3 |golden| (the Russian roulette boost
# drives pixels up to ~30), and 99.9% of pixels hold.
PT_RTOL = 1e-3
FRAMES = 5
# Phase 8's PathTracer frame: 16 spp, cut to 2 when 16 times one 1-spp
# frame exceeds a minute (2, not 4, keeps the script with phase 11 near
# eight minutes on the H100).
PT_SPP, PT_SPP_CUT, PT_FRAME_S = 16, 2, 60.0

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


def card_name():
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()


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


def profile_device(run, host_ops=True):
    """Device busy time of run() under torch.profiler, summed over the
    device's own kernel and copy rows.  Returns (busy ms, device events
    recorded, {name: (ms, events)} of the largest rows, {aten operator:
    (ms, calls)} of the host operators whose own device kernels took
    longest; empty without `host_ops`, which traces the device alone)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    with profile(activities=acts) as prof:
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
    card = card_name()
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
    records7, shadow7 = traversal_modes(scene, cfg, key, o, d, pk, pi, b,
                                        card)
    records += records7

    # -- 8 ------------------------------------------------------------------
    pt_launches, pt_err = shaders_phase(scene, cam, small, scam, key, card)
    for rec in records:
        kind = next(k for k, v in KERNELS.items() if v["name"] == rec["name"])
        rec["launches_pathtracer"] = pt_launches[kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], pt_err.get(kind, 0.0))

    # -- 9 ------------------------------------------------------------------
    cli_launches = loaders_phase(cam, key, cfg, img, rays, card)
    for rec in records:
        kind = next(k for k, v in KERNELS.items() if v["name"] == rec["name"])
        rec["launches_cli"] = cli_launches[kind]

    # -- 10 -----------------------------------------------------------------
    grad_launches, grad_err, grad_ref = gradients_phase(scene, cam, card)
    for rec in records:
        kind = next(k for k, v in KERNELS.items() if v["name"] == rec["name"])
        rec["launches_grad"] = grad_launches[kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], grad_err.get(kind, 0.0))

    # -- 11 -----------------------------------------------------------------
    frame4 = dict(image=torch.from_numpy(img), bitmap=out["bitmap"].cpu(),
                  rays=rays)
    shard_launches, shard_err = sharded_phase(frame4, frame_ms, grad_ref,
                                              card)
    for rec in records:
        kind = next(k for k, v in KERNELS.items() if v["name"] == rec["name"])
        rec["launches_sharded"] = shard_launches[kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], shard_err.get(kind, 0.0))

    # -- 12 -----------------------------------------------------------------
    auto_launches, bench_launches, bench_pt_launches, bench_err = (
        measuring_phase(scene, cam, cfg, key, frame4, card))
    for rec in records:
        kind = next(k for k, v in KERNELS.items() if v["name"] == rec["name"])
        rec["launches_auto"] = auto_launches[kind]
        rec["launches_bench"] = bench_launches[kind]
        rec["launches_bench_pt"] = bench_pt_launches[kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], bench_err.get(kind, 0.0))

    # -- 13 -----------------------------------------------------------------
    sweep_launches, sweep_err = sweep_phase(dev, card)
    for rec in records:
        kind = next(k for k, v in KERNELS.items() if v["name"] == rec["name"])
        rec["launches_sweep"] = sweep_launches[kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], sweep_err.get(kind, 0.0))

    # -- 14 -----------------------------------------------------------------
    bvh_launches, knob_launches, knob_err, by_g_n = block_bvh_phase(
        scene, cam, cfg, key, (o, d, pk, pi), shadow7, card)
    for rec in records:
        kind = next(k for k, v in KERNELS.items() if v["name"] == rec["name"])
        rec["launches_block_bvh"] = bvh_launches[kind]
        rec["launches_knobs"] = knob_launches[kind]
        rec["max_abs_err"] = max(rec["max_abs_err"], knob_err.get(kind, 0.0))
        if kind == "resident":
            rec["by_g_n"] = by_g_n

    # -- 15 -----------------------------------------------------------------
    window = windows_phase(scene, (o, d, pk, pi), shadow7, card)
    window.update(launches=launches["window"],
                  launches_pathtracer=pt_launches["window"],
                  launches_grad=grad_launches["window"])
    records.append(window)

    say(15, f"chip_smoke.py took {time.perf_counter() - T_START:.1f} s")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def traversal_modes(scene, cfg, key, o, d, pk, pi, b, card):
    """Phase 7: the "tilebw" and "resident" modes on the 512x512 primaries
    and their NEE shadow batch.  Returns the two kernels' JSON records and
    the shadow rays (o, d, max_dist, prev_kind, prev_id) of its last NEE
    call, the timing loop's over the tile-MT primaries' hits (which differ
    from the tilebw hits only on coincident triangles)."""
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
        def occ(scene_, o_, d_, md, pk_, pi_, coherent=False):
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
    return records, shadow["rays"]


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


# test_golden.py's oracle for the deterministic captures (:55-64): mean
# |diff| below 1.5/255 and under 2% of pixels off by more than 4/255.
GOLD = ROOT / "refgold" / "golden"
CAPTURES = (("cornell_noshadows_256", 0, 0), ("cornell_whitted_256", 0, 1),
            ("cornell_depthmap_256", 0, 3), ("cornell_diffuse_256", 0, 4),
            ("spheres_whitted_256", 1, 1), ("spheres2_whitted_256", 3, 1),
            ("cornell2_depthmap_256", 2, 3), ("cornell2_diffuse_256", 2, 4))


def unpack_bitmap(bitmap):
    bm = np.asarray(bitmap).astype(np.int64)
    return np.stack([(bm >> s) & 0xFF for s in (0, 8, 16)],
                    -1).astype(np.float32) / 255.0


def golden_close(ours, ref, mean_tol=1.5 / 255, outlier_tol=4.0 / 255,
                 outlier_frac=0.02):
    """(holds, mean |diff|, share of pixels off by more than outlier_tol)."""
    diff = np.abs(ours - ref)
    mean = float(diff.mean())
    frac = float((diff.max(axis=-1) > outlier_tol).mean())
    return mean < mean_tol and frac < outlier_frac, mean, frac


def loaders_phase(cam, key, cfg, img4, rays4, card):
    """Phase 9: OBJ loading, Renderer, the command line, the refgold
    captures, the lifecycle and the samplers on the card.  `cam`, `cfg`,
    `img4` and `rays4` are phase 4's camera, config, image and rays.
    Returns the kernels' launches in the command line's frame."""
    import tempfile

    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import (bench_scenes, cli, samplers,
                                           sampling, scenes)
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.loaders import native
    from mobileraytracer_tpu_torch.loaders.obj import (load_obj_scene_ex,
                                                       save_obj_scene)
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.ops import kernels as K
    from mobileraytracer_tpu_torch.renderer import STATE_STOPPED

    dev = key.device
    size = cfg.width
    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = pathlib.Path(tmp)
        proxy, _, _ = bench_scenes.conference_proxy()
        t0 = time.perf_counter()
        written = save_obj_scene(proxy, str(tmp / "conference_proxy.obj"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if native.library() is None:
            raise AssertionError("the native OBJ parser did not build/load")
        build_s = time.perf_counter() - t0
        scene, info = load_obj_scene_ex(str(tmp / "conference_proxy.obj"))
        say(9, f"conference proxy to OBJ+MTL in {save_s:.2f} s "
               f"({written['obj_bytes']} bytes, {written['vertices']} "
               f"vertices); native parser ready in {build_s:.2f} s; loaded "
               f"{info['triangles']} triangles, {info['lights']} lights, "
               f"{info['materials']} materials: parse "
               f"{info['parse_seconds']:.4f} s, fill "
               f"{info['fill_seconds']:.4f} s [{card}]")
        if (info["triangles"], info["lights"]) != (331179, 2):
            raise AssertionError(f"OBJ load: {info}")

        # The loaded arrays are the procedural ones, so phase 4's frame.
        t0 = time.perf_counter()
        r = mrt.Renderer(scene, cam, cfg)
        build_s = time.perf_counter() - t0
        img = r.render()
        same = np.array_equal(img, img4) and r.total_rays == rays4
        say(9, f"{size}x{size} Whitted frame of the loaded OBJ through Renderer "
               f"(block grid built in {build_s:.2f} s): rays "
               f"{r.total_rays} (phase 4: {rays4}), image mean "
               f"{img.mean():.6f}; bitwise equal to phase 4's frame: {same}")
        if not same:
            raise AssertionError("the OBJ frame differs from phase 4's")
        bscene = r.scene

        # The command line on the OBJ, with phase 4's camera as a .cam.
        # Every kernel batch of its frame is kept, and the frame itself is
        # held against the same command line run with the plain versions
        # in the kernels' place.
        (tmp / "conference_proxy.cam").write_text(bench_scenes._FALLBACK_CAM)
        argv = ["--scene", str(C.SCENE_OBJ), "--obj",
                str(tmp / "conference_proxy.obj"), "--cam",
                str(tmp / "conference_proxy.cam"), "--shader", "1", "--spp",
                "1", "--width", str(size), "--height", str(size), "--acc",
                "3", "--quiet", "--metrics-jsonl"]
        images = []
        render = mrt.Renderer.render

        def keep(self, *a, **kw):
            images.append(render(self, *a, **kw))
            return images[-1]

        captured, count = {}, [0]

        def tag(kind, any_hit):
            count[0] += 1
            return kind, (f"cli launch {count[0]} "
                          f"({'any-hit' if any_hit else 'closest'})")

        mrt.Renderer.render = keep
        K.reset_launches()
        restore = recording(captured, tag)
        windows = bt._candidates
        try:
            code = cli.main(argv + [str(tmp / "metrics.jsonl")])
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            restore()
            K.traverse_tilemt, K.traverse_banded = (K.tilemt_plain,
                                                    K.banded_plain)
            bt._candidates = bt._candidates_plain
            plain_code = cli.main(argv + [str(tmp / "plain.jsonl")])
            torch.cuda.synchronize()
        finally:
            restore()
            bt._candidates = windows
            mrt.Renderer.render = render
        line = (tmp / "metrics.jsonl").read_text().strip().splitlines()[-1]
        m = json.loads(line)
        plain_m = json.loads(
            (tmp / "plain.jsonl").read_text().strip().splitlines()[-1])
    say(9, f"cli.main on the OBJ, {size}x{size}, 1 spp, --acc 3: exit {code}, "
           f"launches {launches}, {m['render_seconds'] * 1e3:.3f} ms/frame, "
           f"{m['rays_per_second'] / 1e6:.4f} M rays/s [{card}]")
    say(9, f"metrics line: {line}")
    check_batches(9, captured)
    same = (plain_code == 0 and m["total_rays"] == plain_m["total_rays"]
            and len(images) == 2 and np.array_equal(images[0], images[1]))
    say(9, f"cli.main frame: shape {images[0].shape}, finite "
           f"{bool(np.isfinite(images[0]).all())}, mean "
           f"{images[0].mean():.6f}; with the plain versions: exit "
           f"{plain_code}, rays {plain_m['total_rays']}; bitwise equal: "
           f"{same}")
    if not (code == 0 and m["rays_per_second"] > 0
            and m["total_rays"] >= size * size and same
            and np.isfinite(images[0]).all()
            and sum(a[3].shape[0] > 0 for a in captured.values())
            == launches["tilemt"] + launches["banded"] == launches["window"]
            and all(launches[k] > 0 for k in ("tilemt", "banded"))):
        raise AssertionError("the command line's run failed its checks")

    # The eight analytic captures of the C++ reference.
    held = []
    for name, sid, shader in CAPTURES:
        raw = np.fromfile(GOLD / f"{name}.bin", dtype=np.int32)
        w, h = int(raw[0]), int(raw[1])
        ref = unpack_bitmap(raw[2:].reshape(h, w))
        sc, cm = scenes.load_builtin(sid, 1.0)
        cfg_g = mrt.RenderConfig(width=w, height=h, shader=shader,
                                 accelerator=C.ACC_NAIVE, scene_id=sid,
                                 accumulation="int_parity")
        out = mrt.render_frame(sc.to(dev), cm, cfg_g, sampling.prng_key(0),
                               scenes.DEPTHMAP_MAX_POINT[sid])
        held.append((name,) + golden_close(unpack_bitmap(
            out["bitmap"].cpu().numpy()), ref))
    say(9, "refgold captures at 256x256 (int_parity, ACC_NAIVE) vs the C++ "
           "reference: " + "; ".join(
               f"{n} holds {ok} (mean {mean * 255:.3f}/255, outliers "
               f"{frac:.4f})" for n, ok, mean, frac in held))
    if not all(ok for _, ok, _, _ in held):
        raise AssertionError("a refgold capture disagrees")

    # The lifecycle on the card: a checkpoint resume and an async stop.
    lc = mrt.RenderConfig(width=size // 4, height=size // 4, spp=6,
                          shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                          nee_share=128, nee_share_secondary=True)
    full = mrt.Renderer(bscene, cam, lc)
    frames = [full.bitmap]
    img_full = full.render(callback=lambda rr: frames.append(rr.bitmap))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(pathlib.Path(tmp) / "render.npz")
        a = mrt.Renderer(bscene, cam, lc)
        a.render(callback=lambda rr: rr.sample == 2 and rr.stop_render())
        a.save_checkpoint(path)
        b = mrt.Renderer(bscene, cam, lc)
        b.load_checkpoint(path)
        img_b = b.render()
    resumed = (a.sample == 2 and np.array_equal(img_b, img_full)
               and b.total_rays == full.total_rays)
    c = mrt.Renderer(bscene, cam, dataclasses.replace(lc, spp=100000))
    c.render_async()
    polls = []
    deadline = time.time() + 60
    while c.sample < 2 and time.time() < deadline:
        polls.append((c.sample, c.bitmap, c.sample))
        time.sleep(0.002)
    c.stop_render()
    state = c.wait(60)
    whole = all(any(np.array_equal(bm, f) for f in frames)
                for s0, bm, s1 in polls if s1 < len(frames))
    say(9, f"lifecycle on the card ({lc.width}x{lc.height} of the loaded "
           f"OBJ): resumed at "
           f"sample 2 from a checkpoint, bitwise equal to the uninterrupted "
           f"{lc.spp}-spp render: {resumed}; render_async stopped by the "
           f"poller after {c.sample} samples, state {state}, {len(polls)} "
           f"polled bitmaps each a whole frame: {whole}; "
           f"{c.stats_line()}")
    if not (resumed and state == STATE_STOPPED and whole and c.sample >= 2):
        raise AssertionError("the lifecycle failed its checks")

    # The samplers' draws on the card against the CPU's.
    pids = torch.arange(size * size, dtype=torch.int32)
    k3 = sampling.prng_key(3)
    diff = []
    for name in samplers.SAMPLER_NAMES:
        for s in (0, 5):
            got = samplers.pixel_jitter(name, k3.to(dev), pids.to(dev), s,
                                        size * size).cpu()
            want = samplers.pixel_jitter(name, k3, pids, s, size * size)
            if not torch.equal(got.view(torch.int32),
                               want.view(torch.int32)):
                diff.append((name, s))
    for base in (2, 3):
        idx = torch.arange(1 << 20, dtype=torch.int64) * 4099
        if not torch.equal(sampling.halton(idx.to(dev), base).cpu(),
                           sampling.halton(idx, base)):
            diff.append(("halton", base))
    say(9, f"pixel_jitter of the {len(samplers.SAMPLER_NAMES)} samplers "
           f"({size}x{size}, samples 0 and 5) and halton (bases 2, 3) on the "
           f"card: "
           f"bitwise equal to the CPU's: {not diff} {diff or ''}")
    if diff:
        raise AssertionError(f"card draws differ from the CPU's: {diff}")
    say(9, f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return launches



# Phase 10's golden, as tests/test_torch_golden_grads.py computes it.
GRAD_SIZE = 32
GRAD_VKW = dict(edge_samples=4, edge_budget=64, shadow_edges=True,
                shadow_budget=32)
GRAD_LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-3, 1e-5


def grads_close(got, want):
    """(holds, max abs err): finite, and within GRAD_RTOL or GRAD_ATOL_REL
    times the largest |want| entry-wise."""
    got = got.detach().cpu().numpy()
    err = np.abs(got - want)
    tol = GRAD_RTOL * np.abs(want) + GRAD_ATOL_REL * np.abs(want).max()
    return bool(np.isfinite(got).all() and (err <= tol).all()), \
        float(err.max())


def golden_grads(dev):
    """The 32x32 cornell2 gradients against the JAX package's golden.
    Returns the largest relative error seen."""
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch import sampling, scenes
    from mobileraytracer_tpu_torch.diff import geom
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.parallel import mesh as pmesh
    gold = np.load(GOLDEN_GRADS)
    target = torch.from_numpy(gold["target"])
    held = []
    for acc, acc_id in (("naive", C.ACC_NAIVE), ("bvh", C.ACC_BVH)):
        sc, cm = scenes.load_builtin(C.SCENE_CORNELL2, 1.0)
        le = sc.materials.le.clone()
        le[0] = torch.from_numpy(gold["le0"])
        sc = sc.replace(materials=sc.materials.replace(le=le))
        sc = bt.build(sc, device=dev) if acc == "bvh" else sc.to(dev)
        cfg = mrt.RenderConfig(width=GRAD_SIZE, height=GRAD_SIZE, spp=1,
                               shader=C.SHADER_WHITTED, accelerator=acc_id,
                               scene_id=C.SCENE_CORNELL2)
        loss, g = pmesh.train_step_sharded(sc, cm, cfg,
                                           sampling.prng_key(1, dev), target)
        vloss, vg = geom.vertex_grad(sc, cm, cfg, sampling.prng_key(3, dev),
                                     edge_keep=geom.edge_topology(
                                         sc.triangles), **GRAD_VKW)
        got = {"kd": g["kd"], "le": g["le"], **vg}
        checks = [(k, *grads_close(got[k], gold[f"{acc}_{k}"])) for k in got]
        for k, l in (("loss", loss), ("vloss", vloss)):
            want = float(gold[f"{acc}_{k}"])
            rel = abs(float(l) - want) / abs(want)
            checks.append((k, rel <= GRAD_LOSS_RTOL, rel))
        say(10, f"cornell2 {GRAD_SIZE}x{GRAD_SIZE} {acc}: material loss "
                f"{float(loss):.7f} (JAX {float(gold[acc + '_loss']):.7f}), "
                f"vertex loss {float(vloss):.7f} (JAX "
                f"{float(gold[acc + '_vloss']):.7f}); max abs err "
                + ", ".join(f"{k} {e:.3e}" for k, _, e in checks)
                + f"; within the CPU tests' tolerance: "
                  f"{all(ok for _, ok, _ in checks)}")
        held += checks
    if not all(ok for _, ok, _ in held):
        raise AssertionError("gradients disagree with the JAX golden")


def gradients_phase(scene, cam, card):
    """Phase 10: BASELINE #5's vertex gradients and the material trainer on
    the card.  Returns ({kind: launches in the timed gradient call},
    {kind: max abs err of its batches against the plain version})."""
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch import sampling, threefry
    from mobileraytracer_tpu_torch.diff import geom
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.ops import kernels as K
    from mobileraytracer_tpu_torch.parallel import mesh as pmesh
    from mobileraytracer_tpu_torch.parallel import recover
    t_phase = time.perf_counter()
    dev = scene.device
    cam = cam.to(dev)
    size = 512
    cfg = mrt.RenderConfig(width=size, height=size, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                           nee_share=128)
    keep = geom.edge_topology(scene.triangles)
    vkw = dict(edge_samples=8, edge_keep=keep, edge_budget=4096,
               shadow_edges=True, shadow_budget=1024)
    gkey = sampling.prng_key(0, dev)
    say(10, f"BASELINE #5: {size}x{size} Whitted over the block BVH, "
            f"{int(keep.sum())} of {keep.size} edges kept, "
            f"{vkw['edge_budget']} silhouette and {vkw['shadow_budget']} "
            f"shadow draws x "
            f"{vkw['edge_samples']} samples")

    def vg():
        return geom.vertex_grad(scene, cam, cfg, gkey, **vkw)

    # Warm-up, under torch.profiler, with the banded batches and the two
    # edge draws' arguments recorded.
    captured, draws = {}, []
    restore = recording(captured, lambda kind, any_hit: (
        kind, "shadow (any-hit)" if any_hit else "closest"))
    gumbel = K.gumbel_argmax

    def record_draw(key, logits, k, table):
        draws.append((key.clone(), logits.clone(), k))
        return gumbel(key, logits, k, table)
    K.gumbel_argmax = record_draw
    try:
        busy, events, top, _ = profile_device(vg, host_ops=False)
    finally:
        restore()
        K.gumbel_argmax = gumbel
    err, _, _ = check_batches(10, captured)
    t_warm = time.perf_counter() - t_phase

    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    geom.EVENTS = {}
    out = {}
    try:
        call_ms = event_ms(lambda: out.update(r=vg()))
        parts = {k: sum(a.elapsed_time(b) for a, b in ev)
                 for k, ev in geom.EVENTS.items()}
    finally:
        geom.EVENTS = None
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    loss, grads = out["r"]
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    mpx = size * size / (call_ms / 1e3) / 1e6
    n_edges = 3 * scene.triangles.capacity
    say(10, f"vertex_grad: {call_ms:.3f} ms by CUDA events, {mpx:.6f} "
            f"Mpixel-grads/s; loss {float(loss):.7f}; grads finite {finite},"
            f" max |g| " + ", ".join(f"{k} {float(g.abs().max()):.4e}"
                                     for k, g in grads.items())
            + f"; launches {launches}; peak memory {peak} bytes "
              f"({peak / 2**30:.3f} GiB) [{card}]")
    say(10, "its parts by CUDA events (ms): interior forward + backward "
            f"{parts['interior']:.3f}; silhouette term "
            f"{parts['silhouette']:.3f} and shadow term "
            f"{parts['shadow']:.3f}, each with its edge "
            f"draw; the two Gumbel-max draws {parts['draws']:.3f} "
            f"({(4096 + 1024) * n_edges} draws over {n_edges} edges, share "
            f"{parts['draws'] / call_ms:.3f} of the call) [{card}]")
    say(10, f"the warm-up call under torch.profiler: device busy "
            f"{busy:.3f} ms, idle share {1.0 - busy / call_ms:.3f} of the "
            f"timed call, {events} device events; largest device rows (ms): "
            + "; ".join(f"{k[:60]} {ms:.3f} ({n})"
                        for k, (ms, n) in top.items())
            + f" [{card}]")
    if not (finite and launches["banded"] > 0 and launches["tilemt"] == 0
            and launches["gumbel"] == 2
            and all(float(g.abs().max()) > 0 for g in grads.values())):
        raise AssertionError("the gradient call failed its checks")

    say(10, f"the profiled warm-up done at {t_warm:.1f} s, the timed call "
            f"at {time.perf_counter() - t_phase:.1f} s")
    # The whole call against the plain versions, deterministically (the
    # NaN fill of new tensors would only cost time here).
    torch.use_deterministic_algorithms(True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        l1, g1 = vg()
        saved = (K.traverse_tilemt, K.traverse_banded, K.gumbel_argmax,
                 bt._candidates)
        K.traverse_tilemt, K.traverse_banded = K.tilemt_plain, K.banded_plain
        K.gumbel_argmax = lambda key, logits, k, table: (
            threefry.categorical(key, logits, k, table=table))
        bt._candidates = bt._candidates_plain
        try:
            l2, g2 = vg()
        finally:
            (K.traverse_tilemt, K.traverse_banded, K.gumbel_argmax,
             bt._candidates) = saved
        same = torch.equal(l1, l2) and all(torch.equal(g1[k], g2[k])
                                           for k in g1)
        say(10, f"vertex_grad under deterministic algorithms, kernels vs "
                f"plain versions: bitwise equal {same} (max abs err "
                + ", ".join(f"{k} {float((g1[k] - g2[k]).abs().max()):.3e}"
                            for k in g1) + ")")
        if not same:
            raise AssertionError("vertex_grad differs with the plain versions")
        say(10, f"held against the plain versions at "
                f"{time.perf_counter() - t_phase:.1f} s")
        golden_grads(dev)
        gumbel_draws(draws, card)

        # The trainer: 3 recovery steps toward the frame at the true kd.
        target = mrt.render_frame(scene, cam, cfg, gkey)["image"]
        kd0 = torch.full_like(scene.materials.kd, 0.5)
        prep = pmesh.prepared(scene, cam, cfg, gkey, target)
        _, g0 = pmesh.loss_and_grads(
            dict(pmesh.material_params(scene.materials), kd=kd0), scene, cfg,
            prep, ("kd",))
        o, d = mrt_primaries(scene, cam, cfg)
        b = o.shape[0]
        hit = bt.intersect_scene_blocks(
            scene, o, d, torch.zeros(b, dtype=torch.int32, device=dev),
            torch.full((b,), -1, dtype=torch.int32, device=dev), mode="tilemt")
        seen = torch.unique(hit.mat_id[hit.mat_id >= 0]).long()
        moved = (g0["kd"][seen].abs().amax(1) > 0)
        ck = pathlib.Path(tempfile.mkdtemp()) / "opt.npz"
        kw = dict(steps=3, params_subset=("kd",), learning_rate=0.05,
                  base_key=gkey, init_params={"kd": kd0},
                  checkpoint_path=str(ck), checkpoint_every=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p3, losses = recover.recover_materials(scene, cam, cfg, target, **kw)
        torch.cuda.synchronize()
        per_step = (time.perf_counter() - t0) / 3
        p3r, losses_r = recover.recover_materials(scene, cam, cfg, target,
                                                  resume=True, **kw)
        ck.unlink()
        resumed = (torch.equal(p3["kd"], p3r["kd"])
                   and np.array_equal(losses, losses_r))
        say(10, f"recover_materials, 3 steps (kd from 0.5, lr 0.05, "
                f"{size}x{size}): losses {losses.tolist()}, "
                f"{per_step:.3f} s/step (host clock, checkpoint included); "
                f"{len(seen)} materials seen, {int(moved.sum())} with a "
                f"non-zero kd gradient; resumed from the step-2 checkpoint: "
                f"losses {losses_r.tolist()}, step 3 bitwise equal {resumed}"
                f" [{card}]")
        if not (np.isfinite(losses).all() and bool(moved.all())
                and len(seen) > 0 and resumed):
            raise AssertionError("the recovery steps failed their checks")
        # Phase 11's reference: the one-device training step from kd0.
        s0 = scene.replace(materials=scene.materials.replace(kd=kd0))
        tl, tg = pmesh.train_step_sharded(s0, cam, cfg, gkey, target)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    say(10, f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    ref = dict(target=target.cpu(), kd0=kd0.cpu(),
               losses=torch.from_numpy(losses),
               vg_loss=float(loss), vg=cpu(grads), vg_ms=call_ms,
               train_loss=float(tl), train=cpu(tg), per_step=per_step)
    return launches, err, ref


def gumbel_draws(draws, card):
    """Phase 10: the Gumbel-max kernel against its plain version,
    threefry.categorical (which the CPU tests hold bit for bit against
    jax.random.categorical), on the card at a gradient call's two draws
    (key, logits, rows): bitwise, then timed beside its bound."""
    from mobileraytracer_tpu_torch import threefry
    from mobileraytracer_tpu_torch.ops import _build
    from mobileraytracer_tpu_torch.ops import kernels as K
    ki = _build.kernel_info("gumbel")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(10, f"gumbel_argmax: {ki['regs']} registers, {ki['local_bytes']} "
            f"spilled bytes per thread, {ki['static_smem']} B of shared "
            f"memory, {ki['threads']} threads per block -> "
            f"{ki['blocks_per_sm']} blocks per SM = "
            f"{ki['blocks_per_sm'] * ki['threads'] // 32} of 64 warps, "
            f"{ki['blocks_per_sm'] * sms} blocks at once [{card}]")
    for key, logits, k in draws:
        table = threefry._gumbel_table(logits.device)
        got = K.gumbel_argmax(key, logits, k, table)
        want = threefry.categorical(key, logits, k)
        same = torch.equal(got, want)
        k_ms = cuda_ms(lambda: K.gumbel_argmax(key, logits, k, table), 10)
        p_ms = cuda_ms(lambda: threefry.categorical(key, logits, k), 1)
        e = logits.shape[0]
        bound = K.gumbel_bound_ms(k, e)
        say(10, f"gumbel_argmax, {k} x {e} draws ({k * e} counts, "
                f"{k * e * K.GUMBEL_INT_OPS:.4e} int ops): {k_ms:.4f} ms by "
                f"CUDA events, plain version {p_ms:.3f} ms, bound "
                f"{bound:.4f} ms (int32), share {bound / k_ms:.3f}; "
                f"{len(torch.unique(got))} distinct edges; bitwise equal to "
                f"the plain version: {same} [{card}]")
        if not same:
            raise AssertionError(f"gumbel_argmax {k} x {e}: kernel != plain "
                                 f"version")


# Phase 11: the jobs of ranks that share the card, (backend, ranks, what
# each runs beyond the 1-D frame), and the seconds each job may take.
SHARDED_JOBS = (("gloo", 2, ("2-D", "grads")), ("nccl", 1, ()))
SHARDED_S = 420
SHARDED_SIZE = 512


def spawn_ranks(fn, args, nprocs, timeout_s):
    """Runs fn(rank, *args) in `nprocs` spawned processes and waits for all
    of them; a rank that raises makes this raise (and the others are
    stopped), as does a job that outlasts `timeout_s`."""
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks ran over {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def sharded_frame(pmesh, mesh, name, scene, cam, cfg, key, ref, tag, card):
    """One rank's part of the sharded main-path frame: driven once with the
    launch counters reset just before and the largest batches recorded,
    held bitwise against phase 4's frame, the batches against the plain
    versions, then timed.  Returns the rank's record."""
    from mobileraytracer_tpu_torch.ops import kernels as K

    def frame():
        return pmesh.render_frame_sharded(scene, cam, cfg, key, mesh)

    captured = {}
    restore = recording(captured, lambda kind, any_hit: (
        kind, "primary" if kind == "tilemt" else
        "shadow (any-hit)" if any_hit else "refill (closest)"))
    try:
        K.reset_launches()
        out = frame()
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    finally:
        restore()
    same = (torch.equal(out["image"].cpu(), ref["image"])
            and torch.equal(out["bitmap"].cpu(), ref["bitmap"])
            and int(out["rays"]) == ref["rays"])
    say(11, f"{tag}, {name} mesh {tuple(mesh.mesh.shape)}: frame rays "
            f"{int(out['rays'])}, launches {launches}; image, bitmap and "
            f"rays bitwise equal to phase 4's: {same}")
    if not (same and launches["tilemt"] > 0 and launches["banded"] > 0):
        raise AssertionError(f"{tag}: the {name} sharded frame failed")
    err, _, _ = check_batches(f"11, {tag}", captured)
    ms = cuda_ms(frame, FRAMES)
    walls = []
    for _ in range(FRAMES):
        pmesh.barrier(mesh)
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    say(11, f"{tag}, {name} mesh: {ms:.3f} ms/frame by CUDA events on this "
            f"rank (mean of {FRAMES}); host clock of the whole sharded frame"
            f" min {min(walls):.3f} median {statistics.median(walls):.3f} "
            f"ms [{card}]")
    return dict(launches=launches, err=err, ms=ms, wall_min=min(walls),
                wall_median=statistics.median(walls))


def sharded_grads(pmesh, mesh, scene, cam, ref, tag, card, work):
    """One rank's part of the sharded training step, 3 recovery steps with
    a resume, and BASELINE #5 through vertex_grad(mesh=), each held against
    phase 10's one-device result.  Returns the rank's record."""
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch import sampling
    from mobileraytracer_tpu_torch.diff import geom
    from mobileraytracer_tpu_torch.parallel import recover
    dev = scene.device
    size = SHARDED_SIZE
    cfg = mrt.RenderConfig(width=size, height=size, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                           nee_share=128)
    gkey = sampling.prng_key(0, dev)
    kd0, target = ref["kd0"].to(dev), ref["target"].to(dev)
    rel = lambda a, b: abs(a - b) / abs(b)

    s0 = scene.replace(materials=scene.materials.replace(kd=kd0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, g = pmesh.train_step_sharded(s0, cam, cfg, gkey, target, mesh)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    checks = [("loss", rel(float(loss), ref["train_loss"]) <= GRAD_LOSS_RTOL,
               rel(float(loss), ref["train_loss"]))]
    checks += [(k, *grads_close(g[k], ref["train"][k].numpy()))
               for k in ("kd", "le")]
    say(11, f"{tag}: train_step_sharded at {size}x{size} (kd from 0.5) in "
            f"{step_s:.3f} s (host clock, first call); loss {float(loss):.7f}"
            f" (one device {ref['train_loss']:.7f}); max abs err "
            + ", ".join(f"{k} {e:.3e}" for k, _, e in checks)
            + f"; within the CPU tests' tolerance: "
              f"{all(ok for _, ok, _ in checks)} [{card}]")
    if not all(ok for _, ok, _ in checks):
        raise AssertionError(f"{tag}: the sharded step differs")

    ck = work / "opt.npz"
    kw = dict(steps=3, params_subset=("kd",), learning_rate=0.05,
              base_key=gkey, init_params={"kd": kd0},
              checkpoint_path=str(ck), checkpoint_every=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p3, losses = recover.recover_materials(scene, cam, cfg, target, mesh,
                                           **kw)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / 3
    same = pmesh.same_on_every_rank(p3, mesh)
    t0 = time.perf_counter()
    p3r, losses_r = recover.recover_materials(scene, cam, cfg, target, mesh,
                                              resume=True, **kw)
    torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    resumed = (torch.equal(p3["kd"], p3r["kd"])
               and np.array_equal(losses, losses_r))
    close = bool(np.allclose(losses, ref["losses"].numpy(),
                             rtol=GRAD_LOSS_RTOL, atol=0.0))
    say(11, f"{tag}: recover_materials(mesh=), 3 steps: losses "
            f"{losses.tolist()} (one device {ref['losses'].tolist()}, within "
            f"rtol {GRAD_LOSS_RTOL}: {close}), {per_step:.3f} s/step (host "
            f"clock, checkpoint included; one device {ref['per_step']:.3f});"
            f" kd bitwise equal on every rank: {same}; resumed from the "
            f"step-2 checkpoint, step 3 bitwise equal: {resumed} (the "
            f"resumed call, its one step: {resumed_s:.3f} s) [{card}]")
    if not (close and same and resumed):
        raise AssertionError(f"{tag}: the sharded recovery failed")

    keep = geom.edge_topology(scene.triangles)
    vkw = dict(edge_samples=8, edge_keep=keep, edge_budget=4096,
               shadow_edges=True, shadow_budget=1024)

    def vg():
        return geom.vertex_grad(scene, cam, cfg, gkey, mesh=mesh, **vkw)

    vg()                                            # warm-up
    torch.cuda.reset_peak_memory_stats()
    out = {}
    ms = event_ms(lambda: out.update(r=vg()))
    peak = torch.cuda.max_memory_allocated()
    vloss, vgr = out["r"]
    checks = [("loss", rel(float(vloss), ref["vg_loss"]) <= GRAD_LOSS_RTOL,
               rel(float(vloss), ref["vg_loss"]))]
    checks += [(k, *grads_close(vgr[k], ref["vg"][k].numpy())) for k in vgr]
    say(11, f"{tag}: BASELINE #5 through vertex_grad(mesh=): {ms:.3f} ms "
            f"by CUDA events ({size * size / (ms / 1e3) / 1e6:.6f} Mpixel-grads/s;"
            f" one device {ref['vg_ms']:.3f} ms), peak memory {peak} bytes "
            f"({peak / 2**30:.3f} GiB) on this rank; max abs err "
            + ", ".join(f"{k} {e:.3e}" for k, _, e in checks)
            + f"; within the CPU tests' tolerance of phase 10's: "
              f"{all(ok for _, ok, _ in checks)} [{card}]")
    if not all(ok for _, ok, _ in checks):
        raise AssertionError(f"{tag}: the sharded vertex gradients differ")
    return dict(step_s=step_s, per_step=per_step, resumed_s=resumed_s,
                vg_ms=ms, peak=peak)


def sharded_rank(rank, world, backend, work, jobs, card):
    """Phase 11's rank `rank` of `world`: joins the job, builds the
    conference proxy (checked equal on every rank), then runs the 1-D
    frame and `jobs` and writes its record to work/rank{rank}.json.
    Raises on any failed check."""
    import datetime
    from mobileraytracer_tpu_torch import bench_scenes, sampling
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.ops import _build
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.parallel import mesh as pmesh
    work = pathlib.Path(work)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    pmesh.distributed_init(f"file://{work / 'store'}", world, rank,
                           backend=backend,
                           timeout=datetime.timedelta(seconds=SHARDED_S))
    meshes = {"1-D": pmesh.make_mesh()}
    if "2-D" in jobs:
        meshes["2-D"] = pmesh.make_mesh_2d(n_hosts=world)
    dev = pmesh.rank_device()
    tag = f"{backend} rank {rank} of {world} on {dev}"
    ref = torch.load(work.parent / "ref.pt")
    _build.load()
    t0 = time.perf_counter()
    scene, cam, _ = bench_scenes.conference_proxy()
    scene = bt.build(scene, device=dev)
    cam = cam.to(dev)
    pmesh.check_replicated(scene, meshes["1-D"])
    say(11, f"{tag}: conference proxy built in "
            f"{time.perf_counter() - t0:.2f} s, bitwise the same on every "
            f"rank (digest all-gathered)")
    cfg = mrt.RenderConfig(width=SHARDED_SIZE, height=SHARDED_SIZE, spp=1,
                           shader=C.SHADER_WHITTED, accelerator=C.ACC_BVH,
                           nee_share=128, nee_share_secondary=True)
    key = sampling.prng_key(0, dev)
    rec = {name: sharded_frame(pmesh, mesh, name, scene, cam, cfg, key, ref,
                               tag, card)
           for name, mesh in meshes.items()}
    if "grads" in jobs:
        rec["grads"] = sharded_grads(pmesh, meshes["1-D"], scene, cam, ref,
                                     tag, card, work)
    (work / f"rank{rank}.json").write_text(json.dumps(rec))
    torch.distributed.destroy_process_group()


def sharded_phase(frame4, frame_ms, grad_ref, card):
    """Phase 11: the sharded forms on the one card, each job's ranks
    sharing cuda:0.  Returns ({kind: launches in the 2-rank gloo 1-D frame,
    summed over its ranks}, {kind: max abs err of the ranks' batches
    against the plain versions})."""
    t_phase = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp())
    torch.save(dict(frame4, **grad_ref), root / "ref.pt")
    torch.cuda.empty_cache()
    recs = []
    for backend, world, jobs in SHARDED_JOBS:
        work = root / f"{backend}{world}"
        work.mkdir()
        t0 = time.perf_counter()
        spawn_ranks(sharded_rank, (world, backend, str(work), jobs, card),
                    world, SHARDED_S)
        recs.append((backend, [json.loads((work / f"rank{r}.json").read_text())
                               for r in range(world)]))
        say(11, f"the {backend} job of {world} rank(s) took "
                f"{time.perf_counter() - t0:.1f} s")
    for backend, rs in recs:
        for r, rec in enumerate(rs):
            say(11, f"{backend} rank {r}: " + "; ".join(
                f"{name} frame {f['ms']:.3f} ms by CUDA events, host clock "
                f"median {f['wall_median']:.3f} ms"
                for name, f in rec.items() if name != "grads")
                + f" (phase 6, one device: {frame_ms:.3f} ms/frame)"
                + (f"; vertex_grad {rec['grads']['vg_ms']:.3f} ms (phase "
                   f"10: {grad_ref['vg_ms']:.3f} ms)" if "grads" in rec
                   else "") + f" [{card}]")
    first = [rec["1-D"] for rec in recs[0][1]]
    launches = {k: sum(r["launches"][k] for r in first) for k in KERNELS}
    err = {}
    for _, rs in recs:
        for rec in rs:
            for name, f in rec.items():
                for k, e in f.get("err", {}).items():
                    err[k] = max(err.get(k, 0.0), e)
    say(11, f"launches in the 2-rank gloo 1-D frame, summed over its ranks: "
            f"{launches}; phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return launches, err


# Phase 12: the seconds a measuring command may take as a subprocess.
BENCH_S = 600


def bench_line(module, args, card):
    """Runs `python -m mobileraytracer_tpu_torch.<module> <args>` as a user
    runs it, echoes what it printed with the card, and returns its JSON
    line (a nonzero exit raises)."""
    cmd = [sys.executable, "-m", f"mobileraytracer_tpu_torch.{module}",
           *args]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=BENCH_S)
    if run.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited {run.returncode}:"
                             f" {run.stderr[-3000:]}")
    lines = run.stdout.strip().splitlines()
    say(12, f"python {' '.join(cmd[1:])} ({time.perf_counter() - t0:.1f} s"
            f" with its start): " + " | ".join(lines) + f" [{card}]")
    return json.loads(lines[-1])


def measuring_phase(scene, cam, cfg, key, frame4, card):
    """Phase 12: render_frame_auto's chunked 512x512 frame, and the bench
    and bench_grad commands.  Returns ({kind: launches in the chunked
    frame}, {kind: launches in the in-process default bench run}, {kind:
    launches in the in-process chunked PathTracer bench run}, {kind: max
    abs err of the chunks' batches against the plain version})."""
    from mobileraytracer_tpu_torch import bench, renderer, sampling
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.ops import kernels as K
    from mobileraytracer_tpu_torch.shaders import engine
    t_phase = time.perf_counter()

    # (a) The main path's frame in four chunks, each sample_pixels call of
    # render_frame_auto one chunk (1 spp).
    budget = renderer._dispatch_cost(cfg) / 4
    n_chunks, chunk = renderer._chunk_geometry(cfg, budget)
    sampler = renderer.sample_pixels
    at = {"chunk": -1}

    def next_chunk(*args, **kwargs):
        at["chunk"] += 1
        return sampler(*args, **kwargs)

    captured = {}
    renderer.sample_pixels = next_chunk
    restore = recording(captured,
                        lambda kind, any_hit: (kind, f"chunk {at['chunk']}"))
    try:
        K.reset_launches()
        out = renderer.render_frame_auto(scene, cam, cfg, key, budget=budget)
        torch.cuda.synchronize()
        launches_auto = dict(K.LAUNCHES)
    finally:
        restore()
        renderer.sample_pixels = sampler
    same = (int(out["rays"]) == frame4["rays"]
            and torch.equal(out["bitmap"].cpu(), frame4["bitmap"])
            and torch.equal(out["image"].cpu(), frame4["image"]))
    in_chunk = [sorted(k for k, w in captured if w == f"chunk {i}")
                for i in range(n_chunks)]
    say(12, f"render_frame_auto, budget {budget:.0f} units (cost "
            f"{renderer._dispatch_cost(cfg):.0f}): {n_chunks} chunks of "
            f"{chunk} lanes (sample_pixels calls: {at['chunk'] + 1}); rays "
            f"{int(out['rays'])} (phase 4: {frame4['rays']}); image and "
            f"bitmap bitwise equal to phase 4's: {same}; kernels in each "
            f"chunk {in_chunk}; launches {launches_auto}")
    if not (n_chunks >= 4 and at["chunk"] + 1 == n_chunks and same
            and all(k == ["banded", "tilemt"] for k in in_chunk)):
        raise AssertionError("the chunked frame failed its checks")
    err, _, _ = check_batches(12, captured)

    # (b) The default bench (BASELINE #3) as a user runs it, then in this
    # process, held against render_frame over the bench's own frame keys
    # fold_in(key, i) (phase 4's frame has the key itself).
    bench_line("bench", [], card)
    K.reset_launches()
    rays_b, dt_b, out_b = bench.run(bench.build_parser().parse_args([]))
    torch.cuda.synchronize()
    launches_bench = dict(K.LAUNCHES)
    refs = [renderer.render_frame(scene, cam, cfg, sampling.fold_in(key, i))
            for i in range(9)]
    want = sum(int(r["rays"]) for r in refs) // len(refs)
    last = torch.equal(out_b["image"], refs[-1]["image"])
    say(12, f"bench in this process: {rays_b} rays per frame (render_frame "
            f"over the 9 frame keys: {want}), {dt_b * 1e3:.3f} ms/frame, "
            f"{rays_b / dt_b:.1f} rays/s; last frame bitwise equal to "
            f"render_frame's: {last}; launches {launches_bench} [{card}]")
    if not (rays_b == want and last and launches_bench["tilemt"] > 0
            and launches_bench["banded"] > 0):
        raise AssertionError("the bench run failed its checks")

    # (c) The PathTracer at 1 spp: above the budget, so two chunks of
    # 131,072 lanes, whose compaction and NEE groups follow the chunk.  The
    # largest batch of each kernel in each chunk's primary step and bounces
    # is recorded and held against the plain versions.
    args = ["--shader", "2", "--spp", "1", "--reps", "2"]
    pt = dataclasses.replace(cfg, shader=C.SHADER_PATHTRACER)
    n_pt, chunk_pt = renderer._chunk_geometry(pt,
                                              renderer.DISPATCH_UNIT_BUDGET)
    at = {"chunk": -1, "step0": 0}

    def next_pt_chunk(*args, **kwargs):
        at["chunk"] += 1
        at["step0"] = engine.WALK["steps"]
        return sampler(*args, **kwargs)

    def pt_tag(kind, any_hit):
        step = ("primary step" if engine.WALK["steps"] == at["step0"]
                else "bounces")
        return kind, (f"PathTracer chunk {at['chunk'] % n_pt} {step} "
                      f"({'any-hit' if any_hit else 'closest'})")

    captured_pt = {}
    renderer.sample_pixels = next_pt_chunk
    restore = recording(captured_pt, pt_tag)
    try:
        K.reset_launches()
        rays_c, dt_c, out_c = bench.run(bench.build_parser().parse_args(args))
        torch.cuda.synchronize()
        launches_pt = dict(K.LAUNCHES)
    finally:
        restore()
        renderer.sample_pixels = sampler
    finite = bool(torch.isfinite(out_c["image"]).all())
    in_chunk = [sorted({k for k, w in captured_pt
                        if w.startswith(f"PathTracer chunk {i} ")})
                for i in range(n_pt)]
    say(12, f"bench {' '.join(args)}: dispatch cost "
            f"{renderer._dispatch_cost(pt):.0f} units, {n_pt} chunks of "
            f"{chunk_pt} lanes (sample_pixels calls over the bench's 4 "
            f"frames: {at['chunk'] + 1}); {rays_c} rays per frame, "
            f"{dt_c * 1e3:.3f} ms/frame with the recorders in place, "
            f"{rays_c / dt_c:.1f} rays/s; image finite {finite}, mean "
            f"{float(out_c['image'].mean()):.6f}; kernels in each chunk "
            f"{in_chunk}; launches {launches_pt} [{card}]")
    if not (renderer._dispatch_cost(pt) > renderer.DISPATCH_UNIT_BUDGET
            and n_pt >= 2 and at["chunk"] + 1 == 4 * n_pt
            and finite and rays_c > 0
            and all(k == ["banded", "tilemt"] for k in in_chunk)):
        raise AssertionError("the chunked PathTracer bench failed its checks")
    err_pt, _, _ = check_batches(12, captured_pt)
    for kind, e in err_pt.items():
        err[kind] = max(err.get(kind, 0.0), e)

    # (d) BASELINE #5 as a user runs it.
    grad = bench_line("bench_grad", [], card)
    if not (grad["metric"] == "mpixel_grads_per_second"
            and np.isfinite(grad["value"]) and grad["value"] > 0):
        raise AssertionError("bench_grad's line failed its checks")
    say(12, f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return launches_auto, launches_bench, launches_pt, err


# Phase 13: the seconds the sweep may take as a subprocess.
SWEEP_S = 600


def sweep_phase(dev, card):
    """Phase 13: the sweep command, the same sweep in this process on `dev`
    with the kernels recorded, and MobileRT's two statistical captures on
    `dev`.  Returns
    ({kind: launches in the in-process sweep}, {kind: max abs err of its
    batches against the plain version})."""
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import renderer, sampling, scenes, sweep
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.ops import kernels as K
    t_phase = time.perf_counter()
    args = sweep.build_parser().parse_args([])
    configs = [(s, sh, acc) for s in args.scenes for sh in args.shaders
               for acc in args.accs]

    # (a) The command at its defaults, as a user runs it.
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = pathlib.Path(tmp) / "sweep.dat"
        cmd = [sys.executable, "-m", "mobileraytracer_tpu_torch.sweep",
               "--out", str(path)]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=SWEEP_S)
        if run.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[1:])} exited "
                                 f"{run.returncode}: {run.stderr[-3000:]}")
        dat = path.read_text().splitlines()
    say(13, f"python -m mobileraytracer_tpu_torch.sweep "
            f"({time.perf_counter() - t0:.1f} s with its start): "
            + " | ".join(run.stdout.strip().splitlines()) + f" [{card}]")
    for line in dat:
        say(13, f"sweep.dat: {line}")
    rows = [line.split() for line in dat[1:]]
    timed = np.array([[float(x) for x in r[8:]] for r in rows])
    if not (dat[0] == sweep.HEADER.rstrip("\n") and len(rows) == 8
            and [tuple(map(int, r[:3])) for r in rows] == configs
            and timed.shape == (8, 2) and np.isfinite(timed).all()
            and (timed > 0).all()):
        raise AssertionError("the sweep's .dat failed its checks")

    # (b) The same sweep in this process, each ACC_BVH row's launches
    # counted and the largest batch of each kernel and query kind in each
    # row recorded and held against the plain versions.
    at, per_row = {}, {}

    class Watched(renderer.Renderer):
        def __init__(self, scene, cam, cfg, **kwargs):
            at["row"] = (cfg.scene_id, cfg.shader, cfg.accelerator)
            per_row.setdefault(at["row"], dict.fromkeys(K.LAUNCHES, 0))
            super().__init__(scene, cam, cfg, **kwargs)

        def render(self, *a, **kw):
            before = dict(K.LAUNCHES)
            try:
                return super().render(*a, **kw)
            finally:
                for k, n in K.LAUNCHES.items():
                    per_row[at["row"]][k] += n - before[k]

    captured = {}
    restore = recording(captured, lambda kind, any_hit: (
        kind, f"scene {at['row'][0]} shader {at['row'][1]} "
              f"{'any-hit' if any_hit else 'closest'}"))
    sweep.Renderer = Watched
    try:
        K.reset_launches()
        t0 = time.perf_counter()
        got = sweep.sweep(args.scenes, args.shaders, args.accs, args.size,
                          args.spp, args.spl, args.reps, device=dev)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        restore()
        sweep.Renderer = renderer.Renderer
    by = {(r.scene, r.shader, r.accelerator): r for r in got}
    say(13, f"the sweep in this process ({sweep_s:.1f} s): " + "; ".join(
        f"scene {s} shader {sh} acc {acc}: {by[s, sh, acc].total_rays} rays,"
        f" median {by[s, sh, acc].render_s:.4f} s, "
        f"{by[s, sh, acc].mrays_s:.4f} M rays/s, launches "
        f"{per_row[s, sh, acc]}" for s, sh, acc in configs)
        + f"; launches {launches} [{card}]")
    same_rays = all(by[s, sh, C.ACC_NAIVE].total_rays
                    == by[s, sh, C.ACC_BVH].total_rays
                    for s, sh, _ in configs)
    bvh_rows = [per_row[c] for c in configs if c[2] == C.ACC_BVH]
    if not (list(by) == configs and same_rays and bvh_rows
            and all(n["tilemt"] > 0 and n["banded"] > 0 for n in bvh_rows)
            and all(sum(per_row[c].values()) == 0 for c in configs
                    if c[2] != C.ACC_BVH)):
        raise AssertionError("the in-process sweep failed its checks: ray "
                             f"counts equal across accelerators {same_rays},"
                             f" launches {per_row}")
    err, _, _ = check_batches(13, captured)

    # (c) MobileRT's two statistical captures, with test_golden.py's
    # oracles (:167-174 and :255-275) at render_builtin's settings.
    readings = {}
    for name, sid, shader, spp in (
            ("cornell2_whitted_256_16spp", C.SCENE_CORNELL2,
             C.SHADER_WHITTED, 16),
            ("cornell2_pt_256_64spp", C.SCENE_CORNELL2,
             C.SHADER_PATHTRACER, 64)):
        raw = np.fromfile(GOLD / f"{name}.bin", dtype=np.int32)
        w, h = int(raw[0]), int(raw[1])
        ref = unpack_bitmap(raw[2:].reshape(h, w))
        sc, cm = scenes.load_builtin(sid, 1.0)
        cfg = mrt.RenderConfig(width=w, height=h, spp=spp, shader=shader,
                               accelerator=C.ACC_NAIVE, scene_id=sid,
                               accumulation="int_parity")
        t0 = time.perf_counter()
        out = mrt.render_frame(sc.to(dev), cm, cfg,
                               sampling.prng_key(0, dev),
                               scenes.DEPTHMAP_MAX_POINT[sid])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ours = unpack_bitmap(out["bitmap"].cpu().numpy())
        if shader == C.SHADER_WHITTED:
            ok, mean, frac = golden_close(ours, ref, mean_tol=4.0 / 255,
                                          outlier_tol=16.0 / 255,
                                          outlier_frac=0.05)
            what = (f"mean |diff| {mean * 255:.4f}/255 (limit 4), "
                    f"{frac * 100:.4f}% of pixels past 16/255 (limit 5%)")
        else:
            blk = 16
            rb = ref.reshape(h // blk, blk, w // blk, blk, 3).mean((1, 3))
            ob = ours.reshape(h // blk, blk, w // blk, blk, 3).mean((1, 3))
            ok, mean, frac = golden_close(ob, rb, mean_tol=6.0 / 255,
                                          outlier_tol=24.0 / 255,
                                          outlier_frac=0.08)
            bias = float(np.abs((ours - ref).mean(axis=(0, 1))).max())
            ok = ok and bias < 2.0 / 255
            what = (f"16x16 block means: mean |diff| {mean * 255:.4f}/255 "
                    f"(limit 6), {frac * 100:.4f}% of blocks past 24/255 "
                    f"(limit 8%); global channel bias {bias * 255:.4f}/255 "
                    f"(limit 2)")
        readings[name] = ok
        say(13, f"{name} through render_frame (int_parity, ACC_NAIVE, key "
                f"0): {int(out['rays'])} rays in {secs:.3f} s; {what}; "
                f"holds {ok} [{card}]")
    if not all(readings.values()):
        raise AssertionError(f"a statistical capture disagrees: {readings}")
    say(13, f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return launches, err


# Phase 14: JAX's three window settings (tests/test_pallas_bvh.py::
# test_selection_knobs_stay_exact), the tile window of tile-MT, and the
# resident kernel's bands per program.
KNOB_SELS = ({"sel_st": 32, "top_s": 16, "top_m": 24},
             {"sel_st": 128, "top_s": 16, "top_m": 24},
             {"sel_st": 16, "top_s": 8, "top_m": 8})
TILE_KNOBS = {"top_s": 16, "top_m": 64}
RES_GROUPS = (4, 8, 16)
BLOCK_BVH_SAMPLE = 4096


def block_bvh_phase(scene, cam, cfg, key, primaries, shadow, card):
    """Phase 14: (a) the conference proxy through ops/block_bvh (plain
    PyTorch, no kernel): build seconds, the 512x512 Whitted frame timed and
    profiled, its primaries against the exact block traversal and 4,096 of
    them against the CPU; (b) the window knobs and res_group on phase 7's
    primaries and reversed shadow rays, with the launch counters reset just
    before: hits and occlusion equal to the default windows', every
    recorded kernel batch bitwise equal to its plain version, the resident
    kernel's ms, bound, registers and shared memory per g_n.  Returns
    ({kind: launches in the block_bvh frame}, {kind: launches in (b)},
    {kind: max abs err}, {g_n: resident record})."""
    import mobileraytracer_tpu_torch as mrt
    from mobileraytracer_tpu_torch import bench_scenes
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.ops import _build
    from mobileraytracer_tpu_torch.ops import block_bvh as bb
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.ops import intersect as nv
    from mobileraytracer_tpu_torch.ops import kernels as K
    t_phase = time.perf_counter()
    dev = scene.device
    big = C.RAY_LENGTH_MAX
    o, d, pk, pi = primaries

    # (a) The two-level block BVH.
    proxy, _, _ = bench_scenes.conference_proxy()
    t0 = time.perf_counter()
    sbb = bb.build(proxy, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    g = sbb.bvh
    say(14, f"block_bvh.build on the conference proxy: {build_s:.2f} s; "
            f"{g.num_supers} supers of {g.block_count.shape[1]} blocks of "
            f"at most {g.block_size} triangles, top_s {g.top_s}, top_m "
            f"{g.top_m}")

    def frame():
        return mrt.render_frame(sbb, cam, cfg, key)

    K.reset_launches()
    out = frame()
    torch.cuda.synchronize()
    bvh_launches = dict(K.LAUNCHES)
    img = out["image"].cpu().numpy()
    rays = int(out["rays"])
    if not (np.isfinite(img).all()
            and img.shape == (cfg.height, cfg.width, 3)
            and rays > 0 and not any(bvh_launches.values())):
        raise AssertionError(f"the block_bvh frame failed its checks: rays "
                             f"{rays}, launches {bvh_launches}")
    ms = cuda_ms(frame, FRAMES)
    busy, _, top, _ = profile_device(frame)
    say(14, f"{cfg.width}x{cfg.height} Whitted frame over block_bvh: "
            f"{ms:.3f} ms/frame, "
            f"{rays / (ms / 1e3) / 1e6:.4f} M rays/s ({rays} rays, mean of "
            f"{FRAMES} frames by CUDA events after a warm-up; image mean "
            f"{img.mean():.6f}; kernel launches {bvh_launches}); one frame "
            f"under torch.profiler: device busy {busy:.3f} ms, idle share "
            f"{1.0 - busy / ms:.3f}; largest device rows (ms): "
            + "; ".join(f"{k[:60]} {v:.3f}" for k, (v, _) in top.items())
            + f" [{card}]")

    # Its primaries against the exact traversal: a budget can lose a hit
    # but never finds a closer one; at equal t the hit triangle is the
    # same (the two builds order the triangles differently, so the
    # triangles' corners are compared).
    t_b, id_b = bb.traverse_closest(g, sbb.triangles, o, d, big, pk, pi)
    t_x, id_x = bt.traverse_tilemt(scene.bvh, scene.triangles, o, d, big,
                                   pk, pi)

    def corners(tris, ids):
        i = ids.clamp(min=0).long()
        return torch.cat([tris.point_a[i], tris.ab[i], tris.ac[i]], 1)

    same_t = t_b == t_x
    same_tri = (corners(sbb.triangles, id_b)
                == corners(scene.triangles, id_x)).all(1) \
        & ((id_b >= 0) == (id_x >= 0))
    closer = int((t_b < t_x).sum())
    missed = int((t_b > t_x).sum())
    ties = int((same_t & ~same_tri).sum())
    say(14, f"block_bvh primaries vs the exact block traversal on "
            f"{o.shape[0]} rays: {closer} closer (must be 0), {missed} "
            f"lanes whose hit lies past the budgets (a farther hit or "
            f"none), {ties} lanes at equal t on another triangle "
            f"(coincident or shared-edge ties)")
    if closer or ties > o.shape[0] // 1000:
        raise AssertionError("block_bvh primaries disagree with the exact "
                             "traversal")
    n = BLOCK_BVH_SAMPLE
    cpu = sbb.to("cpu")
    t_c, id_c = bb.traverse_closest(cpu.bvh, cpu.triangles, o[:n].cpu(),
                                    d[:n].cpu(), big, pk[:n].cpu(),
                                    pi[:n].cpu())
    same = float((id_c == id_b[:n].cpu()).float().mean())
    hit = id_c >= 0
    rel = float(((t_c - t_b[:n].cpu()).abs() / t_c.abs())[hit].max())
    say(14, f"the first {n} primaries on the CPU: ids equal on {same:.6f} "
            f"of lanes (at least 0.999), t max relative difference {rel:.3e}"
            f" (at most 1e-5)")
    if same < 0.999 or rel > 1e-5:
        raise AssertionError("block_bvh on the card disagrees with the CPU")

    # (b) The window knobs and res_group, recorded.
    wrapped = {"banded": K.traverse_banded, "tilemt": K.traverse_tilemt,
               "resident": K.traverse_resident}
    plain = {"banded": K.banded_plain, "tilemt": K.tilemt_plain,
             "resident": K.resident_plain}
    captured = {}
    stage = {"tag": None}

    def recorder(kind):
        fn = wrapped[kind]

        def rec(*args):
            tag = (kind, stage["tag"])
            if stage["tag"] and tag not in captured:
                captured[tag] = tuple(a.clone() if torch.is_tensor(a) else a
                                      for a in args)
            return fn(*args)
        return rec

    so, sd, smd, spk, spi = shadow
    smd = torch.as_tensor(smd, device=dev).expand(so.shape[0])
    tris = scene.triangles
    knob = lambda kw: ",".join(f"{k}={v}" for k, v in kw.items())

    def closest_diff(t, ids, t_ref, id_ref):
        """(lanes whose id differs, those of them at the bit-identical t
        (coincident triangles, PARITY.md section 7) or one ulp farther: a
        coarse bundle's window cut, computed in rounded float32, can sit
        an ulp past a hit on an unlisted block's face)."""
        diff = ids != id_ref
        ulp = torch.nextafter(t_ref, torch.full_like(t_ref, torch.inf))
        return int(diff.sum()), int((diff & ((t == t_ref) | (t == ulp)))
                                    .sum())

    def shadow_diff(occ, occ_ref):
        """(lanes whose occlusion differs, those of them that the default
        windows occlude with the naive oracle's blocker within one ulp of
        the segment's end, which a per-ray window's exact slab bound
        prunes, as phase 7's tile windows do)."""
        lanes = torch.nonzero((occ >= 0) != (occ_ref >= 0))[:, 0]
        t_n, id_n = nv.closest_triangles(tris, so[lanes], sd[lanes],
                                         smd[lanes], spk[lanes], spi[lanes])
        edge = ((id_n >= 0) & (occ_ref[lanes] >= 0)
                & (torch.nextafter(t_n, torch.full_like(t_n, torch.inf))
                   >= smd[lanes]))
        return len(lanes), int(edge.sum())

    diffs = {}
    K.reset_launches()
    for kind in wrapped:
        setattr(K, f"traverse_{kind}", recorder(kind))
    try:
        t0, id0 = bt.traverse(scene.bvh, tris, o, d, big, pk, pi)
        _, occ0 = bt.traverse(scene.bvh, tris, so, sd, smd, spk, spi,
                              any_hit=True)
        tm0, idm0 = bt.traverse_tilemt(scene.bvh, tris, o, d, big, pk, pi)
        for sel in KNOB_SELS:
            stage["tag"] = f"closest {knob(sel)}"
            t, ids = bt.traverse(scene.bvh, tris, o, d, big, pk, pi, **sel)
            diffs[stage["tag"]] = closest_diff(t, ids, t0, id0)
            stage["tag"] = f"shadow {knob(sel)}"
            _, occ = bt.traverse(scene.bvh, tris, so, sd, smd, spk, spi,
                                 any_hit=True, **sel)
            diffs[stage["tag"]] = shadow_diff(occ, occ0)
        stage["tag"] = f"closest {knob(TILE_KNOBS)}"
        t, ids = bt.traverse_tilemt(scene.bvh, tris, o, d, big, pk, pi,
                                    **TILE_KNOBS)
        diffs[stage["tag"]] = closest_diff(t, ids, tm0, idm0)
        for g_n in RES_GROUPS:
            stage["tag"] = f"shadow res_group={g_n}"
            _, occ = bt.traverse_resident(scene.bvh, tris, so, sd, smd, spk,
                                          spi, res_group=g_n)
            diffs[stage["tag"]] = shadow_diff(occ, occ0)
        stage["tag"] = None
    finally:
        for kind, fn in wrapped.items():
            setattr(K, f"traverse_{kind}", fn)
    torch.cuda.synchronize()
    knob_launches = dict(K.LAUNCHES)
    say(14, f"window knobs on phase 7's {o.shape[0]} primaries and "
            f"{int((occ0 >= 0).sum())} of {so.shape[0]} occluded shadow "
            f"rays, against the default windows (lanes that differ; of "
            f"them, hits at equal t or one ulp farther, or blockers within "
            f"one ulp of the segment's end): "
            + "; ".join(f"{k}: {n} ({e})" for k, (n, e) in diffs.items())
            + f"; launches {knob_launches}")
    if any(n != e for n, e in diffs.values()):
        raise AssertionError("a window setting changed hits or occlusion")
    if not all(knob_launches[k] > 0 for k in wrapped):
        raise AssertionError(f"phase 14 missed a kernel: {knob_launches}")

    err, by_g_n = {}, {}
    for (kind, what), args in sorted(captured.items()):
        got = wrapped[kind](*args)
        if kind == "resident":
            *want, rounds, blocks, pairs = plain[kind](*args, stats=True)
            walk = (rounds, blocks, pairs)
            got, want = torch.stack(got), torch.stack(want)
        elif kind == "banded":
            *want, pairs = plain[kind](*args, stats=True)
            walk = pairs
            got, want = torch.stack(got), torch.stack(want)
        else:
            want, pairs = plain[kind](*args, stats=True)
            walk = pairs
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err[kind] = max(err.get(kind, 0.0), e)
        say(14, f"{KERNELS[kind]['name']} {what}: rays {args[3].shape[0]} m "
                f"{args[4]}, tested pairs by exit {pairs.tolist()}; bitwise "
                f"equal to plain: {torch.equal(got, want)} (max abs err {e})")
        if not torch.equal(got, want):
            raise AssertionError(f"{kind} {what}: kernel != plain version")
        if kind == "resident":
            g_n = args[6]
            k_ms = cuda_ms(lambda: wrapped[kind](*args), 10)
            bound, rounds = kernel_bound(K, kind, args, got, walk)
            ki = _build.kernel_info("resident", g_n)
            by_g_n[g_n] = dict(
                ms=k_ms, bound_ms=bound["ms"], share=bound["ms"] / k_ms,
                rounds_mean=float(rounds.mean()), regs=ki["regs"],
                smem=ki["static_smem"] + ki["dynamic_smem"],
                spilled=ki["local_bytes"], threads=ki["threads"],
                blocks_per_sm=ki["blocks_per_sm"], card=card)
            say(14, f"traverse_resident at g_n={g_n} on the shadow batch: "
                    f"kernel {k_ms:.4f} ms, bound {bound['ms']:.4f} ms, "
                    f"{float(rounds.mean()):.4f} mean rounds per (program, "
                    f"partition); {ki['regs']} registers, "
                    f"{ki['local_bytes']} spilled bytes, "
                    f"{by_g_n[g_n]['smem']} B of shared memory and "
                    f"{ki['threads']} threads per block, "
                    f"{ki['blocks_per_sm']} blocks per SM [{card}]")
    say(14, f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return bvh_launches, knob_launches, err, by_g_n


def window_shapes(scene, primaries, shadow):
    """The window kernel's three shapes on the main path, as
    {name: (o, d, cap, floor, st, top_s, top_m)}: the refill's call
    (65,536 rays, each duplicated into a 16-ray subtile, capped at its
    exact hit and floored at its window-1 cut: the primaries that window 1
    leaves unresolved, repeated to fill the batch), banded window 1 of the
    reversed shadow query (16-ray subtiles capped at their worst segment
    end) and the tile-MT window of the primaries (128-ray tiles at 48/64,
    capped at their worst t_init)."""
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.ops import kernels as K
    grid = scene.bvh
    o, d, pk, pi = primaries
    t, _ = bt.traverse_tilemt(grid, scene.triangles, o, d, C.RAY_LENGTH_MAX,
                              pk, pi)
    cut = bt._candidates(grid, o, d)[3].repeat_interleave(K.ST)
    unres = torch.nonzero(cut < t)[:, 0]
    if unres.numel() == 0:               # a scene that window 1 resolves
        unres = torch.arange(t.numel(), device=t.device)
    ridx = unres.repeat(-(-65536 // unres.numel()))[:65536]
    lanes = ridx.repeat_interleave(K.ST)
    shapes = {"refill": (o[lanes], d[lanes], t[ridx], cut[ridx], K.ST, None,
                         None)}
    so, sd, smax, spk, spi = shadow
    rays, _ = bt._pack_rays(so, sd, bt._t_init(smax, so), spk, spi, K.TILE)
    shapes["shadow window 1"] = (
        rays[:, 0:3], rays[:, 3:6], rays[:, 6].reshape(-1, K.ST).amax(1),
        None, K.ST, None, None)
    rays, _ = bt._pack_rays(o, d, bt._t_init(C.RAY_LENGTH_MAX, o), pk, pi,
                            K.TILE)
    shapes["tile-MT primaries"] = (
        rays[:, 0:3], rays[:, 3:6], rays[:, 6].reshape(-1, K.TILE).amax(1),
        None, K.TILE, bt.TILE_TOP_S, bt.TILE_TOP_M)
    return shapes


def windows_phase(scene, primaries, shadow, card):
    """Phase 15: the window kernel at the main path's three shapes
    (window_shapes) against its plain version, bit for bit, timed by CUDA
    events beside the plain version and its bound (kernels.window_bound),
    with its registers, shared memory and occupancy.  Returns its JSON
    record."""
    from mobileraytracer_tpu_torch import constants as C
    from mobileraytracer_tpu_torch.ops import _build
    from mobileraytracer_tpu_torch.ops import block_traversal as bt
    from mobileraytracer_tpu_torch.ops import kernels as K
    t_phase = time.perf_counter()
    grid = scene.bvh
    shapes = {}
    for what, (o, d, cap, floor, st, top_s, top_m) in window_shapes(
            scene, primaries, shadow).items():
        args = (grid, o, d, cap, floor, st, top_s, top_m)
        got = bt._candidates(*args)
        want = bt._candidates_plain(*args)
        torch.cuda.synchronize()
        bits = lambda x: x.view(torch.int32) if x.is_floating_point() else x
        same = all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))
        k_ms = cuda_ms(lambda: bt._candidates(*args), 20)
        p_ms = cuda_ms(lambda: bt._candidates_plain(*args), 3)
        nt, m = got[0].shape
        s = min(top_s or grid.top_s, grid.num_supers)
        bound = K.window_bound(o.shape[0], nt, grid.num_supers, s, grid.bps,
                               m, (cap is not None) + (floor is not None))
        ki = _build.kernel_info("window", depth=max(s, m))
        finite = int((got[2] < C.RAY_LENGTH_MAX).sum())
        say(15, f"window kernel, {what}: {nt} bundles of {st} rays, top_s "
                f"{s}, top_m {m}, cap {cap is not None}, floor "
                f"{floor is not None}; {finite / nt:.2f} finite entries a "
                f"window; bitwise equal to plain: {same}; kernel {k_ms:.4f} "
                f"ms, plain PyTorch {p_ms:.4f} ms, bound {bound['ms']:.4f} "
                f"ms ({bound['by']}: {bound['ops']} f32 ops, "
                f"{bound['bytes']} bytes), share {bound['ms'] / k_ms:.4f}, "
                f"at the unfused rate {bound['unfused_ms'] / k_ms:.4f}; "
                f"{ki['regs']} registers, {ki['local_bytes']} spilled "
                f"bytes, {ki['static_smem'] + ki['dynamic_smem']} B of "
                f"shared memory and {ki['threads']} threads per block, "
                f"{ki['blocks_per_sm']} blocks per SM; no PyTorch call "
                f"computes a stable two-level candidate window [{card}]")
        if not same:
            raise AssertionError(f"window kernel != plain version: {what}")
        shapes[what] = dict(bundles=nt, st=st, top_s=s, top_m=m, ms=k_ms,
                            plain_ms=p_ms, bound_ms=bound["ms"],
                            bound_by="operations" if bound["by"] == "compute"
                            else "bytes", share=bound["ms"] / k_ms,
                            share_unfused=bound["unfused_ms"] / k_ms,
                            regs=ki["regs"], spilled=ki["local_bytes"],
                            smem=ki["static_smem"] + ki["dynamic_smem"],
                            threads=ki["threads"],
                            blocks_per_sm=ki["blocks_per_sm"])
    say(15, f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return dict(name="candidate_windows", route="cuda",
                source="mobileraytracer_tpu_torch/csrc/candidate_windows.cu",
                replaces="none: the jnp chain of "
                         "mobileraytracer_tpu/ops/pallas_bvh.py:333, fused "
                         "by XLA", library_ms=None, shapes=shapes, card=card)


def mrt_primaries(scene, cam, cfg):
    """The frame's jitterless primary rays in lane order."""
    from mobileraytracer_tpu_torch import cameras, renderer
    u, v, _, _ = renderer._pixel_order(cfg, scene.device)
    zero = torch.zeros_like(u)
    return cameras.generate_rays(cam.to(scene.device), u, v, zero, zero)


if __name__ == "__main__":
    main()
