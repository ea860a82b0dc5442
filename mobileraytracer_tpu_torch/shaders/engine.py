"""The wavefront shading engine (port of
`mobileraytracer_tpu/shaders/engine.py`, Whitted and NoShadows).

The reference shades by recursion (Shader.cpp:86-123).  As in the JAX
package, each lane owns a small stack of pending tree nodes (ray, depth,
throughput weight); each step pops one node per lane, traces the whole
batch, adds the node's own contribution and pushes its children.  Event
keys fold in the lane's own pop count, so which lanes run together never
changes a lane's random draws.

Batches of fewer than 1024 lanes run full-batch steps until drained.
Larger ones run one full-batch primary step (tile-MT closest pass), then
repeatedly gather up to `bc` live lanes, in lane order, into a chunk, step
the chunk and scatter it back.  The chunk layout is reproduced lane for
lane, because with `nee_share_secondary` the NEE sharing groups follow
it.  The PathTracer (buckets, Russian roulette, coherence-sorted chunks)
is not ported yet (ROADMAP.md Queue 1, item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .. import constants as C
from .. import sampling
from ..ops import block_traversal, intersect
from ..types import RenderConfig, Scene
from . import common

# Walk iterations (chunk steps, or full-batch steps) since the last reset.
WALK = {"steps": 0}


class Tracer(NamedTuple):
    closest: Callable   # (scene, o, d, prev_kind, prev_id, coherent) -> Hit
    occluded: Callable  # (scene, o, d, max_dist, prev_kind, prev_id) -> bool


def make_tracer(config: RenderConfig) -> Tracer:
    """Accelerator dispatch.  ACC_BVH: coherent closest-hit batches (the
    primary pass in patch-major order) take the tile-MT traversal, the
    others the banded one; every shadow query takes the banded one."""
    if config.accelerator in (C.ACC_NONE, C.ACC_NAIVE):
        return Tracer(
            closest=lambda *a, **k: intersect.intersect_scene_naive(*a),
            occluded=intersect.occluded_naive)
    if config.accelerator == C.ACC_BVH:
        def closest(scene, o, d, pk, pi, coherent=False):
            return block_traversal.intersect_scene_blocks(
                scene, o, d, pk, pi, mode="tilemt" if coherent else "banded")

        def occluded(scene, o, d, md, pk, pi):
            return block_traversal.occluded_blocks(scene, o, d, md, pk, pi,
                                                   mode="banded")
        return Tracer(closest=closest, occluded=occluded)
    raise NotImplementedError(
        f"accelerator {config.accelerator} is not ported yet (ROADMAP.md "
        "Queue 1, item 11)")


@dataclasses.dataclass
class WalkState:
    """Per-lane stacks of pending nodes, shape (B, S, ...)."""
    sp: torch.Tensor         # (B,) number of pending entries
    st_org: torch.Tensor     # (B, S, 3)
    st_dir: torch.Tensor     # (B, S, 3)
    st_weight: torch.Tensor  # (B, S, 3) product of ancestors' K factors
    st_depth: torch.Tensor   # (B, S)
    st_pkind: torch.Tensor   # (B, S) source primitive kind (self-hit guard)
    st_pid: torch.Tensor     # (B, S) source primitive id
    rgb: torch.Tensor        # (B, 3) accumulated radiance
    rays: torch.Tensor       # (B,) rays cast (the reference's ray counter)
    pops: torch.Tensor       # (B,) pops so far: the lane-local iteration

    def map(self, fn) -> "WalkState":
        return WalkState(**{f.name: fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)})


def _push(state: WalkState, mask, org, dirn, weight, depth, pkind, pid):
    """Pushes one entry on each masked lane's stack (dropped on
    overflow)."""
    s = state.st_depth.shape[1]
    pos = torch.clamp(state.sp, 0, s - 1)
    lane_ok = mask & (state.sp < s)
    onehot = ((torch.arange(s, device=pos.device)[None, :] == pos[:, None])
              & lane_ok[:, None])
    oh3 = onehot[:, :, None]
    return dataclasses.replace(
        state,
        sp=torch.where(lane_ok, state.sp + 1, state.sp),
        st_org=torch.where(oh3, org[:, None, :], state.st_org),
        st_dir=torch.where(oh3, dirn[:, None, :], state.st_dir),
        st_weight=torch.where(oh3, weight[:, None, :], state.st_weight),
        st_depth=torch.where(onehot, depth[:, None], state.st_depth),
        st_pkind=torch.where(onehot, pkind[:, None], state.st_pkind),
        st_pid=torch.where(onehot, pid[:, None], state.st_pid))


def _pop(state: WalkState):
    idx = torch.clamp(state.sp - 1, min=0).long()
    b = torch.arange(state.sp.shape[0], device=idx.device)
    entry = dict(org=state.st_org[b, idx], dirn=state.st_dir[b, idx],
                 weight=state.st_weight[b, idx],
                 depth=state.st_depth[b, idx],
                 pkind=state.st_pkind[b, idx], pid=state.st_pid[b, idx])
    active = state.sp > 0
    return dataclasses.replace(
        state, sp=torch.clamp(state.sp - 1, min=0),
        rays=state.rays + active.to(torch.int32),
        pops=state.pops + 1), entry, active


def trace_radiance(scene: Scene, config: RenderConfig, tracer: Tracer,
                   o: torch.Tensor, d: torch.Tensor, keys: torch.Tensor):
    """Whitted (or NoShadows) radiance of a batch of primary rays.  Returns
    (rgb (B, 3), casted-ray count as an int32 tensor)."""
    shader = config.shader
    if shader not in (C.SHADER_WHITTED, C.SHADER_NOSHADOWS):
        raise NotImplementedError(
            f"shader {shader} is not ported yet (ROADMAP.md Queue 1, "
            "item 10)")
    b = o.shape[0]
    s = config.stack_size
    dev = o.device
    i32 = dict(dtype=torch.int32, device=dev)
    st_org = torch.zeros((b, s, 3), dtype=torch.float32, device=dev)
    st_dir = torch.zeros_like(st_org)
    st_weight = torch.zeros_like(st_org)
    st_org[:, 0] = o
    st_dir[:, 0] = d
    st_weight[:, 0] = 1.0
    state = WalkState(
        sp=torch.ones((b,), **i32), st_org=st_org, st_dir=st_dir,
        st_weight=st_weight,
        st_depth=torch.ones((b, s), **i32),   # primary rays have depth 1
        st_pkind=torch.zeros((b, s), **i32),
        st_pid=torch.full((b, s), -1, **i32),
        rgb=torch.zeros((b, 3), dtype=torch.float32, device=dev),
        rays=torch.zeros((b,), **i32), pops=torch.zeros((b,), **i32))

    def step(state: WalkState, keys, primary: bool = False):
        it = state.pops
        state, e, active = _pop(state)
        org, dirn = common.park_dead_lanes(e["org"], e["dirn"], active)
        hit = tracer.closest(scene, org, dirn, e["pkind"], e["pid"],
                             coherent=primary)
        le, kd, ks, kt, ior = common.bind_material(scene, hit)

        hit_ok = active & ~hit.missed
        in_depth = e["depth"] <= config.depth_max
        emissive = common.has_positive(le)
        live = hit_ok & in_depth

        emit_w = live & emissive
        contrib = torch.where(emit_w[:, None], e["weight"] * le, 0.0)
        cont = live & ~emissive

        diffuse = cont & common.has_positive(kd)
        nee_keys = sampling.event_key(keys, it, 1)
        shared_step = primary or config.nee_share_secondary
        rev = shared_step and config.nee_reverse
        ld_sum, n_shadow = common.direct_lighting(
            scene, hit, nee_keys, config.samples_light,
            shadows=(shader != C.SHADER_NOSHADOWS),
            occluded_fn=tracer.occluded, mask=diffuse,
            share_mask=None if shared_step else (it == 0),
            share_width=config.nee_share, share_all=shared_step,
            reverse=rev)
        ld = kd * ld_sum / torch.full_like(ld_sum,
                                           float(config.samples_light))
        has_l = scene.lights.num > 0
        ld = torch.where((diffuse & has_l)[:, None], ld, 0.0)
        contrib = contrib + e["weight"] * ld
        rays = state.rays + torch.where(diffuse, n_shadow, 0)
        # Ambient term "rgb += kD * 0.1" (Whitted.cpp:91, NoShadows.cpp:46).
        contrib = contrib + torch.where(
            cont[:, None], e["weight"] * kd * C.WHITTED_AMBIENT, 0.0)
        state = dataclasses.replace(state, rays=rays.to(torch.int32),
                                    rgb=state.rgb + contrib)
        if shader == C.SHADER_NOSHADOWS:
            return state

        depth1 = e["depth"] + 1
        # Specular reflection child (Whitted.cpp:73-79).
        spec = cont & common.has_positive(ks)
        rdir = common.reflect(e["dirn"], hit.normal)
        state = _push(state, spec, hit.point, rdir, e["weight"] * ks, depth1,
                      hit.prim_kind, hit.prim_id)
        # Specular transmission child (Whitted.cpp:82-90).
        trans = cont & common.has_positive(kt)
        tdir, tvalid = common.refract(e["dirn"], hit.normal, 1.0 / ior)
        return _push(state, trans & tvalid, hit.point, tdir,
                     e["weight"] * kt, depth1, hit.prim_kind, hit.prim_id)

    max_iters = 1 if shader == C.SHADER_NOSHADOWS \
        else config.resolved_max_walk_iters()

    def lane_live(st):
        return (st.sp > 0) & (st.pops < max_iters)

    unit = C.SUBTILE * max(1, 128 // C.SUBTILE)   # traversal padding unit
    if b < 8 * unit or shader == C.SHADER_NOSHADOWS:
        # Small batches: full-batch steps until drained.
        it = 0
        while it < max_iters and bool(lane_live(state).any()):
            state = step(state, keys)
            it += 1
            WALK["steps"] += 1
    else:
        state = step(state, keys, primary=True)
        WALK["steps"] += 1
        div = config.walk_chunk_div
        if div is None:
            div = 32
        bc = max(unit, (b // div + unit - 1) // unit * unit)
        max_chunks = -(-b // bc) * max_iters
        lanes = torch.arange(b, device=dev)
        slots = torch.arange(bc, device=dev)
        it = 0
        while it < max_chunks:
            live = lane_live(state)
            if not bool(live.any()):
                break
            # The first bc live lanes in lane order; unfilled slots hold
            # lane 0.
            pos = torch.cumsum(live, 0) - 1
            sel = live & (pos < bc)
            idx = torch.zeros(bc + 1, dtype=torch.int64, device=dev)
            idx[torch.where(sel, pos, bc)] = lanes       # slot bc is the drop
            idx = idx[:bc]
            sub = step(state.map(lambda a: a[idx]), keys[idx])
            # Where lane 0 fills several slots the last one is written, as
            # XLA's scatter writes duplicates in order.
            last = torch.zeros(b, dtype=torch.int64, device=dev).scatter_reduce(
                0, idx, slots, reduce="amax")
            keep = slots == last[idx]
            ki = idx[keep]
            # In place: nothing else holds the previous state's tensors.
            for f in dataclasses.fields(state):
                getattr(state, f.name)[ki] = getattr(sub, f.name)[keep]
            it += 1
            WALK["steps"] += 1
    return state.rgb, state.rays.sum().to(torch.int32)


def trace_image_sample(scene: Scene, config: RenderConfig, o, d, keys):
    """Radiance of one sample of every lane, dispatched on the shader id
    (C_wrapper.cpp:154-194)."""
    return trace_radiance(scene, config, make_tracer(config), o, d, keys)
