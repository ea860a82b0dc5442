"""The wavefront shading engine (port of
`mobileraytracer_tpu/shaders/engine.py`): the five shaders of the
reference, over the naive scan, the regular grid and the two BVHs.

The reference shades by recursion (Shader.cpp:86-123).  As in the JAX
package, each lane owns a small stack of pending tree nodes (ray, depth,
throughput weight); each step pops one node per lane, traces the whole
batch, adds the node's own contribution and pushes its children.  Event
keys fold in the lane's own pop count, so which lanes run together never
changes a lane's random draws.

The PathTracer's post-order NEE guard (PathTracer.cpp:107-113) is kept
with per-lane buckets, one per diffuse-indirect nesting level: a node's
terms go to the innermost open bucket, and a bucket closes when the stack
top's bucket depth drops below its level, flowing into the enclosing one
or killed when the edge's parent had Ld > 0 and the spine below it hit an
emitter.

Batches of fewer than 1024 lanes, and every differentiable walk, run
full-batch steps until drained.  Larger ones run one full-batch primary
step (tile-MT closest pass), then repeatedly gather up to `bc` live lanes
into a chunk, step the chunk and scatter it back: in lane order for
Whitted, in (direction octant, origin Morton code) order for the
PathTracer.  The chunk layout is reproduced
lane for lane, because with `nee_share_secondary` the NEE sharing groups
follow it.

The differentiable walk is the JAX package's scan (engine.py:436-439):
full-batch steps, none of them a primary step, with every update out of
place, so autograd records it; the traversal kernels run off the tape.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .. import constants as C
from .. import sampling
from ..ops import block_bvh, block_traversal, bvh, grid, intersect
from ..types import RenderConfig, Scene
from . import common

# Walk iterations (chunk steps, or full-batch steps) since the last reset.
WALK = {"steps": 0}


class Tracer(NamedTuple):
    closest: Callable   # (scene, o, d, prev_kind, prev_id, coherent) -> Hit
    occluded: Callable  # (scene, o, d, max_dist, prev_kind, prev_id,
    #                      coherent) -> bool


def _no_reverse_mode(what: str, where: str):
    raise ValueError(
        f"differentiable rendering does not pass through {what}: the JAX "
        f"package runs it as a lax.while_loop ({where}), which reverse mode "
        "rejects; render gradients with ACC_NAIVE, or ACC_BVH on a block "
        "grid (ops/block_traversal.build or ops/block_bvh.build)")


def make_tracer(config: RenderConfig, differentiable: bool = False) -> Tracer:
    """Accelerator dispatch.  ACC_REGULAR_GRID: the grid DDA when the
    scene holds a grid, else the naive scan.  ACC_BVH on a block grid
    (ops/block_traversal.build): coherent closest-hit batches (the primary
    pass in patch-major order) take the tile-MT traversal, the others the
    banded one, and every shadow query the banded one, with the windows of
    block_traversal.SHADOW_SEL on coherent ones (the reversed shared-light
    cones); on a two-level block BVH (ops/block_bvh.build): its fixed-work
    traversal; on an escape-index tree (ops/bvh.build): the escape-index
    walk.

    With `differentiable` the block traversals run off the tape and their
    hits are re-derived from the live triangle table, and shadow queries
    (boolean) see a detached scene and rays.  The grid DDA and the
    escape-index walk raise, as reverse mode rejects them in the JAX
    package."""
    if config.accelerator in (C.ACC_NONE, C.ACC_NAIVE):
        return Tracer(
            closest=lambda *a, **k: intersect.intersect_scene_naive(*a),
            occluded=lambda *a, **k: intersect.occluded_naive(*a))
    if config.accelerator == C.ACC_REGULAR_GRID:
        def closest_g(scene, o, d, pk, pi, coherent=False):
            if isinstance(scene.bvh, grid.RegularGrid):
                if differentiable:
                    _no_reverse_mode("the regular grid's DDA", "grid.py:154")
                return grid.intersect_scene_grid(scene, o, d, pk, pi)
            return intersect.intersect_scene_naive(scene, o, d, pk, pi)

        def occluded_g(scene, o, d, md, pk, pi, coherent=False):
            if isinstance(scene.bvh, grid.RegularGrid):
                return grid.occluded_grid(scene, o, d, md, pk, pi)
            return intersect.occluded_naive(scene, o, d, md, pk, pi)
        return Tracer(closest=closest_g, occluded=occluded_g)
    if config.accelerator == C.ACC_BVH:
        def closest(scene, o, d, pk, pi, coherent=False):
            if isinstance(scene.bvh, block_traversal.BlockGrid):
                return block_traversal.intersect_scene_blocks(
                    scene, o, d, pk, pi,
                    mode="tilemt" if coherent else "banded",
                    differentiable=differentiable)
            if isinstance(scene.bvh, block_bvh.BlockGrid):
                return block_bvh.intersect_scene_blocks(
                    scene, o, d, pk, pi, differentiable=differentiable)
            if differentiable:
                _no_reverse_mode("the escape-index BVH walk", "bvh.py:277")
            return bvh.intersect_scene_bvh(scene, o, d, pk, pi)

        def occluded_any(scene, o, d, md, pk, pi, coherent):
            if isinstance(scene.bvh, block_traversal.BlockGrid):
                sel = block_traversal.SHADOW_SEL if coherent else {}
                return block_traversal.occluded_blocks(
                    scene, o, d, md, pk, pi, mode="banded", **sel)
            if isinstance(scene.bvh, block_bvh.BlockGrid):
                return block_bvh.occluded_blocks(scene, o, d, md, pk, pi)
            return bvh.occluded_bvh(scene, o, d, md, pk, pi)

        def occluded(scene, o, d, md, pk, pi, coherent=False):
            if differentiable:
                with torch.no_grad():
                    return occluded_any(scene.detach(), o.detach(),
                                        d.detach(),
                                        torch.as_tensor(md).detach(), pk,
                                        pi, coherent)
            return occluded_any(scene, o, d, md, pk, pi, coherent)
        return Tracer(closest=closest, occluded=occluded)
    raise ValueError(f"unknown accelerator {config.accelerator}")


@dataclasses.dataclass
class WalkState:
    """Per-lane stacks of pending nodes, shape (B, S, ...), and the
    PathTracer's guard buckets, shape (B, K, ...) with K = depth_max for
    the PathTracer and 1 for the other shaders."""
    sp: torch.Tensor         # (B,) number of pending entries
    st_org: torch.Tensor     # (B, S, 3)
    st_dir: torch.Tensor     # (B, S, 3)
    st_weight: torch.Tensor  # (B, S, 3) product of ancestors' K factors
    st_depth: torch.Tensor   # (B, S)
    st_pkind: torch.Tensor   # (B, S) source primitive kind (self-hit guard)
    st_pid: torch.Tensor     # (B, S) source primitive id
    st_flags: torch.Tensor   # (B, S) FLAG_SPINE: a diffuse-indirect child
    st_nb: torch.Tensor      # (B, S) number of enclosing buckets
    rgb: torch.Tensor        # (B, 3) accumulated radiance
    rays: torch.Tensor       # (B,) rays cast (the reference's ray counter)
    pops: torch.Tensor       # (B,) pops so far: the lane-local iteration
    bkt_rgb: torch.Tensor    # (B, K, 3) pending subtree contribution
    bkt_ld: torch.Tensor     # (B, K) the edge's parent had Ld > 0
    bkt_light: torch.Tensor  # (B, K) the diffuse spine hit an emitter
    bkt_pspine: torch.Tensor  # (B, K) the edge's parent is a spine node
    bkt_open: torch.Tensor   # (B, K)

    def map(self, fn) -> "WalkState":
        return WalkState(**{f.name: fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)})


FLAG_SPINE = 1


def _push(state: WalkState, mask, org, dirn, weight, depth, pkind, pid,
          flags, nb):
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
        st_pid=torch.where(onehot, pid[:, None], state.st_pid),
        st_flags=torch.where(onehot, flags[:, None], state.st_flags),
        st_nb=torch.where(onehot, nb[:, None], state.st_nb))


def _pop(state: WalkState):
    """Pops each lane's stack top; `pops` counts every lane, drained ones
    included, as in the JAX package."""
    idx = torch.clamp(state.sp - 1, min=0).long()
    b = torch.arange(state.sp.shape[0], device=idx.device)
    entry = dict(org=state.st_org[b, idx], dirn=state.st_dir[b, idx],
                 weight=state.st_weight[b, idx],
                 depth=state.st_depth[b, idx],
                 pkind=state.st_pkind[b, idx], pid=state.st_pid[b, idx],
                 flags=state.st_flags[b, idx], nb=state.st_nb[b, idx])
    active = state.sp > 0
    return dataclasses.replace(
        state, sp=torch.clamp(state.sp - 1, min=0),
        rays=state.rays + active.to(torch.int32),
        pops=state.pops + 1), entry, active


def _close_buckets(state: WalkState, maxnb: torch.Tensor) -> WalkState:
    """Closes every open bucket at a level >= `maxnb` (the lane's stack-top
    bucket depth), from the innermost out (PathTracer.cpp:107-113): a
    killed bucket (its parent's Ld > 0 and its spine hit an emitter) is
    dropped, any other flows into the enclosing bucket or the film, and
    its spine-light flag reaches the enclosing bucket only through a spine
    parent (PathTracer.cpp:143).  Every update is out of place: the
    chunked walk scatters the returned tensors into the state in place."""
    rgb = state.rgb
    bkt_rgb, bkt_ld = state.bkt_rgb, state.bkt_ld
    bkt_light, bkt_open = state.bkt_light, state.bkt_open
    levels = torch.arange(bkt_open.shape[1], device=maxnb.device)
    for k in range(bkt_open.shape[1] - 1, -1, -1):
        close = bkt_open[:, k] & (maxnb <= k)
        killed = bkt_ld[:, k] & bkt_light[:, k]
        flow = torch.where((close & ~killed)[:, None], bkt_rgb[:, k], 0.0)
        if k == 0:
            rgb = rgb + flow
        else:
            up = (levels == k - 1)[None, :]
            bkt_rgb = bkt_rgb + torch.where(up[:, :, None], flow[:, None, :],
                                            0.0)
            bkt_light = bkt_light | (
                up & (close & bkt_light[:, k] & state.bkt_pspine[:, k])[:,
                                                                       None])
        at = (levels == k)[None, :] & close[:, None]
        bkt_rgb = torch.where(at[:, :, None], 0.0, bkt_rgb)
        bkt_light = bkt_light & ~at
        bkt_ld = bkt_ld & ~at
        bkt_open = bkt_open & ~at
    return dataclasses.replace(state, rgb=rgb, bkt_rgb=bkt_rgb, bkt_ld=bkt_ld,
                               bkt_light=bkt_light, bkt_open=bkt_open)


def _spread5(x: torch.Tensor) -> torch.Tensor:
    """5 bits -> every third bit."""
    x = (x | (x << 8)) & 0x100F
    x = (x | (x << 4)) & 0x10C3
    return (x | (x << 2)) & 0x1249


def _coherence_order(st: WalkState, live: torch.Tensor) -> torch.Tensor:
    """Lanes sorted by the stack-top ray's direction octant, then the
    Morton code of its origin on a 32^3 lattice over the live lanes'
    bounds; dead lanes last.  The sort is stable, as jnp.argsort is."""
    lanes = torch.arange(st.sp.shape[0], device=live.device)
    top = torch.clamp(st.sp - 1, min=0).long()
    o_t = st.st_org[lanes, top]
    d_t = st.st_dir[lanes, top]
    octant = ((d_t[:, 0] > 0).to(torch.int32) * 4
              + (d_t[:, 1] > 0).to(torch.int32) * 2
              + (d_t[:, 2] > 0).to(torch.int32))
    lo = torch.where(live[:, None], o_t, torch.inf).amin(0)
    hi = torch.where(live[:, None], o_t, -torch.inf).amax(0)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp(((o_t - lo) * inv * 32.0).to(torch.int32), 0, 31)
    morton = (_spread5(q[:, 0]) | (_spread5(q[:, 1]) << 1)
              | (_spread5(q[:, 2]) << 2))
    key = torch.where(live, octant * (1 << 15) + morton, 1 << 24)
    return torch.argsort(key, stable=True)


def _scatter_back(state: WalkState, sub: WalkState, lanes, keep) -> None:
    """Writes the chunk's slots `keep` back into the state's `lanes`, in
    place: nothing else holds the state's tensors."""
    for f in dataclasses.fields(state):
        getattr(state, f.name)[lanes] = getattr(sub, f.name)[keep]


def trace_radiance(scene: Scene, config: RenderConfig, tracer: Tracer,
                   o: torch.Tensor, d: torch.Tensor, keys: torch.Tensor,
                   differentiable: bool = False):
    """Whitted, NoShadows or PathTracer radiance of a batch of primary
    rays.  Returns (rgb (B, 3), casted-ray count as an int32 tensor).
    With `differentiable` every step is a full-batch step (no primary
    step, no compaction): the JAX package's differentiable scan, which
    stops here once no lane is live, since every later step adds
    nothing."""
    shader = config.shader
    pathtracer = shader == C.SHADER_PATHTRACER
    b = o.shape[0]
    s = config.stack_size
    kb = config.depth_max if pathtracer else 1
    dev = o.device
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    # Slot 0 holds the primary ray; built out of place for autograd.
    rest = torch.zeros((b, s - 1, 3), **f32)
    st_org = torch.cat([o[:, None], rest], 1)
    st_dir = torch.cat([d[:, None], rest], 1)
    st_weight = torch.cat([torch.ones((b, 1, 3), **f32), rest], 1)
    no = dict(dtype=torch.bool, device=dev)
    state = WalkState(
        sp=torch.ones((b,), **i32), st_org=st_org, st_dir=st_dir,
        st_weight=st_weight,
        st_depth=torch.ones((b, s), **i32),   # primary rays have depth 1
        st_pkind=torch.zeros((b, s), **i32),
        st_pid=torch.full((b, s), -1, **i32),
        st_flags=torch.zeros((b, s), **i32), st_nb=torch.zeros((b, s), **i32),
        rgb=torch.zeros((b, 3), **f32),
        rays=torch.zeros((b,), **i32), pops=torch.zeros((b,), **i32),
        bkt_rgb=torch.zeros((b, kb, 3), **f32),
        bkt_ld=torch.zeros((b, kb), **no), bkt_light=torch.zeros((b, kb), **no),
        bkt_pspine=torch.zeros((b, kb), **no),
        bkt_open=torch.zeros((b, kb), **no))

    def step(state: WalkState, keys, primary: bool = False):
        it = state.pops
        bb = state.sp.shape[0]
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
        # The grid DDA cannot exclude the sphere a reversed segment ends
        # on, so reversed NEE stays off on ACC_REGULAR_GRID.
        rev = (shared_step and config.nee_reverse
               and config.accelerator != C.ACC_REGULAR_GRID)
        ld_sum, n_shadow = common.direct_lighting(
            scene, hit, nee_keys, config.samples_light,
            shadows=(shader != C.SHADER_NOSHADOWS),
            occluded_fn=tracer.occluded, mask=diffuse,
            share_mask=None if shared_step else (it == 0),
            share_width=config.nee_share, share_all=shared_step,
            reverse=rev, coherent=rev)
        ld = kd * ld_sum / torch.full_like(ld_sum,
                                           float(config.samples_light))
        has_l = scene.lights.num > 0
        ld = torch.where((diffuse & has_l)[:, None], ld, 0.0)
        contrib = contrib + e["weight"] * ld
        rays = state.rays + torch.where(diffuse, n_shadow, 0)
        state = dataclasses.replace(state, rays=rays.to(torch.int32))
        if not pathtracer:
            # Ambient term "rgb += kD * 0.1" (Whitted.cpp:91,
            # NoShadows.cpp:46).
            contrib = contrib + torch.where(
                cont[:, None], e["weight"] * kd * C.WHITTED_AMBIENT, 0.0)
            state = dataclasses.replace(state, rgb=state.rgb + contrib)
            if shader == C.SHADER_NOSHADOWS:
                return state
        else:
            # The node's terms go to the innermost enclosing bucket, or to
            # the film outside every diffuse subtree; an emissive hit on a
            # diffuse spine flags that bucket (PathTracer.cpp:30-33, 102).
            nb = e["nb"]
            top = nb == 0
            oh = ((torch.arange(kb, device=dev)[None, :] == (nb - 1)[:, None])
                  & ~top[:, None])
            spine = (e["flags"] & FLAG_SPINE) != 0
            state = dataclasses.replace(
                state,
                rgb=state.rgb + torch.where(top[:, None], contrib, 0.0),
                bkt_rgb=state.bkt_rgb + torch.where(
                    oh[:, :, None], contrib[:, None, :], 0.0),
                bkt_light=state.bkt_light | (
                    oh & (emit_w & spine & ~top)[:, None]))

        depth1 = e["depth"] + 1
        zero_i = torch.zeros((bb,), **i32)
        # Specular reflection child (Whitted.cpp:73-79,
        # PathTracer.cpp:117-124).
        spec = cont & common.has_positive(ks)
        rdir = common.reflect(e["dirn"], hit.normal)
        state = _push(state, spec, hit.point, rdir, e["weight"] * ks, depth1,
                      hit.prim_kind, hit.prim_id, zero_i, e["nb"])
        # Specular transmission child (Whitted.cpp:82-90,
        # PathTracer.cpp:127-135).
        trans = cont & common.has_positive(kt)
        tdir, tvalid = common.refract(e["dirn"], hit.normal, 1.0 / ior)
        state = _push(state, trans & tvalid, hit.point, tdir,
                      e["weight"] * kt, depth1, hit.prim_kind, hit.prim_id,
                      zero_i, e["nb"])
        if not pathtracer:
            return state

        # Diffuse indirect child with Russian roulette
        # (PathTracer.cpp:88-113): always continue while depth <=
        # RayDepthMin, then when u > finishProbability, boosted by
        # 1 / (continueProbability * 0.5).
        rr = sampling.uniform(sampling.event_key(keys, it, 2))
        go = diffuse & ((e["depth"] <= config.depth_min)
                        | (rr > C.RR_FINISH_PROBABILITY))
        ndir = sampling.cosine_sample_hemisphere(
            sampling.event_key(keys, it, 3), hit.normal)
        boost = torch.where(e["depth"] > config.depth_min,
                            1.0 / ((1.0 - C.RR_FINISH_PROBABILITY) * 0.5), 1.0)
        w_ind = e["weight"] * kd * boost[:, None]
        # Open the edge's bucket at level nb (the child runs at nb + 1).
        ohb = ((torch.arange(kb, device=dev)[None, :] == e["nb"][:, None])
               & go[:, None])
        state = dataclasses.replace(
            state, bkt_open=state.bkt_open | ohb,
            bkt_ld=torch.where(ohb, common.has_positive(ld)[:, None],
                               state.bkt_ld),
            bkt_light=state.bkt_light & ~ohb,
            bkt_pspine=torch.where(ohb, spine[:, None], state.bkt_pspine),
            bkt_rgb=torch.where(ohb[:, :, None], 0.0, state.bkt_rgb))
        state = _push(state, go, hit.point, ndir, w_ind, depth1,
                      hit.prim_kind, hit.prim_id,
                      torch.full((bb,), FLAG_SPINE, **i32), e["nb"] + 1)
        # Close every bucket whose subtree just drained.
        lanes = torch.arange(bb, device=dev)
        topnb = torch.where(
            state.sp > 0,
            state.st_nb[lanes, torch.clamp(state.sp - 1, min=0).long()], 0)
        return _close_buckets(state, topnb)

    max_iters = 1 if shader == C.SHADER_NOSHADOWS \
        else config.resolved_max_walk_iters()

    def lane_live(st):
        return (st.sp > 0) & (st.pops < max_iters)

    unit = C.SUBTILE * max(1, 128 // C.SUBTILE)   # traversal padding unit
    if differentiable or b < 8 * unit or shader == C.SHADER_NOSHADOWS:
        # Small batches and the differentiable walk: full-batch steps
        # until drained.
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
            div = 4 if pathtracer else 32
        bc = max(unit, (b // div + unit - 1) // unit * unit)
        max_chunks = -(-b // bc) * max_iters
        lanes = torch.arange(b, device=dev)
        slots = torch.arange(bc, device=dev)
        it = 0
        while it < max_chunks:
            live = lane_live(state)
            if not bool(live.any()):
                break
            if pathtracer:
                # A slice of a permutation: no lane repeats.  Dead lanes
                # sorted past the live ones may fill a last partial chunk.
                idx = _coherence_order(state, live)[:bc]
                sub = step(state.map(lambda a: a[idx]), keys[idx])
                keep, ki = slice(None), idx
            else:
                # The first bc live lanes in lane order; unfilled slots
                # hold lane 0.
                pos = torch.cumsum(live, 0) - 1
                sel = live & (pos < bc)
                idx = torch.zeros(bc + 1, dtype=torch.int64, device=dev)
                idx[torch.where(sel, pos, bc)] = lanes   # slot bc: the drop
                idx = idx[:bc]
                sub = step(state.map(lambda a: a[idx]), keys[idx])
                # Where lane 0 fills several slots the last one is
                # written, as XLA's scatter writes duplicates in order.
                last = torch.zeros(b, dtype=torch.int64,
                                   device=dev).scatter_reduce(
                    0, idx, slots, reduce="amax")
                keep = slots == last[idx]
                ki = idx[keep]
            _scatter_back(state, sub, ki, keep)
            it += 1
            WALK["steps"] += 1
    if pathtracer:
        # Force-close what the pops budget left open: an unresolved spine
        # did not reach a light, as the reference's recursion past the
        # depth cap returns false.
        state = _close_buckets(state, torch.zeros((b,), **i32))
    return state.rgb, state.rays.sum().to(torch.int32)


def _first_hit(tracer: Tracer, scene: Scene, o, d):
    b = o.shape[0]
    return tracer.closest(
        scene, o, d, torch.zeros((b,), dtype=torch.int32, device=o.device),
        torch.full((b,), -1, dtype=torch.int32, device=o.device))


def shade_depthmap(scene: Scene, config: RenderConfig, tracer: Tracer,
                   o, d, max_point):
    """Grayscale by distance (DepthMap.cpp:12-17): maxDist = |maxPoint -
    origin| * 1.1, value max((maxDist - t) / maxDist, 0)."""
    hit = _first_hit(tracer, scene, o, d)
    x = max_point - o
    max_dist = torch.sqrt(intersect._dot(x, x)) * 1.1
    val = torch.clamp((max_dist - hit.t) / max_dist, min=0.0)
    return (val[:, None].expand(-1, 3).contiguous(),
            torch.tensor(o.shape[0], dtype=torch.int32, device=o.device))


def shade_diffuse(scene: Scene, config: RenderConfig, tracer: Tracer, o, d):
    """Flat material colour (DiffuseMaterial.cpp:11-27): the first of Kd,
    Ks, Kt, Le with a positive component."""
    hit = _first_hit(tracer, scene, o, d)
    le, kd, ks, kt, _ = common.bind_material(scene, hit)
    rgb = torch.zeros_like(kd)
    for v in (le, kt, ks, kd):
        rgb = torch.where(common.has_positive(v)[:, None], v, rgb)
    rgb = torch.where(hit.missed[:, None], 0.0, rgb)
    return rgb, torch.tensor(o.shape[0], dtype=torch.int32, device=o.device)


def trace_image_sample(scene: Scene, config: RenderConfig, o, d, keys,
                       max_point=None, differentiable: bool = False):
    """Radiance of one sample of every lane, dispatched on the shader id
    (C_wrapper.cpp:154-194).  `max_point` is DepthMap's far point,
    (1, 1, 1) when None.  `differentiable` takes the differentiable walk
    and tracer (see make_tracer); DepthMap and DiffuseMaterial use that
    tracer too."""
    tracer = make_tracer(config, differentiable=differentiable)
    if config.shader == C.SHADER_DEPTHMAP:
        if max_point is None:
            max_point = torch.ones(3)
        max_point = torch.as_tensor(max_point, dtype=torch.float32,
                                    device=o.device)
        return shade_depthmap(scene, config, tracer, o, d, max_point)
    if config.shader == C.SHADER_DIFFUSE:
        return shade_diffuse(scene, config, tracer, o, d)
    return trace_radiance(scene, config, tracer, o, d, keys,
                          differentiable=differentiable)
