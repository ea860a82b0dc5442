"""Two-level "block BVH" traversal with fixed work per ray (port of
`mobileraytracer_tpu/ops/block_bvh.py`).

The SAH build of ops/bvh.py is cut at `block_size`-triangle leaves
("blocks", each a contiguous range of the reordered triangles), grouped
`blocks_per_super` consecutive blocks to a "super".  A traversal takes
the rays in tiles of `tile` consecutive lanes and runs three dense
phases per tile:

  A. slab entry of every ray against every super, reduced over the tile
     (the minimum), and the tile's `top_s` nearest supers;
  B. the entries of the tile's rays against those supers' blocks, reduced
     over the tile, and the `top_m` nearest blocks;
  C. exactly `top_m` steps, each testing the tile's rays against one
     block's triangles with Moller-Trumbore (Triangle.cpp:63-109).

The budgets bound the work; a ray whose hit lies behind more than `top_s`
supers or `top_m` blocks can miss it (a hit is never invented: every t
returned is a real triangle's), so they are sized for the scene.  There
is no refill and no data-dependent loop: the work is fixed by the shapes,
and no step waits for the device.

Ties follow the JAX package: its `lax.top_k(-x, k)` becomes a stable
ascending sort (lower index first on equal entries; `torch.topk` promises
no order on ties), its `lax.scan` a Python loop of `m` steps, and its
`argmin` `torch.argmin` (the first index at the minimum).  The slab test
and the Moller-Trumbore arithmetic are this module's own copies, as in
the JAX package (block_traversal's interval bounds compute something
else).  No kernel runs here: the JAX module is XLA, not Pallas.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import constants as C
from ..types import Hit, Scene, TensorData, Triangles, entry_device
from . import intersect as nv
from .bvh import build_triangle_bvh

_BIG = C.RAY_LENGTH_MAX

DEFAULT_BLOCK_SIZE = 64
DEFAULT_BLOCKS_PER_SUPER = 16
DEFAULT_TOP_S = 48
DEFAULT_TOP_M = 96
_RAY_CHUNK = 65536


@dataclasses.dataclass
class BlockGrid(TensorData):
    """Two-level block table over the reordered triangle array, AABBs
    componentwise and each block's triangles packed as one (BS, 12) row:
    pax..paz, abx..abz, acx..acz, valid, 0, 0."""
    super_lo: torch.Tensor     # (3, K1) f32
    super_hi: torch.Tensor     # (3, K1) f32
    block_lo: torch.Tensor     # (3, K1, BPS) f32
    block_hi: torch.Tensor     # (3, K1, BPS) f32
    block_first: torch.Tensor  # (K1, BPS) i32
    block_count: torch.Tensor  # (K1, BPS) i32, 0 on padding
    tri_blocks: torch.Tensor   # (K1 * BPS, BS, 12) f32
    block_size: int = 128
    top_s: int = DEFAULT_TOP_S
    top_m: int = DEFAULT_TOP_M
    tile: int = 16

    @property
    def num_supers(self) -> int:
        return self.super_lo.shape[1]


def build_blocks(tris: Triangles, block_size: int = DEFAULT_BLOCK_SIZE,
                 blocks_per_super: int = DEFAULT_BLOCKS_PER_SUPER,
                 top_s: int = DEFAULT_TOP_S,
                 top_m: int = DEFAULT_TOP_M,
                 tile: int = 16) -> Tuple[Triangles, BlockGrid]:
    """The JAX package's numpy build.  Returns the reordered triangles and
    the grid, as CPU tensors."""
    tris2, bvh = build_triangle_bvh(tris, leaf_size=block_size)
    counts = np.asarray(bvh.node_count)
    leaf = counts > 0
    bmin = np.asarray(bvh.node_min)[leaf]
    bmax = np.asarray(bvh.node_max)[leaf]
    bfirst = np.asarray(bvh.node_first)[leaf]
    bcount = counts[leaf]
    k = bmin.shape[0]

    bps = min(blocks_per_super, k)
    k1 = -(-k // bps)
    padded = k1 * bps

    def pad(a, fill):
        out = np.full((padded,) + a.shape[1:], fill, a.dtype)
        out[:k] = a
        return out

    bmin_p = pad(bmin, np.float32(3e38)).reshape(k1, bps, 3)
    bmax_p = pad(bmax, np.float32(-3e38)).reshape(k1, bps, 3)
    bfirst_p = pad(bfirst, np.int32(0)).reshape(k1, bps)
    bcount_p = pad(bcount.astype(np.int32), np.int32(0)).reshape(k1, bps)

    bs_max = int(bcount.max()) if k else 1
    pa = tris2.point_a.numpy()
    ab = tris2.ab.numpy()
    ac = tris2.ac.numpy()
    va = tris2.valid.numpy()
    tb = np.zeros((padded, bs_max, 12), np.float32)
    bf_flat = bfirst_p.reshape(-1)
    bc_flat = bcount_p.reshape(-1)
    for bi in range(padded):
        cnt = int(bc_flat[bi])
        if cnt == 0:
            continue
        f0 = int(bf_flat[bi])
        tb[bi, :cnt, 0:3] = pa[f0:f0 + cnt]
        tb[bi, :cnt, 3:6] = ab[f0:f0 + cnt]
        tb[bi, :cnt, 6:9] = ac[f0:f0 + cnt]
        tb[bi, :cnt, 9] = va[f0:f0 + cnt].astype(np.float32)

    t = lambda a: torch.from_numpy(np.array(a, order="C"))
    grid = BlockGrid(
        super_lo=t(bmin_p.min(1).T), super_hi=t(bmax_p.max(1).T),
        block_lo=t(np.moveaxis(bmin_p, 2, 0)),
        block_hi=t(np.moveaxis(bmax_p, 2, 0)),
        block_first=t(bfirst_p), block_count=t(bcount_p), tri_blocks=t(tb),
        block_size=bs_max, top_s=min(top_s, k1),
        top_m=min(top_m, k1 * bps), tile=tile)
    return tris2, grid


def _entry_cw(ox, oy, oz, ix, iy, iz, lo, hi):
    """Componentwise slab entry distance, +inf on a miss.  The ray
    components broadcast against the boxes' (3, ...) bounds."""
    tx0 = (lo[0] - ox) * ix
    tx1 = (hi[0] - ox) * ix
    ty0 = (lo[1] - oy) * iy
    ty1 = (hi[1] - oy) * iy
    tz0 = (lo[2] - oz) * iz
    tz1 = (hi[2] - oz) * iz
    tnear = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                        torch.minimum(ty0, ty1)),
                          torch.minimum(tz0, tz1))
    tfar = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                       torch.maximum(ty0, ty1)),
                         torch.maximum(tz0, tz1))
    hit = (tnear <= tfar) & (tfar >= 0.0)
    return torch.where(hit, torch.clamp(tnear, min=0.0), torch.inf)


def _mt_cw(ox, oy, oz, dx, dy, dz,
           pax, pay, paz, abx, aby, abz, acx, acy, acz):
    """Componentwise Moller-Trumbore with the reference's acceptance
    tests: t where a pair is accepted, RAY_LENGTH_MAX elsewhere."""
    px = dy * acz - dz * acy
    py = dz * acx - dx * acz
    pz = dx * acy - dy * acx
    det = abx * px + aby * py + abz * pz
    inv = 1.0 / torch.where(torch.abs(det) < C.EPSILON, 1.0, det)
    tvx = ox - pax
    tvy = oy - pay
    tvz = oz - paz
    u = inv * (tvx * px + tvy * py + tvz * pz)
    qx = tvy * abz - tvz * aby
    qy = tvz * abx - tvx * abz
    qz = tvx * aby - tvy * abx
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (acx * qx + acy * qy + acz * qz)
    ok = ((torch.abs(det) >= C.EPSILON) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t >= C.EPSILON))
    return torch.where(ok, t, _BIG)


def _smallest(x: torch.Tensor, k: int):
    """The k smallest entries along the last axis in ascending order, ties
    by lower index (`lax.top_k(-x, k)`)."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _traverse_chunk(grid: BlockGrid, tris: Triangles, o, d, t_init,
                    prev_kind, prev_id):
    """Tile-cooperative traversal of one chunk of rays (B a multiple of
    grid.tile).  Returns (t_best (B,), best_id (B,) int32, -1 for none)."""
    b = o.shape[0]
    tile = grid.tile
    nt = b // tile
    dev = o.device
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-30,
                              torch.where(d < 0, -1e-30, 1e-30), d)
    guard = prev_kind == C.PRIM_TRIANGLE
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    ix, iy, iz = inv_d[:, 0], inv_d[:, 1], inv_d[:, 2]

    # Phase A: per-ray super entries, reduced per tile.
    e_super = _entry_cw(ox[:, None], oy[:, None], oz[:, None],
                        ix[:, None], iy[:, None], iz[:, None],
                        grid.super_lo[:, None, :], grid.super_hi[:, None, :])
    e_super_t = e_super.reshape(nt, tile, -1).amin(1)             # (nt, K1)
    e_sel, sup_ids = _smallest(e_super_t, grid.top_s)             # (nt, s)
    sup_ok = torch.isfinite(e_sel)

    # Phase B: the candidate blocks of the tile's supers.
    cb_lo = grid.block_lo[:, sup_ids]                    # (3, nt, s, BPS)
    cb_hi = grid.block_hi[:, sup_ids]
    cb_first = grid.block_first[sup_ids]                 # (nt, s, BPS)
    cb_count = grid.block_count[sup_ids]
    bps = cb_first.shape[2]
    nc = grid.top_s * bps

    def tile_ray(c):
        return c.reshape(nt, tile, 1)
    e_blk = _entry_cw(tile_ray(ox), tile_ray(oy), tile_ray(oz),
                      tile_ray(ix), tile_ray(iy), tile_ray(iz),
                      cb_lo.reshape(3, nt, 1, nc),
                      cb_hi.reshape(3, nt, 1, nc))        # (nt, tile, nc)
    cand_ok = (cb_count.reshape(nt, nc) > 0) & sup_ok.repeat_interleave(
        bps, 1)
    e_blk = torch.where(cand_ok[:, None, :], e_blk, torch.inf)
    m = min(grid.top_m, nc)
    cand_entry_t, cand = _smallest(e_blk.amin(1), m)             # (nt, m)
    cand_first = torch.gather(cb_first.reshape(nt, nc), 1, cand)
    gids = (sup_ids[:, :, None] * bps
            + torch.arange(bps, device=dev)[None, None, :])
    cand_gid = torch.gather(gids.reshape(nt, nc), 1, cand)
    # Each ray's own entry to the selected blocks.
    e_ray = torch.gather(e_blk, 2, cand[:, None, :].expand(nt, tile, m))

    # Phase C: m steps, each one packed block per tile against its rays.
    offs = torch.arange(grid.block_size, dtype=torch.int32, device=dev)
    otx, oty, otz = (c.reshape(nt, tile, 1) for c in (ox, oy, oz))
    dtx, dty, dtz = (d[:, c].reshape(nt, tile, 1) for c in range(3))
    guard3 = guard.reshape(nt, tile)
    prev3 = prev_id.reshape(nt, tile)
    t_best = t_init.reshape(nt, tile)
    best_id = torch.full((nt, tile), -1, dtype=torch.int32, device=dev)
    for i in range(m):
        tile_ok = torch.isfinite(cand_entry_t[:, i])             # (nt,)
        slot = torch.clamp(cand_first[:, i:i + 1] + offs[None, :],
                           max=tris.capacity - 1)                 # (nt, BS)
        rows = grid.tri_blocks[cand_gid[:, i]]                    # (nt, BS, 12)
        r = [rows[:, None, :, c] for c in range(9)]
        tvalid = rows[..., 9] > 0.5
        t = _mt_cw(otx, oty, otz, dtx, dty, dtz, *r)              # (nt, tile, BS)
        useful = e_ray[:, :, i] < t_best                          # (nt, tile)
        ok = ((tile_ok[:, None] & tvalid)[:, None, :]
              & useful[:, :, None]
              & (t < t_best[:, :, None])
              & ~(guard3[:, :, None] & (slot[:, None, :] == prev3[:, :, None])))
        t = torch.where(ok, t, _BIG)
        arg = torch.argmin(t, dim=2)                              # (nt, tile)
        tmin = torch.gather(t, 2, arg[:, :, None])[:, :, 0]
        smin = torch.gather(slot, 1, arg)
        closer = tmin < t_best
        t_best = torch.where(closer, tmin, t_best)
        best_id = torch.where(closer, smin, best_id)
    return t_best.reshape(b), best_id.reshape(b)


def traverse_closest(grid: BlockGrid, tris: Triangles, o, d, t_max,
                     prev_kind, prev_id):
    """Closest triangle hit of each ray within its budgets: (t (B,),
    id (B,) int32, -1 for none; t is t_max there).  Rays go in chunks of
    at most 65,536 lanes, the batch padded to whole tiles."""
    b = o.shape[0]
    t0 = torch.as_tensor(t_max, dtype=torch.float32,
                         device=o.device).expand(b)
    chunk = min(_RAY_CHUNK, -(-b // grid.tile) * grid.tile)
    n_chunks = -(-b // chunk)
    pad = n_chunks * chunk - b
    if pad == 0 and n_chunks == 1:
        return _traverse_chunk(grid, tris, o, d, t0, prev_kind, prev_id)

    def pad0(x, fill=0.0):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)], 0)

    oc, dc, tc = pad0(o), pad0(d, 1.0), pad0(t0)
    pk, pi = pad0(prev_kind, 0), pad0(prev_id, -1)
    t_out, id_out = [], []
    for c in range(n_chunks):
        s = slice(c * chunk, (c + 1) * chunk)
        t_c, id_c = _traverse_chunk(grid, tris, oc[s], dc[s], tc[s], pk[s],
                                    pi[s])
        t_out.append(t_c)
        id_out.append(id_c)
    return torch.cat(t_out)[:b], torch.cat(id_out)[:b]


def traverse_any(grid: BlockGrid, tris: Triangles, o, d, max_dist,
                 prev_kind, prev_id):
    """Whether a triangle blocks each ray before max_dist (within the
    budgets)."""
    md = torch.as_tensor(max_dist, dtype=torch.float32,
                         device=o.device).expand(o.shape[0])
    t_best, _ = traverse_closest(grid, tris, o, d, md, prev_kind, prev_id)
    return t_best < md


# ---------------------------------------------------------------------------
# Scene-level dispatch.
# ---------------------------------------------------------------------------

def build(scene: Scene, block_size: int = DEFAULT_BLOCK_SIZE, device=None,
          **kwargs) -> Scene:
    """Attaches the block table to the scene (reordering its triangles) in
    its `bvh` slot and moves the scene to `device`: the CUDA card unless
    another is named (types.entry_device; without a card it raises).
    `kwargs` go to build_blocks."""
    device = entry_device(device)
    tris2, grid = build_blocks(scene.triangles.to("cpu"), block_size,
                               **kwargs)
    return scene.replace(triangles=tris2, bvh=grid).to(device)


def _grid(scene: Scene) -> BlockGrid:
    if not isinstance(scene.bvh, BlockGrid):
        raise ValueError("call ops.block_bvh.build first")
    return scene.bvh


def intersect_scene_blocks(scene: Scene, o, d, prev_kind, prev_id,
                           t_max=_BIG, differentiable: bool = False) -> Hit:
    """Closest hit over the whole scene: planes, spheres and area lights by
    the naive scans, triangles by the block traversal.  With
    `differentiable` the traversal runs off the tape on detached triangles
    and rays, and the winner's t is re-derived from the live triangle
    table, so gradients reach the triangles through the hit."""
    grid = _grid(scene)
    tm = nv._t_max(t_max, o)
    t_pl, id_pl = nv.closest_planes(scene.planes, o, d, tm, prev_kind,
                                    prev_id)
    t_sp, id_sp = nv.closest_spheres(scene.spheres, o, d, tm, prev_kind,
                                     prev_id)
    if differentiable:
        with torch.no_grad():
            _, id_tr = traverse_closest(grid, scene.triangles.detach(),
                                        o.detach(), d.detach(), tm.detach(),
                                        prev_kind, prev_id)
        t_tr = nv.recompute_tri_t(scene.triangles, o, d, id_tr)
    else:
        t_tr, id_tr = traverse_closest(grid, scene.triangles, o, d, tm,
                                       prev_kind, prev_id)
    t_tr = torch.where(id_tr >= 0, t_tr, _BIG)
    t_li, id_li = nv.closest_lights(scene.lights, o, d, tm, prev_kind,
                                    prev_id)
    return nv._fill_hit(scene, o, d, t_pl, id_pl, t_sp, id_sp, t_tr, id_tr,
                        t_li, id_li)


def occluded_blocks(scene: Scene, o, d, max_dist, prev_kind, prev_id):
    """Shadow query over the whole scene: a plane, sphere (other than the
    ray's own) or triangle strictly closer than max_dist blocks."""
    grid = _grid(scene)
    md = nv._t_max(max_dist, o)
    t_pl, _ = nv.closest_planes(scene.planes, o, d, md, prev_kind, prev_id)
    t_sp, _ = nv.closest_spheres(scene.spheres, o, d, md, prev_kind, prev_id,
                                 exclude_prev=True)
    blocked = traverse_any(grid, scene.triangles, o, d, md, prev_kind,
                           prev_id)
    return blocked | (t_pl < md) | (t_sp < md)
