"""Regular-grid accelerator: Amanatides-Woo 3D-DDA over a uniform cell grid
(port of `mobileraytracer_tpu/ops/grid.py`; reference
Accelerators/RegularGrid.hpp:333-515, 32^3 cells by default).

The build is host-side numpy producing a CSR cell table (`cell_start`,
`item_kind`, `item_id`) bit-equal to the JAX package's: a cell lists the
triangles, then the spheres, whose bounding boxes overlap it, each in id
order.  Planes are unbounded and stay on the naive scan.

The traversal walks every ray of a batch one cell per step, in a Python
loop until no ray is left in the grid; each step tests all items of the
rays' current cells at once.  A ray keeps the first item at its minimal
distance below its best so far, which is what the JAX package's
item-by-item loop with a strict `<` keeps, so the walk ends where it ends
there.  The DDA runs outside any kernel in the JAX package too.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..types import Hit, Scene, TensorData, entry_device
from . import intersect as nv

_BIG = C.RAY_LENGTH_MAX

DEFAULT_GRID_SIZE = 32


@dataclasses.dataclass
class RegularGrid(TensorData):
    bounds_min: torch.Tensor   # (3,) f32
    bounds_max: torch.Tensor   # (3,) f32
    cell_start: torch.Tensor   # (S^3 + 1,) i32 CSR offsets
    item_kind: torch.Tensor    # (T,) i32 PRIM_TRIANGLE | PRIM_SPHERE
    item_id: torch.Tensor      # (T,) i32
    size: int = DEFAULT_GRID_SIZE


def build_grid_tables(scene: Scene, size: int = DEFAULT_GRID_SIZE):
    """The grid's arrays as numpy, in the JAX package's order: (bounds_min,
    bounds_max, cell_start, item_kind, item_id)."""
    tris, sph = scene.triangles, scene.spheres
    np_ = lambda a: a.detach().cpu().numpy()
    kinds, ids, lo_box, hi_box = [], [], [], []
    tv = np_(tris.valid)
    if tv.any():
        pa = np_(tris.point_a)
        pb = pa + np_(tris.ab)
        pc = pa + np_(tris.ac)
        sel = np.nonzero(tv)[0]
        kinds.append(np.full(len(sel), C.PRIM_TRIANGLE, np.int32))
        ids.append(sel)
        lo_box.append(np.minimum(pa, np.minimum(pb, pc))[sel])
        hi_box.append(np.maximum(pa, np.maximum(pb, pc))[sel])
    sv = np_(sph.valid)
    if sv.any():
        ce = np_(sph.center)
        r = np.sqrt(np_(sph.sq_radius))
        sel = np.nonzero(sv)[0]
        kinds.append(np.full(len(sel), C.PRIM_SPHERE, np.int32))
        ids.append(sel)
        lo_box.append((ce - r[:, None])[sel])
        hi_box.append((ce + r[:, None])[sel])

    if kinds:
        kinds, ids = np.concatenate(kinds), np.concatenate(ids)
        bmin, bmax = np.concatenate(lo_box), np.concatenate(hi_box)
        wmin = bmin.min(0).astype(np.float32)
        wmax = bmax.max(0).astype(np.float32)
    else:
        kinds = ids = np.zeros(0, np.int32)
        bmin = bmax = np.zeros((0, 3), np.float32)
        wmin = np.zeros(3, np.float32)
        wmax = np.ones(3, np.float32)
    ext = np.maximum(wmax - wmin, 1e-6)
    wmin = wmin - 1e-4 * ext
    wmax = wmax + 1e-4 * ext
    cell = (wmax - wmin) / size

    lo = np.clip(((bmin - wmin) / cell).astype(int), 0, size - 1)
    hi = np.clip(((bmax - wmin) / cell).astype(int), 0, size - 1)
    span = hi - lo + 1                                  # cells per axis
    n_cells = span.prod(1)
    # Every (primitive, overlapped cell) pair, primitives in order; a
    # stable sort by cell keeps that order within each cell.
    prim = np.repeat(np.arange(len(kinds)), n_cells)
    k = np.arange(len(prim)) - np.repeat(np.cumsum(n_cells) - n_cells,
                                         n_cells)
    sx, sy = span[prim, 0], span[prim, 1]
    x = lo[prim, 0] + k % sx
    y = lo[prim, 1] + (k // sx) % sy
    z = lo[prim, 2] + k // (sx * sy)
    cid = (z * size + y) * size + x
    order = np.argsort(cid, kind="stable")
    start = np.zeros(size ** 3 + 1, np.int32)
    start[1:] = np.cumsum(np.bincount(cid, minlength=size ** 3))
    item_kind = kinds[prim[order]].astype(np.int32)
    item_id = ids[prim[order]].astype(np.int32)
    if len(item_kind) == 0:
        item_kind = item_id = np.zeros(1, np.int32)
    return (np.asarray(wmin, np.float32), np.asarray(wmax, np.float32), start,
            item_kind, item_id)


def build_grid(scene: Scene, size: int = DEFAULT_GRID_SIZE,
               device=None) -> Scene:
    """Builds the cell table into the scene's `bvh` slot and moves the
    scene to `device`: the CUDA card unless another is named
    (types.entry_device)."""
    device = entry_device(device)
    t = lambda a: torch.from_numpy(np.array(a, order="C"))
    wmin, wmax, start, kind, ids = build_grid_tables(scene, size)
    grid = RegularGrid(bounds_min=t(wmin), bounds_max=t(wmax),
                       cell_start=t(start), item_kind=t(kind),
                       item_id=t(ids), size=size)
    return scene.replace(bvh=grid).to(device)


def _sphere_t(o, d, center, sq_radius):
    """The grid's sphere test (its own copy in the JAX package too)."""
    oc = center - o
    proj = nv._dot(oc, d)
    a = nv._dot(d, d)
    b = 2.0 * -proj
    c = nv._dot(oc, oc) - sq_radius
    disc = b * b - 4.0 * a * c
    pos = disc >= 0.0
    sq = torch.sqrt(torch.where(pos, disc, 1.0))
    t = torch.minimum(-b + sq, -b - sq) / (2.0 * a)
    return torch.where(pos & (t >= C.EPSILON_LARGE), t, _BIG)


def _cell_items(grid: RegularGrid, scene: Scene, o, d, ci, t_best, best_kind,
                best_id, prev_kind, prev_id):
    """Tests every item of each ray's cell `ci`; a ray takes the first
    item at the smallest distance, if below its `t_best`."""
    start = grid.cell_start[ci].long()
    count = grid.cell_start[ci + 1].long() - start
    n = int(count.sum())
    if n == 0:
        return t_best, best_kind, best_id
    ray = torch.repeat_interleave(torch.arange(o.shape[0], device=o.device),
                                  count)
    first = torch.cumsum(count, 0) - count
    pos = torch.arange(n, device=o.device) - first[ray]
    item = start[ray] + pos
    kind = grid.item_kind[item]
    pid = grid.item_id[item]
    tris, sph = scene.triangles, scene.spheres
    ro, rd = o[ray], d[ray]
    tid = torch.clamp(pid, max=tris.capacity - 1).long()
    tt, ok = nv._mt_components(ro, rd, tris.point_a[tid], tris.ab[tid],
                               tris.ac[tid])
    tri = ((kind == C.PRIM_TRIANGLE) & ok
           & ~((prev_kind[ray] == C.PRIM_TRIANGLE) & (pid == prev_id[ray])))
    sid = torch.clamp(pid, max=sph.capacity - 1).long()
    ts = _sphere_t(ro, rd, sph.center[sid], sph.sq_radius[sid])
    t = torch.where(tri, tt, torch.where(kind == C.PRIM_SPHERE, ts, _BIG))
    t = torch.where(t < t_best[ray], t, _BIG)
    tmin = torch.full_like(t_best, _BIG).scatter_reduce(0, ray, t, "amin")
    win = (t < _BIG) & (t == tmin[ray])
    big = torch.full((o.shape[0],), n, dtype=torch.int64, device=o.device)
    arg = big.scatter_reduce(0, ray, torch.where(win, pos + first[ray], n),
                             "amin")
    found = arg < n
    arg = torch.clamp(arg, max=n - 1)
    return (torch.where(found, tmin, t_best),
            torch.where(found, kind[arg], best_kind),
            torch.where(found, pid[arg], best_id))


def traverse_grid(grid: RegularGrid, scene: Scene, o, d, t_max, prev_kind,
                  prev_id):
    """Closest grid item per ray below `t_max`: (t, kind, id), kind 0 and
    id -1 where none."""
    b = o.shape[0]
    dev = o.device
    size = grid.size
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(b)
    lo, hi = grid.bounds_min, grid.bounds_max
    cell = (hi - lo) / size
    inv_d = nv._inv_dir(d)
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    t_enter = torch.clamp(tnear, min=0.0)
    alive = (tnear <= tfar) & (tfar >= 0.0)

    p_enter = o + d * (t_enter + 1e-6)[:, None]
    ijk = torch.clamp(((p_enter - lo) / cell).to(torch.int32), 0, size - 1)
    step = torch.where(d >= 0, 1, -1).to(torch.int32)
    next_bound = lo + (ijk + (step > 0).to(torch.int32)).to(
        torch.float32) * cell
    t_next = torch.where(torch.abs(d) < 1e-30, _BIG, (next_bound - o) * inv_d)
    t_delta = torch.abs(cell * inv_d)

    t_best = tm.clone()
    kind = torch.zeros(b, dtype=torch.int32, device=dev)
    pid = torch.full((b,), -1, dtype=torch.int32, device=dev)
    while True:
        rows = torch.nonzero(alive)[:, 0]
        if rows.numel() == 0:
            break
        c = ijk[rows]
        ci = ((c[:, 2] * size + c[:, 1]) * size + c[:, 0]).long()
        tb, kb, ib = _cell_items(grid, scene, o[rows], d[rows], ci,
                                 t_best[rows], kind[rows], pid[rows],
                                 prev_kind[rows], prev_id[rows])
        t_best[rows], kind[rows], pid[rows] = tb, kb, ib
        # Advance to the next cell along the axis whose boundary is next
        # (the first such axis on ties, as argmin).
        tn = t_next[rows]
        axis = torch.argmin(tn, dim=1)
        t_exit = torch.gather(tn, 1, axis[:, None])[:, 0]
        hot = torch.nn.functional.one_hot(axis, 3).bool()
        c = c + torch.where(hot, step[rows], 0)
        t_next[rows] = torch.where(hot, tn + t_delta[rows], tn)
        ijk[rows] = c
        inside = ((c >= 0) & (c < size)).all(1)
        alive[rows] = inside & (tb > t_exit) & (t_exit < tm[rows])
    return t_best, kind, pid


def intersect_scene_grid(scene: Scene, o, d, prev_kind, prev_id,
                         t_max=_BIG) -> Hit:
    """Closest hit: planes and area lights by the naive scans, triangles and
    spheres by the grid."""
    g = scene.bvh
    if not isinstance(g, RegularGrid):
        raise ValueError("call ops.grid.build_grid first")
    tm = nv._t_max(t_max, o)
    t_pl, id_pl = nv.closest_planes(scene.planes, o, d, tm, prev_kind,
                                    prev_id)
    t_g, k_g, id_g = traverse_grid(g, scene, o, d, tm, prev_kind, prev_id)
    tri = k_g == C.PRIM_TRIANGLE
    sp = k_g == C.PRIM_SPHERE
    t_li, id_li = nv.closest_lights(scene.lights, o, d, tm, prev_kind,
                                    prev_id)
    return nv._fill_hit(scene, o, d, t_pl, id_pl,
                        torch.where(sp, t_g, _BIG), torch.where(sp, id_g, -1),
                        torch.where(tri, t_g, _BIG),
                        torch.where(tri, id_g, -1), t_li, id_li)


def occluded_grid(scene: Scene, o, d, max_dist, prev_kind, prev_id):
    """Shadow query: a closest-hit walk bounded by `max_dist` (as in the
    JAX package, not an any-hit walk)."""
    g = scene.bvh
    if not isinstance(g, RegularGrid):
        raise ValueError("call ops.grid.build_grid first")
    md = nv._t_max(max_dist, o)
    t_pl, _ = nv.closest_planes(scene.planes, o, d, md, prev_kind, prev_id)
    t_g, _, _ = traverse_grid(g, scene, o, d, md, prev_kind, prev_id)
    return (t_g < md) | (t_pl < md)
