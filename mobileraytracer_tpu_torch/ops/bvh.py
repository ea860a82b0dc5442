"""SAH BVH: the host-side build and the escape-index walk (port of
`mobileraytracer_tpu/ops/bvh.py`; reference BVH.hpp:161-283, 327-384,
398-439).

The build is the same numpy code as the JAX package, so the node tables
and the triangle permutation are bit-equal.  The block traversal
(ops/block_traversal.py) cuts this tree at 128-triangle leaves; `build`
attaches the tree itself, which the escape-index walk traverses: each
ray's cursor moves to the next node in preorder when it enters a box and
to the node's escape index when it misses, one node per step for the
whole batch, in a Python loop until every cursor is past the last node.
The JAX package computes the walk outside any kernel too.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import constants as C
from ..types import Hit, Scene, TensorData, Triangles, entry_device
from . import intersect as nv

LEAF_SIZE = 4
_BIG = C.RAY_LENGTH_MAX


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class BVHNodes(TensorData):
    """Flat DFS-preorder node table; leaves cover the contiguous triangle
    range [node_first, node_first + node_count).  numpy from
    `build_triangle_bvh`, tensors once `build` attaches it to a scene."""
    node_min: np.ndarray     # (K, 3) f32
    node_max: np.ndarray     # (K, 3) f32
    node_first: np.ndarray   # (K,) i32
    node_skip: np.ndarray    # (K,) i32 escape index
    node_count: np.ndarray   # (K,) i32, 0 for internal nodes

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


_SAH_BUCKETS = 10  # reference bucket count (BVH.hpp getSplitIndexSah)


def _sah_split(cen_axis: np.ndarray, bmin: np.ndarray, bmax: np.ndarray):
    """Binned SAH split (the reference's 10-bucket strategy,
    BVH.hpp:398-439): bucket centroids along the longest axis, pick the
    bucket boundary minimizing count*surfaceArea left + right.  Returns
    (mid, permutation) partitioning [0, n) into [0, mid) and [mid, n).
    Falls back to a median split when centroids are degenerate."""
    n = cen_axis.shape[0]
    c0, c1 = cen_axis.min(), cen_axis.max()
    if c1 - c0 < 1e-12:
        mid = n // 2
        return mid, np.argpartition(cen_axis, mid)

    nb = _SAH_BUCKETS
    bins = np.minimum(((cen_axis - c0) / (c1 - c0) * nb).astype(np.int64),
                      nb - 1)
    counts = np.bincount(bins, minlength=nb)

    big = np.float64(1e30)
    lo_b = np.full((nb, 3), big)
    hi_b = np.full((nb, 3), -big)
    for b in range(nb):
        sel = bins == b
        if counts[b]:
            lo_b[b] = bmin[sel].min(0)
            hi_b[b] = bmax[sel].max(0)

    def area(lo, hi):
        e = np.maximum(hi - lo, 0.0)
        return 2.0 * (e[:, 0] * e[:, 1] + e[:, 0] * e[:, 2]
                      + e[:, 1] * e[:, 2])

    pre_lo = np.minimum.accumulate(lo_b, 0)
    pre_hi = np.maximum.accumulate(hi_b, 0)
    suf_lo = np.minimum.accumulate(lo_b[::-1], 0)[::-1]
    suf_hi = np.maximum.accumulate(hi_b[::-1], 0)[::-1]
    nl = np.cumsum(counts)[:-1]                     # left counts per cut
    nr = n - nl
    cost = (nl * area(pre_lo[:-1], pre_hi[:-1])
            + nr * area(suf_lo[1:], suf_hi[1:]))
    cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
    if not np.isfinite(cost).any():
        mid = n // 2
        return mid, np.argpartition(cen_axis, mid)
    cut = int(np.argmin(cost))                      # split after bucket `cut`
    part = np.argsort(bins > cut, kind="stable")
    return int(nl[cut]), part


def build_triangle_bvh(tris: Triangles,
                       leaf_size: int = LEAF_SIZE) -> Tuple[Triangles, "BVHNodes"]:
    """Builds the threaded BVH and returns (reordered triangles, bvh).

    Only valid triangles participate; padding rows are moved to the tail
    and never referenced by any leaf.
    """
    pa = _np(tris.point_a)
    ab = _np(tris.ab)
    ac = _np(tris.ac)
    valid = _np(tris.valid)
    n_valid = int(valid.sum())

    if n_valid == 0:
        bvh = BVHNodes(node_min=np.zeros((1, 3), np.float32),
                  node_max=np.zeros((1, 3), np.float32),
                  node_first=np.zeros((1,), np.int32),
                  node_skip=np.ones((1,), np.int32),
                  node_count=np.zeros((1,), np.int32))
        return tris, bvh

    ids = np.nonzero(valid)[0]
    pb = pa + ab
    pc = pa + ac
    bb_min = np.minimum(pa, np.minimum(pb, pc))[ids]
    bb_max = np.maximum(pa, np.maximum(pb, pc))[ids]
    centroid = 0.5 * (bb_min + bb_max)

    order = np.arange(n_valid)

    node_min, node_max, node_first, node_count = [], [], [], []
    out_order = np.empty(n_valid, np.int64)
    # Iterative DFS emitting nodes in preorder; each node records its
    # primitive range so escape indices can be resolved afterwards.
    stack = [(0, n_valid)]
    range_lo, range_hi = [], []

    while stack:
        lo, hi = stack.pop()
        idx = order[lo:hi]
        bmin = bb_min[idx].min(0)
        bmax = bb_max[idx].max(0)
        node_min.append(bmin)
        node_max.append(bmax)
        range_lo.append(lo)
        range_hi.append(hi)
        if hi - lo <= leaf_size:
            node_first.append(lo)
            node_count.append(hi - lo)
            out_order[lo:hi] = idx
        else:
            node_first.append(0)
            node_count.append(0)
            cen = centroid[idx]
            ext = cen.max(0) - cen.min(0)
            axis = int(np.argmax(ext))
            mid, part = _sah_split(cen[:, axis], bb_min[idx], bb_max[idx])
            order[lo:hi] = idx[part]
            # Push right first so left is emitted next (preorder).
            stack.append((lo + mid, hi))
            stack.append((lo, lo + mid))

    k = len(node_min)
    node_first = np.asarray(node_first, np.int32)
    node_count = np.asarray(node_count, np.int32)
    range_lo = np.asarray(range_lo)
    range_hi = np.asarray(range_hi)

    # skip[i] = the next node after i's subtree.  In preorder, i's subtree
    # is exactly the nodes j >= i with range within [range_lo[i],
    # range_hi[i]); the first node after it is the smallest j > i with
    # range_lo[j] >= range_hi[i].  Compute with a monotonic stack.
    node_skip = np.full(k, k, np.int32)
    stack2 = []  # indices whose skip is pending
    for i in range(k):
        while stack2 and range_hi[stack2[-1]] <= range_lo[i]:
            node_skip[stack2.pop()] = i
        stack2.append(i)
    # Remaining nodes' subtrees extend to the end: skip = k (terminate).

    # Physically reorder triangles: new position p holds old out_order[p].
    perm = np.concatenate([ids[out_order],
                           np.nonzero(~valid)[0]]).astype(np.int32)

    def g(a):
        return torch.from_numpy(np.array(_np(a)[perm], order="C"))

    tris2 = Triangles(
        point_a=g(tris.point_a), ab=g(tris.ab), ac=g(tris.ac),
        normal_a=g(tris.normal_a), normal_b=g(tris.normal_b),
        normal_c=g(tris.normal_c),
        uv_a=g(tris.uv_a), uv_b=g(tris.uv_b), uv_c=g(tris.uv_c),
        mat_id=g(tris.mat_id), valid=g(tris.valid))

    bvh = BVHNodes(node_min=np.stack(node_min).astype(np.float32),
              node_max=np.stack(node_max).astype(np.float32),
              node_first=node_first,
              node_skip=node_skip,
              node_count=node_count)
    return tris2, bvh


def build(scene: Scene, device=None) -> Scene:
    """Attaches the triangle BVH to the scene (reordering its triangles)
    and moves the scene to `device`: the CUDA card unless another is named
    (types.entry_device).  Spheres and planes stay on the naive scans."""
    device = entry_device(device)
    tris2, nodes = build_triangle_bvh(scene.triangles.to("cpu"))
    nodes = BVHNodes(**{f.name: torch.from_numpy(getattr(nodes, f.name))
                        for f in dataclasses.fields(nodes)})
    return scene.replace(triangles=tris2, bvh=nodes).to(device)


# ---------------------------------------------------------------------------
# The escape-index walk.
# ---------------------------------------------------------------------------

def _slab_test(o, inv_d, bmin, bmax, t_best):
    """Ray/AABB slab test (reference AABB.cpp:34-54): the box is hit
    closer than t_best."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    return (tnear <= tfar) & (tfar >= 0.0) & (tnear < t_best)


def _leaf_tests(bvh: BVHNodes, tris: Triangles, o, d, cur, hit_box, t_lim,
                guard, prev_id):
    """Moller-Trumbore of each ray against the up to LEAF_SIZE triangles of
    its node, where the node is a leaf whose box it hit.  Returns (t (B, L),
    slot (B, L)) with misses, excluded and invalid lanes at _BIG."""
    cnt = bvh.node_count[cur]
    lane = torch.arange(LEAF_SIZE, device=o.device)
    slot = torch.clamp(bvh.node_first[cur][:, None] + lane[None, :],
                       max=tris.capacity - 1)
    s = slot.long()
    t, ok = nv._mt_components(o[:, None, :], d[:, None, :], tris.point_a[s],
                              tris.ab[s], tris.ac[s])
    ok = (ok & (lane[None, :] < cnt[:, None]) & ((cnt > 0) & hit_box)[:, None]
          & tris.valid[s] & (t < t_lim[:, None])
          & ~(guard[:, None] & (slot == prev_id[:, None])))
    return torch.where(ok, t, _BIG), slot


def _advance(bvh: BVHNodes, cursor, cur, hit_box, active):
    nxt = torch.where(hit_box & (bvh.node_count[cur] == 0), cursor + 1,
                      bvh.node_skip[cur])
    return torch.where(active, nxt, cursor)


def traverse_closest(bvh: BVHNodes, tris: Triangles, o, d, t_max, prev_kind,
                     prev_id):
    """Closest triangle per ray below `t_max`: (t, slot), slot -1 where
    none; slots index the reordered triangles."""
    b = o.shape[0]
    k = bvh.node_min.shape[0]
    inv_d = nv._inv_dir(d)
    guard = prev_kind == C.PRIM_TRIANGLE
    cursor = torch.zeros(b, dtype=torch.int32, device=o.device)
    t_best = nv._t_max(t_max, o).clone()
    best_id = torch.full((b,), -1, dtype=torch.int32, device=o.device)
    while bool((cursor < k).any()):
        cur = torch.clamp(cursor, max=k - 1).long()
        active = cursor < k
        hit_box = _slab_test(o, inv_d, bvh.node_min[cur], bvh.node_max[cur],
                             t_best) & active
        t, slot = _leaf_tests(bvh, tris, o, d, cur, hit_box, t_best, guard,
                              prev_id)
        arg = torch.argmin(t, dim=1, keepdim=True)     # first minimum
        tmin = torch.gather(t, 1, arg)[:, 0]
        closer = tmin < t_best
        t_best = torch.where(closer, tmin, t_best)
        best_id = torch.where(closer, torch.gather(slot, 1, arg)[:, 0],
                              best_id)
        cursor = _advance(bvh, cursor, cur, hit_box, active)
    return t_best, best_id


def traverse_any(bvh: BVHNodes, tris: Triangles, o, d, max_dist, prev_kind,
                 prev_id):
    """Whether any triangle lies below `max_dist`, each ray stopping at its
    first."""
    b = o.shape[0]
    k = bvh.node_min.shape[0]
    inv_d = nv._inv_dir(d)
    guard = prev_kind == C.PRIM_TRIANGLE
    md = nv._t_max(max_dist, o)
    cursor = torch.zeros(b, dtype=torch.int32, device=o.device)
    found = torch.zeros(b, dtype=torch.bool, device=o.device)
    while bool(((cursor < k) & ~found).any()):
        cur = torch.clamp(cursor, max=k - 1).long()
        active = (cursor < k) & ~found
        hit_box = _slab_test(o, inv_d, bvh.node_min[cur], bvh.node_max[cur],
                             md) & active
        t, _ = _leaf_tests(bvh, tris, o, d, cur, hit_box, md, guard, prev_id)
        found = found | (t < _BIG).any(1)
        cursor = _advance(bvh, cursor, cur, hit_box, active)
    return found


def intersect_scene_bvh(scene: Scene, o, d, prev_kind, prev_id,
                        t_max=_BIG) -> Hit:
    """Closest hit: planes, spheres and area lights by the naive scans,
    triangles by the escape-index walk."""
    if not isinstance(scene.bvh, BVHNodes):
        raise ValueError("call ops.bvh.build first")
    tm = nv._t_max(t_max, o)
    t_pl, id_pl = nv.closest_planes(scene.planes, o, d, tm, prev_kind,
                                    prev_id)
    t_sp, id_sp = nv.closest_spheres(scene.spheres, o, d, tm, prev_kind,
                                     prev_id)
    t_tr, id_tr = traverse_closest(scene.bvh, scene.triangles, o, d, tm,
                                   prev_kind, prev_id)
    t_tr = torch.where(id_tr >= 0, t_tr, _BIG)
    t_li, id_li = nv.closest_lights(scene.lights, o, d, tm, prev_kind,
                                    prev_id)
    return nv._fill_hit(scene, o, d, t_pl, id_pl, t_sp, id_sp, t_tr, id_tr,
                        t_li, id_li)


def occluded_bvh(scene: Scene, o, d, max_dist, prev_kind, prev_id):
    """Shadow query: the escape-index any-hit walk, and the naive scans of
    planes and spheres (the ray's own sphere excluded)."""
    if not isinstance(scene.bvh, BVHNodes):
        raise ValueError("call ops.bvh.build first")
    md = nv._t_max(max_dist, o)
    t_pl, _ = nv.closest_planes(scene.planes, o, d, md, prev_kind, prev_id)
    t_sp, _ = nv.closest_spheres(scene.spheres, o, d, md, prev_kind, prev_id,
                                 exclude_prev=True)
    blocked = traverse_any(scene.bvh, scene.triangles, o, d, md, prev_kind,
                           prev_id)
    return blocked | (t_pl < md) | (t_sp < md)
