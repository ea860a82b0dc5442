"""The triangle order of the port's block build: the binned SAH split
(MobileRT's 10 buckets, BVH.hpp:398-439) down to 128-triangle leaves,
leaves in depth-first order, invalid rows last.

A frozen copy of the order that `ops/bvh.build_triangle_bvh` computes and
`block_traversal.build` applies, so that the reference can work out by
itself which row of the built table each triangle is: the vertex-gradient
call draws its edges by their row.
"""
from __future__ import annotations

import numpy as np

_BUCKETS = 10


def _sah_split(cen_axis, bmin, bmax):
    n = cen_axis.shape[0]
    c0, c1 = cen_axis.min(), cen_axis.max()
    if c1 - c0 < 1e-12:
        mid = n // 2
        return mid, np.argpartition(cen_axis, mid)
    nb = _BUCKETS
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
    nl = np.cumsum(counts)[:-1]
    nr = n - nl
    cost = (nl * area(pre_lo[:-1], pre_hi[:-1])
            + nr * area(suf_lo[1:], suf_hi[1:]))
    cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
    if not np.isfinite(cost).any():
        mid = n // 2
        return mid, np.argpartition(cen_axis, mid)
    cut = int(np.argmin(cost))
    return int(nl[cut]), np.argsort(bins > cut, kind="stable")


def block_order(point_a, ab, ac, valid, leaf_size: int = 128) -> np.ndarray:
    """perm: row p of the built table is row perm[p] of the input."""
    pa, ab, ac = (np.asarray(x, np.float32) for x in (point_a, ab, ac))
    valid = np.asarray(valid, bool)
    ids = np.nonzero(valid)[0]
    n = ids.shape[0]
    pb, pc = pa + ab, pa + ac
    bb_min = np.minimum(pa, np.minimum(pb, pc))[ids]
    bb_max = np.maximum(pa, np.maximum(pb, pc))[ids]
    centroid = 0.5 * (bb_min + bb_max)
    order = np.arange(n)
    out = np.empty(n, np.int64)
    stack = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        idx = order[lo:hi]
        if hi - lo <= leaf_size:
            out[lo:hi] = idx
            continue
        cen = centroid[idx]
        axis = int(np.argmax(cen.max(0) - cen.min(0)))
        mid, part = _sah_split(cen[:, axis], bb_min[idx], bb_max[idx])
        order[lo:hi] = idx[part]
        stack.append((lo + mid, hi))
        stack.append((lo, lo + mid))
    return np.concatenate([ids[out], np.nonzero(~valid)[0]]).astype(np.int64)
