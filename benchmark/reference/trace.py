"""Closest-hit and occlusion queries of ray bundles against a triangle
list: plain PyTorch, brute force over the triangles that a bundle's cone
can reach.

Consecutive rays form bundles (128 by default; one ray is a bundle too).
A bundle's rays either leave one point (a frame's camera rays), or, for
shadow segments, end at one point (the light sample that a group of lanes
shares); that point is the apex of a cone around the bundle's mean
direction that holds every ray of the bundle.  A triangle is kept for a
bundle when its bounding sphere meets that cone within the bundle's
longest segment; the test runs in float64 with margins, so it only drops
triangles that no ray of the bundle can reach.  Each kept (bundle,
triangle) pair then takes MobileRT's Moller-Trumbore test
(Shapes/Triangle.cpp:63-109: |det| >= EPSILON, u in [0, 1], v >= 0,
u + v <= 1, t >= EPSILON) on all of its rays, in the arithmetic dtype
asked for.
"""
from __future__ import annotations

import math

import torch

EPSILON = 1.0e-06
BIG = 1.0e30
BUNDLE = 128
_PAIRS = 1 << 25          # (ray, triangle) tests per pass
_CULL = 1 << 24           # (bundle, triangle) cone tests per pass


class Triangles:
    """A triangle list on a device: corners as (point_a, ab, ac) in the
    arithmetic dtype, and bounding spheres in float64 for the culling."""

    def __init__(self, point_a, ab, ac, dtype=torch.float32, device=None):
        f64 = dict(dtype=torch.float64, device=device)
        pa = torch.as_tensor(point_a).to(**f64)
        ab64 = torch.as_tensor(ab).to(**f64)
        ac64 = torch.as_tensor(ac).to(**f64)
        corners = torch.stack([pa, pa + ab64, pa + ac64], 1)
        self.center = corners.mean(1)
        self.radius = ((corners - self.center[:, None]).norm(dim=-1).amax(1)
                       * (1 + 1e-6) + 1e-3)
        cast = dict(dtype=dtype, device=device)
        self.pa = torch.as_tensor(point_a).to(**cast)
        self.ab = torch.as_tensor(ab).to(**cast)
        self.ac = torch.as_tensor(ac).to(**cast)
        self.n = self.pa.shape[0]


def moller_trumbore(o, d, pa, ab, ac):
    """(t, ok) of rays o, d against triangles pa, ab, ac (broadcast)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    pax, pay, paz = pa.unbind(-1)
    abx, aby, abz = ab.unbind(-1)
    acx, acy, acz = ac.unbind(-1)
    px = dy * acz - dz * acy
    py = dz * acx - dx * acz
    pz = dx * acy - dy * acx
    det = abx * px + aby * py + abz * pz
    big_det = torch.abs(det) >= EPSILON
    inv = 1.0 / torch.where(big_det, det, torch.ones_like(det))
    tvx, tvy, tvz = ox - pax, oy - pay, oz - paz
    u = inv * (tvx * px + tvy * py + tvz * pz)
    qx = tvy * abz - tvz * aby
    qy = tvz * abx - tvx * abz
    qz = tvx * aby - tvy * abx
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (acx * qx + acy * qy + acz * qz)
    ok = (big_det & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= EPSILON))
    return t, ok


def cone_pairs(tris: Triangles, apex, dirs, reach, live, slack=0.0):
    """(bundle, triangle) pairs that the cone culling keeps, as two int64
    tensors.  apex (nb, 3), dirs (nb, m, 3) the directions from the apex
    that the bundle's rays cover, reach (nb,) the longest distance from
    the apex, live (nb, m) the rays that count; `slack` widens every
    triangle's sphere."""
    nb = apex.shape[0]
    dd = dirs.double()
    dd = dd / dd.norm(dim=-1, keepdim=True).clamp(min=1e-300)
    axis = torch.where(live[..., None], dd, 0.0).sum(1)
    alen = axis.norm(dim=-1, keepdim=True)
    axis = axis / alen.clamp(min=1e-300)
    cos_min = torch.where(live, (dd * axis[:, None]).sum(-1), 2.0).amin(1)
    half = torch.arccos(cos_min.clamp(-1.0, 1.0)) + 1e-6
    half = torch.where(alen[:, 0] > 1e-9, half, math.pi)
    reach = reach.double() * (1 + 1e-6) + 1e-3
    radius = tris.radius + slack
    group = max(1, _CULL // tris.n)
    todo = torch.nonzero(live.any(1)).squeeze(1)
    gs, ts = [], []
    for g0 in range(0, todo.shape[0], group):
        g = todo[g0:g0 + group]
        w = tris.center[None] - apex[g].double()[:, None]    # (G, T, 3)
        dist = w.norm(dim=-1)
        inside = dist <= radius[None]
        cosang = (w * axis[g][:, None]).sum(-1) / dist.clamp(min=1e-300)
        ang = torch.arccos(cosang.clamp(-1.0, 1.0))
        spread = torch.arcsin((radius[None] / dist.clamp(min=1e-300))
                              .clamp(max=1.0))
        keep = inside | (ang <= half[g][:, None] + spread + 1e-6)
        keep &= (dist - radius[None]) <= reach[g][:, None]
        gi, ti = torch.nonzero(keep, as_tuple=True)
        gs.append(g[gi])
        ts.append(ti)
    if not gs:
        z = torch.zeros(0, dtype=torch.int64, device=apex.device)
        return z, z
    return torch.cat(gs), torch.cat(ts)


def _pairs_of(tris, o, d, tmax, live, bundle, apex):
    nb = o.shape[0] // bundle
    lv = live.reshape(nb, bundle)
    if apex is None:
        o64 = o.double().reshape(nb, bundle, 3)
        if not bool(((o64 == o64[:, :1]).all(-1) | ~lv).all()):
            raise ValueError("the rays of a bundle must share their origin")
        reach = torch.where(lv, tmax.double().reshape(nb, bundle),
                            0.0).amax(1)
        return cone_pairs(tris, o64[:, 0], d.reshape(nb, bundle, 3), reach,
                          lv)
    toward = o.double().reshape(nb, bundle, 3) - apex.double()[:, None]
    reach = torch.where(lv, toward.norm(dim=-1), 0.0).amax(1)
    return cone_pairs(tris, apex, toward, reach, lv, slack=1e-2)


def _chunks(bund, tid, bundle):
    step = max(1, _PAIRS // bundle)
    for p0 in range(0, bund.shape[0], step):
        yield bund[p0:p0 + step], tid[p0:p0 + step]


def _pair_tests(tris: Triangles, o, d, bundles, tri_ids, bundle):
    """Every ray of each pair's bundle against the pair's triangle: (t, ok)
    of shape (P, bundle), and the rays' lane indices."""
    lanes = (bundles[:, None] * bundle
             + torch.arange(bundle, device=o.device)[None])
    t, ok = moller_trumbore(o[lanes], d[lanes], tris.pa[tri_ids][:, None],
                            tris.ab[tri_ids][:, None],
                            tris.ac[tri_ids][:, None])
    return t, ok, lanes


def closest(tris: Triangles, o, d, exclude=None, bundle: int = BUNDLE):
    """Closest triangle of each ray other than `exclude` (B,): (t (B,) with
    BIG for a miss, id (B,) int64 with -1 for a miss); equal distances go
    to the lower id.  The rays of a bundle share their origin."""
    b = o.shape[0]
    live = torch.ones(b, dtype=torch.bool, device=o.device)
    tmax = torch.full((b,), math.inf, dtype=torch.float64, device=o.device)
    bund, tid = _pairs_of(tris, o, d, tmax, live, bundle, None)
    none = torch.iinfo(torch.int64).max
    best = torch.full((b,), none, dtype=torch.int64, device=o.device)
    for bs, ts in _chunks(bund, tid, bundle):
        t, ok, lanes = _pair_tests(tris, o, d, bs, ts, bundle)
        if exclude is not None:
            ok &= ts[:, None] != exclude[lanes]
        # t >= EPSILON > 0, so float order is the order of its bits: one
        # key holds the distance, then the id that breaks a tie.
        bits = t.float().view(torch.int32).to(torch.int64)
        key = torch.where(ok, (bits << 32) | ts[:, None], none)
        best.scatter_reduce_(0, lanes.reshape(-1), key.reshape(-1), "amin")
    hit = best != none
    t_best = (best >> 32).to(torch.int32).view(torch.float32)
    return (torch.where(hit, t_best, BIG).to(tris.pa.dtype),
            torch.where(hit, best & 0xFFFFFFFF, -1))


def occluded(tris: Triangles, o, d, tmax, exclude, live,
             bundle: int = BUNDLE, apex=None):
    """Whether a triangle other than `exclude` (B,) lies at a distance in
    [EPSILON, tmax) along each live ray.  The rays of a bundle share their
    origin, or, given `apex` (one point a bundle), end near it."""
    b = o.shape[0]
    blocked = torch.zeros(b, dtype=torch.bool, device=o.device)
    bund, tid = _pairs_of(tris, o, d, tmax, live, bundle, apex)
    for bs, ts in _chunks(bund, tid, bundle):
        t, ok, lanes = _pair_tests(tris, o, d, bs, ts, bundle)
        hit = (ok & (t < tmax[lanes]) & (ts[:, None] != exclude[lanes])
               & live[lanes])
        blocked[lanes[hit]] = True
    return blocked
