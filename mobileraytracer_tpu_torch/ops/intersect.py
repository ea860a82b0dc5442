"""Ray-primitive intersection: the naive oracle (port of
`mobileraytracer_tpu/ops/intersect.py`; reference Naive.hpp:85-94).

Every test is a dense op over a (B rays x N primitives) tile scanned in
chunks of `_CHUNK` primitives.  The arithmetic is written out component by
component in the JAX package's order (cross products as in `jnp.cross`,
dot products summed x, y, z), so hit ids and distances match it:
 - triangles: reference Shapes/Triangle.cpp:63-109 (Moller-Trumbore)
 - spheres:   reference Shapes/Sphere.cpp:42-81 (EpsilonLarge cutoff)
 - planes:    reference Shapes/Plane.cpp:38-72 (two-sided)
"""
from __future__ import annotations

import torch

from .. import constants as C
from ..types import (Hit, Lights, Planes, Scene, Spheres, Triangles,
                     device_const)

_BIG = C.RAY_LENGTH_MAX
_CHUNK = 512  # primitives per scan step; bounds the (B, chunk) tile size
_SMALL = 32   # tables up to this size are scanned one primitive at a time


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _normalize(v):
    """v / sqrt(max(|v|^2, 1e-30)) over the last axis."""
    return v / torch.sqrt(torch.clamp(_dot(v, v), min=1e-30))[..., None]


# ---------------------------------------------------------------------------
# Per-primitive-type distances: (B, N) with misses at RAY_LENGTH_MAX.
# ---------------------------------------------------------------------------

def triangle_distances(o, d, point_a, ab, ac):
    """Moller-Trumbore of (B, 3) rays against (N, 3) triangles; returns
    (t, u, v), each (B, N)."""
    p = _cross(d[:, None, :], ac[None, :, :])
    det = _dot(ab[None, :, :], p)
    inv_det = 1.0 / torch.where(torch.abs(det) < C.EPSILON, 1.0, det)
    tvec = o[:, None, :] - point_a[None, :, :]
    u = inv_det * _dot(tvec, p)
    q = _cross(tvec, ab[None, :, :])
    v = inv_det * _dot(d[:, None, :], q)
    t = inv_det * _dot(ac[None, :, :], q)
    ok = ((torch.abs(det) >= C.EPSILON) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t >= C.EPSILON))
    return torch.where(ok, t, _BIG), u, v


def sphere_distances(o, d, center, sq_radius):
    """Smaller root of the ray-sphere quadratic, >= EpsilonLarge."""
    oc = center[None, :, :] - o[:, None, :]
    proj = _dot(oc, d[:, None, :])
    a = _dot(d, d)[:, None]
    b = 2.0 * -proj
    c = _dot(oc, oc) - sq_radius[None, :]
    disc = b * b - 4.0 * a * c
    pos = disc >= 0.0
    sq = torch.sqrt(torch.where(pos, disc, 1.0))
    t = torch.minimum(-b + sq, -b - sq) / (2.0 * a)
    ok = pos & (t >= C.EPSILON_LARGE)
    return torch.where(ok, t, _BIG)


def plane_distances(o, d, point, normal):
    denom = _dot(normal[None, :, :], d[:, None, :])
    safe = torch.where(torch.abs(denom) < C.EPSILON, 1.0, denom)
    num = _dot(normal[None, :, :], point[None, :, :] - o[:, None, :])
    t = num / safe
    ok = (torch.abs(denom) >= C.EPSILON) & (t >= C.EPSILON)
    return torch.where(ok, t, _BIG)


# ---------------------------------------------------------------------------
# Closest-hit scans.
# ---------------------------------------------------------------------------

def _scan_min(num_prims, chunk_fn, t_init, id_init):
    """Scans chunks of `_CHUNK` primitives carrying (best_t, best_id).  The
    last chunk is clamped to end at num_prims (as dynamic_slice clamps in
    the JAX package); within a chunk the first minimum wins, and a later
    chunk wins only if strictly closer, so ties keep the lowest id."""
    n_chunks = max(1, -(-num_prims // _CHUNK))
    size = min(_CHUNK, num_prims)
    best_t, best_id = t_init, id_init
    for ci in range(n_chunks):
        start = min(ci * _CHUNK, num_prims - size)
        t = chunk_fn(start, size)
        # argmin returns the first minimum, like jnp.argmin.
        arg = torch.argmin(t, dim=1)
        tmin = torch.gather(t, 1, arg[:, None])[:, 0]
        closer = tmin < best_t
        best_t = torch.where(closer, tmin, best_t)
        best_id = torch.where(closer, (arg + start).to(torch.int32), best_id)
    return best_t, best_id


def _components(a):
    return a[..., 0], a[..., 1], a[..., 2]


def _closest_planes_small(pla: Planes, o, d, t_max, prev_kind, prev_id):
    ox, oy, oz = _components(o)
    dx, dy, dz = _components(d)
    guard = prev_kind == C.PRIM_PLANE
    best_t = t_max.expand(ox.shape)
    best_id = torch.full(ox.shape, -1, dtype=torch.int32, device=o.device)
    for i in range(pla.capacity):
        nx, ny, nz = _components(pla.normal[i])
        px, py, pz = _components(pla.point[i])
        denom = nx * dx + ny * dy + nz * dz
        safe = torch.where(torch.abs(denom) < C.EPSILON, 1.0, denom)
        num = nx * (px - ox) + ny * (py - oy) + nz * (pz - oz)
        t = num / safe
        ok = ((torch.abs(denom) >= C.EPSILON) & (t >= C.EPSILON)
              & pla.valid[i] & ~(guard & (prev_id == i)))
        closer = ok & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_id = torch.where(closer, i, best_id)
    return best_t, best_id


def _closest_spheres_small(sph: Spheres, o, d, t_max, prev_kind, prev_id,
                           exclude_prev=False):
    ox, oy, oz = _components(o)
    dx, dy, dz = _components(d)
    a = dx * dx + dy * dy + dz * dz
    best_t = t_max.expand(ox.shape)
    best_id = torch.full(ox.shape, -1, dtype=torch.int32, device=o.device)
    guard = (prev_kind == C.PRIM_SPHERE) if exclude_prev else None
    for i in range(sph.capacity):
        cx, cy, cz = _components(sph.center[i])
        ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
        proj = ocx * dx + ocy * dy + ocz * dz
        b = 2.0 * -proj
        c = ocx * ocx + ocy * ocy + ocz * ocz - sph.sq_radius[i]
        disc = b * b - 4.0 * a * c
        pos = disc >= 0.0
        sq = torch.sqrt(torch.where(pos, disc, 1.0))
        t = torch.minimum(-b + sq, -b - sq) / (2.0 * a)
        ok = pos & (t >= C.EPSILON_LARGE) & sph.valid[i]
        if guard is not None:
            ok = ok & ~(guard & (prev_id == i))
        closer = ok & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_id = torch.where(closer, i, best_id)
    return best_t, best_id


def _mt_components(o, d, pa, ab, ac):
    """Moller-Trumbore of each ray against one triangle row (rows of
    pa/ab/ac broadcast against the rays); returns (t, ok)."""
    ox, oy, oz = _components(o)
    dx, dy, dz = _components(d)
    pax, pay, paz = _components(pa)
    abx, aby, abz = _components(ab)
    acx, acy, acz = _components(ac)
    px = dy * acz - dz * acy
    py = dz * acx - dx * acz
    pz = dx * acy - dy * acx
    det = abx * px + aby * py + abz * pz
    inv = 1.0 / torch.where(torch.abs(det) < C.EPSILON, 1.0, det)
    tvx, tvy, tvz = ox - pax, oy - pay, oz - paz
    u = inv * (tvx * px + tvy * py + tvz * pz)
    qx = tvy * abz - tvz * aby
    qy = tvz * abx - tvx * abz
    qz = tvx * aby - tvy * abx
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (acx * qx + acy * qy + acz * qz)
    ok = ((torch.abs(det) >= C.EPSILON) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t >= C.EPSILON))
    return t, ok


def _closest_lights_small(lights: Lights, o, d, t_max, prev_kind, prev_id):
    guard = prev_kind == C.PRIM_LIGHT
    b = o.shape[0]
    best_t = torch.full((b,), _BIG, dtype=torch.float32, device=o.device)
    best_id = torch.zeros((b,), dtype=torch.int32, device=o.device)
    for i in range(lights.capacity):
        t, ok = _mt_components(o, d, lights.tri_a[i], lights.tri_ab[i],
                               lights.tri_ac[i])
        active = lights.valid[i] & (lights.kind[i] == C.LIGHT_AREA)
        ok = ok & active & ~(guard & (prev_id == i))
        closer = ok & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_id = torch.where(closer, i, best_id)
    return torch.where(best_t < t_max, best_t, _BIG), best_id


def closest_triangles(tris: Triangles, o, d, t_max, prev_kind, prev_id):
    """(t, id) of the closest triangle below t_max per ray; id -1 = none."""
    n = tris.capacity
    guard = prev_kind == C.PRIM_TRIANGLE

    def chunk(start, size):
        sl = slice(start, start + size)
        ids = start + torch.arange(size, dtype=torch.int32, device=o.device)
        t, _, _ = triangle_distances(o, d, tris.point_a[sl], tris.ab[sl],
                                     tris.ac[sl])
        t = torch.where(tris.valid[sl][None, :], t, _BIG)
        # Self-intersection guard (reference Triangle.cpp:64-66).
        return torch.where(guard[:, None] & (ids[None, :] == prev_id[:, None]),
                           _BIG, t)

    return _scan_min(n, chunk, t_max.clone(),
                     torch.full((o.shape[0],), -1, dtype=torch.int32,
                                device=o.device))


def closest_spheres(sph: Spheres, o, d, t_max, prev_kind, prev_id,
                    exclude_prev=False):
    """`exclude_prev=True` only for occlusion queries (see the JAX
    package's docstring: spheres carry no self-intersection pointer)."""
    n = sph.capacity
    if n <= _SMALL:
        return _closest_spheres_small(sph, o, d, t_max, prev_kind, prev_id,
                                      exclude_prev=exclude_prev)

    def chunk(start, size):
        sl = slice(start, start + size)
        ids = start + torch.arange(size, dtype=torch.int32, device=o.device)
        t = sphere_distances(o, d, sph.center[sl], sph.sq_radius[sl])
        t = torch.where(sph.valid[sl][None, :], t, _BIG)
        if exclude_prev:
            t = torch.where(((prev_kind == C.PRIM_SPHERE)[:, None]
                             & (prev_id[:, None] == ids[None, :])), _BIG, t)
        return t

    return _scan_min(n, chunk, t_max.clone(),
                     torch.full((o.shape[0],), -1, dtype=torch.int32,
                                device=o.device))


def closest_planes(pla: Planes, o, d, t_max, prev_kind, prev_id):
    n = pla.capacity
    if n <= _SMALL:
        return _closest_planes_small(pla, o, d, t_max, prev_kind, prev_id)
    guard = prev_kind == C.PRIM_PLANE

    def chunk(start, size):
        sl = slice(start, start + size)
        ids = start + torch.arange(size, dtype=torch.int32, device=o.device)
        t = plane_distances(o, d, pla.point[sl], pla.normal[sl])
        t = torch.where(pla.valid[sl][None, :], t, _BIG)
        return torch.where(guard[:, None] & (ids[None, :] == prev_id[:, None]),
                           _BIG, t)

    return _scan_min(n, chunk, t_max.clone(),
                     torch.full((o.shape[0],), -1, dtype=torch.int32,
                                device=o.device))


def closest_lights(lights: Lights, o, d, t_max, prev_kind, prev_id):
    """Area-light triangles are hittable during normal tracing (reference
    Shader.cpp:111)."""
    if lights.capacity <= _SMALL:
        return _closest_lights_small(lights, o, d, t_max, prev_kind, prev_id)
    guard = prev_kind == C.PRIM_LIGHT
    t, _, _ = triangle_distances(o, d, lights.tri_a, lights.tri_ab,
                                 lights.tri_ac)
    active = lights.valid & (lights.kind == C.LIGHT_AREA)
    t = torch.where(active[None, :], t, _BIG)
    ids = torch.arange(lights.capacity, dtype=torch.int32, device=o.device)
    t = torch.where(guard[:, None] & (ids[None, :] == prev_id[:, None]),
                    _BIG, t)
    arg = torch.argmin(t, dim=1)
    tmin = torch.gather(t, 1, arg[:, None])[:, 0]
    return torch.where(tmin < t_max, tmin, _BIG), arg.to(torch.int32)


# ---------------------------------------------------------------------------
# Full-scene closest hit and shadow queries.
# ---------------------------------------------------------------------------

def _tri_barycentrics(o, d, pa, ab, ac):
    p = _cross(d, ac)
    det = _dot(ab, p)
    inv = 1.0 / torch.where(torch.abs(det) < C.EPSILON, 1.0, det)
    tvec = o - pa
    u = inv * _dot(tvec, p)
    q = _cross(tvec, ab)
    v = inv * _dot(d, q)
    return u, v


def _fill_hit(scene: Scene, o, d, t_pl, id_pl, t_sp, id_sp, t_tr, id_tr,
              t_li, id_li, tri_attr=None) -> Hit:
    """Combines the per-type winners (ties: plane, sphere, triangle, light
    in that order) and gathers the winner's surface attributes.
    `tri_attr` is the optional packed (N, 32) triangle table of the block
    grid (cols 0:3 pa, 3:6 ab, 6:9 ac, 9:18 normals, 18:24 uvs, 24
    mat_id)."""
    b = o.shape[0]
    ts = torch.stack([t_pl, t_sp, t_tr, t_li], 0)
    ids = torch.stack([id_pl, id_sp, id_tr, id_li], 0)
    kinds = device_const((C.PRIM_PLANE, C.PRIM_SPHERE, C.PRIM_TRIANGLE,
                          C.PRIM_LIGHT), torch.int32, o.device)
    winner = torch.argmin(ts, dim=0)
    t = torch.gather(ts, 0, winner[None, :])[0]
    pid = torch.gather(ids, 0, winner[None, :])[0]
    found = t < _BIG
    kind = torch.where(found, kinds[winner], C.PRIM_NONE)
    pid = torch.where(found, pid, -1)
    point = o + d * t[:, None]
    gid = torch.clamp(pid, min=0).long()

    pl_i = torch.clamp(gid, max=scene.planes.capacity - 1)
    n_pl = scene.planes.normal[pl_i]
    m_pl = scene.planes.mat_id[pl_i]

    sp_i = torch.clamp(gid, max=scene.spheres.capacity - 1)
    n_sp = _normalize(point - scene.spheres.center[sp_i])
    m_sp = scene.spheres.mat_id[sp_i]

    tid = torch.clamp(gid, max=scene.triangles.capacity - 1)
    if tri_attr is not None:
        row = tri_attr[tid]
        pa, ab, ac = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        na_, nb_, nc_ = row[:, 9:12], row[:, 12:15], row[:, 15:18]
        uva, uvb, uvc = row[:, 18:20], row[:, 20:22], row[:, 22:24]
        m_tr = row[:, 24].to(torch.int32)
    else:
        tris = scene.triangles
        pa, ab, ac = tris.point_a[tid], tris.ab[tid], tris.ac[tid]
        na_, nb_, nc_ = (tris.normal_a[tid], tris.normal_b[tid],
                         tris.normal_c[tid])
        uva, uvb, uvc = tris.uv_a[tid], tris.uv_b[tid], tris.uv_c[tid]
        m_tr = tris.mat_id[tid]
    u_t, v_t = _tri_barycentrics(o, d, pa, ab, ac)
    w_t = 1.0 - u_t - v_t
    n_tr = _normalize(na_ * w_t[:, None] + nb_ * u_t[:, None]
                      + nc_ * v_t[:, None])
    uv_tr = uva * w_t[:, None] + uvb * u_t[:, None] + uvc * v_t[:, None]

    li = torch.clamp(gid, max=scene.lights.capacity - 1)
    n_li = _normalize(_cross(scene.lights.tri_ac[li], scene.lights.tri_ab[li]))
    le_li = scene.lights.radiance[li]

    sel = winner
    s3 = sel[:, None]
    normal = torch.where(s3 == 0, n_pl, torch.where(
        s3 == 1, n_sp, torch.where(s3 == 2, n_tr, n_li)))
    mat_id = torch.where(sel == 0, m_pl, torch.where(
        sel == 1, m_sp, torch.where(sel == 2, m_tr, -1)))
    mat_id = torch.where(kind == C.PRIM_NONE, -1, mat_id).to(torch.int32)
    uv = torch.where(s3 == 2, uv_tr, -1.0)
    light_le = torch.where((s3 == 3) & (kind == C.PRIM_LIGHT)[:, None],
                           le_li, 0.0)
    return Hit(t=t, prim_kind=kind.to(torch.int32), prim_id=pid.to(torch.int32),
               mat_id=mat_id, point=point, normal=normal, uv=uv,
               light_le=light_le)


def recompute_tri_t(tris: Triangles, o, d, tid):
    """Hit distance of known winning triangles (one id per ray, -1 =
    miss), re-derived from the triangle table."""
    gid = torch.clamp(tid, min=0).long()
    t, ok = _mt_components(o, d, tris.point_a[gid], tris.ab[gid],
                           tris.ac[gid])
    return torch.where((tid >= 0) & ok, t, _BIG)


def _inv_dir(d):
    """1 / d with components below 1e-30 in magnitude taken as +-1e-30."""
    tiny = torch.where(d < 0, -1e-30, 1e-30)
    return 1.0 / torch.where(torch.abs(d) < 1e-30, tiny, d)


def _t_max(t_max, o):
    return torch.as_tensor(t_max, dtype=torch.float32,
                           device=o.device).expand(o.shape[0])


def intersect_scene_naive(scene: Scene, o, d, prev_kind, prev_id,
                          t_max=_BIG) -> Hit:
    """Closest hit over planes, spheres, triangles, then area lights (the
    reference's trace order, Shader.cpp:86-123)."""
    tm = _t_max(t_max, o)
    t_pl, id_pl = closest_planes(scene.planes, o, d, tm, prev_kind, prev_id)
    t_sp, id_sp = closest_spheres(scene.spheres, o, d, tm, prev_kind, prev_id)
    t_tr, id_tr = closest_triangles(scene.triangles, o, d, tm, prev_kind,
                                    prev_id)
    t_li, id_li = closest_lights(scene.lights, o, d, tm, prev_kind, prev_id)
    return _fill_hit(scene, o, d, t_pl, id_pl, t_sp, id_sp, t_tr, id_tr,
                     t_li, id_li)


def occluded_naive(scene: Scene, o, d, max_dist, prev_kind, prev_id):
    """Any primitive strictly closer than max_dist blocks; lights never
    occlude (reference Shader.cpp:132-158)."""
    md = _t_max(max_dist, o)
    t_pl, _ = closest_planes(scene.planes, o, d, md, prev_kind, prev_id)
    t_sp, _ = closest_spheres(scene.spheres, o, d, md, prev_kind, prev_id,
                              exclude_prev=True)
    t_tr, _ = closest_triangles(scene.triangles, o, d, md, prev_kind, prev_id)
    return torch.minimum(torch.minimum(t_pl, t_sp), t_tr) < md
