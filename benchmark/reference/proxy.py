"""The conference proxy scene as raw arrays: the benchmark's own copy of
the procedural stand-in for MobileRT's conference OBJ (331,179 triangles,
2 area lights), which the repository does not vendor.

The construction is a frozen copy of the port's `bench_scenes.
conference_proxy()` with `MRT_CONFERENCE_DIR` empty (the fallback palette
and camera): a room shell, a table, chairs, 48 tessellated blobs and small
quads up to the triangle count.  It returns numpy arrays only, so the
harness hands the same numbers to the program and to the reference.
"""
from __future__ import annotations

import numpy as np

CONFERENCE_PRIMS = 331179

# kd of the fallback palette (every material is diffuse: no ks, kt or le).
PALETTE = ((0.64, 0.6, 0.6), (0.7, 0.2, 0.2), (0.2, 0.2, 0.25))
# The fallback conference camera: position with X already negated as the
# .cam loader does, look-at, up, and the (horizontal, vertical) fov in
# degrees at aspect ratio 1.
CAMERA = {"position": (460.0, 500.0, -1000.0), "look_at": (0.0, 400.0, 0.0),
          "up": (0.0, 1.0, 0.0), "fov": (45.0, 45.0)}


def _box_tris(bmin, bmax):
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    v = np.asarray([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ], np.float32)
    f = np.asarray([
        [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
        [3, 6, 2], [3, 7, 6], [0, 4, 7], [0, 7, 3], [1, 2, 6], [1, 6, 5],
    ], np.int32)
    return v[f][:, ::-1, :]


def _sphere_tris(center, radius, nu, nv):
    theta = np.linspace(0, np.pi, nv + 1)
    phi = np.linspace(0, 2 * np.pi, nu + 1)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    pts = np.stack([
        np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1)
    pts = center + radius * pts
    a = pts[:-1, :-1]
    b = pts[:-1, 1:]
    c = pts[1:, 1:]
    d = pts[1:, :-1]
    t1 = np.stack([a, b, c], 2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], 2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2], 0)[:, ::-1, :].astype(np.float32)


def conference_proxy(target_prims: int = CONFERENCE_PRIMS,
                     seed: int = 0) -> dict:
    """{"point_a", "ab", "ac", "normal" (N, 3) float32, "mat_id" (N,) int32,
    "kd" (M, 3) float32, "lights": [(a, b, c, radiance)], "camera"}."""
    rng = np.random.default_rng(seed)
    room_mat, table_mat, red_mat = 0, 1, 2
    batches = []
    room = _box_tris(np.asarray([-920.0, 0.0, -1000.0]),
                     np.asarray([920.0, 800.0, 1000.0]))[:, ::-1, :]
    batches.append((room, room_mat))
    batches.append((_box_tris((-500, 270, -300), (300, 300, 300)), table_mat))
    for dx in (-450, 250):
        for dz in (-250, 250):
            batches.append((_box_tris((dx, 0, dz), (dx + 40, 270, dz + 40)),
                            room_mat))
    for i in range(10):
        x = -800 + i * 170
        for z in (650, 850):
            batches.append((_box_tris((x, 0, z), (x + 90, 140, z + 90)),
                            red_mat))
            batches.append((_box_tris((x, 140, z + 70), (x + 90, 280, z + 90)),
                            red_mat))
    used = sum(t.shape[0] for t, _ in batches)
    per_blob = max(target_prims - used, 0) // 48
    nv = max(int(np.sqrt(per_blob / 4.0)), 2)
    nu = 2 * nv
    for _ in range(48):
        center = np.asarray([rng.uniform(-850, 850), rng.uniform(40, 740),
                             rng.uniform(-950, 950)])
        radius = rng.uniform(25, 70)
        batches.append((_sphere_tris(center, radius, nu, nv),
                        int(rng.integers(len(PALETTE)))))
    used = sum(t.shape[0] for t, _ in batches)
    if used > target_prims:
        last_t, last_m = batches[-1]
        batches[-1] = (last_t[:-(used - target_prims)], last_m)
    else:
        n_extra = target_prims - used
        z = np.full(n_extra, 999.0, np.float32)
        x = rng.uniform(-900, 900, n_extra).astype(np.float32)
        y = rng.uniform(10, 790, n_extra).astype(np.float32)
        a = np.stack([x, y, z], -1)
        extra = np.stack([a, a + (5, 0, 0), a + (0, 5, 0)], 1)
        batches.append((extra.astype(np.float32), room_mat))

    parts = {"point_a": [], "ab": [], "ac": [], "normal": [], "mat_id": []}
    for tris, mat in batches:
        n = tris.shape[0]
        if n == 0:
            continue
        pa = np.asarray(tris[:, 0], np.float32)
        ab = np.asarray(tris[:, 1] - tris[:, 0], np.float32)
        ac = np.asarray(tris[:, 2] - tris[:, 0], np.float32)
        geo = np.cross(ac, ab)
        geo /= np.maximum(np.linalg.norm(geo, axis=-1, keepdims=True), 1e-30)
        for k, v in (("point_a", pa), ("ab", ab), ("ac", ac),
                     ("normal", np.asarray(geo, np.float32)),
                     ("mat_id", np.full(n, mat, np.int32))):
            parts[k].append(v)
    out = {k: np.concatenate(v, 0) for k, v in parts.items()}
    out["kd"] = np.asarray(PALETTE, np.float32)
    out["lights"] = [((cx - 120, 799.0, -120), (cx + 120, 799.0, -120),
                      (cx + 120, 799.0, 120), (0.9, 0.9, 0.9))
                     for cx in (-250.0, 250.0)]
    out["camera"] = dict(CAMERA)
    return out
