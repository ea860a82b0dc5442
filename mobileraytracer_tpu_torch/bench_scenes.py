"""Benchmark scenes.

The reference's canonical benchmark is the `conference` OBJ (~331k
triangles, 2 area lights — the demo gif's status line reads "p=331179,
l=2"), but the repo vendors only its .mtl/.cam, not the OBJ
(scripts/profile.sh:128; WavefrontOBJs/conference/).  With no network
egress we build a *procedural proxy* at the same scale instead: a
conference-room-like layout (floor/walls/ceiling, a table slab, chair
boxes, tessellated filler blobs) using the real conference.mtl materials
and the real conference.cam camera, padded to exactly the reference's
primitive count.  BVH depth, occlusion and material variety are
representative; absolute rays/s numbers are comparable across rounds.

Port of `mobileraytracer_tpu/bench_scenes.py`: the same numpy
construction, so every array equals the JAX package's.  Where
CONFERENCE_DIR is absent (the usual case) the fallback palette and
_FALLBACK_CAM are used, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from . import constants as C
from .builder import SceneBuilder
from .loaders.cam import load_camera_file, load_camera_text
from .loaders.mtl import parse_mtl_text
from .types import Camera, Scene

# Directory of the reference's WavefrontOBJs/conference (.mtl and .cam).
# Empty by default: the fallback palette and camera below are then used.
CONFERENCE_DIR = os.environ.get("MRT_CONFERENCE_DIR", "")
CONFERENCE_PRIMS = 331179
CONFERENCE_LIGHTS = 2

_FALLBACK_CAM = """t perspective
p -460.0 500.0 -1000.0
l 0.0 400.0 0.0
u 0.0 1.0 0.0
f 45 45
"""


def _box_tris(bmin, bmax):
    """12 triangles of an axis-aligned box, outward winding."""
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    v = np.asarray([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ], np.float32)
    f = np.asarray([
        [0, 2, 1], [0, 3, 2],      # z0
        [4, 5, 6], [4, 6, 7],      # z1
        [0, 1, 5], [0, 5, 4],      # y0
        [3, 6, 2], [3, 7, 6],      # y1
        [0, 4, 7], [0, 7, 3],      # x0
        [1, 2, 6], [1, 6, 5],      # x1
    ], np.int32)
    # Reverse winding: geometric normals follow the reference's
    # cross(AC, AB) convention, which flips the usual CCW orientation.
    return v[f][:, ::-1, :]        # (12, 3, 3)


def _sphere_tris(center, radius, nu, nv):
    """UV-sphere triangulation: 2*nu*(nv-1) triangles."""
    theta = np.linspace(0, np.pi, nv + 1)
    phi = np.linspace(0, 2 * np.pi, nu + 1)
    t, p = np.meshgrid(theta, phi, indexing="ij")   # (nv+1, nu+1)
    pts = np.stack([
        np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1)
    pts = center + radius * pts
    quads = []
    a = pts[:-1, :-1]
    b = pts[:-1, 1:]
    c = pts[1:, 1:]
    d = pts[1:, :-1]
    t1 = np.stack([a, b, c], 2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], 2).reshape(-1, 3, 3)
    # Same winding flip as _box_tris (cross(AC, AB) convention).
    return np.concatenate([t1, t2], 0)[:, ::-1, :].astype(np.float32)


def conference_proxy(target_prims: int = CONFERENCE_PRIMS,
                     seed: int = 0) -> Tuple[Scene, Camera, dict]:
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    # Materials from the real conference.mtl (value variety matters for
    # gather patterns); fall back to a small palette.
    mtl_path = os.path.join(CONFERENCE_DIR, "conference.mtl")
    palettes = []
    if CONFERENCE_DIR and os.path.exists(mtl_path):
        with open(mtl_path, errors="replace") as f:
            mats = parse_mtl_text(f.read())
        for m in mats.values():
            if (np.asarray(m.emission) > 0).any():
                continue
            palettes.append(b.add_material(
                kd=m.diffuse, ks=m.specular,
                kt=tuple(np.asarray(m.transmittance) * (1 - m.dissolve)),
                ior=m.ior, dedup=True))
    if not palettes:
        palettes = [b.add_material(kd=(0.64, 0.6, 0.6)),
                    b.add_material(kd=(0.7, 0.2, 0.2)),
                    b.add_material(kd=(0.2, 0.2, 0.25))]

    room_mat = palettes[0]
    red_mat = palettes[min(2, len(palettes) - 1)]

    batches = []     # list of (tris (N,3,3), mat_id)

    # Room shell: 1840 x 800 x 2000, interior faces.
    lo = np.asarray([-920.0, 0.0, -1000.0])
    hi = np.asarray([920.0, 800.0, 1000.0])
    room = _box_tris(lo, hi)
    room = room[:, ::-1, :]   # flip winding: camera is inside
    batches.append((room, room_mat))

    # Conference table.
    batches.append((_box_tris((-500, 270, -300), (300, 300, 300)),
                    palettes[min(1, len(palettes) - 1)]))
    for dx in (-450, 250):
        for dz in (-250, 250):
            batches.append((_box_tris((dx, 0, dz), (dx + 40, 270, dz + 40)),
                            room_mat))

    # Chairs: two rows of simple boxes.
    for i in range(10):
        x = -800 + i * 170
        for z in (650, 850):
            batches.append((_box_tris((x, 0, z), (x + 90, 140, z + 90)),
                            red_mat))
            batches.append((_box_tris((x, 140, z + 70), (x + 90, 280, z + 90)),
                            red_mat))

    # Filler blobs: tessellated spheres bring the count to the target.
    used = sum(t.shape[0] for t, _ in batches)
    budget = max(target_prims - used, 0)
    n_blobs = 48
    per_blob = budget // n_blobs
    # 2 * nu * nv ~ per_blob with nu = 2 * nv.
    nv = max(int(np.sqrt(per_blob / 4.0)), 2)
    nu = 2 * nv
    for i in range(n_blobs):
        center = np.asarray([
            rng.uniform(-850, 850), rng.uniform(40, 740),
            rng.uniform(-950, 950)])
        radius = rng.uniform(25, 70)
        tris = _sphere_tris(center, radius, nu, nv)
        batches.append((tris, palettes[int(rng.integers(len(palettes)))]))

    used = sum(t.shape[0] for t, _ in batches)
    # Trim or top up with small quads to hit the target exactly.
    if used > target_prims:
        overshoot = used - target_prims
        last_t, last_m = batches[-1]
        batches[-1] = (last_t[:-overshoot], last_m)
    else:
        n_extra = target_prims - used
        z = np.full(n_extra, 999.0, np.float32)
        x = rng.uniform(-900, 900, n_extra).astype(np.float32)
        y = rng.uniform(10, 790, n_extra).astype(np.float32)
        a = np.stack([x, y, z], -1)
        extra = np.stack([a, a + (5, 0, 0), a + (0, 5, 0)], 1)
        batches.append((extra.astype(np.float32), room_mat))

    for tris, mat in batches:
        n = tris.shape[0]
        if n == 0:
            continue
        pa = tris[:, 0]
        ab = tris[:, 1] - tris[:, 0]
        ac = tris[:, 2] - tris[:, 0]
        geo = np.cross(ac, ab)
        geo /= np.maximum(np.linalg.norm(geo, axis=-1, keepdims=True), 1e-30)
        uv = np.full((n, 2), -1.0, np.float32)
        b.add_triangles_bulk(pa, ab, ac, geo, geo, geo, uv, uv, uv,
                             np.full(n, mat, np.int32))

    # Two ceiling area lights (the conference scene reports l=2).
    for cx in (-250.0, 250.0):
        b.add_area_light((cx - 120, 799.0, -120), (cx + 120, 799.0, -120),
                         (cx + 120, 799.0, 120), (0.9, 0.9, 0.9))

    scene = b.build()

    cam_path = os.path.join(CONFERENCE_DIR, "conference.cam")
    if CONFERENCE_DIR and os.path.exists(cam_path):
        camera = load_camera_file(cam_path, 1.0)
    else:
        camera = load_camera_text(_FALLBACK_CAM, 1.0)

    info = {"triangles": target_prims, "lights": CONFERENCE_LIGHTS,
            "materials": len(b._mat)}
    return scene, camera, info
