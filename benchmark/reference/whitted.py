"""A plain Whitted frame at one sample per pixel, written from MobileRT's
definitions (Whitted.cpp, Perspective.cpp, AreaLight.cpp, Shader.cpp)
and the port's documented conventions, for a scene whose materials are
all diffuse: one camera ray per pixel, its closest hit over the triangles
and the area lights, and at a diffuse hit the ambient term kD * 0.1 plus
one next-event sample.

The conventions the frame is held to:
  * pixels are traced in 4x4 patches, patch-major, and the film is put
    back in row order; u = x / width, v = y / height, no jitter at 1 spp;
  * pixel p of frame key K draws with key fold_in(fold_in(K, 0), p); its
    light sample is shared by each run of `share` consecutive lanes and
    drawn from the first lane's key k = fold_in(fold_in(key, 0), 1): the
    light is floor(uniform(fold_in(k, 0)) * lights * 0.99999), the point
    a uniform point of its triangle from uniform(fold_in(k, 1), 2);
  * the shadow ray runs reversed, from the light point toward the hit,
    and ends EPSILON short of it; the hit triangle itself never blocks,
    and lights never block;
  * a pixel casts one camera ray, and one shadow ray at a diffuse hit
    whose normal faces the light point (the reference's ray counter).

The arithmetic runs in the dtype asked for (float32 for the frame as
configured; bfloat16 makes the control).
"""
from __future__ import annotations

import numpy as np
import torch

from . import threefry as tf
from .trace import BIG, EPSILON, Triangles, closest, moller_trumbore, \
    occluded

QUARTER_PI = 0.7853981633974483
AMBIENT = 0.1
KIND_NONE, KIND_TRIANGLE, KIND_LIGHT = 0, 3, 4


def pixel_order(width: int, height: int, subtile: int = 16):
    """(u, v, pixel ids, inverse permutation) in lane order: 4-row patches
    of subtile / 4 ... 4 columns, patch-major."""
    ph, pw = max(subtile // 4, 1), 4
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    order = np.lexsort((xs.ravel() % pw, ys.ravel() % ph,
                        xs.ravel() // pw, ys.ravel() // ph))
    pids = (ys.ravel() * width + xs.ravel())[order].astype(np.int32)
    inv = np.empty_like(pids)
    inv[pids] = np.arange(width * height, dtype=np.int32)
    u = (pids % width).astype(np.float32) / width
    v = (pids // width).astype(np.float32) / height
    return u, v, pids, inv


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def _normalize(v):
    return v / torch.sqrt(torch.clamp(_sum3(v * v), min=1e-30))[..., None]


def camera_basis(camera: dict, dtype, device):
    """(position, direction, right, up, fov_u, fov_v) of a perspective
    camera (Camera.cpp:14-18): the unit view direction, and right and up
    from cross products, left unnormalised."""
    pos, look, up0 = (torch.tensor(camera[k], dtype=torch.float32)
                      .to(dtype=dtype, device=device)
                      for k in ("position", "look_at", "up"))
    direction = look - pos
    direction = direction / torch.sqrt(direction[0] * direction[0]
                                       + direction[1] * direction[1]
                                       + direction[2] * direction[2])
    right = _cross(up0, direction)
    up = _cross(direction, right)
    fov_u, fov_v = (torch.tensor(np.float32(np.deg2rad(f)))
                    .to(dtype=dtype, device=device) for f in camera["fov"])
    return pos, direction, right, up, fov_u, fov_v


def arctan(x):
    """The reference's polynomial arctan (Perspective.cpp:40-46)."""
    ax = torch.abs(x)
    return QUARTER_PI * x - (x * (ax - 1.0)) * (0.2447 + 0.0663 * ax)


def camera_rays(camera: dict, u, v, dtype):
    """Perspective camera rays (Perspective.cpp:16-46) through pixel
    corners u, v: the reference's arctan of the fov-scaled offsets."""
    pos, direction, right, up, pu, pv = camera_basis(camera, dtype, u.device)
    rp = arctan(pu * (u - 0.5))
    upp = arctan(pv * (0.5 - v))
    dest = pos + direction + right * rp[:, None] + up * upp[:, None]
    d = dest - pos
    d = d / torch.sqrt(d[:, 0:1] * d[:, 0:1] + d[:, 1:2] * d[:, 1:2]
                       + d[:, 2:3] * d[:, 2:3])
    return pos.expand_as(d), d


class Scene:
    """The scene's arrays on a device, in the arithmetic dtype."""

    def __init__(self, arrays: dict, dtype=torch.float32, device=None):
        cast = dict(dtype=dtype, device=device)
        self.dtype, self.device = dtype, device
        self.tris = Triangles(arrays["point_a"], arrays["ab"], arrays["ac"],
                              dtype=dtype, device=device)
        self.normal = torch.as_tensor(arrays["normal"]).to(**cast)
        self.mat_id = torch.as_tensor(arrays["mat_id"]).to(device).long()
        self.kd = torch.as_tensor(arrays["kd"]).to(**cast)
        la = np.asarray([l[0] for l in arrays["lights"]], np.float32)
        lb = np.asarray([l[1] for l in arrays["lights"]], np.float32)
        lc = np.asarray([l[2] for l in arrays["lights"]], np.float32)
        self.l_a = torch.as_tensor(la).to(**cast)
        self.l_ab = torch.as_tensor(lb - la).to(**cast)
        self.l_ac = torch.as_tensor(lc - la).to(**cast)
        self.l_rad = torch.as_tensor(np.asarray(
            [l[3] for l in arrays["lights"]], np.float32)).to(**cast)
        self.camera = arrays["camera"]


def light_points(scene, keys):
    """One light sample for each key (N, 2): the light
    floor(uniform(fold_in(k, 0)) * lights * 0.99999) and a uniform point of
    its triangle from uniform(fold_in(k, 1), 2) (AreaLight.cpp:17-26).
    Returns (points (N, 3), radiance (N, 3))."""
    n_l = scene.l_a.shape[0]
    pick = torch.floor(tf.uniform(tf.fold_in(keys, 0)) * float(n_l)
                       * 0.99999).to(torch.int64).clamp(0, n_l - 1)
    rs = tf.uniform(tf.fold_in(keys, 1), 2).to(scene.l_a.dtype)
    r, s = rs[:, 0:1], rs[:, 1:2]
    flip = (r + s) >= 1.0
    r = torch.where(flip, 1.0 - r, r)
    s = torch.where(flip, 1.0 - s, s)
    return (scene.l_a[pick] + r * scene.l_ab[pick] + s * scene.l_ac[pick],
            scene.l_rad[pick])


def _closest_light(scene: Scene, o, d):
    """Closest area light of each ray: (t, index)."""
    best_t = torch.full(o.shape[:1], BIG, dtype=scene.dtype, device=o.device)
    best_i = torch.zeros(o.shape[:1], dtype=torch.int64, device=o.device)
    for i in range(scene.l_a.shape[0]):
        t, ok = moller_trumbore(o, d, scene.l_a[i], scene.l_ab[i],
                                scene.l_ac[i])
        closer = ok & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_i = torch.where(closer, i, best_i)
    return best_t, best_i


def frame(scene: Scene, frame_key: torch.Tensor, width: int, height: int,
          share: int = 128) -> dict:
    """The frame of `frame_key` ((2,) int64).  Returns, in lane order, the
    camera rays' hit t, kind, material and normal, which lanes send a
    shadow ray that counts ("live") and whether it is blocked, and the
    (H, W, 3) float32 image and the ray count."""
    dev, dt = scene.device, scene.dtype
    u, v, pids, inv = pixel_order(width, height)
    u = torch.from_numpy(u).to(dev).to(dt)
    v = torch.from_numpy(v).to(dev).to(dt)
    pids = torch.from_numpy(pids).to(dev)
    b = pids.shape[0]
    o, d = camera_rays(scene.camera, u, v, dt)

    t_tr, id_tr = closest(scene.tris, o, d)
    t_li, id_li = _closest_light(scene, o, d)
    light_wins = t_li < t_tr               # a triangle wins a tie
    t = torch.where(light_wins, t_li, t_tr)
    hit = t < BIG
    kind = torch.where(light_wins, KIND_LIGHT,
                       torch.where(hit, KIND_TRIANGLE, KIND_NONE))
    point = o + d * t[:, None]

    tid = id_tr.clamp(min=0)
    pa, ab, ac = scene.tris.pa[tid], scene.tris.ab[tid], scene.tris.ac[tid]
    p = _cross(d, ac)
    det = _sum3(ab * p)
    inv_det = 1.0 / torch.where(torch.abs(det) < EPSILON, 1.0, det)
    tvec = o - pa
    bu = inv_det * _sum3(tvec * p)
    bv = inv_det * _sum3(d * _cross(tvec, ab))
    bw = 1.0 - bu - bv
    nt = scene.normal[tid]
    n_tri = _normalize(nt * bw[:, None] + nt * bu[:, None]
                       + nt * bv[:, None])
    n_li = _normalize(_cross(scene.l_ac[id_li], scene.l_ab[id_li]))
    normal = torch.where((kind == KIND_LIGHT)[:, None], n_li, n_tri)
    is_tri = kind == KIND_TRIANGLE
    mat = torch.where(is_tri, scene.mat_id[tid], -1)
    kd = torch.where(is_tri[:, None], scene.kd[mat.clamp(min=0)], 0.0)
    le = torch.where((kind == KIND_LIGHT)[:, None], scene.l_rad[id_li], 0.0)
    diffuse = is_tri & (kd > 0.0).any(-1)

    # One light sample per run of `share` lanes, from its first lane.
    keys = tf.fold_in(tf.fold_in(frame_key.to(dev), 0), pids.long())
    nee = tf.fold_in(tf.fold_in(keys, 0), 1)
    lpos, radiance = light_points(scene, nee.reshape(b // share, share,
                                                     2)[:, 0])
    lpos = lpos.repeat_interleave(share, 0)
    radiance = radiance.repeat_interleave(share, 0)

    to_light = lpos - point
    dist = torch.sqrt(torch.clamp(_sum3(to_light * to_light), min=1e-30))
    ldir = to_light / torch.clamp(dist[:, None], min=1e-30)
    cos_nl = _sum3(normal * ldir)
    facing = cos_nl > 0.0
    live = diffuse & facing
    md = torch.clamp(dist - EPSILON, min=0.0)
    exclude = torch.where(is_tri, id_tr, -1)
    blocked = occluded(scene.tris, lpos, -ldir, md.double(), exclude, live)
    lit = facing & ~blocked
    ld = torch.where(lit[:, None], radiance * cos_nl[:, None], 0.0)
    ld = torch.where(diffuse[:, None], kd * ld, 0.0)
    rgb = torch.where((hit & ~is_tri)[:, None], le, 0.0) + ld
    rgb = rgb + torch.where(diffuse[:, None], kd * AMBIENT, 0.0)
    image = rgb.float()[torch.from_numpy(inv).to(dev).long()]
    rays = b + int((diffuse & facing).sum())
    return {"t": t.float(), "kind": kind, "mat": mat, "normal": normal.float(),
            "live": live, "occ": blocked,
            "image": image.reshape(height, width, 3), "rays": rays}
