"""A plain vertex-position gradient of L = mean(image) for a Whitted frame
of an all-diffuse scene, by the edge-sampling estimator that MobileRT's
differentiable form asks for (Li et al. 2018), written from the port's
documented conventions:

  * interior: autograd of the pixel-mean radiance at fixed hits; the hit
    triangle is found on the scene as built, its distance and its
    geometric normal normalize(cross(AC, AB)) recomputed from the
    vertices; one next-event sample a pixel, the light sample shared by
    each run of 128 lanes (from the first lane's key), the shadow ray cast
    forward from the surface and off the tape;
  * silhouette edges: `edge_budget` edges drawn by the Gumbel-max
    categorical over the log of their length in factor space (the
    camera's (right, up) offsets), `samples` points each, the radiance
    jump probed `eps` to each side, times the pixel density, the
    viewport's mask and the factor map's Jacobian along the edge normal;
  * shadow edges: `shadow_budget` edges drawn by world length, one light
    sample a point, the receiver traced past the edge, the shadow point
    on its tangent plane, the jump of single-sample direct light probed to
    each side of the shadow curve;
  * the triangle rows, and so the edge ids, follow the block build's
    order (sah.py), and the edges that can carry a silhouette are those
    of edges.py.

Keys: pixel p of base key K is fold_in(fold_in(K, 0), p); silhouette
probe i fold_in(fold_in(K, 1), i); shadow point i fold_in(fold_in(K, 2),
i); the draws fold_in(K, 0x5ED6E) and fold_in(K, 0x511AD0).
"""
from __future__ import annotations

import numpy as np
import torch

from . import edges, gumbel, sah
from . import threefry as tf
from .trace import BIG, EPSILON, Triangles, closest, moller_trumbore, \
    occluded
from .whitted import (AMBIENT, _cross, _normalize, _sum3, arctan,
                      camera_basis, light_points, pixel_order)

SILHOUETTE_KEY, SHADOW_KEY = 0x5ED6E, 0x511AD0


def _dot(a, b):
    return _sum3(a * b)


def _norm(v):
    return torch.sqrt(_dot(v, v))


class Scene:
    """The scene's arrays in the block build's row order, on a device.
    With `shade` (a dtype) the geometry stays in `dtype` and every value
    of the shading and of the estimator is rounded to `shade` where it is
    made, on the tape as off it: the control that keeps the rays exact
    where bfloat16 would collapse them (coordinates near 1,000) and takes
    bfloat16 everywhere else."""

    def __init__(self, arrays: dict, device=None, dtype=torch.float32,
                 shade=None):
        n = arrays["mat_id"].shape[0]
        cap = -(-max(n, 1) // 8) * 8        # the builder pads to 8 rows

        def pad(a, fill):
            return np.concatenate([a, np.full((cap - n,) + a.shape[1:], fill,
                                              a.dtype)])
        pa, ab, ac = (pad(arrays[k], f) for k, f in
                      (("point_a", 0.0), ("ab", 1.0), ("ac", 1.0)))
        nrm, mat = pad(arrays["normal"], 1.0), pad(arrays["mat_id"], 0)
        valid = np.arange(cap) < n
        perm = sah.block_order(pa, ab, ac, valid)
        pa, ab, ac, nrm, mat, valid = (x[perm] for x in (pa, ab, ac, nrm,
                                                          mat, valid))
        self.keep = torch.from_numpy(
            edges.edge_keep(pa, ab, ac, mat, valid).astype(np.float32)
        ).to(device)
        cast = dict(dtype=dtype, device=device)
        self.dtype, self.device = dtype, device
        self.low = ((lambda x: x.to(shade).to(x.dtype)) if shade is not None
                    else (lambda x: x))
        self.n = cap
        self.tris = Triangles(pa, ab, ac, dtype=dtype, device=device)
        self.normal = torch.from_numpy(nrm).to(**cast)
        self.valid = torch.from_numpy(valid).to(device)
        self.mat = torch.from_numpy(mat).to(device).long()
        self.kd = torch.as_tensor(arrays["kd"]).to(**cast)
        la = np.asarray([l[0] for l in arrays["lights"]], np.float32)
        lb = np.asarray([l[1] for l in arrays["lights"]], np.float32)
        lc = np.asarray([l[2] for l in arrays["lights"]], np.float32)
        self.l_a = torch.from_numpy(la).to(**cast)
        self.l_ab = torch.from_numpy(lb - la).to(**cast)
        self.l_ac = torch.from_numpy(lc - la).to(**cast)
        self.l_rad = torch.from_numpy(np.asarray(
            [l[3] for l in arrays["lights"]], np.float32)).to(**cast)
        self.cam = camera_basis(arrays["camera"], dtype, device)

    def vertices(self):
        pa = self.tris.pa
        return {"va": pa, "vb": pa + self.tris.ab, "vc": pa + self.tris.ac}


# -- the camera's factor space ---------------------------------------------

def factors_of_point(cam, x):
    """World points (..., 3) -> (right, up) factors (..., 2), by Cramer's
    rule on s (x - p) = direction + rf right + uf up."""
    pos, dirn, rgt, up = cam[0], cam[1], cam[2], cam[3]
    w = x - pos
    rgt, up, dirn = (t.expand_as(w) for t in (rgt, up, dirn))

    def det(a, b, c):
        return _dot(a, _cross(b, c))
    det_p = det(w, -rgt, -up)
    return torch.stack([det(w, dirn, -up) / det_p,
                        det(w, -rgt, dirn) / det_p], -1)


def rays_from_factors(cam, q):
    pos, dirn, rgt, up = cam[0], cam[1], cam[2], cam[3]
    dest = pos + dirn + rgt * q[..., 0:1] + up * q[..., 1:2]
    d = dest - pos
    d = d / _norm(d)[..., None]
    return pos.expand_as(d), d


def pixel_density(cam, q):
    persp = (1.0 + torch.tan(q[..., 0]) ** 2) * (1.0 + torch.tan(q[..., 1])
                                                 ** 2)
    return persp / (cam[4] * cam[5])


def viewport_mask(cam, width, height, q):
    """1 where factor points land in the image's factor-space support: the
    pixel grid, warped by the arctan, plus the half-pixel jitter box."""
    pu, pv = cam[4], cam[5]
    r_lo = arctan(pu * (0.0 - 0.5)) - 0.5 / width
    r_hi = arctan(pu * ((width - 1.0) / width - 0.5)) + 0.5 / width
    u_lo = arctan(pv * (1.0 - (height - 1.0) / height - 0.5)) - 0.5 / height
    u_hi = arctan(pv * (1.0 - 0.5)) + 0.5 / height
    inside = ((q[..., 0] >= r_lo) & (q[..., 0] <= r_hi)
              & (q[..., 1] >= u_lo) & (q[..., 1] <= u_hi))
    return inside.to(q.dtype)


# -- hits ------------------------------------------------------------------

def _light_hit(scene: Scene, o, d):
    best_t = torch.full(o.shape[:1], BIG, dtype=scene.dtype, device=o.device)
    best_i = torch.zeros(o.shape[:1], dtype=torch.int64, device=o.device)
    for i in range(scene.l_a.shape[0]):
        t, ok = moller_trumbore(o, d, scene.l_a[i], scene.l_ab[i],
                                scene.l_ac[i])
        closer = ok & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_i = torch.where(closer, i, best_i)
    return best_t, best_i


def hit_of(scene: Scene, o, d, tid, geom, normals):
    """The hit record of rays o, d whose closest triangle is `tid` (-1: a
    miss): the distance from Moller-Trumbore on `geom` (va, ab, ac rows,
    which may be on the tape), the area lights' hits, the point, the
    interpolated `normals` rows, the material and the emission."""
    va, ab, ac = geom
    g = tid.clamp(min=0)
    t_tr, ok = moller_trumbore(o, d, va[g], ab[g], ac[g])
    t_tr = torch.where((tid >= 0) & ok, t_tr, BIG)
    t_li, id_li = _light_hit(scene, o, d)
    light = t_li < t_tr
    t = torch.where(light, t_li, t_tr)
    hit = t < BIG
    is_tri = hit & ~light
    point = o + d * t[:, None]
    p = _cross(d, ac[g])
    det = _dot(ab[g], p)
    inv = 1.0 / torch.where(torch.abs(det) < EPSILON, 1.0, det)
    tvec = o - va[g]
    bu = inv * _dot(tvec, p)
    bv = inv * _dot(d, _cross(tvec, ab[g]))
    bw = 1.0 - bu - bv
    n = normals[g]
    n_tri = _normalize(n * bw[:, None] + n * bu[:, None] + n * bv[:, None])
    n_li = _normalize(_cross(scene.l_ac[id_li], scene.l_ab[id_li]))
    normal = torch.where(light[:, None], n_li, n_tri)
    kd = torch.where(is_tri[:, None], scene.kd[scene.mat[g]], 0.0)
    le = torch.where((hit & light)[:, None], scene.l_rad[id_li], 0.0)
    return {"t": t, "hit": hit, "tri": is_tri, "point": point,
            "normal": normal, "kd": kd, "le": le,
            "exclude": torch.where(is_tri, tid, -1)}


def radiance(scene: Scene, q, keys, geom=None, normals=None):
    """Whitted radiance (B, 3) of the camera rays through factor points q
    (B, 2), B a multiple of 128; on the tape of `geom` where given (the
    scene's own rows and normals otherwise)."""
    o, d = rays_from_factors(scene.cam, q)
    tid = closest(scene.tris, o.detach(), d.detach())[1]
    if geom is None:
        geom = (scene.tris.pa, scene.tris.ab, scene.tris.ac)
        normals = scene.normal
    h = hit_of(scene, o, d, tid, geom, normals)
    low = scene.low
    h["normal"], h["kd"], h["le"] = (low(h[k]) for k in ("normal", "kd",
                                                        "le"))
    b = q.shape[0]
    nee = tf.fold_in(tf.fold_in(keys, 0), 1)
    lpos_g, rad = light_points(scene, nee.reshape(b // 128, 128, 2)[:, 0])
    lpos = lpos_g.repeat_interleave(128, 0)
    rad = low(rad.repeat_interleave(128, 0))
    to_l = lpos - h["point"]
    dist = torch.sqrt(torch.clamp(_dot(to_l, to_l), min=1e-30))
    ldir = to_l / torch.clamp(dist[:, None], min=1e-30)
    cos_nl = low(_dot(h["normal"], low(ldir)))
    diffuse = h["tri"] & (h["kd"] > 0.0).any(-1)
    live = diffuse & (cos_nl > 0.0)
    with torch.no_grad():
        blocked = occluded(scene.tris, h["point"].detach(), ldir.detach(),
                           dist.detach().double(), h["exclude"], live,
                           apex=lpos_g)
    lit = live & ~blocked
    ld = low(torch.where(lit[:, None], rad * cos_nl[:, None], 0.0))
    rgb = low(h["le"] + low(torch.where(diffuse[:, None], h["kd"] * ld,
                                        0.0)))
    return low(rgb + torch.where(diffuse[:, None], low(h["kd"] * AMBIENT),
                                 0.0))


# -- the estimator ---------------------------------------------------------

def _draws(key, w, budget, low=lambda x: x):
    w = w.float()       # the draw's arithmetic is float32's bits
    logits = low(gumbel.xla_log(torch.clamp(w, min=1e-30)))
    sel = gumbel.categorical(key, logits, budget, low=low)
    p = w[sel] / torch.clamp(torch.sum(w), min=1e-30)
    return sel, torch.where(p > 0, 1.0 / (budget * p), 0.0)


def _to_vertices(sel, n, g0, g1, low=lambda x: x):
    """Per-draw endpoint gradients summed into the vertex rows: edge e is
    slot e // n (ab, bc, ca) of triangle e % n."""
    slot, tri = sel // n, sel % n
    zeros = torch.zeros((n, 3), dtype=g0.dtype, device=g0.device)
    g = {"va": zeros, "vb": zeros, "vc": zeros}
    names = ("va", "vb", "vc")
    for sl in range(3):
        m = (slot == sl)[:, None]
        a, b = names[sl], names[(sl + 1) % 3]
        g[a] = g[a].index_add(0, tri, torch.where(m, g0, 0.0))
        g[b] = g[b].index_add(0, tri, torch.where(m, g1, 0.0))
    return {k: low(x) for k, x in g.items()}


def interior(scene: Scene, key, width, height):
    """(loss, {va, vb, vc} gradients) of the pixel-mean image."""
    dev = scene.device
    u, v, pids, _ = pixel_order(width, height)
    u = torch.from_numpy(u).to(dev).to(scene.dtype)
    v = torch.from_numpy(v).to(dev).to(scene.dtype)
    keys = tf.fold_in(tf.fold_in(key, 0), torch.from_numpy(pids).to(dev)
                      .long())
    pu, pv = scene.cam[4], scene.cam[5]
    q = torch.stack([arctan(pu * (u - 0.5)), arctan(pv * (0.5 - v))], -1)
    leaves = {k: x.detach().clone().requires_grad_(True)
              for k, x in scene.vertices().items()}
    va, vb, vc = leaves["va"], leaves["vb"], leaves["vc"]
    ab, ac = vb - va, vc - va
    gn = _normalize(_cross(ac, ab))
    rgb = radiance(scene, q, keys, (va, ab, ac), gn)
    loss = scene.low(torch.mean(rgb))
    grads = torch.autograd.grad(loss, [va, vb, vc])
    return loss.detach(), {k: scene.low(g) for k, g in
                           zip(("va", "vb", "vc"), grads)}


def silhouette(scene: Scene, key, width, height, samples, eps, budget):
    """({va, vb, vc} gradients, the edges drawn) of the silhouette term."""
    dev, cam, n, low = scene.device, scene.cam, scene.n, scene.low
    vt = scene.vertices()
    va, vb, vc = vt["va"], vt["vb"], vt["vc"]
    e0, e1 = torch.cat([va, vb, vc]), torch.cat([vb, vc, va])
    opp = torch.cat([vc, va, vb])
    q0, q1, qo = (factors_of_point(cam, x) for x in (e0, e1, opp))
    seg = q1 - q0
    seg_len = torch.sqrt(seg[:, 0] * seg[:, 0] + seg[:, 1] * seg[:, 1])
    nh = torch.stack([seg[:, 1], -seg[:, 0]], -1)
    nh = nh / torch.clamp(seg_len[:, None], min=1e-20)
    inward = torch.sum((qo - q0) * nh, -1)
    nh = torch.where((inward > 0)[:, None], -nh, nh)
    sel, mc_w = _draws(tf.fold_in(key, SILHOUETTE_KEY),
                       low(seg_len * scene.keep), budget, low)
    mc_w = low(mc_w)
    sa = (torch.arange(samples, dtype=scene.dtype, device=dev) + 0.5) \
        / samples
    qs = q0[sel][:, None, :] + seg[sel][:, None, :] * sa[None, :, None]
    nhs = nh[sel]
    p_in = (qs - eps * nhs[:, None, :]).reshape(-1, 2)
    p_out = (qs + eps * nhs[:, None, :]).reshape(-1, 2)
    keys = tf.fold_in(tf.fold_in(key, 1),
                      torch.arange(p_in.shape[0], device=dev))
    dl = torch.mean(radiance(scene, p_in, keys) - radiance(scene, p_out,
                                                           keys), -1)
    dl = low(low(dl).reshape(-1, samples) * low(pixel_density(cam, qs))
             * viewport_mask(cam, width, height, qs))
    xs = (e0[sel][:, None, :] * (1 - sa)[None, :, None]
          + e1[sel][:, None, :] * sa[None, :, None]).reshape(-1, 3)
    jac = torch.func.vmap(torch.func.jacrev(
        lambda p: factors_of_point(cam, p)))(xs)
    ndotj = low(torch.einsum("ek,ekd->ed",
                             low(nhs).repeat_interleave(samples, 0),
                             low(jac)).reshape(-1, samples, 3))
    wgt = low(dl * low(low(seg_len[sel]) * mc_w)[:, None] / samples)
    g0 = low(torch.sum(wgt[:, :, None] * ndotj * (1 - sa)[None, :, None],
                       1))
    g1 = low(torch.sum(wgt[:, :, None] * ndotj * sa[None, :, None], 1))
    return _to_vertices(sel, n, g0, g1, low), sel


def shadow(scene: Scene, key, width, height, samples, eps, budget):
    """({va, vb, vc} gradients, the edges drawn) of the first-bounce
    shadow-edge term."""
    dev, cam, n, low = scene.device, scene.cam, scene.n, scene.low
    vt = scene.vertices()
    va, vb, vc = vt["va"], vt["vb"], vt["vc"]
    e0, e1 = torch.cat([va, vb, vc]), torch.cat([vb, vc, va])
    sel, mc_w = _draws(tf.fold_in(key, SHADOW_KEY),
                       low(_norm(e1 - e0) * scene.keep), budget, low)
    mc_w = low(mc_w)
    sa = (torch.arange(samples, dtype=scene.dtype, device=dev) + 0.5) \
        / samples
    v0 = e0[sel].repeat_interleave(samples, 0)
    v1 = e1[sel].repeat_interleave(samples, 0)
    ss = sa.repeat(budget)[:, None]
    z = (1.0 - ss) * v0 + ss * v1
    bsize = z.shape[0]
    edge_tri = (sel % n).repeat_interleave(samples)
    y, rad = light_points(scene, tf.fold_in(tf.fold_in(key, 2),
                                            torch.arange(bsize, device=dev)))
    udir = z - y
    udir = udir / torch.clamp(_norm(udir)[:, None], min=1e-30)
    geom = (scene.tris.pa, scene.tris.ab, scene.tris.ac)
    tid = closest(scene.tris, z, udir, exclude=edge_tri, bundle=1)[1]
    recv = hit_of(scene, z, udir, tid, geom, scene.normal)

    def q_of_z(zz, yy, rp, rn):
        dirn = zz - yy
        den = _dot(rn, dirn)
        tau = _dot(rn, rp - yy) / torch.where(torch.abs(den) < 1e-12, 1e-12,
                                              den)
        return factors_of_point(cam, yy + tau[..., None] * dirn)

    qstar = q_of_z(z, y, recv["point"], recv["normal"])
    jq = torch.func.vmap(torch.func.jacfwd(q_of_z))(z, y, recv["point"],
                                                    recv["normal"])
    jq = low(jq)
    tang = low(torch.einsum("bij,bj->bi", jq, v1 - v0))
    tlen = torch.sqrt(tang[:, 0] * tang[:, 0] + tang[:, 1] * tang[:, 1])
    n_q = torch.stack([tang[:, 1], -tang[:, 0]], -1)
    n_q = n_q / torch.clamp(tlen[:, None], min=1e-20)

    def side(qp):
        o, d = rays_from_factors(cam, qp)
        t2 = closest(scene.tris, o, d)[1]
        h = hit_of(scene, o, d, t2, geom, scene.normal)
        to_l = y - h["point"]
        dist = _norm(to_l)
        ldir = to_l / torch.clamp(dist[:, None], min=1e-30)
        cos_nl = _dot(h["normal"], ldir)
        blocked = occluded(scene.tris, h["point"], ldir, dist.double(),
                           h["exclude"], h["hit"], bundle=1)
        vis = (cos_nl > 0) & ~blocked & h["hit"]
        return low(torch.where(vis[:, None],
                               low(h["kd"]) * low(rad) * low(cos_nl)[:, None],
                               0.0))

    df = low(torch.mean(side(qstar - eps * n_q) - side(qstar + eps * n_q),
                        -1))
    wgt = low(torch.where(recv["hit"], df * low(pixel_density(cam, qstar))
                          * viewport_mask(cam, width, height, qstar)
                          * tlen / samples, 0.0))
    wgt = low(wgt * mc_w.repeat_interleave(samples))
    ndotj = low(torch.einsum("bi,bij->bj", low(n_q), jq))
    g0 = low(((wgt * (1.0 - ss[:, 0]))[:, None] * ndotj).reshape(
        budget, samples, 3).sum(1))
    g1 = low(((wgt * ss[:, 0])[:, None] * ndotj).reshape(budget, samples,
                                                         3).sum(1))
    return _to_vertices(sel, n, g0, g1, low), sel


def vertex_grad(scene: Scene, key, width, height, samples=8, eps=1e-3,
                budget=4096, shadow_budget=1024) -> dict:
    """Every part of the estimator for base key `key` ((2,) int64)."""
    loss, g_int = interior(scene, key, width, height)
    with torch.no_grad():
        g_sil, sel_sil = silhouette(scene, key, width, height, samples, eps,
                                    budget)
        g_sh, sel_sh = shadow(scene, key, width, height, samples, eps,
                              shadow_budget)
    valid = scene.valid[:, None]
    total = {k: scene.low(torch.where(valid, g_int[k] + g_sil[k] + g_sh[k],
                                      0.0))
             for k in g_int}
    return {"loss": loss, "interior": g_int, "silhouette": g_sil,
            "shadow": g_sh, "grads": total,
            "draws": torch.cat([sel_sil, sel_sh])}
