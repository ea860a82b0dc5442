"""Vertex-position gradients with visibility (edge-sampling) terms (port of
`mobileraytracer_tpu/diff/geom.py`, whose docstring derives the
estimator).

For L = mean(image), dL/dv is the interior term (autograd through the
differentiable walk at fixed hit topology) plus the boundary terms, which
reverse mode cannot see: integrals along each triangle edge, projected
into the camera's factor space q (the (right, up) offsets that
`cameras.generate_rays` perturbs), of the radiance jump across the edge
times the edge's normal velocity.  The jump is probed with camera rays
`edge_eps` inside and outside the edge; with `shadow_edges` the
first-bounce NEE shadow curves add the same form, their curve found by
tracing from a light sample past the edge (Li et al. 2018, secondary
edges).  The bounce >= 2 shadow term is left out, as in the JAX package
(PARITY.md section 11).

Edges are either all enumerated or drawn by length importance with the
Gumbel-max draw of `jax.random.categorical` (`kernels.gumbel_argmax`, one
CUDA kernel on the card, `threefry.categorical` on the CPU), so the same
key picks the same edges in both packages.  Jacobians of the factor
map come from torch.func (jacrev, and jacfwd for the shadow curve) under
vmap, as the JAX package takes them; the boundary terms are values, not
taped.

With `mesh` (parallel/mesh.py) the pixel lanes of the interior and the
silhouette probes shard over the ranks, as the JAX package's shard_map
shards them; the edge draws and the shadow term run whole on every rank.
The probes' radiance is all-gathered; the interior's loss and vertex
gradients are each rank's autograd over its own lanes, all-reduced (what
shard_map's transpose does for the replicated vertices), so no collective
is on the tape.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from .. import sampling, threefry
from ..cameras import fast_arctan
from ..ops import kernels
from ..ops.intersect import _cross, _dot
from ..parallel import mesh as pmesh
from ..shaders import common
from ..shaders.engine import make_tracer, trace_image_sample
from ..types import (CAMERA_PERSPECTIVE, Camera, RenderConfig, Scene,
                     Triangles)
from ..utils.metrics import span


# When a dict, the spans of vertex_grad's parts on a CUDA device also
# record CUDA events into it, {part: [(start, end), ...]}, for a caller to
# read after a sync (chip_smoke.py phase 10): "interior", "silhouette" and
# "shadow" (each term with its edge draw), and "draws" (the Gumbel-max
# draws alone).
EVENTS = None


def _det(a, b, c):
    """det of the 3x3 matrix with columns a, b, c: a . (b x c)."""
    return _dot(a, _cross(b, c))


def factors_of_point(camera: Camera, x: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) -> factor coordinates (..., 2).  Perspective:
    s (x - p) = direction + rf right + uf up; orthographic: x - p = rf
    right + uf up + s direction.  Each 3x3 system is solved by Cramer's
    rule (the JAX package factors it with LU: equal to float32 ulps)."""
    w = x - camera.position
    rgt, up, dirn = camera.right, camera.up, camera.direction
    rgt, up, dirn = (t.expand_as(w) for t in (rgt, up, dirn))
    det_p = _det(w, -rgt, -up)
    rf_p = _det(w, dirn, -up) / det_p
    uf_p = _det(w, -rgt, dirn) / det_p
    det_o = _det(rgt, up, dirn)
    rf_o = _det(w, up, dirn) / det_o
    uf_o = _det(rgt, w, dirn) / det_o
    persp = camera.kind == CAMERA_PERSPECTIVE
    return torch.stack([torch.where(persp, rf_p, rf_o),
                        torch.where(persp, uf_p, uf_o)], -1)


def _norm(v):
    return torch.sqrt(_dot(v, v))


def _norm2(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def rays_from_factors(camera: Camera, q: torch.Tensor):
    """Rays through factor coordinates q (..., 2): the jitterless core of
    cameras.generate_rays with (rf, uf) given."""
    rf, uf = q[..., 0:1], q[..., 1:2]
    dest = (camera.position + camera.direction + camera.right * rf
            + camera.up * uf)
    dir_p = dest - camera.position
    dir_p = dir_p / _norm(dir_p)[..., None]
    org_p = camera.position.expand_as(dir_p)
    org_o = camera.position + camera.right * rf + camera.up * uf
    dir_o = camera.direction.expand_as(org_o)
    persp = camera.kind == CAMERA_PERSPECTIVE
    return torch.where(persp, org_p, org_o), torch.where(persp, dir_p, dir_o)


def pixel_density(camera: Camera, q: torch.Tensor) -> torch.Tensor:
    """Pixels per unit factor-space area over the pixel count: the weight
    that turns the factor-space integral into the pixel-mean image."""
    rf, uf = q[..., 0], q[..., 1]
    persp = (1.0 + torch.tan(rf) ** 2) * (1.0 + torch.tan(uf) ** 2)
    dens = torch.where(camera.kind == CAMERA_PERSPECTIVE, persp, 1.0)
    return dens / (camera.param_u * camera.param_v)


def viewport_mask(camera: Camera, config: RenderConfig,
                  q: torch.Tensor) -> torch.Tensor:
    """1.0 where factor points q (..., 2) land inside the image's
    factor-space support (the pixel grid plus the jitter box, warped by
    fastArcTan for the perspective model), else 0.0."""
    w, h = config.width, config.height
    persp = camera.kind == CAMERA_PERSPECTIVE

    def bounds(p, n, lo_u, hi_u):
        lo_p = fast_arctan(p * (lo_u - 0.5)) - 0.5 / n
        hi_p = fast_arctan(p * (hi_u - 0.5)) + 0.5 / n
        lo_o = p * (lo_u - 0.5) - 0.5 / n
        hi_o = p * (hi_u - 0.5) + 0.5 / n
        return torch.where(persp, lo_p, lo_o), torch.where(persp, hi_p, hi_o)

    r_lo, r_hi = bounds(camera.param_u, w, 0.0, (w - 1.0) / w)
    u_lo, u_hi = bounds(camera.param_v, h, 1.0 - (h - 1.0) / h, 1.0)
    inside = ((q[..., 0] >= r_lo) & (q[..., 0] <= r_hi)
              & (q[..., 1] >= u_lo) & (q[..., 1] <= u_hi))
    return inside.to(torch.float32)


def triangle_vertices(tris: Triangles) -> Dict[str, torch.Tensor]:
    """The vertex parameterization: va, vb, vc (N, 3) world positions."""
    va = tris.point_a
    return {"va": va, "vb": va + tris.ab, "vc": va + tris.ac}


def scene_with_vertices(scene: Scene, verts: Dict[str, torch.Tensor]) -> Scene:
    """The scene with its triangle table (and geometric shading normals,
    normalize(cross(AC, AB)) as the reference builds them) rebuilt from
    vertex positions; every derived field stays on autograd's tape."""
    va, vb, vc = verts["va"], verts["vb"], verts["vc"]
    ab = vb - va
    ac = vc - va
    gn = _cross(ac, ab)
    # sqrt(max(., 1e-30)): a padded row's zero normal keeps a finite VJP.
    gn = gn / torch.sqrt(torch.clamp(_dot(gn, gn), min=1e-30))[..., None]
    tris = scene.triangles.replace(point_a=va, ab=ab, ac=ac, normal_a=gn,
                                   normal_b=gn, normal_c=gn)
    return scene.replace(triangles=tris)


def _shard_rays(q: torch.Tensor, keys, mesh):
    """This rank's part of the batch (q, keys) padded to a multiple of the
    mesh size with zero q and copies of keys[:1] (the JAX package's
    padding), and how many of its lanes are real (the padding is last)."""
    n, b = mesh.size(), q.shape[0]
    bp = -(-b // n) * n
    if bp != b:
        q = torch.cat([q, q.new_zeros((bp - b, 2))], 0)
        keys = torch.cat([keys, keys[:1].expand(bp - b, *keys.shape[1:])], 0)
    sl = pmesh._lane_slice(bp, mesh)
    return q[sl], keys[sl], max(0, min(sl.stop, b) - sl.start)


def _mean_radiance(scene: Scene, camera: Camera, config: RenderConfig,
                   q: torch.Tensor, keys, mesh=None) -> torch.Tensor:
    """Radiance (B, 3) of the rays through factor points q (B, 2), by the
    differentiable walk.  With `mesh` each rank traces its shard and the
    shards are all-gathered, off autograd's tape (the silhouette probes)."""
    if mesh is not None:
        q_l, k_l, _ = _shard_rays(q, keys, mesh)
        rgb = _mean_radiance(scene, camera, config, q_l, k_l)
        return pmesh.all_gather(rgb, mesh)[:q.shape[0]]
    o, d = rays_from_factors(camera, q)
    rgb, _ = trace_image_sample(scene, config, o, d, keys,
                                differentiable=True)
    return rgb


def edge_topology(tris: Triangles, quantum: float = 1e-5) -> np.ndarray:
    """Host-side static edge culling (numpy): a (3N,) bool keep mask over
    the [ab | bc | ca] edge slots.  A shared edge whose two faces are
    coplanar with equal normals and the same material is
    radiance-continuous, so both copies drop; boundary edges, creases and
    material seams keep, as do only valid, non-degenerate faces."""
    arr = lambda t: t.detach().cpu().numpy()
    va = arr(tris.point_a)
    vb = va + arr(tris.ab)
    vc = va + arr(tris.ac)
    n = va.shape[0]
    valid = arr(tris.valid)
    nrm = np.cross(arr(tris.ab), arr(tris.ac))
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.maximum(ln, 1e-30)
    mat = arr(tris.mat_id)

    def key_of(p):
        return np.round(p / quantum).astype(np.int64)

    ka, kb, kc = key_of(va), key_of(vb), key_of(vc)
    keys = []
    for (p, q) in ((ka, kb), (kb, kc), (kc, ka)):
        keys.append(np.concatenate([np.minimum(p, q), np.maximum(p, q)],
                                   axis=1))
    allk = np.concatenate(keys, axis=0)                  # (3N, 6)
    order = np.lexsort(allk.T)
    sk = allk[order]
    same_prev = np.concatenate([[False],
                                np.all(sk[1:] == sk[:-1], axis=1)])
    same_next = np.concatenate([same_prev[1:], [False]])
    # Mates are neighbours in sort order (runs > 2 pair arbitrarily,
    # which only weakens the cull).
    mate_sorted = np.full(3 * n, -1, np.int64)
    prev_idx = np.nonzero(same_prev)[0]
    mate_sorted[prev_idx] = order[prev_idx - 1]
    next_idx = np.nonzero(same_next)[0]
    mate_sorted[next_idx] = order[next_idx + 1]
    mate = np.full(3 * n, -1, np.int64)
    mate[order] = mate_sorted

    tri_of = np.tile(np.arange(n), 3)
    has_mate = mate >= 0
    m_tri = tri_of[np.maximum(mate, 0)]
    coplanar = np.abs(np.einsum("ij,ij->i", nrm[tri_of],
                                nrm[m_tri])) > 1.0 - 1e-6
    same_nrm = np.linalg.norm(nrm[tri_of] - nrm[m_tri], axis=-1) < 1e-6
    same_mat = mat[tri_of] == mat[m_tri]
    keep = ~(has_mate & coplanar & same_nrm & same_mat)
    # Edge slots are slot-major ([ab x N | bc x N | ca x N]).
    keep &= np.tile(valid, 3)
    keep &= np.tile(ln[:, 0] > 1e-20, 3)
    return keep


def _draw_edges(key, w_e: torch.Tensor, budget: int):
    """`budget` edges drawn by length importance (jax.random.categorical
    over log-weights) and each draw's weight 1 / (budget p_e)."""
    with span("gradients.draws", events=EVENTS, device=w_e.device):
        logits = threefry.xla_log(torch.clamp(w_e, min=1e-30))
        sel = kernels.gumbel_argmax(key, logits, budget,
                                    threefry._gumbel_table(w_e.device))
    p_e = w_e[sel] / torch.clamp(torch.sum(w_e), min=1e-30)
    mc_w = torch.where(p_e > 0, 1.0 / (budget * p_e), 0.0)
    return sel, mc_w


def _scatter_edges(sel, n_tri: int, g0, g1) -> Dict[str, torch.Tensor]:
    """Per-draw endpoint gradients (E, 3) summed into the vertex slots:
    edge id e is slot e // N (0 ab, 1 bc, 2 ca) of triangle e % N, whose
    endpoints are va/vb/vc and vb/vc/va."""
    slot = sel // n_tri
    tri = sel % n_tri
    zeros = torch.zeros((n_tri, 3), dtype=torch.float32, device=g0.device)
    g = {"va": zeros, "vb": zeros, "vc": zeros}
    names = ["va", "vb", "vc"]
    for sl in range(3):
        msk = (slot == sl)[:, None]
        p0, p1 = names[sl], names[(sl + 1) % 3]
        g[p0] = g[p0].index_add(0, tri, torch.where(msk, g0, 0.0))
        g[p1] = g[p1].index_add(0, tri, torch.where(msk, g1, 0.0))
    return g


def _shadow_boundary_term(scene: Scene, camera: Camera, config: RenderConfig,
                          base_key, verts: Dict[str, torch.Tensor],
                          w_e: torch.Tensor, budget: int, samples: int,
                          eps: float) -> Dict[str, torch.Tensor]:
    """The first-bounce NEE shadow-edge boundary term (the JAX package's
    `_shadow_boundary_term`, whose docstring derives it): `budget` blocker
    edges drawn by world length, `samples` points z on each, one light
    sample y per point, the receiver traced past z, the shadow curve's
    factor-space Jacobian by jacfwd through the receiver's tangent plane,
    and the jump probed by camera rays `eps` to each side with a real
    shadow ray."""
    n_tri = verts["va"].shape[0]
    dev = w_e.device
    va, vb, vc = verts["va"], verts["vb"], verts["vc"]
    e0 = torch.cat([va, vb, vc], 0)
    e1 = torch.cat([vb, vc, va], 0)

    tracer = make_tracer(config)
    bkey = sampling.fold_in(base_key, 0x511AD0)
    sel, mc_w = _draw_edges(bkey, w_e, budget)
    tri_sel = (sel % n_tri).to(torch.int32)

    sa = (torch.arange(samples, dtype=torch.float32, device=dev) + 0.5) \
        / samples
    v0 = e0[sel].repeat_interleave(samples, 0)              # (B, 3)
    v1 = e1[sel].repeat_interleave(samples, 0)
    ss = sa.repeat(budget)[:, None]                         # (B, 1)
    z = (1.0 - ss) * v0 + ss * v1
    bsize = z.shape[0]
    blk_tri = tri_sel.repeat_interleave(samples)

    # One light sample per point: the NEE sampler's uniform pick and
    # uniform triangle point (shaders/common.direct_lighting).
    lights = scene.lights
    skeys = sampling.ray_key(
        base_key, torch.arange(bsize, dtype=torch.int32, device=dev), 2)
    lidx = sampling.pick_light(sampling.fold_in(skeys, 0), lights.num).long()
    p_area = sampling.sample_triangle_point(
        sampling.fold_in(skeys, 1), lights.tri_a[lidx], lights.tri_ab[lidx],
        lights.tri_ac[lidx])
    y = torch.where((lights.kind[lidx] == C.LIGHT_AREA)[:, None], p_area,
                    lights.position[lidx])
    radiance = lights.radiance[lidx]

    # Receiver: the first hit past the edge along y -> z.
    udir = z - y
    udir = udir / torch.clamp(_norm(udir)[:, None], min=1e-30)
    pk_blk = torch.full((bsize,), C.PRIM_TRIANGLE, dtype=torch.int32,
                        device=dev)
    rhit = tracer.closest(scene, z, udir, pk_blk, blk_tri)
    recv_ok = ~rhit.missed

    def q_of_z(zz, yy, rp, rn):
        """The shadow point: ray y -> z against the receiver's tangent
        plane, in factor space."""
        dirn = zz - yy
        den = _dot(rn, dirn)
        tau = _dot(rn, rp - yy) / torch.where(torch.abs(den) < 1e-12,
                                              1e-12, den)
        return factors_of_point(camera, yy + tau[..., None] * dirn)

    qstar = q_of_z(z, y, rhit.point, rhit.normal)           # (B, 2)
    jq = torch.func.vmap(torch.func.jacfwd(q_of_z))(
        z, y, rhit.point, rhit.normal)                      # (B, 2, 3)
    tang = torch.einsum("bij,bj->bi", jq, v1 - v0)
    tlen = _norm2(tang)
    n_q = torch.stack([tang[:, 1], -tang[:, 0]], -1)
    n_q = n_q / torch.clamp(tlen[:, None], min=1e-20)

    zero_k = torch.zeros((bsize,), dtype=torch.int32, device=dev)
    none_id = torch.full((bsize,), -1, dtype=torch.int32, device=dev)

    def side_f(qp):
        """Single-sample direct light of the surface the camera sees at
        qp toward y, with a real shadow ray."""
        o_p, d_p = rays_from_factors(camera, qp)
        hit = tracer.closest(scene, o_p, d_p, zero_k, none_id)
        _, kd, _, _, _ = common.bind_material(scene, hit)
        to_l = y - hit.point
        dist = _norm(to_l)
        ldir = to_l / torch.clamp(dist[:, None], min=1e-30)
        cos_nl = _dot(hit.normal, ldir)
        blocked = tracer.occluded(scene, hit.point, ldir, dist,
                                  hit.prim_kind, hit.prim_id)
        vis = (cos_nl > 0) & ~blocked & ~hit.missed
        return torch.where(vis[:, None], kd * radiance * cos_nl[:, None],
                           0.0)

    df = torch.mean(side_f(qstar - eps * n_q) - side_f(qstar + eps * n_q),
                    -1)
    live = recv_ok & (lights.num > 0)
    wgt = torch.where(live, df * pixel_density(camera, qstar)
                      * viewport_mask(camera, config, qstar)
                      * tlen / samples, 0.0)
    wgt = wgt * mc_w.repeat_interleave(samples)
    ndotj = torch.einsum("bi,bij->bj", n_q, jq)              # (B, 3)
    g0 = ((wgt * (1.0 - ss[:, 0]))[:, None] * ndotj).reshape(
        budget, samples, 3).sum(1)
    g1 = ((wgt * ss[:, 0])[:, None] * ndotj).reshape(budget, samples,
                                                     3).sum(1)
    return _scatter_edges(sel, n_tri, g0, g1)


def _boundary_terms(verts, scene, camera, base_key, ek_arr, *, config,
                    edge_samples, edge_eps, edge_budget, shadow_edges,
                    shadow_budget, mesh=None):
    """The silhouette (and with `shadow_edges` the shadow) boundary
    gradient, a dict of (N, 3) per vertex slot; with `mesh` the silhouette
    probes are sharded and the shadow term is not."""
    dev = verts["va"].device
    with span("gradients.silhouette", events=EVENTS, device=dev):
        g_bnd = _silhouette_term(verts, scene, camera, base_key, ek_arr,
                                 config, edge_samples, edge_eps, edge_budget,
                                 mesh)
    if shadow_edges:
        # Shadow-edge importance: world-space edge length.
        e0 = torch.cat([verts["va"], verts["vb"], verts["vc"]], 0)
        e1 = torch.cat([verts["vb"], verts["vc"], verts["va"]], 0)
        wl = _norm(e1 - e0) * ek_arr
        with span("gradients.shadow", events=EVENTS, device=dev):
            g_sh = _shadow_boundary_term(scene, camera, config, base_key,
                                         verts, wl, shadow_budget,
                                         edge_samples, edge_eps)
        g_bnd = {k: g_bnd[k] + g_sh[k] for k in g_bnd}
    return g_bnd


def _silhouette_term(verts, scene, camera, base_key, ek_arr, config,
                     edge_samples, edge_eps, edge_budget, mesh=None):
    """The primary (silhouette) edges' boundary gradient: every kept edge,
    or `edge_budget` length-importance draws, probed at `edge_samples`
    points."""
    n_tri = verts["va"].shape[0]
    dev = verts["va"].device
    s = edge_samples
    sa = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s

    va, vb, vc = verts["va"], verts["vb"], verts["vc"]
    # Edges [ab | bc | ca]: endpoints and the opposite vertex.
    e0 = torch.cat([va, vb, vc], 0)
    e1 = torch.cat([vb, vc, va], 0)
    opp = torch.cat([vc, va, vb], 0)
    q0 = factors_of_point(camera, e0)                     # (E, 2)
    q1 = factors_of_point(camera, e1)
    qo = factors_of_point(camera, opp)
    seg = q1 - q0
    seg_len = _norm2(seg)
    n_hat = torch.stack([seg[:, 1], -seg[:, 0]], -1)
    n_hat = n_hat / torch.clamp(seg_len[:, None], min=1e-20)
    # Outward: flip where the opposite vertex lies on the +n side.
    inward = torch.sum((qo - q0) * n_hat, -1)
    n_hat = torch.where((inward > 0)[:, None], -n_hat, n_hat)
    w_e = seg_len * ek_arr

    if edge_budget is None:
        sel = torch.arange(e0.shape[0], device=dev)
        mc_w = torch.where(w_e > 0, 1.0, 0.0)
    else:
        sel, mc_w = _draw_edges(sampling.fold_in(base_key, 0x5ED6E), w_e,
                                edge_budget)
    e0s, e1s = e0[sel], e1[sel]
    segs, lens, nhs = seg[sel], seg_len[sel], n_hat[sel]

    # Sample points in factor space (Es, S, 2) and the two probes.
    qs = q0[sel][:, None, :] + segs[:, None, :] * sa[None, :, None]
    probe_in = (qs - edge_eps * nhs[:, None, :]).reshape(-1, 2)
    probe_out = (qs + edge_eps * nhs[:, None, :]).reshape(-1, 2)
    pkeys = sampling.ray_key(
        base_key, torch.arange(probe_in.shape[0], dtype=torch.int32,
                               device=dev), 1)
    l_in = _mean_radiance(scene, camera, config, probe_in, pkeys, mesh)
    l_out = _mean_radiance(scene, camera, config, probe_out, pkeys, mesh)
    dl = torch.mean(l_in - l_out, -1).reshape(-1, s)
    dl = dl * pixel_density(camera, qs) * viewport_mask(camera, config, qs)

    # dq/dv0 = (1 - s) J(x), dq/dv1 = s J(x) at x = (1 - s) p0 + s p1.
    xs = (e0s[:, None, :] * (1 - sa)[None, :, None]
          + e1s[:, None, :] * sa[None, :, None]).reshape(-1, 3)
    jac = torch.func.vmap(torch.func.jacrev(
        lambda p: factors_of_point(camera, p)))(xs)       # (Es S, 2, 3)
    ndotj = torch.einsum("ek,ekd->ed", nhs.repeat_interleave(s, 0),
                         jac).reshape(-1, s, 3)
    wgt = dl * (lens * mc_w)[:, None] / s                  # (Es, S)
    g0 = torch.sum(wgt[:, :, None] * ndotj * (1 - sa)[None, :, None], 1)
    g1 = torch.sum(wgt[:, :, None] * ndotj * sa[None, :, None], 1)
    return _scatter_edges(sel, n_tri, g0, g1)


def _interior(scene: Scene, camera: Camera, config: RenderConfig, verts,
              keys, u, v, pixel_chunk: Optional[int] = None, mesh=None):
    """(loss, {slot: dL/dv}) of L = mean radiance of the jitterless pixel
    rays, by autograd through the differentiable walk, in one pass or in
    chunks of `pixel_chunk` lanes (a multiple of 128): L is a mean over
    every pixel, so its gradient is the sum of the chunks' gradients of
    sum(rgb) / (3 B).  With `mesh` each chunk is sharded: each rank takes
    the gradient of its own lanes' sum, and the sums are all-reduced."""
    b_pix = u.shape[0]
    ck = b_pix
    if pixel_chunk is not None and pixel_chunk < b_pix:
        ck = max(128, pixel_chunk - pixel_chunk % 128)
    denom = float(b_pix * 3)
    leaves = {k: x.detach().requires_grad_(True) for k, x in verts.items()}
    loss = torch.zeros((), dtype=torch.float32, device=u.device)
    g_int = {k: torch.zeros_like(x) for k, x in leaves.items()}
    for lo in range(0, b_pix, ck):
        uc, vc, kc = u[lo:lo + ck], v[lo:lo + ck], keys[lo:lo + ck]
        qs = torch.stack([fast_arctan(camera.param_u * (uc - 0.5)),
                          fast_arctan(camera.param_v * (0.5 - vc))], -1)
        if mesh is not None:
            qs, kc, real = _shard_rays(qs, kc, mesh)
        rgb = _mean_radiance(scene_with_vertices(scene, leaves), camera,
                             config, qs, kc)
        if mesh is not None:
            rgb = rgb[:real]
        lc = (torch.mean(rgb) if ck == b_pix and mesh is None
              else torch.sum(rgb) / denom)
        loss = loss + lc.detach()
        if lc.requires_grad:        # DiffuseMaterial's flat colour has none
            gc = torch.autograd.grad(lc, list(leaves.values()),
                                     allow_unused=True)
            g_int = {k: g_int[k] if g is None else g_int[k] + g
                     for k, g in zip(g_int, gc)}
    if mesh is not None:
        g_int = pmesh.reduce_sums(dict(g_int, _loss=loss), mesh)
        loss = g_int.pop("_loss")
    return loss, g_int


@span("gradients.vertex_grad")
def vertex_grad(scene: Scene, camera: Camera, config: RenderConfig,
                base_key: torch.Tensor, edge_samples: int = 8,
                edge_eps: float = 1e-3, spp: int = 1, edge_keep=None,
                edge_budget: Optional[int] = None,
                shadow_edges: bool = False, shadow_budget: int = 256,
                mesh=None, pixel_chunk: Optional[int] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Gradient of L = mean(image) with respect to every triangle vertex,
    on the scene's device.  Returns (loss, {"va", "vb", "vc": (N, 3)}),
    padded rows zero.

    Interior: autograd through one jitterless sample per pixel (`spp` is
    accepted and unused, as in the JAX package), chunked by `pixel_chunk`.
    Boundary: `edge_samples` points per edge, radiance probes `edge_eps`
    to each side in factor space; `edge_keep` a (3N,) mask from
    `edge_topology`; `edge_budget` draws that many edges by length
    importance instead of enumerating all 3N; `shadow_edges` adds the
    first-bounce shadow term with `shadow_budget` draws.  With `mesh`
    every rank of it calls this and gets the whole result."""
    from ..renderer import _pixel_order
    dev = scene.device
    camera = camera.to(dev)
    base_key = base_key.to(dev)
    verts = triangle_vertices(scene.triangles)
    u, v, pids, _ = _pixel_order(config, dev)
    keys = sampling.ray_key(base_key, pids, 0)
    with span("gradients.interior", events=EVENTS, device=dev):
        loss, g_int = _interior(scene, camera, config, verts, keys, u, v,
                                pixel_chunk, mesh)

    n_tri = verts["va"].shape[0]
    if edge_keep is None:
        ek_arr = torch.ones((3 * n_tri,), dtype=torch.float32, device=dev)
    else:
        ek_arr = torch.as_tensor(np.asarray(edge_keep)).to(
            device=dev, dtype=torch.float32)
    with torch.no_grad():
        g_bnd = _boundary_terms(
            {k: x.detach() for k, x in verts.items()}, scene.detach(),
            camera, base_key, ek_arr, config=config,
            edge_samples=edge_samples, edge_eps=edge_eps,
            edge_budget=edge_budget, shadow_edges=shadow_edges,
            shadow_budget=shadow_budget, mesh=mesh)
    valid = scene.triangles.valid.to(torch.bool)[:, None]
    grads = {k: torch.where(valid, g_int[k] + g_bnd[k], 0.0) for k in g_int}
    return loss, grads
