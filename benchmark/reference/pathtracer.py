"""A plain PathTracer sample of an all-diffuse scene with area lights,
written from MobileRT's PathTracer (PathTracer.cpp, Shader.cpp,
AreaLight.cpp, Perspective.cpp) and the port's documented conventions
(PARITY.md), in float32 (bfloat16 makes the check's control).

What one sample of a pixel is:
  * a camera ray through the pixel corner jittered by a uniform draw
    (Renderer.cpp:137-140): pixel p of sample s of base key K draws with
    key k = fold_in(fold_in(K, s), p); the jitter is uniform(fold_in(
    fold_in(k, 0), 0), 2), deviation (r - 0.5) * 2 * (0.5 / size);
  * every surface is diffuse, so a path is a chain: at each diffuse hit
    one next-event sample (the light pick and point of AreaLight.cpp from
    the NEE key fold_in(fold_in(k, n), 1), n the node's index on the
    path) adds radiance * cos(N, L) * kD when the shadow segment is clear,
    and Russian roulette (uniform(fold_in(fold_in(k, n), 2)) > 0.5) past
    depth RAY_DEPTH_MIN continues it with a cosine-weighted direction
    (Shader.cpp:188-216, key fold_in(fold_in(k, n), 3)), weighted by kD
    and, past RAY_DEPTH_MIN, by 1 / (0.5 * 0.5); a node deeper than
    RAY_DEPTH_MAX casts its ray and adds nothing; a hit on a light adds
    its radiance times the path weight and ends the path;
  * the NEE double-count guard (PathTracer.cpp:107-113; PARITY.md 2):
    when a path ends on a light, the indirect part of every node before
    it whose own NEE found light is dropped, from the innermost out;
  * the rays a pixel casts: one per path node, and one shadow ray at each
    diffuse hit whose normal faces its light point.

The port's deviations that the sample is held to:
  * NEE light samples are shared by `share` consecutive lanes of the
    traced batch, drawn from the first lane's key (PARITY.md 8); on every
    step with `secondary` (PARITY.md 13), on the camera step only
    without; shared segments run reversed, from the light point to EPSILON
    short of the surface (PARITY.md 12), unshared ones forward;
  * the batches: pixels run in 4x4 patches, patch-major (whitted.py); the
    camera step traces every lane; later steps trace chunks of `chunk`
    lanes (a quarter of the lanes, rounded up to 128) taken from the
    lanes that still have a ray, sorted stably by the ray's direction
    octant and the Morton code of its origin on a 32^3 lattice over those
    lanes' origins (the lanes without a ray last, by lane); the lanes of a
    chunk that have no ray still advance their node index and lend their
    NEE key to their group (shaders/engine.py:22-25, _coherence_order);
  * each lane's node index advances once a step it is traced in, and a
    lane stops after 2 * (RAY_DEPTH_MAX + 1) of them (never reached by a
    chain, which has at most RAY_DEPTH_MAX + 1 nodes).

Departures of this reference: images of fewer than 1024 lanes (which the
port walks in full-batch steps) and scenes with specular, transparent or
emissive materials are refused; ties between coincident triangles go to
the lower index of the arrays as given (PARITY.md 7).  Given `layout`,
the chunks are the ones listed (each chunk step's lane order, as the
program's walker made it) and the reference orders only the lanes left
after them: a lane that rightly differs (such a tie) then changes its own
pixel, where under the reference's own order it would shift every NEE
group behind it in its chunk.  Hit searches are exact: camera rays, whose
bundles share an origin, through trace.py's cone-culled `closest`; every
other ray and every shadow segment against 128-triangle clusters (Morton
order of the centroids) taken in order of where the ray enters their
bounds, each tested with trace.py's Moller-Trumbore while it can still
hold a closer hit (or, for a shadow segment, until a blocker).  The
sample's queries run in ray blocks, so a 512x512 sample fits in a few GB.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import threefry as tf
from . import whitted
from .compare import NORMAL_ABS, PIXEL_ABS, PPM, T_REL
from .trace import BIG, EPSILON, closest, moller_trumbore
from .whitted import _cross, _normalize, _sum3, arctan, light_points

DEPTH_MIN = 1
DEPTH_MAX = 6
RR_FINISH = 0.5
MAX_NODES = 2 * (DEPTH_MAX + 1)
NODES = DEPTH_MAX + 1          # the longest chain
UNIT = 128
CHUNK_DIV = 4
TWO_PI = 6.283185307179586
KIND_NONE, KIND_TRIANGLE, KIND_LIGHT = (whitted.KIND_NONE,
                                        whitted.KIND_TRIANGLE,
                                        whitted.KIND_LIGHT)
CLUSTER = 128                  # triangles a cluster
RAY_BLOCK = 16384              # rays a pass of the cluster search
WAVE = 16                      # clusters a ray takes in its first round
MAX_WAVE = 256                 # ... and at most in a later one
PAIRS = 1 << 25                # (ray, triangle) tests a batch


class Scene(whitted.Scene):
    """whitted.Scene plus 128-triangle clusters for rays that share no
    origin: the triangles in Morton order of their centroids, cut into
    runs of 128, each with bounds (from float64 corners) widened by 1e-2
    and 1e-5 of their size, held in float32."""

    def __init__(self, arrays: dict, dtype=torch.float32, device=None):
        super().__init__(arrays, dtype=dtype, device=device)
        if np.any(np.asarray(arrays["kd"]) <= 0.0):
            raise ValueError("the reference shades all-diffuse scenes only")
        pa, ab, ac = (t.double().cpu().numpy() for t in (
            self.tris.pa, self.tris.ab, self.tris.ac))
        pts = np.stack([pa, pa + ab, pa + ac], 1)
        cen = pts.mean(1)
        lo, hi = cen.min(0), cen.max(0)
        q = ((cen - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
        code = np.zeros(len(q), np.int64)
        for bit in range(10):
            for a in range(3):
                code |= ((q[:, a] >> bit) & 1) << (3 * bit + a)
        order = np.argsort(code, kind="stable")
        n = order.shape[0]
        nc = -(-n // CLUSTER)
        ids = np.full(nc * CLUSTER, -1, np.int64)
        ids[:n] = order
        ids = ids.reshape(nc, CLUSTER)
        cp = np.where((ids >= 0)[:, :, None, None], pts[ids.clip(0)],
                      np.nan)
        c_lo = np.nanmin(cp, (1, 2))
        c_hi = np.nanmax(cp, (1, 2))
        pad = 1e-5 * np.abs(c_hi - c_lo) + 1e-2
        f32 = dict(dtype=torch.float32, device=device)
        self.c_ids = torch.from_numpy(ids).to(device)
        self.c_lo = torch.from_numpy(c_lo - pad).to(**f32)
        self.c_hi = torch.from_numpy(c_hi + pad).to(**f32)


# -- hit searches -----------------------------------------------------------

def _entries(scene: Scene, o, d):
    """Each ray's entry distance into each cluster's bounds (inf where it
    misses them), ascending, with the cluster order: (R, C) float32 and
    int64.  The bounds are widened by at least 1e-2, far more than the
    float32 rounding of the slab distances, so no needed cluster is
    entered late."""
    tiny = torch.where(d < 0, -1e-30, 1e-30)
    inv = 1.0 / torch.where(d.abs() < 1e-30, tiny, d)
    near = far = None
    for a in range(3):
        t1 = (scene.c_lo[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        t2 = (scene.c_hi[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
        lo_a, hi_a = torch.minimum(t1, t2), torch.maximum(t1, t2)
        near = lo_a if near is None else torch.maximum(near, lo_a)
        far = hi_a if far is None else torch.minimum(far, hi_a)
    entry = torch.where((near <= far) & (far >= 0.0), near.clamp(min=0.0),
                        math.inf)
    return torch.sort(entry, dim=1)


def cluster_search(scene: Scene, o, d, tmax, exclude, any_hit: bool):
    """Closest triangle (any_hit False: (t, id), BIG and -1 for a miss,
    equal t to the lower id) or any blocker (any_hit True: bool) of each
    ray o, d among the triangles other than `exclude` at a distance in
    [EPSILON, tmax).  Each ray takes the clusters in entry order, in
    rounds of WAVE, 2 WAVE, 4 WAVE ... clusters, while the next one's
    entry lies before its nearest hit (or, for any_hit, until a
    blocker)."""
    r = o.shape[0]
    dev = o.device
    none = torch.iinfo(torch.int64).max
    best = torch.full((r,), none, dtype=torch.int64, device=dev)
    blocked = torch.zeros(r, dtype=torch.bool, device=dev)
    tris = scene.tris
    of = o.float()
    df = d.float()
    for r0 in range(0, r, RAY_BLOCK):
        sl = slice(r0, r0 + RAY_BLOCK)
        ro, rd = of[sl], df[sl]
        tm, ex = tmax[sl].float(), exclude[sl]
        entry, order = _entries(scene, ro, rd)
        reach = tm.clone()              # a cluster is needed before it
        key = best[sl].clone()
        blk = blocked[sl].clone()
        rows = torch.arange(ro.shape[0], device=dev)
        k0, w = 0, WAVE
        while k0 < entry.shape[1]:
            rows = rows[entry[rows, k0] < reach[rows]]
            if rows.numel() == 0:
                break
            step = max(1, PAIRS // (w * CLUSTER))
            for s0 in range(0, rows.shape[0], step):
                sub = rows[s0:s0 + step]
                cl = order[sub, k0:k0 + w]
                tid = scene.c_ids[cl].reshape(sub.shape[0], -1)
                ok_id = (tid >= 0) & (tid != ex[sub][:, None])
                g = tid.clamp(min=0)
                t, ok = moller_trumbore(o[sl][sub][:, None],
                                        d[sl][sub][:, None],
                                        tris.pa[g], tris.ab[g], tris.ac[g])
                ok = ok & ok_id & (t.float() < tm[sub][:, None])
                if any_hit:
                    hit = ok.any(1)
                    blk[sub] |= hit
                    reach[sub] = torch.where(hit, -math.inf, reach[sub])
                else:
                    bits = t.float().view(torch.int32).to(torch.int64)
                    kk = torch.where(ok, (bits << 32) | g, none).amin(1)
                    kk = torch.minimum(key[sub], kk)
                    key[sub] = kk
                    t_best = (kk >> 32).to(torch.int32).view(torch.float32)
                    reach[sub] = torch.where(kk != none, torch.minimum(
                        reach[sub], t_best), reach[sub])
            k0, w = k0 + w, min(2 * w, MAX_WAVE)
        best[sl], blocked[sl] = key, blk
    if any_hit:
        return blocked
    hit = best != none
    t_best = (best >> 32).to(torch.int32).view(torch.float32)
    return (torch.where(hit, t_best, BIG).to(scene.dtype),
            torch.where(hit, best & 0xFFFFFFFF, -1))


def trace_closest(scene: Scene, o, d, exclude, camera: bool):
    """The closest hit of each ray over the triangles and the lights (a
    triangle wins a tie): (t, kind, triangle id or -1, light id)."""
    if camera:
        t_tr, id_tr = closest(scene.tris, o, d)
    else:
        tmax = torch.full(o.shape[:1], BIG, dtype=torch.float32,
                          device=o.device)
        t_tr, id_tr = cluster_search(scene, o, d, tmax, exclude, False)
    t_li, id_li = whitted._closest_light(scene, o, d)
    light_wins = t_li < t_tr
    t = torch.where(light_wins, t_li, t_tr)
    kind = torch.where(light_wins, KIND_LIGHT,
                       torch.where(t < BIG, KIND_TRIANGLE, KIND_NONE))
    return t, kind, torch.where(kind == KIND_TRIANGLE, id_tr, -1), id_li


def hit_attributes(scene: Scene, o, d, t, kind, tid, lid):
    """(point, normal, material or -1, kD, Le) of each hit: the point
    o + d t, a triangle's vertex normals interpolated at the hit's
    barycentrics, a light's normalize(AC x AB)."""
    point = o + d * t[:, None]
    g = tid.clamp(min=0)
    pa, ab, ac = scene.tris.pa[g], scene.tris.ab[g], scene.tris.ac[g]
    p = _cross(d, ac)
    det = _sum3(ab * p)
    inv_det = 1.0 / torch.where(torch.abs(det) < EPSILON, 1.0, det)
    tvec = o - pa
    bu = inv_det * _sum3(tvec * p)
    bv = inv_det * _sum3(d * _cross(tvec, ab))
    bw = 1.0 - bu - bv
    nt = scene.normal[g]
    n_tri = _normalize(nt * bw[:, None] + nt * bu[:, None]
                       + nt * bv[:, None])
    n_li = _normalize(_cross(scene.l_ac[lid], scene.l_ab[lid]))
    is_li = kind == KIND_LIGHT
    is_tri = kind == KIND_TRIANGLE
    normal = torch.where(is_li[:, None], n_li, n_tri)
    mat = torch.where(is_tri, scene.mat_id[g], -1)
    kd = torch.where(is_tri[:, None], scene.kd[mat.clamp(min=0)], 0.0)
    le = torch.where(is_li[:, None], scene.l_rad[lid], 0.0)
    return point, normal, mat, kd, le


# -- sampling ---------------------------------------------------------------

def _sumsq(v):
    return (v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
            + v[..., 2:3] * v[..., 2:3])


def cosine_direction(keys, normal):
    """A cosine-weighted direction about each normal (Shader.cpp:188-216):
    phi = 2 pi r0, cos theta = sqrt(r1) in the frame of a helper axis (y,
    or x where |n.x| <= 0.1), normalised."""
    r = tf.uniform(keys, 2).to(normal.dtype)
    phi = TWO_PI * r[:, 0]
    r2 = r[:, 1]
    cos_theta = torch.sqrt(r2)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=normal.dtype,
                     device=normal.device)
    normal = torch.where(_sumsq(normal) > 0.25, normal, z.expand_as(normal))
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=normal.dtype,
                      device=normal.device).expand_as(normal)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=normal.dtype,
                      device=normal.device).expand_as(normal)
    helper = torch.where(torch.abs(normal[:, :1]) > 0.1, ey, ex)
    u = _cross(helper, normal)
    u = u / torch.sqrt(torch.clamp(_sumsq(u), min=1e-20))
    v = _cross(normal, u)
    dirn = (u * (torch.cos(phi) * cos_theta)[:, None]
            + v * (torch.sin(phi) * cos_theta)[:, None]
            + normal * torch.sqrt(torch.clamp(1.0 - r2, min=0.0))[:, None])
    return dirn / torch.sqrt(torch.clamp(_sumsq(dirn), min=1e-20))


def camera_rays(scene: Scene, u, v, keys, width: int, height: int):
    """Jittered perspective camera rays (Perspective.cpp:16-46)."""
    dt = scene.dtype
    pos, dirn, right, up, pu, pv = whitted.camera_basis(scene.camera, dt,
                                                        u.device)
    r = tf.uniform(tf.fold_in(tf.fold_in(keys, 0), 0), 2).to(dt)
    dev_u = (r[:, 0] - 0.5) * 2.0 * (0.5 / width)
    dev_v = (r[:, 1] - 0.5) * 2.0 * (0.5 / height)
    rp = arctan(pu * (u - 0.5)) + dev_u
    upp = arctan(pv * (0.5 - v)) + dev_v
    dest = pos + dirn + right * rp[:, None] + up * upp[:, None]
    d = dest - pos
    d = d / torch.sqrt(d[:, 0:1] * d[:, 0:1] + d[:, 1:2] * d[:, 1:2]
                       + d[:, 2:3] * d[:, 2:3])
    return pos.expand_as(d), d


def _spread5(x):
    x = (x | (x << 8)) & 0x100F
    x = (x | (x << 4)) & 0x10C3
    return (x | (x << 2)) & 0x1249


def coherence_order(live, org, dirn):
    """Lanes with a ray by direction octant, then the Morton code of the
    origin on a 32^3 lattice over their bounds; the others last; stable."""
    octant = ((dirn[:, 0] > 0).to(torch.int32) * 4
              + (dirn[:, 1] > 0).to(torch.int32) * 2
              + (dirn[:, 2] > 0).to(torch.int32))
    lo = torch.where(live[:, None], org, torch.inf).amin(0)
    hi = torch.where(live[:, None], org, -torch.inf).amax(0)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-20)
    q = torch.clamp(((org - lo) * inv * 32.0).to(torch.int32), 0, 31)
    morton = (_spread5(q[:, 0]) | (_spread5(q[:, 1]) << 1)
              | (_spread5(q[:, 2]) << 2))
    key = torch.where(live, octant * (1 << 15) + morton, 1 << 24)
    return torch.argsort(key, stable=True)


# -- the sample -------------------------------------------------------------

class _Paths:
    """Per lane: the pending ray (if any), its node index and weight, and
    each node's contribution and NEE flag along the chain."""

    def __init__(self, o, d, dt):
        b, dev = o.shape[0], o.device
        self.pending = torch.ones(b, dtype=torch.bool, device=dev)
        self.node = torch.zeros(b, dtype=torch.int64, device=dev)
        self.org, self.dir = o.clone(), d.clone()
        self.weight = torch.ones((b, 3), dtype=dt, device=dev)
        self.src = torch.full((b,), -1, dtype=torch.int64, device=dev)
        self.contrib = torch.zeros((b, NODES, 3), dtype=dt, device=dev)
        self.ld_pos = torch.zeros((b, NODES), dtype=torch.bool, device=dev)
        self.length = torch.zeros(b, dtype=torch.int64, device=dev)
        self.on_light = torch.zeros(b, dtype=torch.bool, device=dev)
        self.rays = torch.zeros(b, dtype=torch.int64, device=dev)


def _step(scene: Scene, paths: _Paths, lanes, keys, share: int,
          shared: bool, camera: bool):
    """Traces one node of every lane in `lanes` (the batch, in its order)
    and pushes the next ray where the path goes on."""
    dt = scene.dtype
    n = paths.node[lanes]
    active = paths.pending[lanes]
    paths.node[lanes] = n + 1
    paths.rays[lanes] += active.long()
    k_node = tf.fold_in(keys[lanes], n)
    nee_keys = tf.fold_in(k_node, 1)
    nb = lanes.shape[0]
    if shared and nb % share == 0:
        first = nee_keys.reshape(nb // share, share, 2)[:, 0]
        lpos, rad = light_points(scene, first)
        lpos = lpos.repeat_interleave(share, 0)
        rad = rad.repeat_interleave(share, 0)
        reverse = True
    else:
        lpos, rad = light_points(scene, nee_keys)
        reverse = False

    act = torch.nonzero(active).squeeze(1)
    lane_a = lanes[act]
    o, d = paths.org[lane_a], paths.dir[lane_a]
    t, kind, tid, lid = trace_closest(scene, o, d, paths.src[lane_a], camera)
    point, normal, mat, kd, le = hit_attributes(scene, o, d, t, kind, tid,
                                                lid)
    depth = n[act] + 1
    live = (kind != KIND_NONE) & (depth <= DEPTH_MAX)
    emit = live & (le > 0.0).any(-1)
    diffuse = live & ~emit & (kd > 0.0).any(-1)

    # Next-event estimation with the batch's light samples.
    lp, rd = lpos[act], rad[act]
    to_light = lp - point
    dist = torch.sqrt(torch.clamp(_sum3(to_light * to_light), min=1e-30))
    ldir = to_light / torch.clamp(dist[:, None], min=1e-30)
    cos_nl = _sum3(normal * ldir)
    facing = cos_nl > 0.0
    send = diffuse & facing
    paths.rays[lane_a] += send.long()
    blocked = torch.zeros_like(send)
    s = torch.nonzero(send).squeeze(1)
    if reverse:
        blocked[s] = cluster_search(scene, lp[s], -ldir[s], torch.clamp(
            dist[s] - EPSILON, min=0.0), tid[s], True)
    else:
        blocked[s] = cluster_search(scene, point[s], ldir[s], dist[s],
                                    tid[s], True)
    lit = facing & ~blocked
    ld = torch.where(lit[:, None], rd * cos_nl[:, None], 0.0)
    ld = torch.where(diffuse[:, None], kd * ld, 0.0)
    contrib = torch.where(emit[:, None], paths.weight[lane_a] * le, 0.0)
    contrib = contrib + paths.weight[lane_a] * ld

    # Russian roulette and the cosine-weighted continuation.
    rr = tf.uniform(tf.fold_in(k_node[act], 2)).to(dt)
    go = diffuse & ((depth <= DEPTH_MIN) | (rr > RR_FINISH))
    ndir = cosine_direction(tf.fold_in(k_node[act], 3), normal)
    boost = torch.where(depth > DEPTH_MIN,
                        1.0 / ((1.0 - RR_FINISH) * 0.5), 1.0).to(dt)
    j = n[act].clamp(max=NODES - 1)
    paths.contrib[lane_a, j] = contrib
    paths.ld_pos[lane_a, j] = go & (ld > 0.0).any(-1)
    paths.length[lane_a] = n[act] + 1
    paths.on_light[lane_a] = emit & (n[act] > 0)
    paths.pending[lane_a] = go
    paths.org[lane_a] = torch.where(go[:, None], point, o)
    paths.dir[lane_a] = torch.where(go[:, None], ndir, d)
    paths.weight[lane_a] = torch.where(
        go[:, None], paths.weight[lane_a] * kd * boost[:, None],
        paths.weight[lane_a])
    paths.src[lane_a] = torch.where(go, tid, paths.src[lane_a])
    return {"t": t, "kind": kind, "mat": mat, "normal": normal} \
        if camera else None


def _radiance(paths: _Paths):
    """Each lane's radiance from its chain, with the NEE guard: from the
    innermost node out, a node's indirect part (the nodes after it) is
    dropped when its NEE found light and the path ended on a light."""
    acc = torch.zeros_like(paths.contrib[:, 0])
    for k in range(NODES - 2, -1, -1):
        opened = paths.length >= k + 2          # node k went on
        inner = paths.contrib[:, k + 1] + acc
        killed = paths.ld_pos[:, k] & paths.on_light
        acc = torch.where(opened[:, None],
                          torch.where(killed[:, None], 0.0, inner), acc)
    return paths.contrib[:, 0] + acc


def chunk_lanes(b: int) -> int:
    """Lanes of a chunk step for a batch of b: a quarter, rounded up to a
    multiple of 128, at least 128."""
    return max(UNIT, (b // CHUNK_DIV + UNIT - 1) // UNIT * UNIT)


def sample(scene: Scene, base_key: torch.Tensor, s: int, width: int,
           height: int, share: int = 128, secondary: bool = True,
           layout=None) -> dict:
    """Sample `s` of the frame of `base_key` ((2,) int64).  Returns, in
    lane order, the camera rays' hit t, kind, material and normal, the
    sample's (B, 3) radiance "rgb" (float32), and its ray count.
    `layout`, where given, lists each chunk step's lanes in order (a lane
    order of the whole batch, of which a chunk's worth is taken)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, dt = scene.device, scene.dtype
    u, v, pids, _ = whitted.pixel_order(width, height)
    b = pids.shape[0]
    if b < 8 * UNIT:
        raise ValueError("the reference walks images of 1024 lanes or more")
    u = torch.from_numpy(u).to(dev).to(dt)
    v = torch.from_numpy(v).to(dev).to(dt)
    keys = tf.fold_in(tf.fold_in(base_key.to(dev), s),
                      torch.from_numpy(pids).to(dev).long())
    o, d = camera_rays(scene, u, v, keys, width, height)
    paths = _Paths(o, d, dt)
    lanes = torch.arange(b, device=dev)
    hits = _step(scene, paths, lanes, keys, share, True, True)
    chunk = chunk_lanes(b)
    given = list(layout or ())
    for _ in range(-(-b // chunk) * MAX_NODES):
        live = paths.pending & (paths.node < MAX_NODES)
        if not bool(live.any()):
            break
        order = (given.pop(0).to(dev).long() if given
                 else coherence_order(live, paths.org, paths.dir))
        _step(scene, paths, order[:chunk], keys, share, secondary, False)
    rgb = _radiance(paths)
    return dict(hits, rgb=rgb.float(), rays=int(paths.rays.sum()))


def film(samples) -> torch.Tensor:
    """The progressive film after the samples, in order: mean_k =
    mean_{k-1} + (x_k - mean_{k-1}) / k, from zero."""
    acc = None
    for k, rgb in enumerate(samples, 1):
        acc = torch.zeros_like(rgb) if acc is None else acc
        acc = acc + (rgb - acc) / torch.full_like(acc, float(k))
    return acc


# -- the comparison -----------------------------------------------------------

NUMBERS = ("hit_lanes_off_ppm", "pixels_off_ppm", "rays_off_ppm",
           "film_pixels_off_ppm")


def hits_off(prog: dict, ref: dict) -> torch.Tensor:
    """Camera lanes whose hit differs: kind, t (1e-4 relative), material or
    normal (1e-3), as compare.frame_counts counts them."""
    dev = ref["t"].device
    p = {k: prog[k].to(dev) for k in ("t", "kind", "mat", "normal")}
    hit = ref["kind"] != KIND_NONE
    t_ref = ref["t"].float()
    off = p["kind"].long() != ref["kind"].long()
    off |= hit & ((p["t"].float() - t_ref).abs()
                  > T_REL * t_ref.clamp(min=1.0))
    off |= hit & (p["mat"].long() != ref["mat"].long())
    off |= hit & ((p["normal"].float() - ref["normal"].float()).abs()
                  .amax(-1) > NORMAL_ABS)
    return off


def pixels_off(prog_rgb: torch.Tensor, ref_rgb: torch.Tensor) -> float:
    """The share, in ppm, of pixels off by more than PIXEL_ABS in a
    channel (or not finite)."""
    diff = (prog_rgb.to(ref_rgb.device).float() - ref_rgb.float()).abs()
    off = ~(diff <= PIXEL_ABS).all(-1)
    return PPM * int(off.sum()) / off.numel()


def sample_counts(prog: dict, ref: dict) -> dict:
    """{"hit_lanes_off_ppm", "pixels_off_ppm", "rays_off_ppm"} of one
    sample; answers of another shape than the reference's are all off."""
    shapes = all(k in prog and prog[k].shape == ref[k].shape
                 for k in ("t", "kind", "mat", "normal", "rgb"))
    if not shapes:
        return dict.fromkeys(NUMBERS[:3], PPM)
    off = hits_off(prog, ref)
    return {"hit_lanes_off_ppm": PPM * int(off.sum()) / off.numel(),
            "pixels_off_ppm": pixels_off(prog["rgb"], ref["rgb"]),
            "rays_off_ppm": PPM * abs(int(prog["rays"]) - int(ref["rays"]))
            / int(ref["rays"])}


def film_counts(prog_film, ref_film) -> dict:
    if prog_film is None or prog_film.shape != ref_film.shape:
        return {"film_pixels_off_ppm": PPM}
    return {"film_pixels_off_ppm": pixels_off(prog_film, ref_film)}
