"""Shared shading math: material binding, reflection and refraction,
Fresnel, next-event estimation (port of
`mobileraytracer_tpu/shaders/common.py`).  All functions work on ray
batches."""
from __future__ import annotations

import torch

from .. import constants as C
from .. import sampling
from ..ops import intersect
from ..types import Hit, Scene, device_const
from ..utils.metrics import span

_X = (1.0, 0.0, 0.0)


def _vec(v, like):
    return device_const(tuple(v), like.dtype, like.device)


def _sum3(a):
    """a[..., 0] + a[..., 1] + a[..., 2], summed in that order."""
    return a[..., 0] + a[..., 1] + a[..., 2]


def park_dead_lanes(o: torch.Tensor, d: torch.Tensor, live: torch.Tensor):
    """Dead lanes duplicate the first live lane of their ST-lane subtile, so
    the traversal's interval hulls stay the live hull; subtiles with no
    live lane park at the far sentinel and find no candidates.  The
    duplicates' results are discarded by the caller."""
    b = o.shape[0]
    st = C.SUBTILE
    far = torch.full_like(o, C.FAR_SENTINEL)
    x = _vec(_X, d).expand_as(d)
    if b % st != 0:
        return (torch.where(live[:, None], o, far),
                torch.where(live[:, None], d, x))
    nt = b // st
    live_t = live.reshape(nt, st)
    pick = torch.argmax(live_t.to(torch.int32), dim=1)   # first live lane
    any_live = live_t.any(1)
    rows = torch.arange(nt, device=o.device)
    o_rep = o.reshape(nt, st, 3)[rows, pick]
    d_rep = d.reshape(nt, st, 3)[rows, pick]
    o_rep = torch.where(any_live[:, None], o_rep, C.FAR_SENTINEL)
    d_rep = torch.where(any_live[:, None], d_rep, _vec(_X, d))
    # The fills are a layout artifact and carry no gradient: a dead lane's
    # cotangent (NaN from inf * 0 where a chain is masked only at its end)
    # would otherwise flow into the live lane it copies.
    o_fill = o_rep.repeat_interleave(st, 0).detach()
    d_fill = d_rep.repeat_interleave(st, 0).detach()
    return (torch.where(live[:, None], o, o_fill),
            torch.where(live[:, None], d, d_fill))


def has_positive(v: torch.Tensor) -> torch.Tensor:
    """Any component > 0 (reference Utils.hpp hasPositiveValue)."""
    return (v > 0.0).any(-1)


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """glm::reflect: i - 2 dot(n, i) n."""
    return i - 2.0 * _sum3(n * i)[..., None] * n


def refract(i: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """glm::refract; returns (direction, valid), valid False on total
    internal reflection (direction zero).  sqrt(k) is taken as 0 at k == 0
    without its infinite derivative there, so a masked lane's zero
    cotangent stays zero (the JAX package's `sqrt(where(k >= 0, k, 1))`
    turns it into NaN, e.g. for a zero direction at eta 1)."""
    cosi = _sum3(n * i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    valid = k >= 0.0
    pos = k > 0.0
    root = torch.where(pos, torch.sqrt(torch.where(pos, k, 1.0)), 0.0)
    d = eta[..., None] * i - (eta * cosi + root)[..., None] * n
    return torch.where(valid[..., None], d, 0.0), valid


def fresnel(i: torch.Tensor, n: torch.Tensor, ior: torch.Tensor):
    """Fresnel reflectance (reference Utils.cpp:206-229), with the
    reference's swapped clamp, cosi = min(1, dot(I, N))."""
    cosi = torch.clamp(_sum3(i * n), max=1.0)
    one = torch.ones_like(ior)
    etai = torch.where(cosi > 0, ior, one)
    etat = torch.where(cosi > 0, one, ior)
    sint = etai / etat * torch.sqrt(torch.clamp(1.0 - cosi * cosi, min=0.0))
    cost = torch.sqrt(torch.clamp(1.0 - sint * sint, min=0.0))
    acosi = torch.abs(cosi)
    rs = (etat * acosi - etai * cost) / (etat * acosi + etai * cost)
    rp = (etai * acosi - etat * cost) / (etai * acosi + etat * cost)
    kr = (rs * rs + rp * rp) / torch.full_like(rs, 2.0)
    return torch.where(sint >= 1.0, 1.0, kr)


def sample_atlas(scene: Scene, tex_id: torch.Tensor,
                 uv: torch.Tensor) -> torch.Tensor:
    """Nearest texel (Texture.cpp:37-48): x = int(u W), y = int(v H)."""
    atlas = scene.atlas
    tid = torch.clamp(tex_id, 0, atlas.num_textures - 1).long()
    size = atlas.sizes[tid]
    h = size[..., 0].to(torch.float32)
    w = size[..., 1].to(torch.float32)
    x = torch.minimum(torch.clamp((uv[..., 0] * w).to(torch.int32), min=0),
                      size[..., 1] - 1)
    y = torch.minimum(torch.clamp((uv[..., 1] * h).to(torch.int32), min=0),
                      size[..., 0] - 1)
    return atlas.data[tid, y.long(), x.long()]


def bind_material(scene: Scene, hit: Hit):
    """Material at each hit (Shader.cpp:112-121): the material row, Kd from
    the texture where the hit has texcoords, and the light's radiance as
    Le on area-light hits.  Returns (le, kd, ks, kt, ior)."""
    mats = scene.materials
    mid = torch.clamp(hit.mat_id, 0, mats.capacity - 1).long()
    has_mat = (hit.mat_id >= 0)[:, None]
    le = torch.where(has_mat, mats.le[mid], 0.0)
    kd = torch.where(has_mat, mats.kd[mid], 0.0)
    ks = torch.where(has_mat, mats.ks[mid], 0.0)
    kt = torch.where(has_mat, mats.kt[mid], 0.0)
    ior = torch.where(has_mat[:, 0], mats.ior[mid], 1.0)
    tex_id = torch.where(has_mat[:, 0], mats.tex_id[mid], -1)
    textured = (tex_id >= 0) & (hit.uv[:, 0] >= 0) & (hit.uv[:, 1] >= 0)
    kd = torch.where(textured[:, None], sample_atlas(scene, tex_id, hit.uv),
                     kd)
    le = torch.where((hit.prim_kind == C.PRIM_LIGHT)[:, None], hit.light_le,
                     le)
    return le, kd, ks, kt, ior


def _light_samples(scene: Scene, k_pick, k_point):
    """(light position, radiance, kind) for each (pick, point) key pair."""
    lights = scene.lights
    lidx = sampling.pick_light(k_pick, lights.num).long()
    kind = lights.kind[lidx]
    p_area = sampling.sample_triangle_point(
        k_point, lights.tri_a[lidx], lights.tri_ab[lidx],
        lights.tri_ac[lidx])
    lpos = torch.where((kind == C.LIGHT_AREA)[:, None], p_area,
                       lights.position[lidx])
    return lpos, lights.radiance[lidx], kind


@span("walker.direct_lighting")
def direct_lighting(scene: Scene, hit: Hit, keys: torch.Tensor,
                    samples_light: int, shadows: bool, occluded_fn=None,
                    mask=None, share_mask=None, share_width: int = 16,
                    coherent: bool = False, reverse: bool = False,
                    share_all: bool = False):
    """Next-event estimation for diffuse hits (Whitted.cpp:37-65).  Per
    sample: a uniform light pick, its position or a uniform point on it,
    radiance * cos(N, L) when above the horizon and (with `shadows`)
    unoccluded.  Returns the summed radiance and the per-lane count of
    shadow rays cast.

    Each `share_width`-lane group shares one pick and point drawn from its
    first lane's key: for every lane with `share_all` (the draws then run
    on the group's first keys only), otherwise for lanes in `share_mask`
    (all lanes when it is None).  `reverse` traces each shadow segment
    from the light point toward the surface, ending EPSILON short of it.
    `coherent` goes to `occluded_fn`: it marks the reversed shared-light
    bundles (engine.make_tracer gives them block_traversal.SHADOW_SEL).
    """
    b = hit.t.shape[0]
    dev = hit.t.device
    total = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    shadow_rays = torch.zeros((b,), dtype=torch.int32, device=dev)
    has_lights = scene.lights.num > 0
    if occluded_fn is None:
        occluded_fn = lambda *a, **k: intersect.occluded_naive(*a)
    origin = hit.point

    share_all = share_all and b % share_width == 0
    if share_all:
        sw = share_width
        keys_ds = keys.reshape(b // sw, sw, 2)[:, 0]

    for s in range(samples_light):
        if share_all:
            lpos_ds, rad_ds, kind_ds = _light_samples(
                scene, sampling.fold_in(keys_ds, 2 * s),
                sampling.fold_in(keys_ds, 2 * s + 1))
            lpos = lpos_ds.repeat_interleave(sw, 0)
            radiance = rad_ds.repeat_interleave(sw, 0)
        else:
            k_pick = sampling.fold_in(keys, 2 * s)
            k_point = sampling.fold_in(keys, 2 * s + 1)
            st = share_width
            if b % st == 0:
                def subtile_share(k):
                    shared = k.reshape(b // st, st, 2)[:, 0]
                    shared = shared.repeat_interleave(st, 0)
                    if share_mask is None:
                        return shared
                    return torch.where(share_mask[:, None], shared, k)
                k_pick = subtile_share(k_pick)
                k_point = subtile_share(k_point)
            lpos, radiance, _ = _light_samples(scene, k_pick, k_point)

        to_light = lpos - origin
        dist = torch.sqrt(torch.clamp(_sum3(to_light * to_light), min=1e-30))
        ldir = to_light / torch.clamp(dist[:, None], min=1e-30)
        cos_nl = _sum3(hit.normal * ldir)
        visible = cos_nl > 0.0
        if shadows:
            shadow_rays = shadow_rays + (visible & has_lights).to(torch.int32)
            live = visible if mask is None else (mask & visible)
            if reverse:
                org_s, dir_s = lpos, -ldir
                md_s = torch.clamp(dist - C.EPSILON, min=0.0)
            else:
                org_s, dir_s, md_s = origin, ldir, dist
            org_t, dir_t = park_dead_lanes(org_s, dir_s, live)
            blocked = occluded_fn(scene, org_t, dir_t, md_s, hit.prim_kind,
                                  hit.prim_id, coherent=coherent)
            visible = visible & ~blocked
        contrib = radiance * cos_nl[:, None]
        total = total + torch.where((visible & has_lights)[:, None], contrib,
                                    0.0)
    return total, shadow_rays
