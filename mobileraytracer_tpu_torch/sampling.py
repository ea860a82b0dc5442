"""Deterministic, counter-based random sampling (port of
`mobileraytracer_tpu/sampling.py`).

Keys are (..., 2) int64 tensors of threefry words (see threefry.py), so
every draw is bit-identical to the JAX package at the same key: each
function here is the batched form of the JAX function that `jax.vmap`
maps over a key batch.
"""
from __future__ import annotations

import torch

from . import threefry
from .types import device_const

TWO_PI = 6.283185307179586

# Purpose tags keep independent streams decorrelated: the JAX package's
# table.  The pixel samplers take PURPOSE_PIXEL_JITTER; the walker passes
# its own tags (shaders/engine.py), as the JAX package's walker does.
PURPOSE_PIXEL_JITTER = 0
PURPOSE_LIGHT_PICK = 1
PURPOSE_LIGHT_POINT = 2
PURPOSE_HEMISPHERE = 3
PURPOSE_RUSSIAN_ROULETTE = 4
PURPOSE_LOBE_PICK = 5

fold_in = threefry.fold_in
prng_key = threefry.prng_key
uniform = threefry.uniform


def ray_key(base_key: torch.Tensor, pixel_id: torch.Tensor,
            sample_id) -> torch.Tensor:
    """Key for each (pixel, spp-sample) pair; (B, 2) for (B,) pixel ids."""
    return fold_in(fold_in(base_key, sample_id), pixel_id)


def event_key(keys: torch.Tensor, bounce, purpose: int) -> torch.Tensor:
    """Key of one event per ray; `bounce` is an int or a (B,) tensor."""
    return fold_in(fold_in(keys, bounce), purpose)


def halton(index: torch.Tensor, base: int = 2) -> torch.Tensor:
    """Halton radical inverse of each uint32 index (held in int64), the
    reference's haltonSequence (Utils.cpp:43-53), as the JAX package
    computes it: 32 fixed passes in float32.  XLA compiles the JAX
    package's `fraction / base` into a product with the float32 reciprocal
    of the constant base, so this does the same (bit for bit, on the CPU
    and the card alike)."""
    idx = index.to(torch.int64) & 0xFFFFFFFF
    inv_base = torch.tensor(1.0 / base, dtype=torch.float32,
                            device=idx.device)
    fraction = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    value = torch.zeros_like(fraction)
    for _ in range(32):
        active = idx > 0
        fraction = torch.where(active, fraction * inv_base, fraction)
        value = torch.where(active,
                            value + fraction * (idx % base).to(torch.float32),
                            value)
        idx = torch.where(active, idx // base, idx)
    return value


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _sumsq(v):
    return (v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
            + v[..., 2:3] * v[..., 2:3])


def cosine_sample_hemisphere(keys: torch.Tensor,
                             normal: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction around each normal (reference
    Shader.cpp:188-216); `keys` (B, 2), `normal` (B, 3)."""
    r = uniform(keys, 2)
    phi = TWO_PI * r[..., 0]
    r2 = r[..., 1]
    cos_theta = torch.sqrt(r2)
    nsq = _sumsq(normal)
    z = device_const((0.0, 0.0, 1.0), normal.dtype, normal.device)
    normal = torch.where(nsq > 0.25, normal, z.expand_as(normal))
    ey = device_const((0.0, 1.0, 0.0), normal.dtype,
                      normal.device).expand_as(normal)
    ex = device_const((1.0, 0.0, 0.0), normal.dtype,
                      normal.device).expand_as(normal)
    helper = torch.where(torch.abs(normal[..., :1]) > 0.1, ey, ex)
    u = _cross(helper, normal)
    u = u / torch.sqrt(torch.clamp(_sumsq(u), min=1e-20))
    v = _cross(normal, u)
    d = (u * (torch.cos(phi) * cos_theta)[..., None]
         + v * (torch.sin(phi) * cos_theta)[..., None]
         + normal * torch.sqrt(torch.clamp(1.0 - r2, min=0.0))[..., None])
    return d / torch.sqrt(torch.clamp(_sumsq(d), min=1e-20))


def pick_light(keys: torch.Tensor, num_lights: torch.Tensor) -> torch.Tensor:
    """Uniform light index floor(u * numLights * 0.99999) per key
    (reference Shader.cpp:223-233); int32."""
    u = uniform(keys)
    n = num_lights.to(torch.float32)
    idx = torch.floor(u * n * 0.99999).to(torch.int32)
    hi = torch.clamp(num_lights.to(torch.int32) - 1, min=0)
    return torch.minimum(torch.clamp(idx, min=0), hi)


def sample_triangle_point(keys: torch.Tensor, tri_a, tri_ab,
                          tri_ac) -> torch.Tensor:
    """Uniform point on each triangle, folded parallelogram (reference
    AreaLight.cpp:17-26); rows of `tri_*` pair with the keys."""
    rs = uniform(keys, 2)
    r, s = rs[..., 0:1], rs[..., 1:2]
    flip = (r + s) >= 1.0
    r = torch.where(flip, 1.0 - r, r)
    s = torch.where(flip, 1.0 - s, s)
    return tri_a + r * tri_ab + s * tri_ac
