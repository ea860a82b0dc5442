"""Film accumulation and ABGR8 packing (port of
`mobileraytracer_tpu/film.py`; reference Utils.cpp:66-90)."""
from __future__ import annotations

import torch


_M32 = 0xFFFFFFFF


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> uint32 as the JAX package's `astype(jnp.uint32)` runs on
    XLA: truncation toward zero, saturating at 0 and 2^32 - 1, NaN -> 0.
    The values are held in int64."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    x = torch.clamp(x, -1.0, 2.0 ** 33)
    return torch.clamp(x.to(torch.int64), 0, _M32)


def _pack(r, g, b) -> torch.Tensor:
    """0xFF_BB_GG_RR as int32 (the low 32 bits, as uint32 -> int32)."""
    packed = 0xFF000000 | (b << 16) | (g << 8) | r
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                       packed).to(torch.int32)


def quantize_abgr(rgb: torch.Tensor) -> torch.Tensor:
    """Float RGB -> packed int32 0xFF_BB_GG_RR, truncating like the
    reference's `static_cast<uint32>(sample * 255)`."""
    q = torch.clamp(_to_u32(rgb * 255.0), 0, 255)
    return _pack(q[..., 0], q[..., 1], q[..., 2])


def unpack_abgr(bitmap: torch.Tensor) -> torch.Tensor:
    """Packed int32 ABGR -> float RGB in [0, 1]."""
    b = bitmap.to(torch.int64) & 0xFFFFFFFF
    r = (b & 0xFF).to(torch.float32)
    g = ((b >> 8) & 0xFF).to(torch.float32)
    bl = ((b >> 16) & 0xFF).to(torch.float32)
    return torch.stack([r, g, bl], -1) / 255.0


def incremental_avg_float(accum: torch.Tensor, sample_rgb: torch.Tensor,
                          num_sample) -> torch.Tensor:
    """mean_k = mean_{k-1} + (x - mean_{k-1}) / k.  The divisor is a full
    tensor: CUDA turns division by a host scalar into a multiplication by
    its reciprocal, which is not the JAX package's IEEE division."""
    k = torch.full_like(accum, float(num_sample))
    return accum + (sample_rgb - accum) / k


def incremental_avg_int(bitmap: torch.Tensor, sample_rgb: torch.Tensor,
                        num_sample: int) -> torch.Tensor:
    """The reference's integer-packed progressive mean (Utils.cpp:66-90):
    each channel updates as ((n - 1) * last + trunc(sample * 255)) // n in
    uint32 arithmetic (emulated in int64, wrapping at 2^32), clamped to
    255 and packed as 0xFF | B << 16 | G << 8 | R."""
    avg = bitmap.to(torch.int64) & _M32
    n = int(num_sample)
    last = torch.stack([avg & 0xFF, (avg >> 8) & 0xFF, (avg >> 16) & 0xFF],
                       -1)
    cur = (((n - 1) * last + _to_u32(sample_rgb * 255.0)) & _M32) // n
    cur = torch.clamp(cur, max=255)
    return _pack(cur[..., 0], cur[..., 1], cur[..., 2])


def is_uniform(bitmap: torch.Tensor) -> bool:
    """The reference's engine-test oracle: "bitmap is not uniform after a
    render" (ShaderTestEngine.cpp:46-48)."""
    flat = bitmap.reshape(-1)
    return bool((flat == flat[0]).all())
