"""Film accumulation and ABGR8 packing (port of
`mobileraytracer_tpu/film.py`; reference Utils.cpp:66-90)."""
from __future__ import annotations

import torch


def quantize_abgr(rgb: torch.Tensor) -> torch.Tensor:
    """Float RGB -> packed int32 0xFF_BB_GG_RR, truncating like the
    reference's `static_cast<uint32>(sample * 255)`."""
    q = torch.clamp((rgb * 255.0).to(torch.int64), 0, 255)
    packed = (0xFF000000 | (q[..., 2] << 16) | (q[..., 1] << 8) | q[..., 0])
    # Reinterpret the low 32 bits as int32, as uint32 -> int32 does.
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                       packed).to(torch.int32)


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
