"""Primary-ray generation for perspective and orthographic cameras (port
of `mobileraytracer_tpu/cameras.py`; reference Perspective.cpp:16-46,
Orthographic.cpp:16-24).  u = x / width, v = y / height (pixel corners).
"""
from __future__ import annotations

import torch

from .types import CAMERA_ORTHOGRAPHIC, CAMERA_PERSPECTIVE, Camera

QUARTER_PI = 0.7853981633974483


def fast_arctan(x: torch.Tensor) -> torch.Tensor:
    """The reference's polynomial arctan (Perspective.cpp:40-46)."""
    ax = torch.abs(x)
    return QUARTER_PI * x - (x * (ax - 1.0)) * (0.2447 + 0.0663 * ax)


def generate_rays(camera: Camera, u: torch.Tensor, v: torch.Tensor,
                  dev_u: torch.Tensor, dev_v: torch.Tensor):
    """(origins, directions), each (B, 3), for (B,) pixel coordinates.
    Both camera models are evaluated and selected, as in the JAX package."""
    u = u.to(torch.float32)
    v = v.to(torch.float32)
    right_p = fast_arctan(camera.param_u * (u - 0.5)) + dev_u
    up_p = fast_arctan(camera.param_v * (0.5 - v)) + dev_v
    dest = (camera.position + camera.direction
            + camera.right * right_p[..., None]
            + camera.up * up_p[..., None])
    dir_p = dest - camera.position
    norm = torch.sqrt(dir_p[..., 0:1] * dir_p[..., 0:1]
                      + dir_p[..., 1:2] * dir_p[..., 1:2]
                      + dir_p[..., 2:3] * dir_p[..., 2:3])
    dir_p = dir_p / norm
    org_p = camera.position.expand_as(dir_p)

    right_o = (u - 0.5) * camera.param_u
    up_o = (0.5 - v) * camera.param_v
    org_o = (camera.position
             + camera.right * (right_o + dev_u)[..., None]
             + camera.up * (up_o + dev_v)[..., None])
    dir_o = camera.direction.expand_as(org_o)

    is_persp = camera.kind == CAMERA_PERSPECTIVE
    return (torch.where(is_persp, org_p, org_o),
            torch.where(is_persp, dir_p, dir_o))


__all__ = ["fast_arctan", "generate_rays", "CAMERA_PERSPECTIVE",
           "CAMERA_ORTHOGRAPHIC"]
