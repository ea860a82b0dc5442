"""Differentiable geometry: vertex-position gradients (port of
`mobileraytracer_tpu/diff`)."""
from .geom import (factors_of_point, rays_from_factors,  # noqa: F401
                   scene_with_vertices, triangle_vertices, vertex_grad)

__all__ = ["factors_of_point", "rays_from_factors", "scene_with_vertices",
           "triangle_vertices", "vertex_grad"]
