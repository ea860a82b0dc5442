"""Converts the JAX package's state, given as mappings of numpy arrays,
into the port's tensors (the port's counterpart of loading weights).

Each function takes a mapping from field name to array, e.g.
`{f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}`
for a flax dataclass of the JAX package, so this module never imports
jax.  Nested scene parts are mappings too.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .ops.block_traversal import BlockGrid
from .types import (Camera, Lights, Materials, Planes, Scene, Spheres,
                    TextureAtlas, Triangles)


def _t(a, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _fields(cls, arrays: Mapping, device=None):
    names = [n for n in cls.__dataclass_fields__]
    return cls(**{n: _t(arrays[n], device) for n in names})


def scene_from_arrays(arrays: Mapping, device=None) -> Scene:
    """`arrays` maps "triangles", "spheres", "planes", "materials",
    "lights" and "atlas" to mappings of their fields, and optionally "bvh"
    to a PallasGrid's mapping (see grid_from_arrays)."""
    bvh = arrays.get("bvh")
    return Scene(
        triangles=_fields(Triangles, arrays["triangles"], device),
        spheres=_fields(Spheres, arrays["spheres"], device),
        planes=_fields(Planes, arrays["planes"], device),
        materials=_fields(Materials, arrays["materials"], device),
        lights=_fields(Lights, arrays["lights"], device),
        atlas=_fields(TextureAtlas, arrays["atlas"], device),
        bvh=None if bvh is None else grid_from_arrays(bvh, device))


def camera_from_arrays(arrays: Mapping, device=None) -> Camera:
    return _fields(Camera, arrays, device)


def grid_from_arrays(arrays: Mapping, device=None) -> BlockGrid:
    """A JAX PallasGrid's fields."""
    return BlockGrid(
        super_lo=_t(arrays["super_lo"], device),
        super_hi=_t(arrays["super_hi"], device),
        blocks_packed=_t(arrays["blocks_packed"], device),
        tb=_t(arrays["tb"], device), tw=_t(arrays["tw"], device),
        tri_attr=_t(arrays["tri_attr"], device),
        top_s=int(arrays["top_s"]), top_m=int(arrays["top_m"]),
        t_margin=float(arrays["t_margin"]))
