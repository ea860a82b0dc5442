"""Converts the JAX package's state, given as mappings of numpy arrays,
into the port's tensors (the port's counterpart of loading weights):
scenes, cameras, block grids, material parameters, and optax's Adam
state to and from torch.optim.Adam's.

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


def params_from_arrays(arrays: Mapping, device=None) -> dict:
    """Material parameters ({"kd": ..., ...} of the JAX package's
    `material_params` or a recovery state's params) as tensors."""
    return {k: _t(v, device).to(torch.float32) for k, v in arrays.items()}


def adam_from_optax(opt: torch.optim.Optimizer, params: dict, count,
                    mu: Mapping, nu: Mapping) -> None:
    """Loads optax's Adam state (`ScaleByAdamState` count, mu, nu; each of
    mu and nu keyed like `params`) into `opt`, a torch.optim.Adam over
    params' tensors: count -> step, mu -> exp_avg, nu -> exp_avg_sq.  A
    count of 0 leaves `opt` fresh, as PyTorch keeps no state before its
    first step."""
    opt.state.clear()
    if int(count) == 0:
        return
    for k, p in params.items():
        opt.state[p] = {
            "step": torch.tensor(float(int(count)), dtype=torch.float32),
            "exp_avg": _t(mu[k], p.device).to(torch.float32),
            "exp_avg_sq": _t(nu[k], p.device).to(torch.float32)}


def adam_to_optax(opt: torch.optim.Optimizer, params: dict):
    """(count, mu, nu) as numpy, optax's `ScaleByAdamState` of `opt`'s
    state over `params` (zeros before the first step)."""
    count, mu, nu = 0, {}, {}
    for k, p in params.items():
        st = opt.state.get(p, {})
        zero = np.zeros(tuple(p.shape), np.float32)
        if st:
            count = int(st["step"])
        mu[k] = st["exp_avg"].detach().cpu().numpy() if st else zero
        nu[k] = st["exp_avg_sq"].detach().cpu().numpy() if st else zero
    return np.asarray(count, np.int32), mu, nu
