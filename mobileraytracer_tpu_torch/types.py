"""Scene, camera and hit-record tensor dataclasses, and the run config
(port of `mobileraytracer_tpu/types.py`).

Geometry is kept as structure-of-arrays tensors padded to a capacity with
a validity mask, exactly as the JAX package lays it out, so the tensors
convert one to one (see convert.py).  Every dataclass moves between
devices with `.to(device)`.  The entry points that place a scene
(`Renderer`, `block_traversal.build`) take their device from
`entry_device`: the CUDA card unless the caller asks for another.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import constants as C


def entry_device(device=None) -> torch.device:
    """The device an entry point places its scene on: `device`, or the
    CUDA card when it is None.  Raises when that is a CUDA device and
    PyTorch has none; pass device="cpu" to run on the CPU, where the
    kernels' plain versions take over."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mobileraytracer_tpu_torch runs on a CUDA device unless asked "
            "otherwise, and torch.cuda.is_available() is false; pass "
            "device=\"cpu\" to run on the CPU")
    return dev


class TensorData:
    """Mixin for dataclasses of tensors (and nested such dataclasses):
    `.to(device)` moves every tensor field, `.replace(**kw)` copies,
    `.detach()` takes every tensor off the autograd tape."""

    def to(self, device):
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorData)):
                v = v.to(device)
            kw[f.name] = v
        return dataclasses.replace(self, **kw)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def detach(self):
        """A copy whose tensors, nested ones included, are off the
        autograd tape."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorData)):
                v = v.detach()
            kw[f.name] = v
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Triangles(TensorData):
    """SoA triangles (reference Shapes/Triangle.hpp:18-27)."""
    point_a: torch.Tensor    # (N, 3) f32
    ab: torch.Tensor         # (N, 3) f32
    ac: torch.Tensor         # (N, 3) f32
    normal_a: torch.Tensor   # (N, 3) f32
    normal_b: torch.Tensor
    normal_c: torch.Tensor
    uv_a: torch.Tensor       # (N, 2) f32, -1 when untextured
    uv_b: torch.Tensor
    uv_c: torch.Tensor
    mat_id: torch.Tensor     # (N,) i32
    valid: torch.Tensor      # (N,) bool

    @property
    def capacity(self) -> int:
        return self.point_a.shape[0]


@dataclasses.dataclass
class Spheres(TensorData):
    center: torch.Tensor     # (N, 3) f32
    sq_radius: torch.Tensor  # (N,) f32
    mat_id: torch.Tensor     # (N,) i32
    valid: torch.Tensor      # (N,) bool

    @property
    def capacity(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass
class Planes(TensorData):
    point: torch.Tensor      # (N, 3) f32
    normal: torch.Tensor     # (N, 3) f32 unit
    mat_id: torch.Tensor     # (N,) i32
    valid: torch.Tensor      # (N,) bool

    @property
    def capacity(self) -> int:
        return self.point.shape[0]


@dataclasses.dataclass
class Materials(TensorData):
    le: torch.Tensor         # (M, 3) f32
    kd: torch.Tensor
    ks: torch.Tensor
    kt: torch.Tensor
    ior: torch.Tensor        # (M,) f32
    tex_id: torch.Tensor     # (M,) i32

    @property
    def capacity(self) -> int:
        return self.le.shape[0]


@dataclasses.dataclass
class Lights(TensorData):
    """Point lights and triangle area lights in one table."""
    kind: torch.Tensor       # (L,) i32
    position: torch.Tensor   # (L, 3) f32
    tri_a: torch.Tensor      # (L, 3) f32
    tri_ab: torch.Tensor
    tri_ac: torch.Tensor
    radiance: torch.Tensor   # (L, 3) f32
    valid: torch.Tensor      # (L,) bool
    num: torch.Tensor        # () i32

    @property
    def capacity(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass
class TextureAtlas(TensorData):
    data: torch.Tensor       # (T, H, W, 3) f32
    sizes: torch.Tensor      # (T, 2) i32 (height, width)

    @property
    def num_textures(self) -> int:
        return self.data.shape[0]


def empty_texture_atlas() -> TextureAtlas:
    return TextureAtlas(data=torch.zeros((1, 1, 1, 3), dtype=torch.float32),
                        sizes=torch.ones((1, 2), dtype=torch.int32))


@dataclasses.dataclass
class Scene(TensorData):
    triangles: Triangles
    spheres: Spheres
    planes: Planes
    materials: Materials
    lights: Lights
    atlas: TextureAtlas
    # The block grid of ops/block_traversal.py once `build` has run.
    bvh: Optional[TensorData] = None

    @property
    def device(self) -> torch.device:
        return self.triangles.point_a.device


@dataclasses.dataclass
class Camera(TensorData):
    """Camera basis as in the reference Camera.cpp:14-18 (up and right
    deliberately not re-normalized)."""
    kind: torch.Tensor       # () i32: 0 perspective, 1 orthographic
    position: torch.Tensor   # (3,) f32
    direction: torch.Tensor  # (3,) f32
    right: torch.Tensor      # (3,) f32
    up: torch.Tensor         # (3,) f32
    param_u: torch.Tensor    # () f32
    param_v: torch.Tensor    # () f32


CAMERA_PERSPECTIVE = 0
CAMERA_ORTHOGRAPHIC = 1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def _cross3(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def make_camera_basis(position, look_at, up):
    position, look_at, up = _f32(position), _f32(look_at), _f32(up)
    direction = look_at - position
    norm = torch.sqrt(direction[0] * direction[0]
                      + direction[1] * direction[1]
                      + direction[2] * direction[2])
    direction = direction / norm
    right = _cross3(up, direction)
    up_out = _cross3(direction, right)
    return position, direction, right, up_out


def perspective_camera(position, look_at, up, hfov_deg: float,
                       vfov_deg: float) -> Camera:
    position, direction, right, up_out = make_camera_basis(position, look_at,
                                                           up)
    return Camera(kind=torch.tensor(CAMERA_PERSPECTIVE, dtype=torch.int32),
                  position=position, direction=direction, right=right,
                  up=up_out, param_u=_f32(np.deg2rad(hfov_deg)),
                  param_v=_f32(np.deg2rad(vfov_deg)))


def orthographic_camera(position, look_at, up, size_h: float,
                        size_v: float) -> Camera:
    position, direction, right, up_out = make_camera_basis(position, look_at,
                                                           up)
    return Camera(kind=torch.tensor(CAMERA_ORTHOGRAPHIC, dtype=torch.int32),
                  position=position, direction=direction, right=right,
                  up=up_out, param_u=_f32(size_h / 2.0),
                  param_v=_f32(size_v / 2.0))


@dataclasses.dataclass
class Hit(TensorData):
    """Closest-hit records (reference Intersection.hpp:14-55); a miss has
    t == RAY_LENGTH_MAX and prim_kind == PRIM_NONE."""
    t: torch.Tensor          # (B,) f32
    prim_kind: torch.Tensor  # (B,) i32
    prim_id: torch.Tensor    # (B,) i32
    mat_id: torch.Tensor     # (B,) i32
    point: torch.Tensor      # (B, 3) f32
    normal: torch.Tensor     # (B, 3) f32
    uv: torch.Tensor         # (B, 2) f32
    light_le: torch.Tensor   # (B, 3) f32

    @property
    def missed(self) -> torch.Tensor:
        return self.prim_kind == C.PRIM_NONE


def make_miss(batch_shape, device=None) -> Hit:
    b = tuple(batch_shape)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    normal = torch.zeros(b + (3,), **f32)
    normal[..., 2] = 1.0
    return Hit(t=torch.full(b, C.RAY_LENGTH_MAX, **f32),
               prim_kind=torch.zeros(b, **i32),
               prim_id=torch.full(b, -1, **i32),
               mat_id=torch.full(b, -1, **i32),
               point=torch.zeros(b + (3,), **f32), normal=normal,
               uv=torch.full(b + (2,), -1.0, **f32),
               light_le=torch.zeros(b + (3,), **f32))


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static run parameters; a copy of the JAX package's RenderConfig
    (mobileraytracer_tpu/types.py:300-395), whose comments explain each
    knob.  Field names and defaults are the same so one config value
    describes both renders."""

    width: int = 256
    height: int = 256
    spp: int = 1
    samples_light: int = 1
    shader: int = C.SHADER_WHITTED
    accelerator: int = C.ACC_NAIVE
    scene_id: int = C.SCENE_CORNELL
    depth_max: int = C.RAY_DEPTH_MAX
    depth_min: int = C.RAY_DEPTH_MIN
    repeats: int = 1
    seed: int = 0
    max_walk_iters: Optional[int] = None
    stack_size: int = 8
    accumulation: str = "float32"
    pixel_jitter: Optional[bool] = None
    pixel_sampler: str = "prng"
    # Lane-group width sharing one NEE light pick/point on the first
    # bounce; with `nee_share_secondary` on every bounce too, and then the
    # image follows the compacted wavefront's chunk layout.
    nee_share: int = 16
    nee_reverse: bool = True
    nee_share_secondary: bool = False
    walk_chunk_div: Optional[int] = None

    def resolved_max_walk_iters(self) -> int:
        if self.max_walk_iters is not None:
            return self.max_walk_iters
        return 2 * (self.depth_max + 1)

    def resolved_pixel_jitter(self) -> bool:
        if self.pixel_jitter is not None:
            return self.pixel_jitter
        return self.spp > 1

    def rounded(self) -> "RenderConfig":
        """Width/height rounded down to a multiple of 16 (reference Qt
        main.cpp:36-44)."""
        def round_down(v: int) -> int:
            rest = v % C.TILE_MULTIPLE
            return v - rest if rest > 1 else v
        return dataclasses.replace(
            self, width=round_down(self.width),
            height=round_down(self.height))


def scene_num_primitives(scene: Scene) -> dict:
    return {
        "triangles": int(scene.triangles.valid.sum()),
        "spheres": int(scene.spheres.valid.sum()),
        "planes": int(scene.planes.valid.sum()),
        "lights": int(scene.lights.num),
    }
