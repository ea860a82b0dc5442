"""Debug guards and structured failure detection (port of
`mobileraytracer_tpu/utils/guards.py`), the analogues of the reference's
ctor asserts, sanitizer builds and LowMemoryException
(TestAABB.cpp:27-32, Utils.cpp:237-303, JNI_layer.cpp:114-126):

* `validate_scene`: host-side validation of the scene's geometry and
  materials, raising `SceneError`;
* `checked_render`: a validated frame whose image must be finite, raising
  `RenderError`;
* `device_oom_guard`: turns `torch.cuda.OutOfMemoryError` into
  `LowDeviceMemoryError` with the card's free and total memory.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


class RenderError(RuntimeError):
    """A rendered frame holds a non-finite value."""


class SceneError(ValueError):
    """Invalid scene geometry or materials (the ctor-assert tier)."""


class LowDeviceMemoryError(MemoryError):
    """A device allocation failed (the LowMemoryException analogue)."""


def _np(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def _finite(name: str, a, where=None) -> None:
    a = _np(a)
    bad = ~np.isfinite(a)
    if where is not None:
        bad = bad & _np(where).reshape(bad.shape[:1] + (1,) * (bad.ndim - 1))
    if bad.any():
        raise SceneError(f"scene.{name} has {int(bad.sum())} non-finite values")


def validate_scene(scene) -> None:
    """Raises SceneError on the inputs the reference death-tests: non-finite
    vertices, sphere centres or plane points of valid primitives,
    non-positive sphere radii, degenerate plane normals, non-finite
    materials."""
    tri = scene.triangles
    _finite("triangles.point_a", tri.point_a, tri.valid)
    _finite("triangles.ab", tri.ab, tri.valid)
    _finite("triangles.ac", tri.ac, tri.valid)
    sph = scene.spheres
    _finite("spheres.center", sph.center, sph.valid)
    if (_np(sph.valid) & ~(_np(sph.sq_radius) > 0)).any():
        raise SceneError("spheres.sq_radius must be positive for valid spheres")
    pl = scene.planes
    _finite("planes.point", pl.point, pl.valid)
    nl = np.linalg.norm(_np(pl.normal), axis=-1)
    if (_np(pl.valid) & ~(np.isfinite(nl) & (nl >= 1e-6))).any():
        raise SceneError("planes.normal must be finite and non-degenerate")
    for f in ("kd", "ks", "kt", "le"):
        _finite(f"materials.{f}", getattr(scene.materials, f))


def checked_render(scene, camera, config, base_key, max_point=None) -> dict:
    """`render_frame` on a validated scene, raising RenderError when the
    image holds a NaN or an infinity.

    The JAX package compiles the frame under `checkify` float checks,
    which stop at the first NaN, infinity or division by zero with its
    source location.  PyTorch has no counterpart, so this checks the
    scene before and the image after: a non-finite value that the shading
    masks out of the image goes unseen here."""
    from ..renderer import render_frame
    validate_scene(scene)
    out = render_frame(scene, camera, config, base_key, max_point)
    bad = int((~torch.isfinite(out["image"])).sum())
    if bad:
        raise RenderError(f"render produced {bad} non-finite image values")
    return out


@contextlib.contextmanager
def device_oom_guard():
    """Turns torch.cuda.OutOfMemoryError into LowDeviceMemoryError with
    the card's free and total memory (the printFreeMemory analogue)."""
    try:
        yield
    except torch.cuda.OutOfMemoryError as e:
        free = total = 0
        if torch.cuda.is_available():
            free, total = torch.cuda.mem_get_info()
        raise LowDeviceMemoryError(
            f"device allocation failed (free {free / 1e6:.1f} MB of "
            f"{total / 1e6:.1f} MB): {e}") from e
