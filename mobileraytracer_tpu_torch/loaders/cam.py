""".cam camera file loader (reference format documented in
docs/README.md:139-145: lines `t <type>`, `p x y z`, `l x y z`, `u x y z`,
`f fovx fovy`; parsed by PerspectiveLoader.cpp:10-64 via CameraFactory).

Conventions copied from the reference:
 - camera X position is negated (PerspectiveLoader.cpp:50-52, matching the
   OBJ loader's X-axis inversion);
 - horizontal fov is scaled by the aspect ratio (PerspectiveLoader.cpp:60);
 - values may carry trailing '#' comments (conference.cam does).

Port of `mobileraytracer_tpu/loaders/cam.py`; the cameras it returns hold
CPU tensors.
"""
from __future__ import annotations

from ..types import Camera, orthographic_camera, perspective_camera


def _floats(rest: str, n: int):
    vals = []
    for tok in rest.split():
        if tok.startswith("#"):
            break
        vals.append(float(tok))
        if len(vals) == n:
            break
    while len(vals) < n:
        vals.append(0.0)
    return vals


def load_camera_text(text: str, aspect_ratio: float) -> Camera:
    kind = "perspective"
    position = [0.0, 0.0, 0.0]
    look_at = [0.0, 0.0, 0.0]
    up = [0.0, 1.0, 0.0]
    fov = [45.0, 45.0]
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        key, _, rest = line.partition(" ")
        if key == "t":
            kind = rest.split("#")[0].strip()
        elif key == "p":
            position = _floats(rest, 3)
        elif key == "l":
            look_at = _floats(rest, 3)
        elif key == "u":
            up = _floats(rest, 3)
        elif key == "f":
            fov = _floats(rest, 2)

    position[0] = -position[0]  # invert X axis

    if kind.startswith("ortho"):
        return orthographic_camera(position, look_at, up,
                                   fov[0] * aspect_ratio, fov[1])
    return perspective_camera(position, look_at, up,
                              fov[0] * aspect_ratio, fov[1])


def load_camera_file(path: str, aspect_ratio: float) -> Camera:
    with open(path, "r") as f:
        return load_camera_text(f.read(), aspect_ratio)
