"""Hands the benchmark's scene arrays to the program under test: the port's
SceneBuilder and perspective camera, fed the same numbers that the plain
reference reads (benchmark/reference/proxy.py)."""
from __future__ import annotations

import numpy as np


def port_scene(arrays: dict):
    """The port's Scene (CPU tensors) and Camera of the arrays."""
    from mobileraytracer_tpu_torch.builder import SceneBuilder
    from mobileraytracer_tpu_torch.types import perspective_camera

    b = SceneBuilder()
    for kd in arrays["kd"]:
        b.add_material(kd=tuple(float(x) for x in kd))
    n = arrays["mat_id"].shape[0]
    uv = np.full((n, 2), -1.0, np.float32)
    nrm = arrays["normal"]
    b.add_triangles_bulk(arrays["point_a"], arrays["ab"], arrays["ac"],
                         nrm, nrm, nrm, uv, uv, uv, arrays["mat_id"])
    for a, bb, c, radiance in arrays["lights"]:
        b.add_area_light(a, bb, c, radiance)
    cam = arrays["camera"]
    camera = perspective_camera(cam["position"], cam["look_at"], cam["up"],
                                cam["fov"][0], cam["fov"][1])
    return b.build(), camera
