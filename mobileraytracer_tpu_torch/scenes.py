"""The four built-in analytic scenes, value-matched to the reference
(reference app/Scenes/Scenes.cpp:19-302) and selected by the same integer
scene ids (app/System_dependent/Native/C_wrapper.cpp:76-141).

Port of `mobileraytracer_tpu/scenes.py`.
"""
from __future__ import annotations

import numpy as np

from . import constants as C
from .builder import SceneBuilder
from .types import Camera, Scene, orthographic_camera, perspective_camera

# Shared materials (Scenes.cpp:19-46).  Material ctor order there is
# (Kd, Ks, Kt, ior, Le).
LIGHT_LE = (0.9, 0.9, 0.9)
MIRROR_KS = (0.9, 0.9, 0.9)
TRANSMISSION_KT = (0.9, 0.9, 0.9)
TRANSMISSION_IOR = 1.9
LIGHT_GRAY = (0.7, 0.7, 0.7)
RED = (0.9, 0.0, 0.0)
YELLOW = (0.9, 0.9, 0.0)
GREEN = (0.0, 0.9, 0.0)
BLUE = (0.0, 0.0, 0.9)
SAND = (0.914, 0.723, 0.531)
LIGHT_BLUE = (0.0, 0.9, 0.9)

# The shared yellow triangle (Scenes.cpp:48-52): builder vertices A, B, C.
_TRI_A = (0.5, -0.5, 0.99)
_TRI_B = (0.5, 0.5, 1.001)
_TRI_C = (-0.5, -0.5, 0.99)


def _cornell_walls(b: SceneBuilder) -> None:
    """The six cornell walls (Scenes.cpp:63-107)."""
    b.add_plane((0, 0, 1), (0, 0, -1), b.add_material(kd=LIGHT_GRAY))    # back
    b.add_plane((0, 0, -3.5), (0, 0, 1), b.add_material(kd=LIGHT_BLUE))  # front
    b.add_plane((0, -1, 0), (0, 1, 0), b.add_material(kd=LIGHT_GRAY))    # floor
    b.add_plane((0, 1, 0), (0, -1, 0), b.add_material(kd=LIGHT_GRAY))    # ceiling
    b.add_plane((-1, 0, 0), (1, 0, 0), b.add_material(kd=RED))           # left
    b.add_plane((1, 0, 0), (-1, 0, 0), b.add_material(kd=BLUE))          # right


def cornell_box_scene() -> Scene:
    """Scene 0 (Scenes.cpp:109-137): point light, yellow triangle, mirror
    and green spheres, cornell walls."""
    b = SceneBuilder()
    b.add_point_light((0.0, 0.99, 0.0), LIGHT_LE)
    b.add_triangle(_TRI_A, _TRI_B, _TRI_C, b.add_material(kd=YELLOW))
    b.add_sphere((0.45, -0.65, 0.4), 0.35, b.add_material(ks=MIRROR_KS))
    b.add_sphere((-0.45, -0.1, 0.0), 0.35, b.add_material(kd=GREEN))
    _cornell_walls(b)
    return b.build()


def cornell_box_camera(ratio: float) -> Camera:
    """Scenes.cpp:139-150: perspective at (0,0,-3.4) looking at +z,
    fovX = 45 * ratio, fovY = 45."""
    return perspective_camera((0, 0, -3.4), (0, 0, 1), (0, 1, 0),
                              45.0 * ratio, 45.0)


def cornell_box2_scene() -> Scene:
    """Scene 2 (Scenes.cpp:152-225): two triangle area lights on the
    ceiling, yellow + green triangles, mirror + transmissive spheres."""
    b = SceneBuilder()
    b.add_area_light((-0.25, 0.99, -0.25), (0.25, 0.99, -0.25),
                     (0.25, 0.99, 0.25), LIGHT_LE)
    b.add_area_light((0.25, 0.99, 0.25), (-0.25, 0.99, 0.25),
                     (-0.25, 0.99, -0.25), LIGHT_LE)
    b.add_triangle(_TRI_A, _TRI_B, _TRI_C, b.add_material(kd=YELLOW))
    b.add_triangle((-0.5, 0.5, 0.99), (-0.5, -0.5, 0.99), (0.5, 0.5, 0.99),
                   b.add_material(kd=GREEN))
    b.add_sphere((0.45, -0.65, 0.4), 0.35, b.add_material(ks=MIRROR_KS))
    b.add_sphere((-0.4, -0.3, 0.0), 0.35,
                 b.add_material(kt=TRANSMISSION_KT, ior=TRANSMISSION_IOR))
    _cornell_walls(b)
    return b.build()


def spheres_scene() -> Scene:
    """Scene 1 (Scenes.cpp:227-249): one red sphere + sand triangle, no
    lights, orthographic camera."""
    b = SceneBuilder()
    b.add_sphere((4, 4, 4), 4.0, b.add_material(kd=RED))
    b.add_triangle((0, 10, 10), (0, 0, 10), (10, 0, 10),
                   b.add_material(kd=SAND))
    return b.build()


def spheres_camera(ratio: float) -> Camera:
    """Scenes.cpp:251-262: orthographic, sizeH = 10 * ratio, sizeV = 10."""
    return orthographic_camera((0, 1, -10), (0, 1, 7), (0, 1, 0),
                               10.0 * ratio, 10.0)


def spheres2_scene() -> Scene:
    """Scene 3 (Scenes.cpp:264-289)."""
    b = SceneBuilder()
    b.add_point_light((0, 15, 4), LIGHT_LE)
    b.add_sphere((-1, 1, 6), 1.0, b.add_material(kd=RED))
    b.add_sphere((-0.5, 2, 5), 0.3, b.add_material(kd=BLUE))
    b.add_sphere((0, 2, 7), 1.0, b.add_material(ks=MIRROR_KS))
    b.add_sphere((0.5, 0.5, 5), 0.2, b.add_material(kd=YELLOW))
    b.add_sphere((1, 0.5, 4.5), 0.5, b.add_material(kd=GREEN))
    b.add_plane((0, 0, 0), (0, 1, 0), b.add_material(kd=SAND))
    return b.build()


def spheres2_camera(ratio: float) -> Camera:
    """Scenes.cpp:291-302: perspective at (0,0.5,1) toward (0,0,7),
    fov 60 * ratio x 60."""
    return perspective_camera((0, 0.5, 1), (0, 0, 7), (0, 1, 0),
                              60.0 * ratio, 60.0)


# Per-scene DepthMap far points (C_wrapper.cpp:80-138).
DEPTHMAP_MAX_POINT = {
    C.SCENE_CORNELL: np.asarray((1.0, 1.0, 1.0), np.float32),
    C.SCENE_SPHERES: np.asarray((8.0, 8.0, 8.0), np.float32),
    C.SCENE_CORNELL2: np.asarray((1.0, 1.0, 1.0), np.float32),
    C.SCENE_SPHERES2: np.asarray((8.0, 8.0, 8.0), np.float32),
    C.SCENE_OBJ: np.asarray((1.0, 1.0, 1.0), np.float32),
}


def load_builtin(scene_id: int, ratio: float):
    """Scene + camera dispatch matching C_wrapper.cpp:76-141."""
    if scene_id == C.SCENE_CORNELL:
        return cornell_box_scene(), cornell_box_camera(ratio)
    if scene_id == C.SCENE_SPHERES:
        return spheres_scene(), spheres_camera(ratio)
    if scene_id == C.SCENE_CORNELL2:
        return cornell_box2_scene(), cornell_box_camera(ratio)
    if scene_id == C.SCENE_SPHERES2:
        return spheres2_scene(), spheres2_camera(ratio)
    raise ValueError(f"scene {scene_id} is not a built-in; use the OBJ loader")
