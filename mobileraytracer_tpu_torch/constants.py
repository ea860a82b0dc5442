"""Numeric constants shared by the whole port.

The values are those of `mobileraytracer_tpu/constants.py` (which mirror
the reference engine's app/MobileRT/Utils/Constants.hpp:22-79); image
parity with the JAX package depends on matching them exactly.  They are
copied rather than imported because importing the JAX package pulls in
jax.
"""
import os as _os

EPSILON = 1.0e-06
EPSILON_LARGE = 1.0e-05
RAY_LENGTH_MAX = 1.0e+30
RAY_DEPTH_MIN = 1
RAY_DEPTH_MAX = 6
NUMBER_OF_TILES = 256
TILE_MULTIPLE = 16
WHITTED_AMBIENT = 0.1
RR_FINISH_PROBABILITY = 0.5

PRIM_NONE = 0
PRIM_PLANE = 1
PRIM_SPHERE = 2
PRIM_TRIANGLE = 3
PRIM_LIGHT = 4

LIGHT_POINT = 0
LIGHT_AREA = 1

SHADER_NOSHADOWS = 0
SHADER_WHITTED = 1
SHADER_PATHTRACER = 2
SHADER_DEPTHMAP = 3
SHADER_DIFFUSE = 4

ACC_NONE = 0
ACC_NAIVE = 1
ACC_REGULAR_GRID = 2
ACC_BVH = 3

SCENE_CORNELL = 0
SCENE_SPHERES = 1
SCENE_CORNELL2 = 2
SCENE_SPHERES2 = 3
SCENE_OBJ = 4

# Far-away-but-finite origin used to park dead lanes (see
# shaders/common.park_dead_lanes).
FAR_SENTINEL = 1.0e7

# Rays per traversal subtile.  Read from the same environment variable as
# the JAX package (MRT_SUBTILE) so both packages always agree; must
# divide 128.
SUBTILE = int(_os.environ.get("MRT_SUBTILE", "16"))
