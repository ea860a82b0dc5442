"""mobileraytracer_tpu_torch: the ray tracer of `mobileraytracer_tpu` ported
to PyTorch, with its traversal kernels written in CUDA C++ for the H100.

It renders the Whitted/BVH frame path of the JAX package and holds
against it (same scene arrays, same threefry random bits, same block
tables and candidate windows, same traversal tie rules).  Module names
mirror the JAX package's:
  renderer        render_frame, Renderer
  shaders.engine  the wavefront walker (Whitted, NoShadows)
  shaders.common  materials and next-event estimation
  ops.block_traversal  candidate windows, refill, scene queries
  ops.kernels     the CUDA kernels' wrappers and plain versions
  ops.intersect   the naive oracle
  scenes, bench_scenes, builder, cameras, film, sampling, threefry
  convert         JAX package state (as numpy) -> port tensors
"""

from . import bench_scenes, constants, scenes  # noqa: F401
from .builder import SceneBuilder  # noqa: F401
from .renderer import Renderer, render_frame  # noqa: F401
from .types import RenderConfig  # noqa: F401

__version__ = "0.1.0"
