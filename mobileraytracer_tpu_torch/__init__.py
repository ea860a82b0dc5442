"""mobileraytracer_tpu_torch: the ray tracer of `mobileraytracer_tpu` ported
to PyTorch, with its traversal kernels written in CUDA C++ for the H100.

It renders the five shaders of the JAX package over its three
accelerators and holds against it (same scene arrays, same threefry
random bits, same block tables and candidate windows, same traversal tie
rules, same grid cells).  Module names mirror the JAX package's:
  renderer        render_frame, Renderer
  shaders.engine  the wavefront walker (Whitted, NoShadows, PathTracer)
                  and the single-pass DepthMap and DiffuseMaterial
  shaders.common  materials and next-event estimation
  ops.block_traversal  candidate windows, refill, scene queries
  ops.kernels     the CUDA kernels' wrappers and plain versions
  ops.bvh         the SAH build and the escape-index walk
  ops.grid        the regular grid and its DDA
  ops.intersect   the naive oracle
  scenes, bench_scenes, builder, cameras, film, sampling, threefry
  convert         JAX package state (as numpy) -> port tensors
"""

from . import bench_scenes, constants, scenes  # noqa: F401
from .builder import SceneBuilder  # noqa: F401
from .renderer import Renderer, render_frame  # noqa: F401
from .types import RenderConfig  # noqa: F401

__version__ = "0.1.0"
