"""mobileraytracer_tpu_torch: the ray tracer of `mobileraytracer_tpu` ported
to PyTorch, with its traversal kernels written in CUDA C++ for the H100.

It renders the five shaders of the JAX package over its three
accelerators and takes material and vertex gradients, holding against it
(same scene arrays, same threefry random bits, same block tables and
candidate windows, same traversal tie rules, same grid cells), and loads
OBJ scenes from disk through the same conventions.  Module names mirror the JAX package's:
  cli             the command line (python -m mobileraytracer_tpu_torch.cli)
  bench           rays/s of a frame (python -m mobileraytracer_tpu_torch.bench;
                  BASELINE #3, #4 and the grid datapoint)
  bench_grad      Mpixel-grads/s of vertex gradients
                  (python -m mobileraytracer_tpu_torch.bench_grad; BASELINE #5)
  sweep           builtin scenes x shaders x accelerators through the
                  Renderer, one .dat row each
                  (python -m mobileraytracer_tpu_torch.sweep)
  renderer        render_frame, render_frame_auto (frames in lane chunks),
                  Renderer and its lifecycle
  loaders         OBJ/MTL scenes (native C++ parser), textures, cameras
  samplers        the reference's eight pixel samplers
  utils           phase timers and metrics, checkpoints (renders and
                  recovery runs), guards
  diff.geom       vertex gradients with edge sampling (BASELINE #5)
  parallel        the training step and material recovery, and their
                  sharded forms over torch.distributed
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
from .renderer import Renderer, render_frame, render_frame_auto  # noqa: F401
from .types import (Camera, Hit, Lights, Materials, Planes,  # noqa: F401
                    RenderConfig, Scene, Spheres, Triangles,
                    orthographic_camera, perspective_camera)

__version__ = "0.1.0"
