"""Meshes over torch.distributed, the sharded frame, and differentiable
rendering's training step and material recovery, on one device or sharded
over a mesh."""
from . import mesh, recover  # noqa: F401
