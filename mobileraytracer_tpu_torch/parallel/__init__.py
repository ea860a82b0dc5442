"""Differentiable rendering's training step and material recovery, on one
device (the sharded forms are ROADMAP.md Queue 1, item 14)."""
from . import mesh, recover  # noqa: F401
