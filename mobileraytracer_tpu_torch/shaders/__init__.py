"""Shading: the wavefront walker and shared shading math."""
from .engine import trace_image_sample  # noqa: F401
