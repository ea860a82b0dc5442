"""Shading: the wavefront walker and shared shading math."""
