"""Texture factories with the reference's error semantics (port of
`mobileraytracer_tpu/loaders/textures.py`).

The reference decodes textures with stb_image from a byte buffer or a
file (Texture.cpp:57-115) and throws on any decode failure.  Here PIL,
imported only when a texture is decoded, turns every source mode into an
(H, W, 3) float32 array in [0, 1]: grayscale broadcasts, alpha is
dropped, palettes expand.  Where PIL is missing, or the decode fails,
`TextureError` is raised; `strict=False` turns that into a logged warning
and an untextured face.
"""
from __future__ import annotations

import io
import logging
import os
from typing import Dict, Optional

import numpy as np

LOG = logging.getLogger("mobileraytracer_tpu_torch")


class TextureError(RuntimeError):
    """Decode/IO failure — the analogue of the reference's
    ::std::runtime_error{stbi_failure_reason()} (Texture.cpp:63-74)."""


def create_texture_from_bytes(data: bytes) -> np.ndarray:
    """In-memory factory (reference Texture.cpp:57-83): decode an encoded
    image (PNG/JPEG/...) from bytes to (H, W, 3) float32 in [0, 1]."""
    if not data:
        raise TextureError("Error reading texture: empty buffer")
    try:
        from PIL import Image
    except ImportError as e:
        raise TextureError(
            "Error reading texture: no image decoder available "
            "(PIL is not installed)") from e
    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    except Exception as e:
        raise TextureError(f"Error reading texture: {e}") from e
    return _to_rgb_f32(img)


def create_texture(path: str) -> np.ndarray:
    """File factory (reference Texture.cpp:89-115)."""
    if not os.path.exists(path):
        raise TextureError(f"Error reading texture '{path}': no such file")
    with open(path, "rb") as f:
        data = f.read()
    try:
        return create_texture_from_bytes(data)
    except TextureError as e:
        raise TextureError(f"Error reading texture '{path}': {e}") from e


def _to_rgb_f32(img) -> np.ndarray:
    """Normalize any PIL mode to (H, W, 3) float32 in [0, 1]: grayscale
    broadcasts across RGB, alpha is dropped, palette images expand —
    the superset of the reference's channel-count passthrough
    (Texture.cpp:28-48 always samples 3 components)."""
    if img.mode != "RGB":
        img = img.convert("RGB")
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim != 3 or arr.shape[2] != 3:  # defensive; convert guarantees
        raise TextureError(f"Error reading texture: bad shape {arr.shape}")
    return arr


def load_texture(path: str, strict: bool = True) -> Optional[np.ndarray]:
    """Best-effort wrapper used by the OBJ loader: raise in strict mode,
    warn-and-return-None otherwise (never silent)."""
    try:
        return create_texture(path)
    except TextureError as e:
        if strict:
            raise
        LOG.warning("%s — face renders untextured", e)
        return None


class TextureCache:
    """Name-keyed texture cache (reference texture cache by file name,
    OBJLoader.cpp:332-364, Utils.cpp:177-180): each distinct texname
    decodes once per scene load."""

    def __init__(self, base_dir: str, strict: bool = False):
        self.base_dir = base_dir
        self.strict = strict
        self._ids: Dict[str, int] = {}

    def get_id(self, builder, texname: str) -> int:
        if texname not in self._ids:
            img = load_texture(os.path.join(self.base_dir, texname),
                               strict=self.strict)
            self._ids[texname] = builder.add_texture(img) if img is not None else -1
        return self._ids[texname]

    def __len__(self) -> int:
        return len(self._ids)
