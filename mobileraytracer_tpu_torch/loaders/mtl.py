"""Wavefront MTL parsing with tinyobjloader-compatible defaults, since the
reference consumes tinyobj's material_t fields (reference
OBJLoader.cpp:323-366: diffuse, specular, transmittance, dissolve,
emission, ior, diffuse_texname).

Port of `mobileraytracer_tpu/loaders/mtl.py` (pure Python, unchanged).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class MtlMaterial:
    # tinyobj InitMaterial defaults: colors zero, dissolve 1, ior 1.
    diffuse: tuple = (0.0, 0.0, 0.0)
    specular: tuple = (0.0, 0.0, 0.0)
    transmittance: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)
    dissolve: float = 1.0
    ior: float = 1.0
    diffuse_texname: str = ""


def _vec3(parts: List[str]) -> tuple:
    vals = [float(p) for p in parts[:3]]
    while len(vals) < 3:
        vals.append(vals[-1] if vals else 0.0)
    return tuple(vals)


def parse_mtl_text(text: str) -> Dict[str, MtlMaterial]:
    materials: Dict[str, MtlMaterial] = {}
    cur: Optional[MtlMaterial] = None
    for raw in text.splitlines():
        line = raw.split("#")[0].strip()
        if not line:
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "newmtl":
            name = line[6:].strip()
            cur = MtlMaterial()
            materials[name] = cur
        elif cur is None:
            continue
        elif tag == "Kd" and len(parts) >= 2:
            cur.diffuse = _vec3(parts[1:])
        elif tag == "Ks" and len(parts) >= 2:
            cur.specular = _vec3(parts[1:])
        elif tag == "Tf" and len(parts) >= 2:
            cur.transmittance = _vec3(parts[1:])
        elif tag == "Ke" and len(parts) >= 2:
            cur.emission = _vec3(parts[1:])
        elif tag == "d" and len(parts) >= 2:
            cur.dissolve = float(parts[1])
        elif tag == "Tr" and len(parts) >= 2:
            # tinyobj: Tr = 1 - d.
            cur.dissolve = 1.0 - float(parts[1])
        elif tag == "Ni" and len(parts) >= 2:
            cur.ior = float(parts[1])
        elif tag == "map_Kd" and len(parts) >= 2:
            cur.diffuse_texname = parts[-1]
    return materials
