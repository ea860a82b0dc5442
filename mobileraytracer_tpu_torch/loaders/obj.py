"""OBJ/MTL scene assembly (port of `mobileraytracer_tpu/loaders/obj.py`)
with the reference's exact load conventions (reference
app/Components/Loaders/OBJLoader.cpp):

 - X axis negated on vertices and normals (OBJLoader.cpp:139-141, 170-172);
 - missing normals -> geometric normalize(cross(AC, AB)) on all three
   corners (OBJLoader.cpp:174-183);
 - material fields: Kd, Ks, Kt = Tf * (1 - dissolve), Ni, Le =
   emission clamped by its max if max > 1 (OBJLoader.cpp:326-330,
   Utils.cpp:189-196);
 - faces with emissive materials become AreaLights instead of triangles
   (OBJLoader.cpp:367-387);
 - material value-dedup into the scene table (OBJLoader.cpp:406-418);
 - diffuse texture with fract-normalized texcoords; texture cache by
   file name (OBJLoader.cpp:332-364, Utils.cpp:177-180);
 - faces without a material fall back to per-vertex colors; tinyobj
   defaults those to white (OBJLoader.cpp:421-433).

Parsing is done by the native C++ parser (native/objparser.cpp), or the
Python parser where it cannot be built; assembly here is vectorised numpy
(no per-triangle Python loop: conference is ~331k triangles).  Scenes
come back as CPU tensors, as SceneBuilder builds them.
"""
from __future__ import annotations

import dataclasses
import os
import time
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np

from ..builder import SceneBuilder
from ..types import Scene
from .mtl import MtlMaterial, parse_mtl_text
from .native import parse_obj_text
from .textures import TextureCache


def _normalize_emission(e: np.ndarray) -> np.ndarray:
    """MobileRT::normalize(vec3): divide by max component if max > 1."""
    m = e.max(axis=-1, keepdims=True)
    return np.where(m > 1.0, e / np.maximum(m, 1e-30), e)


def _numpy(part):
    """A scene part's tensors as a namespace of numpy arrays."""
    return SimpleNamespace(**{f.name: getattr(part, f.name).cpu().numpy()
                              for f in dataclasses.fields(part)})


def load_obj_scene(obj_path: str, mtl_path: Optional[str] = None,
                   builder: Optional[SceneBuilder] = None,
                   strict_textures: bool = True) -> Scene:
    scene, _ = load_obj_scene_ex(obj_path, mtl_path, builder,
                                 strict_textures=strict_textures)
    return scene


def load_obj_scene_ex(obj_path: str, mtl_path: Optional[str] = None,
                      builder: Optional[SceneBuilder] = None,
                      strict_textures: bool = True
                      ) -> Tuple[Scene, dict]:
    t_start = time.perf_counter()
    with open(obj_path, "rb") as f:
        parsed = parse_obj_text(f.read())
    t_parsed = time.perf_counter()

    base_dir = os.path.dirname(os.path.abspath(obj_path))

    # MTL: explicit path first, else every mtllib next to the OBJ.
    mtl: Dict[str, MtlMaterial] = {}
    mtl_candidates = []
    if mtl_path:
        mtl_candidates.append(mtl_path)
    else:
        mtl_candidates.extend(os.path.join(base_dir, m) for m in parsed.mtllibs)
        # The reference passes the .mtl path explicitly (Config.mtlFilePath);
        # mirror its convention of <obj-stem>.mtl as a fallback for OBJs
        # whose mtllib line names a file that is not on disk (teapot.obj
        # says "default.mtl" but ships "teapot.mtl").
        mtl_candidates.append(os.path.splitext(obj_path)[0] + ".mtl")
    for cand in mtl_candidates:
        if os.path.exists(cand):
            with open(cand, "r", errors="replace") as f:
                mtl.update(parse_mtl_text(f.read()))

    b = builder or SceneBuilder()

    v = parsed.vertices.copy()
    vn = parsed.normals.copy()
    if len(v):
        v[:, 0] = -v[:, 0]      # invert X axis
    if len(vn):
        vn[:, 0] = -vn[:, 0]

    nf = parsed.tri_mat.shape[0]
    if nf == 0:
        return b.build(), {"triangles": 0, "lights": 0, "materials": 0}

    idx_v = parsed.tri_idx[..., 0]   # (NF, 3)
    idx_t = parsed.tri_idx[..., 1]
    idx_n = parsed.tri_idx[..., 2]

    pa = v[idx_v[:, 0]]
    pb = v[idx_v[:, 1]]
    pc = v[idx_v[:, 2]]
    ab = pb - pa
    ac = pc - pa

    # Normals: file normals when present, else the geometric normal on all
    # three corners.
    geo_n = np.cross(ac, ab)
    geo_len = np.linalg.norm(geo_n, axis=-1, keepdims=True)
    geo_n = geo_n / np.maximum(geo_len, 1e-30)
    have_vn = len(vn) > 0
    normals = []
    for k in range(3):
        if have_vn:
            ok = idx_n[:, k] >= 0
            nk = np.where(ok[:, None], vn[np.maximum(idx_n[:, k], 0)], geo_n)
        else:
            nk = geo_n
        normals.append(nk.astype(np.float32))

    # Per-slot material resolution.
    slots = parsed.mat_names
    slot_fields = []
    # Reference semantics: a missing/corrupt diffuse texture aborts the
    # scene load (Texture::createTexture throws, propagated by
    # OBJLoader::getTextureFromCache, OBJLoader.cpp:224-271).  Callers opt
    # into best-effort loading with strict_textures=False.
    tex_cache = TextureCache(base_dir, strict=strict_textures)
    for name in slots:
        m = mtl.get(name, MtlMaterial())
        kd = np.asarray(m.diffuse, np.float32)
        ks = np.asarray(m.specular, np.float32)
        kt = np.asarray(m.transmittance, np.float32) * (1.0 - m.dissolve)
        le = _normalize_emission(np.asarray(m.emission, np.float32))
        tex_id = -1
        if m.diffuse_texname and len(parsed.texcoords):
            tex_id = tex_cache.get_id(b, m.diffuse_texname)
        slot_fields.append((kd, ks, kt, np.float32(m.ior), le, tex_id))
    # Default material for faces without usemtl: white diffuse (tinyobj
    # fills per-vertex colors with 1; OBJLoader.cpp:421-433).
    default_field = (np.ones(3, np.float32), np.zeros(3, np.float32),
                     np.zeros(3, np.float32), np.float32(1.0),
                     np.zeros(3, np.float32), -1)

    # Value-dedup slot materials into the scene table.
    slot_to_scene = np.zeros(len(slots) + 1, np.int32)
    emissive_slot = np.zeros(len(slots) + 1, bool)
    for si, (kd, ks, kt, ior, le, tex_id) in enumerate(
            slot_fields + [default_field]):
        if (le > 0).any():
            emissive_slot[si] = True
            slot_to_scene[si] = -1
        else:
            slot_to_scene[si] = b.add_material(
                kd=kd, ks=ks, kt=kt, ior=float(ior), le=le, tex_id=tex_id,
                dedup=True)

    face_slot = np.where(parsed.tri_mat >= 0, parsed.tri_mat, len(slots))
    face_emissive = emissive_slot[face_slot]
    face_mat = slot_to_scene[face_slot]

    # Texcoords: fract-normalized when the slot has a texture and the face
    # carries texcoord indices; (-1, -1) otherwise.
    has_tex_slot = np.asarray(
        [f[5] >= 0 for f in slot_fields] + [False], bool)[face_slot]
    uvs = []
    vt = parsed.texcoords
    for k in range(3):
        if len(vt):
            ok = has_tex_slot & (idx_t[:, k] >= 0)
            raw = vt[np.maximum(idx_t[:, k], 0)]
            frac = raw - np.floor(raw)  # glm::fract (Utils.cpp:177-180)
            uvk = np.where(ok[:, None], frac, -1.0)
        else:
            uvk = np.full((nf, 2), -1.0, np.float32)
        uvs.append(uvk.astype(np.float32))

    # Emissive faces -> area lights.
    em = face_emissive
    if em.any():
        le_slots = np.stack(
            [f[4] for f in slot_fields] + [default_field[4]])[face_slot]
        for i in np.nonzero(em)[0]:
            b.add_area_light(pa[i], pb[i], pc[i], le_slots[i])

    keep = ~em
    b.add_triangles_bulk(
        pa[keep], ab[keep], ac[keep],
        normals[0][keep], normals[1][keep], normals[2][keep],
        uvs[0][keep], uvs[1][keep], uvs[2][keep],
        face_mat[keep])

    scene = b.build()
    # Phase timers mirroring the reference's load/fill split
    # (C_wrapper.cpp:103-130 "Loading Obj file" / "Filling scene" and the
    # summary at :248-251): parse = tinyobj-stage (native/objparser.cpp),
    # fill = numpy assembly + scene build.
    info = {
        "triangles": int(keep.sum()),
        "lights": int(em.sum()),
        "materials": len(b._mat),
        "textures": len(tex_cache),
        "parse_seconds": t_parsed - t_start,
        "fill_seconds": time.perf_counter() - t_parsed,
    }
    return scene, info


def save_obj_scene(scene: Scene, obj_path: str,
                   mtl_path: Optional[str] = None) -> dict:
    """Serializes a Scene's triangles + area lights to OBJ+MTL, inverting
    the loader's conventions (X re-negated on write; area lights written
    as faces of emissive materials), so `load_obj_scene(obj_path)`
    reproduces the scene: triangle geometry, order, and geometric normals
    bit-for-bit; materials up to the loader's value-dedup id permutation;
    area lights in order.

    Purpose: the reference's canonical bench loads the real 331k-triangle
    conference OBJ and logs per-phase times (C_wrapper.cpp:103-130,
    248-251); the conference OBJ is not vendored, so writing the
    procedural proxy out and loading it back exercises (and times) the
    real parser path at the reference's scale.

    Limitations (none hit by the proxy): shading normals that differ from
    the geometric normal and texture UVs are not written; emissive
    radiance with a component > 1 would be re-normalized on load.
    """
    if mtl_path is None:
        mtl_path = os.path.splitext(obj_path)[0] + ".mtl"

    tris = _numpy(scene.triangles)
    mats = _numpy(scene.materials)
    lights = _numpy(scene.lights)
    valid = tris.valid.astype(bool)
    pa = tris.point_a[valid]
    vb = pa + tris.ab[valid]
    vc = pa + tris.ac[valid]
    mat_id = tris.mat_id[valid]
    n = pa.shape[0]

    # Area-light triangles (emissive faces on load).
    n_l = int(np.asarray(lights.num))
    lk = lights.kind[:n_l]
    area = np.nonzero(lk == 1)[0]       # C.LIGHT_AREA
    la = lights.tri_a[area]
    lb = la + lights.tri_ab[area]
    lc = la + lights.tri_ac[area]
    lrad = lights.radiance[area]

    # One shared vertex table (X negated back; the loader re-negates).
    verts = np.concatenate([pa, vb, vc, la, lb, lc], 0).astype(np.float32)
    verts[:, 0] = -verts[:, 0]
    uniq, inv = np.unique(verts, axis=0, return_inverse=True)
    ia = inv[:n] + 1                     # 1-based OBJ indices
    ib = inv[n:2 * n] + 1
    ic = inv[2 * n:3 * n] + 1
    m_off = 3 * n
    k = len(area)

    used_mats = np.unique(mat_id)
    lines_mtl = []
    for mi in used_mats:
        kd, ks, kt = mats.kd[mi], mats.ks[mi], mats.kt[mi]
        lines_mtl.append(f"newmtl mat{mi}")
        lines_mtl.append("Kd %.9g %.9g %.9g" % tuple(kd))
        lines_mtl.append("Ks %.9g %.9g %.9g" % tuple(ks))
        if (kt > 0).any():
            # Loader rule: Kt = Tf * (1 - dissolve)  (OBJLoader.cpp:326).
            lines_mtl.append("d 0")
            lines_mtl.append("Tf %.9g %.9g %.9g" % tuple(kt))
        lines_mtl.append("Ni %.9g" % mats.ior[mi])
    lrad_u, lrad_inv = (np.unique(lrad, axis=0, return_inverse=True)
                        if k else (np.zeros((0, 3), np.float32),
                                   np.zeros((0,), np.int64)))
    for j, r in enumerate(lrad_u):
        lines_mtl.append(f"newmtl light{j}")
        lines_mtl.append("Kd 0 0 0")
        lines_mtl.append("Ke %.9g %.9g %.9g" % tuple(r))
    with open(mtl_path, "w") as f:
        f.write("\n".join(lines_mtl) + "\n")

    out = [f"mtllib {os.path.basename(mtl_path)}"]
    out.extend("v %.9g %.9g %.9g" % tuple(row) for row in uniq)
    # Faces in original triangle order; usemtl emitted at material-run
    # boundaries (the proxy's batches are long same-material runs).
    cur = None
    for i in range(n):
        mi = int(mat_id[i])
        if mi != cur:
            out.append(f"usemtl mat{mi}")
            cur = mi
        out.append(f"f {ia[i]} {ib[i]} {ic[i]}")
    for j in range(k):
        out.append(f"usemtl light{int(lrad_inv[j])}")
        out.append(f"f {inv[m_off + j] + 1} {inv[m_off + k + j] + 1} "
                   f"{inv[m_off + 2 * k + j] + 1}")
    with open(obj_path, "w") as f:
        f.write("\n".join(out) + "\n")
    return {"triangles": int(n), "lights": int(k),
            "vertices": int(uniq.shape[0]),
            "materials": int(len(used_mats)),
            "obj_bytes": os.path.getsize(obj_path)}
