"""ctypes binding of the native C++ OBJ parser (native/objparser.cpp), with
the pure-Python parser beside it (port of
`mobileraytracer_tpu/loaders/native.py`).

The library is compiled with g++ and native/Makefile's flags at its first
use in a process, into build/objparser/<hash>/ at the repository root,
keyed by a hash of the source and the flags; native/ is never written.
When it cannot be built or loaded, `parse_obj_text` parses in Python, as
the JAX package does; `library()` tells which parser runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "objparser.cpp"
_BUILD_ROOT = _ROOT / "build" / "objparser"
# CXXFLAGS of native/Makefile, and -shared from its link rule.
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_lib = None
_tried = False


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libobjparser.so"


def _build() -> Path:
    """Compiles the library if it is missing; returns its path."""
    path = lib_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise OSError("no C++ compiler (g++) for native/objparser.cpp")
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        out = os.path.join(tmp, path.name)
        proc = subprocess.run([cxx, *FLAGS, "-o", out, str(_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise OSError(f"g++ failed ({proc.returncode}): {proc.stderr}")
        os.replace(out, path)   # atomic: concurrent builds agree
    return path


def library() -> Optional[ctypes.CDLL]:
    """The native parser, built on first use; None when it cannot be built
    or loaded."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except OSError:
        return None
    lib.objp_parse.restype = ctypes.c_void_p
    lib.objp_parse.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.objp_counts.restype = None
    lib.objp_counts.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_long)] * 5
    lib.objp_fill.restype = None
    lib.objp_fill.argtypes = [ctypes.c_void_p] * 6
    lib.objp_mat_name.restype = ctypes.c_char_p
    lib.objp_mat_name.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.objp_mtllibs.restype = ctypes.c_char_p
    lib.objp_mtllibs.argtypes = [ctypes.c_void_p]
    lib.objp_free.restype = None
    lib.objp_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


@dataclass
class ParsedObj:
    vertices: np.ndarray    # (NV, 3) f32
    normals: np.ndarray     # (NN, 3) f32
    texcoords: np.ndarray   # (NT, 2) f32
    tri_idx: np.ndarray     # (NF, 3, 3) i32: per corner (v, vt, vn), -1=none
    tri_mat: np.ndarray     # (NF,) i32 material slot, -1=none
    mat_names: List[str]
    mtllibs: List[str]


def parse_obj_text(text: bytes) -> ParsedObj:
    lib = library()
    if lib is not None:
        return _parse_native(lib, text)
    return _parse_python(text.decode("utf-8", "replace"))


def _parse_native(lib, text: bytes) -> ParsedObj:
    h = lib.objp_parse(text, len(text))
    try:
        nv, nvn, nvt, ntri, nmat = (ctypes.c_long() for _ in range(5))
        lib.objp_counts(h, ctypes.byref(nv), ctypes.byref(nvn),
                        ctypes.byref(nvt), ctypes.byref(ntri),
                        ctypes.byref(nmat))
        v = np.empty((nv.value, 3), np.float32)
        vn = np.empty((nvn.value, 3), np.float32)
        vt = np.empty((nvt.value, 2), np.float32)
        tri = np.empty((ntri.value, 9), np.int32)
        tm = np.empty((ntri.value,), np.int32)
        lib.objp_fill(h, v.ctypes.data, vn.ctypes.data, vt.ctypes.data,
                      tri.ctypes.data, tm.ctypes.data)
        names = [lib.objp_mat_name(h, i).decode() for i in range(nmat.value)]
        mtllibs = [s for s in lib.objp_mtllibs(h).decode().split("\n") if s]
        return ParsedObj(v, vn, vt, tri.reshape(-1, 3, 3), tm, names, mtllibs)
    finally:
        lib.objp_free(h)


def _parse_python(text: str) -> ParsedObj:
    """The Python parser, with the native parser's conventions: faces
    fan-triangulated, negative indices resolved, missing vt/vn -1."""
    v, vn, vt = [], [], []
    tri, tm = [], []
    mat_names: List[str] = []
    mat_index = {}
    mtllibs: List[str] = []
    current = -1

    def fv(tok: str, nv, nvt, nvn):
        parts = tok.split("/")
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        return (vi - 1 if vi > 0 else nv + vi,
                (ti - 1 if ti > 0 else nvt + ti) if ti else -1,
                (ni - 1 if ni > 0 else nvn + ni) if ni else -1)

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v" and len(parts) >= 4:
            v.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "vn" and len(parts) >= 4:
            vn.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "vt" and len(parts) >= 3:
            vt.append([float(parts[1]), float(parts[2])])
        elif tag == "f" and len(parts) >= 4:
            corners = [fv(tok, len(v), len(vt), len(vn))
                       for tok in parts[1:]]
            for i in range(2, len(corners)):
                tri.append([corners[0], corners[i - 1], corners[i]])
                tm.append(current)
        elif tag == "usemtl":
            name = line[6:].split("#")[0].strip()
            if name not in mat_index:
                mat_index[name] = len(mat_names)
                mat_names.append(name)
            current = mat_index[name]
        elif tag == "mtllib":
            name = line[6:].split("#")[0].strip()
            if name:
                mtllibs.append(name)

    return ParsedObj(
        np.asarray(v, np.float32).reshape(-1, 3),
        np.asarray(vn, np.float32).reshape(-1, 3),
        np.asarray(vt, np.float32).reshape(-1, 2),
        np.asarray(tri, np.int32).reshape(-1, 3, 3),
        np.asarray(tm, np.int32).reshape(-1),
        mat_names, mtllibs)
