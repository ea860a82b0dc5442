"""Builds and loads the CUDA kernels (csrc/*.cu): the four traversal
kernels, the Gumbel-max draw and the candidate windows.

`nvcc` compiles the sources into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds).  The library goes to build/mrt_torch_kernels/<hash>/ at the
repository root, keyed by a hash of the sources and flags, and is built
at the first kernel launch of a process when that key has no library
yet.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "mrt_torch_kernels"
LIB_NAME = "libmrt_traverse.so"

# --fmad=false keeps every product and sum separately rounded, as in the
# plain versions (see csrc/mt.cuh); -prec-div stays at its IEEE default
# and --use_fast_math is never passed.
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = ("banded", "tilemt", "tilebw", "resident", "gumbel", "window")
# Launcher argument types: the device pointers, the ints, then any host
# pointer or float and the stream; each kernel's mrt_<name>_info takes an
# int[6] (resident's also its bands per program, window's its depth).
_FUNCS = {
    "mrt_traverse_banded": [_P] * 5 + [_I] * 3 + [_P],
    "mrt_traverse_tilemt": [_P] * 6 + [_I] * 3 + [_P],
    "mrt_traverse_tilebw": [_P] * 6 + [_I] * 3
                           + [ctypes.POINTER(ctypes.c_float), _P],
    "mrt_traverse_resident": [_P] * 5 + [_I] * 4 + [_P],
    "mrt_gumbel_argmax": [_P] * 4 + [_I] * 2 + [_P],
    "mrt_candidate_windows": [_P] * 11 + [_I] * 9 + [ctypes.c_float, _P],
    **{f"mrt_{k}_info": [ctypes.POINTER(_I)] for k in KERNELS},
    "mrt_resident_info": [ctypes.POINTER(_I), _I],
    "mrt_window_info": [ctypes.POINTER(_I), _I],
}
_lib = None
BUILD_INFO = {"seconds": None, "built": False, "path": None, "log": ""}


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def lib_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compiles the library if it is missing; returns its path.  Each
    source compiles in its own nvcc process, all at once, then one more
    links them."""
    path = lib_path()
    if path.exists():
        BUILD_INFO.update(seconds=0.0, built=False, path=str(path))
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in cu]
        nvcc = _nvcc()
        with ThreadPoolExecutor(len(cu)) as pool:
            logs = list(pool.map(
                lambda src_obj: _run([nvcc, *FLAGS, "-c", "-I", str(_CSRC),
                                      "-o", src_obj[1], str(src_obj[0])]),
                zip(cu, objs)))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        logs.append(_run([nvcc, *FLAGS, "-shared", "-o", tmp_lib, *objs]))
        os.replace(tmp_lib, path)   # atomic: concurrent builds agree
    BUILD_INFO.update(seconds=time.perf_counter() - t0, built=True,
                      path=str(path), log="".join(logs))
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _FUNCS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def error_string(err: int) -> str:
    """cudaGetErrorString for a code returned by a launcher."""
    fn = load().mrt_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return f"CUDA error {err}: {fn(err).decode()}"


INFO_KEYS = ("regs", "static_smem", "dynamic_smem", "local_bytes",
             "threads", "blocks_per_sm")


def kernel_info(name: str, g_n: int = 8, depth: int = 64) -> dict:
    """Launch facts of kernel `name` (one of KERNELS) on the current
    device, from cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor: registers per thread,
    static and dynamic shared bytes, spilled bytes per thread, threads per
    block and resident blocks per SM.  `g_n` is the resident kernel's
    bands per program, `depth` the window kernel's max(top_s, top_m)."""
    info = (ctypes.c_int * len(INFO_KEYS))()
    extra = {"resident": (g_n,), "window": (depth,)}.get(name, ())
    err = getattr(load(), f"mrt_{name}_info")(info, *extra)
    if err != 0:
        raise RuntimeError(f"{name} kernel info: {error_string(err)}")
    return dict(zip(INFO_KEYS, info))
