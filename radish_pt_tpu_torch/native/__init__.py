"""The port's native host build: the SAH BVH (``src/bvh_builder.cpp``), the
area-optimal cluster cuts (``src/cluster_cuts.cpp``) and the OBJ parser
(``src/obj_loader.cpp``), C++ bound through ctypes.

Each is the twin of a numpy (or Python) builder of the port, and equal to
it array for array: ``accel/bvh.py::build_bvh_numpy``,
``scene/build.py::_cluster_cuts_numpy`` and
``scene/obj_loader.py::load_obj_py``, which stay the plain versions the
tests hold these against.  ``build_bvh``, ``_cluster_cuts`` and ``load_obj``
call the C++ unless ``RADISH_NATIVE=0`` (read at every call).

The library is compiled with ``g++`` at first use into
``radish_pt_tpu_torch/_build/`` (git-ignored), under a name keyed by a
hash of the sources and the flags, and written under a temporary name and
then renamed, so processes that build it at once each see a whole file.  A
failed build or load raises with the compiler's output: nothing falls back
to numpy in silence.  Nothing here runs at import time.  The build and the
load are the set-up span ``setup.native`` (utils/timing.py), a compile
counted as ``native.built``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..utils import timing

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src")
SOURCES = ("bvh_builder.cpp", "cluster_cuts.cpp", "obj_loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# no -march=native: the library is the same on every x86-64 host, and
# -ffp-contract=off keeps every product and sum rounded as numpy rounds it
CXX_FLAGS = ["-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC"]

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_lib = None


def enabled() -> bool:
    """Whether the builders call the C++ (``RADISH_NATIVE`` is not "0")."""
    return os.environ.get("RADISH_NATIVE", "1") != "0"


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(SRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libradish_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if its hashed file is missing; returns its path."""
    with timing.span("setup.native"):
        path = library_path()
        if os.path.exists(path):
            return path
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("the native host build needs g++ (RADISH_NATIVE=0 selects "
                               "the numpy builders)")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp,
                               *(os.path.join(SRC, s) for s in SOURCES)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native host library:\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, path)
        timing.count("native.built")
        return path


def load_library():
    """The library, built if needed, its entry points typed."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    with timing.span("setup.native"):
        lib = ctypes.CDLL(path)
    lib.radish_build_bvh.restype = ctypes.c_int
    lib.radish_build_bvh.argtypes = [_P, ctypes.c_int, ctypes.c_int] + [_P] * 10
    lib.radish_cluster_cuts.restype = _I64
    lib.radish_cluster_cuts.argtypes = [_P, _P, _I64, _I64, ctypes.c_float, _I64, _P]
    lib.radish_obj_parse.restype = _P
    lib.radish_obj_parse.argtypes = [ctypes.c_char_p]
    lib.radish_obj_error.restype = ctypes.c_char_p
    lib.radish_obj_num_corners.restype = _I64
    lib.radish_obj_num_corners.argtypes = [_P]
    lib.radish_obj_copy.argtypes = [_P] * 4
    lib.radish_obj_free.argtypes = [_P]
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def build_bvh(vertices: np.ndarray, leaf_size: int) -> dict:
    """The BVH of the flat soup ``vertices`` [3T, 3]: the fields of
    ``accel.bvh.BVH`` as a dict, equal to ``build_bvh_numpy``'s."""
    lib = load_library()
    v = np.ascontiguousarray(vertices, dtype=np.float32).reshape(-1, 3)
    n = v.shape[0] // 3
    if n <= 0 or leaf_size <= 0:
        raise ValueError(f"a BVH needs triangles and a leaf size, got {n} and {leaf_size}")
    cap = 2 * n - 1
    bounds_min = np.empty((cap, 3), np.float32)
    bounds_max = np.empty((cap, 3), np.float32)
    # the node tables come back as [6, size]: flat here, cut to size after
    node_leaf, node_aabb, node_miss = (np.empty(6 * cap, np.int32) for _ in range(3))
    leaf_tris = np.empty((n, leaf_size * 9), np.float32)
    leaf_map = np.empty(n * leaf_size, np.int32)
    out = np.zeros(3, np.int32)
    rc = lib.radish_build_bvh(_ptr(v), n, leaf_size, _ptr(bounds_min), _ptr(bounds_max),
                              _ptr(node_leaf), _ptr(node_aabb), _ptr(node_miss),
                              _ptr(leaf_tris), _ptr(leaf_map), _ptr(out[0:1]),
                              _ptr(out[1:2]), _ptr(out[2:3]))
    if rc != 0:
        raise RuntimeError(f"radish_build_bvh returned {rc}")
    size, leaves, depth = (int(x) for x in out)
    return dict(bounds_min=bounds_min[:size].copy(), bounds_max=bounds_max[:size].copy(),
                node_leaf=node_leaf[:6 * size].reshape(6, size).copy(),
                node_aabb=node_aabb[:6 * size].reshape(6, size).copy(),
                node_miss=node_miss[:6 * size].reshape(6, size).copy(),
                leaf_tris=leaf_tris[:leaves].copy(),
                leaf_map=leaf_map[:leaves * leaf_size].copy(), leaf_size=leaf_size,
                depth=depth)


def cluster_cuts(pmin: np.ndarray, pmax: np.ndarray, sub: int, lam, chunk: int) -> np.ndarray:
    """The cut positions (int64, 0 to T) of ``_cluster_cuts_numpy`` with the
    same ``lam`` (numpy's lambda; the DP adds it in f32, as numpy does)."""
    lib = load_library()
    pmin = np.ascontiguousarray(pmin, np.float32)
    pmax = np.ascontiguousarray(pmax, np.float32)
    T = pmin.shape[0]
    out = np.empty(T + 1, np.int64)
    k = lib.radish_cluster_cuts(_ptr(pmin), _ptr(pmax), T, sub, float(np.float32(lam)),
                                chunk, _ptr(out))
    return out[:k].copy()


def load_obj(path: str):
    """(vertices, normals, texcoords) of the OBJ file at ``path``, the
    arrays ``load_obj_py`` makes; raises on a file it cannot parse."""
    lib = load_library()
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    h = lib.radish_obj_parse(os.fsencode(path))
    if not h:
        raise ValueError(f"OBJ file {path!r}: {lib.radish_obj_error().decode()}")
    try:
        nc = lib.radish_obj_num_corners(h)
        v = np.empty((nc, 3), np.float32)
        n = np.empty((nc, 3), np.float32)
        uv = np.empty((nc, 2), np.float32)
        lib.radish_obj_copy(h, _ptr(v), _ptr(n), _ptr(uv))
        return v, n, uv
    finally:
        lib.radish_obj_free(h)
