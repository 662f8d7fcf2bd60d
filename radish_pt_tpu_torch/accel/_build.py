"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``radish_pt_tpu_torch/_build/``
(git-ignored) under a name keyed by a hash of its source, the shared
headers and the flags, so an edited kernel rebuilds and an unchanged one is
reused.  :func:`build_all` starts one ``nvcc`` per source at once.  A
build may take its sources from another ``csrc`` directory into another
build directory (another checkout's kernels, timed beside these).  Nothing
here runs at import time.  Builds and loads are the set-up span
``setup.kernel_libs`` (utils/timing.py); counter ``kernels.built``, one an
nvcc run.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess

from ..utils import timing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = "sm_90a"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# library -> C entry point -> argument types (every entry point returns the
# launch's cudaGetLastError() as an int)
SIGNATURES = {
    "plucker": {
        # packed, T, sub, bounds, clusters, ray_o, ray_d, tmax | tm, feats, N,
        # (prim, dist | occ), stream
        "plucker_closest_hit": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P],
        "plucker_occlusion": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P],
    },
    "compact": {
        # feats, planes, rows, units, flags, tn, stream
        "compact_sphere_flags": [_P, _P, _I, _I, _P, _P, _P],
        # packed, T, unit_tris, spheres, feats, tmax | tm, N, items, item_tn,
        # offsets, rows, (prim, dist | occ), stream
        "compact_closest_hit": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P],
        "compact_occlusion": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P],
    },
    "quad": {
        # packed, T, sub, feats, N, mask, words, prim, dist, stream
        "quad_closest_hit": [_P, _I, _I, _P, _I, _P, _I, _P, _P, _P],
        # packed, T, sub, bounds, clusters, ray_o, seg, feats, N, occ, stream
        "quad_occlusion": [_P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P],
    },
    "band": {
        # packed, T, bounds, word_bounds, clusters, ray_o, ray_d, tmax | tm,
        # feats, N, g, (prim, dist | occ), stream
        "band_closest_hit": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P],
        "band_occlusion": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P],
    },
    "dense": {
        # tri_packed, T, ray_o, ray_d, N, prim, dist, bary, stream
        "dense_closest_hit": [_P, _I, _P, _P, _I, _P, _P, _P, _P],
        # tri_packed, T, ray_o, ray_d, tmax, N, occ, stream
        "dense_occlusion": [_P, _I, _P, _P, _P, _I, _P, _P],
    },
    "bvh": {
        # ray_d, tmax (or NULL), N, dead lanes' output kind, (prim, dist, bary
        # | occ | NULL), ws (queue and counters), stream
        "bvh_bin": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
        # nodes, B, leaf_tris, L, ray_o, ray_d, N, then tmax (or NULL),
        # leaf_map, prim, dist, bary, ws | tmax, occ, ws | steps, stream
        "bvh_closest_hit": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
        "bvh_occlusion": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P],
        "bvh_heatmap": [_P, _I, _P, _I, _P, _P, _I, _P, _P],
    },
    "sort_key": {
        # boxes, C, ray_o, ray_d, tmax (or NULL), every lane's range, range
        # mode, active (or NULL), N, band form, miss_extra, key, stream
        "signature_key": [_P, _I, _P, _P, _P, ctypes.c_float, _I, _P, _I, _I, _I, _P, _P],
    },
    "ris": {
        # the launch's arguments (render/ris.py::RisArgs), stream
        "ris_candidates": [_P, _P],
        # the area lights a block stages in shared memory
        "ris_smem_lights": [],
    },
    "vertex": {
        # the launch's arguments (render/vertex.py::VertexArgs), stream
        "vertex_shade": [_P, _P],
    },
    "surface": {
        # the launch's arguments (render/surface.py::SurfaceArgs), stream
        "surface_shade": [_P, _P],
    },
    "stage_mark": {
        # stage index (utils/timing.py STAGES), stream
        "stage_mark": [_I, _P],
    },
}

_libs: dict = {}
PTXAS_LOG: dict = {}  # library name -> nvcc's output of a verbose build


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ on a machine with the CUDA toolkit")


def library_path(name: str, defines: tuple = (), csrc: str = CSRC,
                 build_dir: str = BUILD_DIR) -> str:
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    for src in [os.path.join(csrc, f"{name}.cu"),
                *sorted(glob.glob(os.path.join(csrc, "*.cuh")))]:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(names=tuple(SIGNATURES), verbose: bool = False,
              defines: tuple = (), csrc: str = CSRC, build_dir: str = BUILD_DIR) -> dict:
    """Compile every ``<csrc>/<name>.cu`` whose hashed library is missing
    from ``build_dir``, one ``nvcc`` per source, all started together;
    returns name -> path.  ``verbose`` adds ``-Xptxas -v`` and keeps what
    it prints in :data:`PTXAS_LOG` (registers, spills per kernel).
    ``defines`` are extra ``-DNAME=value`` flags (a tuning variant: its own
    library)."""
    with timing.span("setup.kernel_libs"):
        os.makedirs(build_dir, exist_ok=True)
        jobs = {}
        for name in names:
            path = library_path(name, defines, csrc, build_dir)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, *defines,
                   *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, os.path.join(csrc, f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, path)
        failed = []
        for name, (proc, tmp, path) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}:\n{out}")
                continue
            if verbose:
                PTXAS_LOG[name] = out
            os.replace(tmp, path)
            timing.count("kernels.built")
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name, defines, csrc, build_dir) for name in names}


def kernel_resources(name: str) -> dict:
    """Per kernel of ``csrc/<name>.cu``, what ``ptxas -v`` reported in a
    verbose build of this process: {mangled kernel name: {"registers",
    "spill_stores", "spill_loads", "smem"}} (bytes; empty if the library
    was not built verbosely here)."""
    out, entry = {}, None
    for line in PTXAS_LOG.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = out.setdefault(m.group(1), {"registers": None, "spill_stores": 0,
                                                "spill_loads": 0, "smem": 0})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["smem"] = int(m.group(1)) if m else 0
    return out


def load_library(name: str, defines: tuple = (), csrc: str = CSRC,
                 build_dir: str = BUILD_DIR):
    """The library of ``<csrc>/<name>.cu`` with its C entry points typed
    as :data:`SIGNATURES` types them (``defines``, another ``csrc``: a
    tuning variant or another checkout's kernel, not cached)."""
    own = not defines and csrc == CSRC
    lib = _libs.get(name) if own else None
    if lib is not None:
        return lib
    path = build_all((name,), defines=defines, csrc=csrc, build_dir=build_dir)[name]
    with timing.span("setup.kernel_libs"):
        lib = ctypes.CDLL(path)
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
    if own:
        _libs[name] = lib
    return lib
