"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``radish_pt_tpu_torch/_build/`` (git-ignored) under a name
keyed by a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = "sm_90a"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict = {}
BUILD_SECONDS: dict = {}  # library name -> seconds spent compiling


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ on a machine with the CUDA toolkit")


def _sources(name: str) -> list[str]:
    return [os.path.join(CSRC, f"{name}.cu")]


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` unless the hashed library exists; returns
    its path.  ``verbose`` adds ``-Xptxas -v`` (registers, spills)."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *_sources(name)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, path)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return path


def load_plucker_library():
    """The Plücker sweep library with its C entry points typed."""
    lib = _libs.get("plucker")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(build("plucker"))
    p, i = ctypes.c_void_p, ctypes.c_int
    common = [p, i, i, p, i, p, i]  # coeffs, T, sub, feats, N, mask, words
    lib.plucker_closest_hit.argtypes = common + [p, p, p]
    lib.plucker_closest_hit.restype = i
    lib.plucker_occlusion.argtypes = common + [p, p, p]
    lib.plucker_occlusion.restype = i
    _libs["plucker"] = lib
    return lib
