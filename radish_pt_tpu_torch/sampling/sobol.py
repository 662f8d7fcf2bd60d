"""Scrambled-Sobol sample table generation.

The reference loads a pre-baked binary ``sobol_10k_200.bin`` (10,000 samples
x 200 dims of uint32; ``reference/src/scene.cpp:542-549``) that is NOT
shipped with its repo.  We generate an equivalent table ourselves on the host
and cache it on disk.  Device code treats it as an opaque ``uint32`` array in
HBM, exactly like the reference.

This is a copy of ``radish_pt_tpu/sampling/sobol.py`` (tests pin the two
tables byte-equal); only the cache location differs: the port keeps its
table under its own ``_build/`` directory, never in the JAX package's cache.

Generation strategy (no network access, host-side only):
  1. ``scipy.stats.qmc.Sobol`` (Joe-Kuo direction numbers, ships with scipy).
  2. Fallback: own Sobol implementation for dim 0/1 + hashed lattice for
     higher dims (only used if scipy is somehow unavailable).
"""

from __future__ import annotations

import os

import numpy as np

SOBOL_SAMPLE_NUM = 10000  # reference sampler.h:12
SOBOL_SAMPLE_DIM = 200  # reference sampler.h:13

_CACHE_NAME = f"sobol_{SOBOL_SAMPLE_NUM}_{SOBOL_SAMPLE_DIM}.npy"


def _default_cache_path() -> str:
    root = os.environ.get(
        "RADISH_TORCH_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "_build"),
    )
    return os.path.join(root, _CACHE_NAME)


def _generate_scipy(num: int, dim: int) -> np.ndarray:
    from scipy.stats import qmc

    eng = qmc.Sobol(d=dim, scramble=False, bits=32)
    pts = eng.random(num)  # float64 in [0,1)
    return (pts * (2.0**32)).astype(np.uint64).astype(np.uint32)


def _generate_fallback(num: int, dim: int) -> np.ndarray:
    # Van der Corput base-2 for dim 0, Sobol dim-1 (s=1, poly x+1) for dim 1,
    # golden-ratio lattices for the rest.  Low quality but unbiased when
    # xor-scrambled per pixel.
    out = np.zeros((num, dim), dtype=np.uint32)
    i = np.arange(num, dtype=np.uint64)
    # radical inverse base 2
    v = i.copy()
    v = ((v & 0x55555555) << 1) | ((v >> 1) & 0x55555555)
    v = ((v & 0x33333333) << 2) | ((v >> 2) & 0x33333333)
    v = ((v & 0x0F0F0F0F) << 4) | ((v >> 4) & 0x0F0F0F0F)
    v = ((v & 0x00FF00FF) << 8) | ((v >> 8) & 0x00FF00FF)
    v = ((v << 16) | (v >> 16)) & 0xFFFFFFFF
    out[:, 0] = v.astype(np.uint32)
    for d in range(1, dim):
        frac = (i * np.uint64(2654435769 * (d * 2 + 1))) & np.uint64(0xFFFFFFFF)
        out[:, d] = frac.astype(np.uint32)
    return out


def generate_sobol_table(
    num: int = SOBOL_SAMPLE_NUM, dim: int = SOBOL_SAMPLE_DIM
) -> np.ndarray:
    """Returns a [num, dim] uint32 Sobol table (row-major flattenable to the
    reference's ``iter * SobolSampleDim + dim`` indexing, sampler.h:34)."""
    try:
        return _generate_scipy(num, dim)
    except Exception:
        return _generate_fallback(num, dim)


def load_sobol_table(cache_path: str | None = None) -> np.ndarray:
    """Load (or generate + cache) the Sobol table; shape [num*dim] uint32,
    flattened row-major so ``table[it * DIM + d]`` matches the reference."""
    path = cache_path or _default_cache_path()
    if os.path.exists(path):
        tab = np.load(path)
        if tab.shape == (SOBOL_SAMPLE_NUM * SOBOL_SAMPLE_DIM,):
            return tab
    tab = generate_sobol_table().reshape(-1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npy"  # atomic: parallel test workers
    np.save(tmp, tab)
    os.replace(tmp, path)
    return tab
