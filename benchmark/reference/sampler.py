"""Scrambled Sobol sampler, the Sobol table and the alias method: frozen
copies of the port's ``sampling/rng.py``, ``sampling/sobol.py`` (the scipy
generation alone) and ``sampling/alias.py``.

One change from the port: the dimension pointer may be a tensor with one
entry a lane, so that lanes of many frames (each its own looper) run in one
wavefront.  The numbers each lane draws are the port's.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from .vmath import u32_to_unit, utilhash

SOBOL_SAMPLE_NUM = 10000  # reference sampler.h:12
SOBOL_SAMPLE_DIM = 200  # reference sampler.h:13


def sobol_table(device) -> torch.Tensor:
    """The unscrambled [num * dim] Sobol table (Joe-Kuo direction numbers,
    scipy), flattened row-major, as int64 holding the u32 values."""
    from scipy.stats import qmc

    with warnings.catch_warnings():  # 10,000 is not a power of 2, as the reference's table
        warnings.simplefilter("ignore", UserWarning)
        pts = qmc.Sobol(d=SOBOL_SAMPLE_DIM, scramble=False, bits=32).random(SOBOL_SAMPLE_NUM)
    tab = (pts * (2.0**32)).astype(np.uint64).astype(np.uint32).reshape(-1)
    return torch.as_tensor(tab.astype(np.int64), device=device)


@dataclass
class SamplerState:
    scramble: torch.Tensor  # int64 [N], values in [0, 2^32)
    ptr: torch.Tensor  # int64, 0-d or [N]: the dimension pointer


def make_sampler(looper, pixel_index: torch.Tensor) -> SamplerState:
    """ptr = looper * SobolSampleDim, scramble = utilhash(pixel_index)
    (sampler.h:32-35); ``looper`` an int or an integer tensor, 0-d or one
    entry a lane."""
    if not isinstance(looper, torch.Tensor):
        looper = torch.tensor(int(looper), device=pixel_index.device)
    return SamplerState(scramble=utilhash(pixel_index),
                        ptr=looper.to(torch.int64) * SOBOL_SAMPLE_DIM)


def sample_1d(table: torch.Tensor, state: SamplerState):
    """r = table[ptr] ^ scramble, then scramble = utilhash(scramble),
    ptr += 1 (sampler.h:21-25); the pointer clamped into the table."""
    ptr = torch.clamp(state.ptr, 0, SOBOL_SAMPLE_NUM * SOBOL_SAMPLE_DIM - 1)
    bits = table[ptr] ^ state.scramble
    return u32_to_unit(bits), SamplerState(scramble=utilhash(state.scramble),
                                           ptr=state.ptr + 1)


def sample_nd(table, state: SamplerState, n: int):
    rs = []
    for _ in range(n):
        r, state = sample_1d(table, state)
        rs.append(r)
    return torch.stack(rs, dim=-1), state


def sample_2d(table, state):
    return sample_nd(table, state, 2)


def sample_3d(table, state):
    return sample_nd(table, state, 3)


def sample_4d(table, state):
    return sample_nd(table, state, 4)


@dataclass
class AliasTable:
    prob: np.ndarray  # float32 [n]
    alias: np.ndarray  # int32 [n]
    total: float


def build_alias_table(weights) -> AliasTable:
    """Vose's alias table (the port's two-stack construction)."""
    w = np.asarray(weights, dtype=np.float64).ravel()
    n = w.size
    if n == 0:
        return AliasTable(np.zeros(0, np.float32), np.zeros(0, np.int32), 0.0)
    total = float(w.sum())
    if total <= 0.0:
        return AliasTable(np.ones(n, np.float32), np.arange(n, dtype=np.int32), 0.0)
    scaled = w * (n / total)
    prob = np.ones(n, dtype=np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()  # noqa: E741
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large:
        prob[i] = 1.0
    for i in small:
        prob[i] = 1.0
    return AliasTable(prob.astype(np.float32), alias, total)


def alias_sample(prob: torch.Tensor, alias: torch.Tensor, r1, r2):
    """O(1) alias sample (sampler.h:205-209): int32 indices."""
    n = prob.shape[0]
    idx = torch.clamp((r1 * n).to(torch.int32), max=n - 1)
    p = prob[idx]
    a = alias[idx]
    return torch.where(r2 < p, idx, a).to(torch.int32)
