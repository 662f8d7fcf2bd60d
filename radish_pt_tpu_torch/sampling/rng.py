"""Wavefront sampler: scrambled Sobol + hash-RNG fallback.

Port of ``radish_pt_tpu/sampling/rng.py`` (reference sampler.h:11-64).  The
whole wavefront shares one scalar ``ptr`` (all lanes draw dimensions in
lockstep), a 0-d int64 tensor on the lanes' device as the reference's
traced int32 scalar, so that a frame reads no looper from the host and a
CUDA graph of frames replays with new loopers; each lane carries a u32
``scramble`` (int64 tensor) that evolves through the ``utilhash`` chain.
Bit-exact with the reference: r = f32(table[ptr] ^ scramble) * 2^-32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.math import u32_to_unit, utilhash
from .sobol import SOBOL_SAMPLE_DIM, SOBOL_SAMPLE_NUM


@dataclass
class SamplerState:
    """Sampler state for a wavefront of lanes."""

    scramble: torch.Tensor  # int64 [N], values in [0, 2^32)
    ptr: torch.Tensor  # int64 0-d: the shared dimension pointer


def make_sampler(looper, pixel_index: torch.Tensor) -> SamplerState:
    """Counterpart of ``makeSeededRandomEngine`` (sampler.h:32-35):
    ptr = looper * SobolSampleDim, scramble = utilhash(pixel_index).
    ``looper`` is an int or an integer 0-d tensor on the lanes' device."""
    if isinstance(looper, torch.Tensor):
        ptr = looper.to(torch.int64) * SOBOL_SAMPLE_DIM
    else:  # a fill, not a copy from the host
        ptr = torch.full((), int(looper) * SOBOL_SAMPLE_DIM, dtype=torch.int64,
                         device=pixel_index.device)
    return SamplerState(scramble=utilhash(pixel_index), ptr=ptr)


def sample_1d(table: torch.Tensor | None, state: SamplerState):
    """Draw one dimension for all lanes; returns (r in [0,1], new state).

    Sobol mode (``table`` is the flattened u32 table as int64): r =
    table[ptr] ^ scramble, then scramble = utilhash(scramble), ptr += 1 —
    sampler.h:21-25.  ``table`` None uses the counter-based hash RNG.
    """
    if table is not None:
        ptr = torch.clamp(state.ptr, 0, SOBOL_SAMPLE_NUM * SOBOL_SAMPLE_DIM - 1)
        bits = torch.index_select(table, 0, ptr.reshape(1)) ^ state.scramble
    else:
        salt = (state.ptr * 0x9E3779B9) & 0xFFFFFFFF
        bits = utilhash(state.scramble ^ salt)
    return u32_to_unit(bits), SamplerState(
        scramble=utilhash(state.scramble), ptr=state.ptr + 1
    )


def sample_nd(table, state: SamplerState, n: int):
    """``n`` consecutive draws stacked on the last axis ([N, n])."""
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
