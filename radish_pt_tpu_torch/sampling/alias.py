"""Alias-method (Vose) discrete sampling.

Port of ``radish_pt_tpu/sampling/alias.py``: the table is built on the host
with numpy (the same Vose construction, pinned equal by the tests), and
device-side sampling is two gathers + one compare over a torch wavefront.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch


@dataclass
class AliasTable:
    """Host-built alias table; ``prob[i]`` is the acceptance probability of
    bucket i, ``alias[i]`` the fallback index.  ``total`` is the un-normalized
    sum of the input weights."""

    prob: np.ndarray  # float32 [n]
    alias: np.ndarray  # int32 [n]
    total: float

    @property
    def n(self) -> int:
        return int(self.prob.shape[0])


def build_alias_table(weights) -> AliasTable:
    """Build an alias table with Vose's algorithm (O(n)).

    Mirrors the semantics of ``DiscreteSampler1D`` (sampler.h:81-125) but
    with the standard numerically robust two-stack construction.
    """
    w = np.asarray(weights, dtype=np.float64).ravel()
    n = w.size
    if n == 0:
        return AliasTable(np.zeros(0, np.float32), np.zeros(0, np.int32), 0.0)
    total = float(w.sum())
    if total <= 0.0:
        # degenerate: uniform table
        return AliasTable(
            np.ones(n, np.float32), np.arange(n, dtype=np.int32), 0.0
        )
    scaled = w * (n / total)
    prob = np.ones(n, dtype=np.float64)
    alias = np.arange(n, dtype=np.int32)

    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large:
        prob[i] = 1.0
    for i in small:  # numerical leftovers
        prob[i] = 1.0
    return AliasTable(prob.astype(np.float32), alias, total)


def alias_sample(prob: torch.Tensor, alias: torch.Tensor, r1, r2):
    """Vectorized O(1) sample — device-side counterpart of
    ``DevDiscreteSampler1D::sample`` (sampler.h:205-209).

    r1, r2: uniform [0,1) f32 tensors of any shape; returns int32 indices of
    the same shape.
    """
    n = prob.shape[0]
    idx = torch.clamp((r1 * n).to(torch.int32), max=n - 1)
    p = prob[idx]
    a = alias[idx]
    return torch.where(r2 < p, idx, a).to(torch.int32)

