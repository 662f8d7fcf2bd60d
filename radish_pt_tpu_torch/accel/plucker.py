"""Plücker closest-hit and shadow sweeps: wrappers, plain versions, prepass.

Port of the main-path engine of ``radish_pt_tpu/accel/pallas_kernels.py``:
``intersect_plucker_pallas`` (:669, kernel ``_plucker_kernel`` :344) and
``occlusion_plucker_pallas`` (:805, kernel ``_plucker_occl_kernel`` :463).

Möller–Trumbore's four decision quantities are bilinear in per-ray features
``f = [d, o x d, o, 1]`` (o centred on ``sweep_center``) and per-triangle
build-time coefficients ``c [T, 4, 10]`` (pallas_kernels.py:210-225):
det = c0·f, bx = c1·f, by = c2·f, t·det = c3·f.  With sd = det², a
triangle is hit when

    min(bx·det, by·det, sd - bx·det - by·det, sd - eps², t·det·det) >= 0

(inclusive edges) at t = t·det·det / sd; a segment with range ``tm`` is
blocked when min(v, t·det·det, tm·sd - t·det·det) >= 0 for some triangle
(v the first four terms).  Zero triangles (cluster padding) have det = 0
and never pass.

Culling: a slab-test prepass (:func:`cluster_mask_words`, the XLA
``_cluster_mask_bits`` :599) flags, per 128-lane row, every cluster of
``sub`` consecutive triangles that any ray of the row may hit within its
``tmax``; the sweep visits only flagged clusters.  Without cluster bounds
(small scenes) every triangle is swept.

Each sweep has two implementations with one contract:
* ``*_cuda``: the hand-written kernels of ``csrc/plucker.cu`` (one thread
  per ray, exact f32 FMA, the winner is the exact minimum t with ties to the
  lower id);
* ``*_plain``: the same arithmetic in plain torch, over the triangles of
  the clusters some row of a chunk of lanes flags, gated per lane
  (:func:`sweep_closest`, :func:`sweep_any`; the quad, band and compact
  engines' plain sweeps share them).
``closest_hit`` / ``occlusion`` dispatch on the tensors' device: CPU tensors
take the plain version, CUDA tensors launch the kernel (or raise) — there is
no fallback between the two.  ``LAUNCHES`` counts kernel launches and
``PLAIN_CALLS`` plain-version calls, per sweep kind.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.math import cross
from .traverse import FLT_MAX, NULL_PRIMITIVE, segment_rays

PLUCKER_EPS2 = 1.1920929e-07 ** 2  # det² threshold == |det| >= eps
ROW = 128  # lanes per culling row (one CUDA block)

# f32 operations per (ray, triangle) pair: the planes' 19 products (4
# multiplies, 15 fused multiply-adds: 34 flops) and the decision terms
# (det², bx·det, by·det, t·det·det, two subtractions, det² - eps²: 7; the
# shadow test adds tm·det² - t·det·det: 2); mins and compares not counted
FLOPS_PER_PAIR = {"closest_hit": 41, "occlusion": 43}
# the 19 coefficients of ``coeffs`` [T, 4, 10] (flattened to 40) that can be
# non-zero, in the kernels' staging order: det reads d, bx and by read d and
# o x d, t·det reads o and 1
LIVE_SLOTS = (*range(0, 3), *range(10, 16), *range(20, 26), *range(36, 40))
PACKED_WIDTH = 20  # floats per packed triangle: the live slots and one zero

LAUNCHES = {"closest_hit": 0, "occlusion": 0}
PLAIN_CALLS = {"closest_hit": 0, "occlusion": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# features and the cluster-mask prepass
# ---------------------------------------------------------------------------


def plucker_features(ray_o, ray_d, center):
    """Per-ray features [N, 10] = [d, (o-c) x d, o-c, 1]."""
    o = ray_o - center
    return torch.cat([ray_d, cross(o, ray_d), o, torch.ones_like(o[:, :1])],
                     dim=1).contiguous()


def cluster_mask_words(cluster_bounds, ray_o, ray_d, tmax):
    """Per 128-lane row, the clusters any of its rays may hit before tmax
    (conservative slab test), packed 32 per int32 word: bit j of word w
    flags cluster 32·w + j.  Returns int32 [ceil(N/128), ceil(C/32)].

    The same f32 arithmetic as the reference prepass, including its padding
    of the last row (o = 0, d = 1, tmax = 0, or FLT_MAX without tmax)."""
    n = ray_o.shape[0]
    n_pad = -(-n // ROW) * ROW
    pad = n_pad - n
    dev = ray_o.device
    o = torch.cat([ray_o, ray_o.new_zeros((pad, 3))])
    d = torch.cat([ray_d, ray_d.new_ones((pad, 3))])
    if tmax is None:
        tm = torch.full((n_pad, 1), FLT_MAX, device=dev)
    else:
        tm = torch.cat([tmax, tmax.new_zeros((pad,))])[:, None]
    cb = cluster_bounds
    inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, torch.full_like(d, 1e-12))
    n_c = cb.shape[0]
    tn = torch.full((n_pad, n_c), -FLT_MAX, device=dev)
    tf = torch.full((n_pad, n_c), FLT_MAX, device=dev)
    for k in range(3):
        a = (cb[None, :, k] - o[:, k, None]) * inv[:, k, None]
        b = (cb[None, :, 3 + k] - o[:, k, None]) * inv[:, k, None]
        tn = torch.maximum(tn, torch.minimum(a, b))
        tf = torch.minimum(tf, torch.maximum(a, b))
    hit = (tf >= torch.clamp(tn, min=0.0)) & (tn < tm)  # [n_pad, C]
    return pack_words(hit.view(n_pad // ROW, ROW, n_c).any(dim=1))


def pack_words(flags):
    """bool [R, C] -> int32 [R, ceil(C/32)] words: bit j of word w is
    flags[:, 32·w + j]."""
    n_c = flags.shape[1]
    n_words = -(-n_c // 32)
    flags = torch.nn.functional.pad(flags, (0, n_words * 32 - n_c))
    weights = torch.ones(32, dtype=torch.int64, device=flags.device) << torch.arange(
        32, device=flags.device)
    words = (flags.view(-1, n_words, 32).to(torch.int64) * weights).sum(-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).contiguous()


def unpack_mask(words, n_clusters):
    """[rows, W] int32 words -> bool [rows, n_clusters]."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :n_clusters].bool()


def flagged_chunks(flags, lanes: int, sub: int, num_tris: int, n: int,
                   device, budget: int = 1 << 24):
    """Chunks of lanes for a plain sweep that visits only flagged clusters:
    yields (lo, hi, tri, keep) for lanes [lo, hi), with ``tri`` the
    ascending ids (int64) of the triangles of every cluster of ``sub``
    triangles that some lane group of the chunk flags, and ``keep`` bool
    [hi - lo, len(tri)] whether the lane's own group (lane // ``lanes``)
    flags the triangle's cluster.  ``flags`` is bool [groups, C] (None:
    every triangle for every lane, ``keep`` None); a chunk holds at most
    about ``budget`` (lane, triangle) pairs."""
    if flags is None:
        step = max(1, budget // max(num_tris, 1))
        tri = torch.arange(num_tris, device=device)
        for lo in range(0, n, step):
            yield lo, min(n, lo + step), tri, None
        return
    groups = flags.shape[0]
    per = int(flags.sum(1).max()) if groups else 0
    # the union of k groups' clusters is at most k·per: k² · lanes·sub·per
    # pairs stay within the budget
    step = max(1, math.isqrt(budget // (lanes * sub * max(per, 1))))
    for g0 in range(0, groups, step):
        g1 = min(groups, g0 + step)
        lo, hi = g0 * lanes, min(n, g1 * lanes)
        if lo >= hi:
            break
        units = torch.nonzero(flags[g0:g1].any(0)).flatten()
        tri = (units[:, None] * sub + torch.arange(sub, device=device)).flatten()
        col = torch.arange(units.numel(), device=device).repeat_interleave(sub)
        real = tri < num_tris  # the last cluster may be ragged
        tri, col = tri[real], col[real]
        keep = flags[g0:g1][:, units][:, col].repeat_interleave(lanes, 0)
        yield lo, hi, tri, keep[:hi - lo]


def mask_flags(mask, sub: int, num_tris: int):
    """Cluster words -> bool [groups, ceil(T / sub)] (None stays None)."""
    return None if mask is None else unpack_mask(mask, -(-num_tris // sub))


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def _planes(coeffs, feats):
    """(det, bx, by, t·det) [R, T] for feature rows ``feats`` [R, 10]."""
    if feats.is_cuda:  # the reference planes are full f32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    t = coeffs.shape[0]
    q = (feats @ coeffs.reshape(t * 4, 10).t()).view(-1, t, 4)
    return q.unbind(-1)


def _decide(coeffs, feats):
    """(u, sd, tdd) [R, T] for feature rows ``feats`` [R, 10]: the pair
    passes when u >= 0, at t = tdd / sd."""
    det, bx, by, td = _planes(coeffs, feats)
    sd = det * det
    bxd = bx * det
    byd = by * det
    v = torch.minimum(torch.minimum(bxd, byd), sd - bxd - byd)
    v = torch.minimum(v, sd - PLUCKER_EPS2)
    tdd = td * det
    return torch.minimum(v, tdd), sd, tdd


def hit_t(coeffs, feats):
    """t f32 [R, T] of every (ray, triangle) pair for feature rows ``feats``
    [R, 10]: tdd / sd where the pair passes, FLT_MAX where it does not."""
    u, sd, tdd = _decide(coeffs, feats)
    return torch.where(u >= 0.0, tdd / sd, FLT_MAX)


def blocks(coeffs, feats, tm):
    """bool [R, T]: the triangle blocks the segment of range ``tm`` f32
    [R] (feature rows ``feats`` [R, 10])."""
    u, sd, tdd = _decide(coeffs, feats)
    return torch.minimum(u, tm[:, None] * sd - tdd) >= 0.0


def closest_hit_plain(coeffs, feats, mask, sub):
    """Plain torch closest hit.  ``coeffs`` f32 [T, 4, 10], ``feats`` f32
    [N, 10], ``mask`` int32 [ceil(N/128), W] cluster words (None: sweep
    every triangle), ``sub`` triangles per cluster.  Returns
    (prim i32 [N], dist f32 [N]): the exact minimum t over the triangles of
    the clusters the lane's row flags, ties to the lower id; misses are
    (-1, FLT_MAX)."""
    PLAIN_CALLS["closest_hit"] += 1
    return sweep_closest(coeffs, feats, mask_flags(mask, sub, coeffs.shape[0]),
                         ROW, sub, hit_t)


def occlusion_plain(coeffs, feats, tm, mask, sub):
    """Plain torch any-hit: True where some (flagged) triangle blocks the
    segment of range ``tm`` f32 [N].  Arguments as :func:`closest_hit_plain`."""
    PLAIN_CALLS["occlusion"] += 1
    return sweep_any(coeffs, feats, mask_flags(mask, sub, coeffs.shape[0]),
                     ROW, sub, lambda c, f, lo, hi: blocks(c, f, tm[lo:hi]))


def sweep_closest(coeffs, feats, flags, lanes, sub, t_of, budget: int = 1 << 24):
    """The plain closest hit over :func:`flagged_chunks`: (prim i32 [N],
    dist f32 [N]), the minimum of ``t_of(coeffs[tri], feats[lo:hi])``
    (f32 [R, len(tri)], FLT_MAX for a miss) over each lane's flagged
    triangles, ties to the lower id."""
    n, dev = feats.shape[0], feats.device
    prim = torch.full((n,), NULL_PRIMITIVE, dtype=torch.int32, device=dev)
    dist = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    for lo, hi, tri, keep in flagged_chunks(flags, lanes, sub, coeffs.shape[0], n,
                                            dev, budget):
        if tri.numel() == 0:
            continue
        t = t_of(coeffs[tri], feats[lo:hi])
        if keep is not None:
            t = torch.where(keep, t, FLT_MAX)
        best, idx = torch.min(t, dim=1)  # first minimum: lower id on ties
        prim[lo:hi] = torch.where(best < FLT_MAX, tri[idx].to(torch.int32),
                                  NULL_PRIMITIVE)
        dist[lo:hi] = best
    return prim, dist


def sweep_any(coeffs, feats, flags, lanes, sub, blocked, budget: int = 1 << 24):
    """The plain any-hit over :func:`flagged_chunks`: bool [N], True where
    ``blocked(coeffs[tri], feats[lo:hi], lo, hi)`` (bool [R, len(tri)])
    holds for one of the lane's flagged triangles."""
    n, dev = feats.shape[0], feats.device
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    for lo, hi, tri, keep in flagged_chunks(flags, lanes, sub, coeffs.shape[0], n,
                                            dev, budget):
        if tri.numel() == 0:
            continue
        hit = blocked(coeffs[tri], feats[lo:hi], lo, hi)
        if keep is not None:
            hit &= keep
        occ[lo:hi] = hit.any(dim=1)
    return occ


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/plucker.cu)
# ---------------------------------------------------------------------------


def _check_inputs(coeffs, feats, mask, sub):
    if not (coeffs.is_cuda and feats.is_cuda):
        raise ValueError("the CUDA sweep takes CUDA tensors")
    if coeffs.dtype != torch.float32 or feats.dtype != torch.float32:
        raise TypeError("coeffs and feats must be float32")
    if coeffs.dim() != 3 or coeffs.shape[1:] != (4, 10):
        raise ValueError(f"coeffs must be [T, 4, 10], got {tuple(coeffs.shape)}")
    if feats.dim() != 2 or feats.shape[1] != 10:
        raise ValueError(f"feats must be [N, 10], got {tuple(feats.shape)}")
    if not (coeffs.is_contiguous() and feats.is_contiguous()):
        raise ValueError("coeffs and feats must be contiguous")
    if mask is not None:
        rows = -(-feats.shape[0] // ROW)
        if (not mask.is_cuda or mask.dtype != torch.int32 or mask.dim() != 2
                or mask.shape[0] != rows or not mask.is_contiguous()):
            raise ValueError("mask must be contiguous int32 [ceil(N/128), W] "
                             "on the card")
        if coeffs.shape[0] % sub or mask.shape[1] * 32 < coeffs.shape[0] // sub:
            raise ValueError("coeffs rows must be whole clusters covered by "
                             "the mask words")


def _launch_args(coeffs, feats, mask, sub):
    import ctypes

    from ._build import load_library

    lib = load_library("plucker")
    n_words = 0 if mask is None else mask.shape[1]
    mask_ptr = None if mask is None else mask.data_ptr()
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    args = (ctypes.c_void_p(coeffs.data_ptr()), ctypes.c_int(coeffs.shape[0]),
            ctypes.c_int(sub), ctypes.c_void_p(feats.data_ptr()),
            ctypes.c_int(feats.shape[0]), ctypes.c_void_p(mask_ptr),
            ctypes.c_int(n_words))
    return lib, args, ctypes.c_void_p(stream)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def closest_hit_cuda(coeffs, feats, mask, sub):
    """The closest-hit kernel (``plucker_closest_hit`` in csrc/plucker.cu);
    same contract as :func:`closest_hit_plain`."""
    _check_inputs(coeffs, feats, mask, sub)
    n = feats.shape[0]
    prim = torch.empty((n,), dtype=torch.int32, device=feats.device)
    dist = torch.empty((n,), dtype=torch.float32, device=feats.device)
    if n == 0:
        return prim, dist
    import ctypes

    lib, args, stream = _launch_args(coeffs, feats, mask, sub)
    with torch.cuda.device(feats.device):
        err = lib.plucker_closest_hit(
            *args, ctypes.c_void_p(prim.data_ptr()),
            ctypes.c_void_p(dist.data_ptr()), stream)
    _raise_on(err, "plucker_closest_hit")
    LAUNCHES["closest_hit"] += 1
    return prim, dist


def occlusion_cuda(coeffs, feats, tm, mask, sub):
    """The shadow kernel (``plucker_occlusion`` in csrc/plucker.cu); same
    contract as :func:`occlusion_plain`."""
    _check_inputs(coeffs, feats, mask, sub)
    n = feats.shape[0]
    if not (tm.is_cuda and tm.dtype == torch.float32 and tm.shape == (n,)
            and tm.is_contiguous()):
        raise ValueError("tm must be contiguous float32 [N] on the card")
    occ = torch.empty((n,), dtype=torch.int32, device=feats.device)
    if n == 0:
        return occ.bool()
    import ctypes

    lib, args, stream = _launch_args(coeffs, feats, mask, sub)
    with torch.cuda.device(feats.device):
        err = lib.plucker_occlusion(
            *args, ctypes.c_void_p(tm.data_ptr()),
            ctypes.c_void_p(occ.data_ptr()), stream)
    _raise_on(err, "plucker_occlusion")
    LAUNCHES["occlusion"] += 1
    return occ.bool()


def closest_hit(coeffs, feats, mask, sub):
    """Closest-hit sweep: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if feats.is_cuda:
        return closest_hit_cuda(coeffs, feats, mask, sub)
    return closest_hit_plain(coeffs, feats, mask, sub)


def occlusion(coeffs, feats, tm, mask, sub):
    """Shadow sweep: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if feats.is_cuda:
        return occlusion_cuda(coeffs, feats, tm, mask, sub)
    return occlusion_plain(coeffs, feats, tm, mask, sub)


# ---------------------------------------------------------------------------
# scene-level entry points
# ---------------------------------------------------------------------------


def intersect_plucker(coeffs, center, cluster_bounds, sub, ray_o, ray_d,
                      tmax=None, plain: bool = False):
    """Closest hit of rays against the stored triangles; (prim i32 [N],
    selector-grade dist f32 [N]).  ``tmax`` (f32 [N]) bounds only the
    culling prepass (-FLT_MAX marks a dead lane, which flags nothing).
    ``plain`` selects the plain torch sweep on any device."""
    feats = plucker_features(ray_o, ray_d, center)
    mask = None
    if cluster_bounds is not None:
        mask = cluster_mask_words(cluster_bounds, ray_o, ray_d, tmax)
    sweep = closest_hit_plain if plain else closest_hit
    return sweep(coeffs, feats, mask, sub)


def occlusion_plucker(coeffs, center, cluster_bounds, sub, x, y,
                      plain: bool = False):
    """True where segment x->y is blocked (bool [N]).  A zero-length
    segment (y == x, a masked lane) has d = 0, so det = 0: never blocked."""
    ray_o, ray_d, tm = segment_rays(x, y)
    feats = plucker_features(ray_o, ray_d, center)
    mask = None
    if cluster_bounds is not None:
        mask = cluster_mask_words(cluster_bounds, ray_o, ray_d, tm)
    sweep = occlusion_plain if plain else occlusion
    return sweep(coeffs, feats, tm.contiguous(), mask, sub)


def numpy_coeffs(tri_packed: np.ndarray):
    """Build-time planes in f32 numpy: (coeffs [T, 4, 10], center [3]) —
    the reference's ``_plucker_coeffs`` (:577) and centre
    (precompute_sweep_coeffs :2218-2219), without the M-stacking."""
    tp = np.asarray(tri_packed, np.float32)
    v0w = tp[:, 0:3]
    center = (np.float32(0.5) * (v0w.min(axis=0) + v0w.max(axis=0))).astype(
        np.float32)
    v0 = v0w - center
    e1 = tp[:, 3:6]
    e2 = tp[:, 6:9]

    def cross(a, b):
        return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)

    n = cross(e1, e2)
    z3 = np.zeros_like(v0)
    z1 = np.zeros_like(v0[:, :1])
    nv = (v0[:, 0] * n[:, 0] + v0[:, 1] * n[:, 1] + v0[:, 2] * n[:, 2])[:, None]
    c_det = np.concatenate([cross(e2, e1), z3, z3, z1], axis=1)
    c_bx = np.concatenate([-cross(e2, v0), e2, z3, z1], axis=1)
    c_by = np.concatenate([cross(e1, v0), -e1, z3, z1], axis=1)
    c_td = np.concatenate([z3, z3, n, -nv], axis=1)
    coeffs = np.stack([c_det, c_bx, c_by, c_td], axis=1)  # [T, 4, 10]
    return np.ascontiguousarray(coeffs, np.float32), center


def numpy_packed_coeffs(coeffs: np.ndarray) -> np.ndarray:
    """The live coefficients of ``coeffs`` [T, 4, 10] packed to f32
    [T, 20]: :data:`LIVE_SLOTS` in order, slot 19 zero — one triangle is 80
    bytes, 16-byte aligned, read by a kernel as five ``float4``
    (``csrc/plucker_planes.cuh``)."""
    flat = np.asarray(coeffs, np.float32).reshape(-1, 40)
    out = np.zeros((flat.shape[0], PACKED_WIDTH), np.float32)
    out[:, :len(LIVE_SLOTS)] = flat[:, list(LIVE_SLOTS)]
    return out
