"""Quadratic-form closest-hit and shadow sweeps: the opt-in quad engine.

Port of ``radish_pt_tpu/accel/pallas_kernels.py:1810-2506``:
``intersect_quad_pallas`` (:2288, kernel ``_quad_kernel`` :1974) and
``occlusion_quad_pallas`` (:2407, kernel ``_quad_occl_kernel`` :2058).

Multiplying Möller–Trumbore's decision quantities through by det makes each
a quadratic form in the ray's 10 linear features (d, m = o x d, o, 1), that
is a linear form in 27 monomials (:1814-1829):

    q1 = bx·det >= 0          q2 = by·det >= 0
    q3 = det² - (bx + by)·det >= 0
    q4 = det² - eps²·|d|² >= 0
    q5 = t·det·det >= 0       q6 = det² - t·det·det >= 0  (segments only)

Per-ray features f [N, 28] = [d⊗d sym (6), m⊗d (9), o⊗d (9), d (3), 1]
(o centred on the scene); per-triangle coefficients c [T, 6, 28], built in
f32 from ``tri_packed`` (the constant slot's coefficient is always 0).  A
ray hits a triangle when min(q1..q5) >= 0 (inclusive, as the reference's
code has it) at t = q5 / (q4 + eps²); a segment x -> y, carried
unnormalized so that t runs over [0, 1], is blocked when min(q1..q6) >= 0
for some triangle.  Pad triangles are all-zero triangles, whose q4 is
-eps²·|d|² < 0: they never pass.  A zero-length segment has all-zero
features, so every q is 0 and it reads as blocked — the reference's
behaviour (:2109-2118), kept here.

Culling is the Plücker engine's per-128-lane-row slab test
(:func:`.plucker.cluster_mask_words`, as ``_quad_launch`` calls
``_cluster_mask_bits``): the closest hit reads the prepass's row words,
the shadow kernel votes its row's words itself (:func:`occl_words_plain`
is its vote in plain torch, equal to the prepass bit for bit), so the
shadow path calls no prepass on the card.  Each sweep has a kernel
(``csrc/quad.cu``) and a plain torch version with one contract: every
form is summed over the 27 monomials in order, one f32 fused
multiply-add per term (the plain version forms each exact product in
f64, adds and rounds to f32), so the two agree to the ulp.  The kernels
leave out the terms whose coefficient is zero by construction (72 of
q1..q5's 135, 81 of q1..q6's 162; they read the live ones from the packed
tables of :func:`numpy_quad_packed` and :func:`numpy_quad_occl_packed`): a
dropped term adds an exact zero, so their values are the plain version's
(:func:`forms_live` is their summation in plain torch).  Inside the shadow
sweep a segment passes over the clusters its own grown box cannot reach
at t = 1 (:func:`.plucker.lane_skip_flags_plain`: no result moves).
``closest_hit`` / ``occlusion`` take the plain version for CPU tensors
and launch the kernel (or raise) for CUDA tensors.  They count
``launch.quad.*`` kernel launches and ``plain.quad.*`` plain-version calls
(utils/timing.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import timing
from ..utils.math import cross
from .plucker import (GROUP, PLUCKER_EPS2, ROW, cluster_mask_words,
                      lane_cluster_flags_plain, mask_flags, pack_words,
                      sweep_any, sweep_closest)
from .traverse import FLT_MAX, RAY_OFFSET, SHADOW_EPS

_PLAIN_PAIRS = 1 << 22  # (lane, triangle) pairs per plain-sweep chunk

QUAD_FEATS = 28  # 27 monomials + the constant slot (coefficient 0)
QUAD_LIVE = 27
STORED_PLANES = 6  # q1..q6 per triangle; the closest hit reads q1..q5
CLOSEST_PLANES = 5
# the monomials whose coefficient can be non-zero, per form (the ranges of
# :func:`numpy_quad_coeffs`' ``row``): q1..q3 read d⊗d and m⊗d, q4 d⊗d, q5
# o⊗d and d (q6, the shadow test's, d⊗d, o⊗d and d)
LIVE_TERMS = (range(0, 15), range(0, 15), range(0, 15), range(0, 6),
              range(15, 27), (*range(0, 6), *range(15, 27)))
# the closest hit's 63 live coefficients of q1..q5 as slots of the
# flattened [6 * 28] row, form by form in monomial order: the packed
# table's layout, one zero slot appended (64 floats, sixteen float4)
LIVE_SLOTS = tuple(p * QUAD_FEATS + k for p in range(CLOSEST_PLANES)
                   for k in LIVE_TERMS[p])
PACKED_WIDTH = 64
# the shadow sweep's 81 live coefficients of q1..q6, in the same order:
# the packed shadow table's layout, three zero slots appended (84 floats,
# twenty-one float4)
OCCL_SLOTS = tuple(p * QUAD_FEATS + k for p in range(STORED_PLANES)
                   for k in LIVE_TERMS[p])
OCCL_PACKED_WIDTH = 84
# f32 operations per (ray, triangle) pair, the min chain not counted: each
# form over its live terms, one multiply and then fused multiply-adds:
# 3 x 29 + 11 + 23 for the closest hit's five, + 35 for q6.  Summed over
# all 27 monomials a form is 53 flops (the *_ALL_TERMS counts)
FLOPS_PER_PAIR = {kind: sum(2 * len(LIVE_TERMS[p]) - 1 for p in range(planes))
                  for kind, planes in (("closest_hit", CLOSEST_PLANES),
                                       ("occlusion", STORED_PLANES))}
CLOSEST_FLOPS_ALL_TERMS = CLOSEST_PLANES * 53
OCCL_FLOPS_ALL_TERMS = STORED_PLANES * 53




# ---------------------------------------------------------------------------
# features and build-time coefficients
# ---------------------------------------------------------------------------


def quad_features(ray_o, ray_d, center):
    """Per-ray monomial features f32 [N, 28] (``_quad_features`` :1904)."""
    o = ray_o - center
    d = ray_d
    mm = cross(o, d)
    dd = torch.stack([d[:, 0] * d[:, 0], d[:, 1] * d[:, 1], d[:, 2] * d[:, 2],
                      d[:, 0] * d[:, 1], d[:, 0] * d[:, 2], d[:, 1] * d[:, 2]], 1)
    md = (mm[:, :, None] * d[:, None, :]).reshape(-1, 9)
    od = (o[:, :, None] * d[:, None, :]).reshape(-1, 9)
    return torch.cat([dd, md, od, d, torch.ones_like(d[:, :1])], 1).contiguous()


def numpy_quad_coeffs(tri_packed: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Build-time quadratic forms f32 [T, 6, 28] of every stored triangle
    (``_quad_coeffs(..., with_q6=True)`` :1940, ``_sym_dd`` :1923,
    ``_outer9`` :1936), in f32 from ``tri_packed`` and the scene centre."""
    tp = np.asarray(tri_packed, np.float32)
    v0 = tp[:, 0:3] - np.asarray(center, np.float32)
    e1, e2 = tp[:, 3:6], tp[:, 6:9]

    def cr(a, b):
        return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)

    def sym_dd(u, a):  # coefficients of (u·d)(a·d) over the d⊗d monomials
        return np.stack([u[:, 0] * a[:, 0], u[:, 1] * a[:, 1], u[:, 2] * a[:, 2],
                         u[:, 0] * a[:, 1] + u[:, 1] * a[:, 0],
                         u[:, 0] * a[:, 2] + u[:, 2] * a[:, 0],
                         u[:, 1] * a[:, 2] + u[:, 2] * a[:, 1]], axis=1)

    def outer9(u, a):
        return (u[:, :, None] * a[:, None, :]).reshape(-1, 9)

    a = cr(e2, e1)  # det = a·d
    b_d, b_m = -cr(e2, v0), e2  # bx = b_d·d + b_m·m
    y_d, y_m = cr(e1, v0), -e1  # by = y_d·d + y_m·m
    n = cr(e1, e2)  # t·det = n·o + t_c
    t_c = -(v0[:, 0] * n[:, 0] + v0[:, 1] * n[:, 1] + v0[:, 2] * n[:, 2])[:, None]
    z6 = np.zeros((tp.shape[0], 6), np.float32)
    z9 = np.zeros((tp.shape[0], 9), np.float32)
    z3 = np.zeros((tp.shape[0], 3), np.float32)

    def row(dd, md, od, dl):
        return np.concatenate([dd, md, od, dl, z3[:, :1]], axis=1)

    det2 = sym_dd(a, a)
    eps_dd = np.zeros((1, 6), np.float32)
    eps_dd[0, 0:3] = np.float32(PLUCKER_EPS2)
    rows = [row(sym_dd(b_d, a), outer9(b_m, a), z9, z3),
            row(sym_dd(y_d, a), outer9(y_m, a), z9, z3),
            row(det2 - sym_dd(b_d + y_d, a), -outer9(b_m + y_m, a), z9, z3),
            row(det2 - eps_dd, z9, z9, z3),
            row(z6, z9, outer9(n, a), t_c * a),
            row(det2, z9, -outer9(n, a), -t_c * a)]
    return np.ascontiguousarray(np.stack(rows, axis=1), np.float32)


def numpy_quad_packed(coeffs: np.ndarray) -> np.ndarray:
    """The closest hit's live coefficients of ``coeffs`` [T, 6, 28] packed
    to f32 [T, 64]: :data:`LIVE_SLOTS` in order (q1 0-14, q2 15-29, q3
    30-44, q4 45-50, q5 51-62), slot 63 zero.  A triangle is 256 bytes,
    16-byte aligned; the kernel reads it as sixteen ``float4``, each
    feeding four fused multiply-adds."""
    flat = np.asarray(coeffs, np.float32).reshape(-1, STORED_PLANES * QUAD_FEATS)
    out = np.zeros((flat.shape[0], PACKED_WIDTH), np.float32)
    out[:, :len(LIVE_SLOTS)] = flat[:, list(LIVE_SLOTS)]
    return out


def numpy_quad_occl_packed(coeffs: np.ndarray) -> np.ndarray:
    """The shadow sweep's live coefficients of ``coeffs`` [T, 6, 28] packed
    to f32 [T, 84]: :data:`OCCL_SLOTS` in order (q1..q5 in the slots of
    :func:`numpy_quad_packed`, q6 63-80), slots 81-83 zero.  A triangle is
    336 bytes, 16-byte aligned, read by the kernel as twenty-one
    ``float4``."""
    flat = np.asarray(coeffs, np.float32).reshape(-1, STORED_PLANES * QUAD_FEATS)
    out = np.zeros((flat.shape[0], OCCL_PACKED_WIDTH), np.float32)
    out[:, :len(OCCL_SLOTS)] = flat[:, list(OCCL_SLOTS)]
    return out


def quad_segments(x, y):
    """Shadow segment x -> y as (origin, unnormalized direction) with the
    parameter t in [0, 1] (``occlusion_quad_pallas`` :2415-2420): the origin
    is inset 1e-5 along the segment and the far end pulled 1e-4 short."""
    d = y - x
    dist = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-24))
    dirn = d / dist[..., None]
    return x + dirn * RAY_OFFSET, dirn * (dist - SHADOW_EPS - RAY_OFFSET)[..., None]


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def forms(coeffs, feats, planes: int):
    """q f32 [R, T, planes] for coefficient rows ``coeffs`` [T, 6, 28] and
    feature rows ``feats`` [R, 28]: each form summed over the 27 live
    monomials in order, each step acc = fma(c, f, acc) rounded once to f32
    (the exact f32·f32 product and the sum are formed in f64), as the
    kernel sums it."""
    c = coeffs[:, :planes, :QUAD_LIVE].double().permute(2, 0, 1)
    c = c.reshape(QUAD_LIVE, -1).contiguous()  # [27, T·planes]
    f = feats[:, :QUAD_LIVE].double().t().contiguous()  # [27, R]
    acc = torch.zeros((f.shape[1], c.shape[1]), dtype=torch.float32,
                      device=feats.device)
    wide = torch.empty(acc.shape, dtype=torch.float64, device=feats.device)
    for k in range(QUAD_LIVE):
        wide.copy_(acc)
        wide.addr_(f[k], c[k])  # exact product, one f64 rounding of the sum
        acc.copy_(wide)  # and the one rounding to f32
    return acc.view(f.shape[1], -1, planes)


def forms_live(packed, feats, planes: int = CLOSEST_PLANES):
    """The first ``planes`` forms f32 [R, T, planes] from a packed table as
    the kernels sum them (``packed`` [T, 64] for q1..q5, the shadow table
    [T, 84] for q1..q6): each form over its live monomials only
    (:data:`LIVE_TERMS`), in order, one fused multiply-add per term from 0.
    Equal by value to ``forms(coeffs, feats, planes)``: a dropped term adds
    an exact zero."""
    f = feats.double()
    c = packed.double()
    wide = torch.empty((f.shape[0], c.shape[0]), dtype=torch.float64,
                       device=feats.device)
    out, slot = [], 0
    for p in range(planes):
        acc = torch.zeros(wide.shape, dtype=torch.float32, device=feats.device)
        for k in LIVE_TERMS[p]:
            wide.copy_(acc)
            wide.addr_(f[:, k], c[:, slot])  # exact product, one f64 rounding
            acc.copy_(wide)  # and the one rounding to f32
            slot += 1
        out.append(acc)
    return torch.stack(out, -1)


def occl_words_plain(cluster_bounds, ray_o, seg):
    """The shadow kernel's vote in plain torch: int32 row words as
    ``cluster_mask_words(cluster_bounds, ray_o, seg, ones)`` returns them.
    Each lane's slab test of its unit-parameter segment at range 1 (a
    padding lane: o = 0, d = 1, range 0, as the prepass pads it), ORed per
    warp of :data:`.plucker.GROUP` lanes, then over the row's four warps."""
    n = ray_o.shape[0]
    n_pad = -(-n // ROW) * ROW
    pad = n_pad - n
    o = torch.cat([ray_o, ray_o.new_zeros((pad, 3))])
    d = torch.cat([seg, seg.new_ones((pad, 3))])
    tm = torch.cat([ray_o.new_ones((n,)), ray_o.new_zeros((pad,))])
    lanes = lane_cluster_flags_plain(cluster_bounds, o, d, tm)
    warps = lanes.view(-1, GROUP, lanes.shape[1]).any(1)
    return pack_words(warps.view(-1, ROW // GROUP, lanes.shape[1]).any(1))


def zero_segments(feats):
    """bool [N]: the segments whose 27 monomial features are all 0 (a
    zero-length segment): every form of every triangle is 0 for them, so
    each reads as blocked wherever its row sweeps a triangle."""
    return ~feats[:, :QUAD_LIVE].bool().any(1)


def hit_t(coeffs, feats):
    """t f32 [R, T] of every (ray, triangle) pair: q5 / (q4 + eps²) where
    min(q1..q5) >= 0, FLT_MAX where not."""
    q = forms(coeffs, feats, CLOSEST_PLANES)
    t = q[..., 4] / (q[..., 3] + PLUCKER_EPS2)
    return torch.where(q.amin(-1) >= 0.0, t, FLT_MAX)


def closest_hit_plain(coeffs, feats, mask, sub):
    """Plain torch closest hit.  ``coeffs`` f32 [T, 6, 28], ``feats`` f32
    [N, 28], ``mask`` int32 [ceil(N/128), W] cluster words of
    :func:`.plucker.cluster_mask_words` (None: sweep every triangle),
    ``sub`` triangles per cluster.  Returns (prim i32 [N], dist f32 [N]):
    the exact minimum t over the triangles of the clusters the lane's row
    flags, ties to the lower id; misses are (-1, FLT_MAX)."""
    timing.count("plain.quad.closest_hit")
    return sweep_closest(coeffs, feats, mask_flags(mask, sub, coeffs.shape[0]), ROW,
                         sub, hit_t, _PLAIN_PAIRS)


def occlusion_plain(coeffs, feats, mask, sub):
    """Plain torch any-hit over unit-parameter segments: True where some
    triangle of a cluster the lane's row flags has min(q1..q6) >= 0.
    Arguments as :func:`closest_hit_plain`, ``feats`` of the segments."""
    timing.count("plain.quad.occlusion")
    return sweep_any(coeffs, feats, mask_flags(mask, sub, coeffs.shape[0]), ROW, sub,
                     lambda c, f, lo, hi: forms(c, f, STORED_PLANES).amin(-1) >= 0.0,
                     _PLAIN_PAIRS)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/quad.cu)
# ---------------------------------------------------------------------------


def _check_inputs(packed, feats, width, sub):
    """Raise on what the kernels do not take: the packed table ``packed``
    f32 [T, width] and the features ``feats`` f32 [N, 28], contiguous,
    16-byte aligned, on the card."""
    for name, t, cols in (("the packed table", packed, width), ("feats", feats, QUAD_FEATS)):
        if not (t.is_cuda and t.dtype == torch.float32 and t.dim() == 2
                and t.shape[1] == cols and t.is_contiguous() and t.data_ptr() % 16 == 0):
            raise ValueError(f"{name} must be 16-byte aligned contiguous float32 "
                             f"[-, {cols}] on the card, got {t.dtype} {tuple(t.shape)}")
    if sub < 1:
        raise ValueError(f"triangles per cluster must be positive, got {sub}")


def _launch(fn: str, *args):
    """C entry point ``fn`` of csrc/quad.cu on the current stream: tensors
    go as their data pointers (None as null), ints as they are; raises if
    the launch is refused."""
    import ctypes

    from ._build import load_library

    lib = load_library("quad")
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    stream = torch.cuda.current_stream(dev).cuda_stream
    conv = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else ctypes.c_void_p(None) if a is None else a for a in args]
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*conv, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")


def closest_hit_cuda(packed, feats, mask, sub):
    """The closest-hit kernel (``quad_closest_hit`` in csrc/quad.cu) on the
    scene's packed table ``packed`` f32 [T, 64]
    (:func:`numpy_quad_packed`); same results as :func:`closest_hit_plain`
    on the forms it was packed from."""
    _check_inputs(packed, feats, PACKED_WIDTH, sub)
    if mask is not None:
        rows = -(-feats.shape[0] // ROW)
        if (not mask.is_cuda or mask.dtype != torch.int32 or mask.dim() != 2
                or mask.shape[0] != rows or not mask.is_contiguous()):
            raise ValueError("mask must be contiguous int32 [ceil(N/128), W] on the card")
        if packed.shape[0] % sub or mask.shape[1] * 32 < packed.shape[0] // sub:
            raise ValueError("the packed table must be whole clusters covered by the "
                             "mask words")
    n = feats.shape[0]
    prim = torch.empty((n,), dtype=torch.int32, device=feats.device)
    dist = torch.empty((n,), dtype=torch.float32, device=feats.device)
    if n == 0:
        return prim, dist
    _launch("quad_closest_hit", packed, packed.shape[0], sub, feats, n, mask,
            0 if mask is None else mask.shape[1], prim, dist)
    timing.count("launch.quad.closest_hit")
    return prim, dist


def occlusion_cuda(packed, feats, cluster_bounds, ray_o, seg, sub):
    """The shadow kernel (``quad_occlusion`` in csrc/quad.cu) on the
    scene's packed shadow table ``packed`` f32 [T, 84]
    (:func:`numpy_quad_occl_packed`): each 128-lane row votes its cluster
    words from ``cluster_bounds`` f32 [C, 6] (None: every triangle is
    swept) and its unit-parameter segments ``ray_o``, ``seg`` f32 [N, 3]
    (:func:`quad_segments`), then sweeps them.  Same results as
    :func:`occlusion_plain` on ``cluster_mask_words(cluster_bounds, ray_o,
    seg, ones)``."""
    _check_inputs(packed, feats, OCCL_PACKED_WIDTH, sub)
    n, num_tris = feats.shape[0], packed.shape[0]
    n_c = -(-num_tris // sub)
    shapes = [("ray_o", ray_o, (n, 3)), ("seg", seg, (n, 3))]
    if cluster_bounds is not None:
        shapes.append(("cluster_bounds", cluster_bounds, (n_c, 6)))
    for name, t, shape in shapes:
        if not (t.is_cuda and t.dtype == torch.float32 and t.shape == shape
                and t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {list(shape)} on the "
                             f"card (one box per cluster of {sub} triangles)")
    occ = torch.empty((n,), dtype=torch.int32, device=feats.device)
    if n == 0:
        return occ.bool()
    _launch("quad_occlusion", packed, num_tris, sub, cluster_bounds,
            0 if cluster_bounds is None else n_c, ray_o, seg, feats, n, occ)
    timing.count("launch.quad.occlusion")
    return occ.bool()


def closest_hit(coeffs, feats, mask, sub, packed=None):
    """Closest-hit sweep: the kernel for CUDA tensors (on the scene's
    ``packed`` table, which it then needs), the plain version for CPU
    tensors."""
    if feats.is_cuda:
        if packed is None:
            raise ValueError("the CUDA quad closest hit needs the scene's "
                             "packed table")
        return closest_hit_cuda(packed, feats, mask, sub)
    return closest_hit_plain(coeffs, feats, mask, sub)


def _row_words(cluster_bounds, ray_o, seg):
    """The prepass's row words of unit-parameter segments (None without
    cluster boxes)."""
    if cluster_bounds is None:
        return None
    return cluster_mask_words(cluster_bounds, ray_o, seg, torch.ones_like(ray_o[:, 0]))


def occlusion(coeffs, feats, cluster_bounds, ray_o, seg, sub, packed=None):
    """Shadow sweep of the unit-parameter segments ``ray_o``, ``seg``: the
    kernel for CUDA tensors (on the scene's packed shadow table
    ``packed``, which it then needs), the plain version on the prepass's
    row words for CPU tensors."""
    if feats.is_cuda:
        if packed is None:
            raise ValueError("the CUDA quad shadow sweep needs the scene's packed "
                             "shadow table")
        return occlusion_cuda(packed, feats, cluster_bounds, ray_o.contiguous(),
                              seg.contiguous(), sub)
    return occlusion_plain(coeffs, feats, _row_words(cluster_bounds, ray_o, seg), sub)


# ---------------------------------------------------------------------------
# scene-level entry points
# ---------------------------------------------------------------------------


def intersect_quad(coeffs, center, cluster_bounds, sub, ray_o, ray_d,
                   tmax=None, plain: bool = False, packed=None):
    """Closest hit of rays against the stored triangles' forms ``coeffs``
    f32 [T, 6, 28]; (prim i32 [N], selector-grade dist f32 [N]).  ``tmax``
    (f32 [N]) bounds only the culling prepass (-FLT_MAX marks a dead lane,
    which flags nothing).  ``plain`` selects the plain sweep on any device;
    ``packed`` is the scene's packed table, which the kernel reads."""
    feats = quad_features(ray_o, ray_d, center)
    mask = None
    if cluster_bounds is not None:
        mask = cluster_mask_words(cluster_bounds, ray_o, ray_d, tmax)
    if plain:
        return closest_hit_plain(coeffs, feats, mask, sub)
    return closest_hit(coeffs, feats, mask, sub, packed)


def occlusion_quad(coeffs, center, cluster_bounds, sub, x, y,
                   plain: bool = False, packed=None):
    """True where segment x -> y is blocked (bool [N]), over the
    unit-parameter segments of :func:`quad_segments` (the culling bounds
    them at t = 1).  A zero-length segment (y == x, a masked lane) reads as
    blocked wherever its row sweeps a triangle, as in the reference.
    ``plain`` selects the plain version on any device; ``packed`` is the
    scene's packed shadow table, which the kernel reads."""
    ray_o, seg = quad_segments(x, y)
    feats = quad_features(ray_o, seg, center)
    if plain:
        return occlusion_plain(coeffs, feats, _row_words(cluster_bounds, ray_o, seg), sub)
    return occlusion(coeffs, feats, cluster_bounds, ray_o, seg, sub, packed)
