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

Culling: a slab test (:func:`lane_cluster_flags_plain`, the XLA
``_cluster_mask_bits`` :599) says, per lane, which clusters of ``sub``
consecutive triangles its ray may hit within its ``tmax``; a group of
``lanes`` consecutive lanes shares the decision (the OR of its lanes'
flags, :func:`cluster_mask_words`) and the sweep visits only the clusters
the lane's group flags.  The group is one warp, :data:`GROUP` = 32 lanes,
on this engine's path on either device; the reference culls per
:data:`ROW` = 128 lanes, which the plain versions reproduce with
``lanes=ROW``.  Without cluster bounds (small scenes) every triangle is
swept.

Each sweep has two implementations with one contract:
* ``*_cuda``: the hand-written kernels of ``csrc/plucker.cu`` (each warp
  runs the slab test on its own 32 rays, votes its own cluster words and
  sweeps the tiles it flags, triangles across its threads, its rays one at
  a time, a ray passing over the tiles it cannot gain from
  (:func:`lane_skip_flags_plain`: no result moves); exact f32 FMA, the
  winner is the exact minimum t with ties to the lower id);
* ``*_plain``: the same arithmetic in plain torch, over the triangles of
  the clusters some group of a chunk of lanes flags, gated per lane
  (:func:`sweep_closest`, :func:`sweep_any`; the quad, band and compact
  engines' plain sweeps share them), on the words of
  :func:`cluster_mask_words`.
``closest_hit`` / ``occlusion`` dispatch on the tensors' device: CPU tensors
take the plain version, CUDA tensors launch the kernel (or raise) — there is
no fallback between the two.  They count ``launch.plucker.*`` kernel
launches and ``plain.plucker.*`` plain-version calls, per sweep kind, and
``prepass.plucker.cluster_mask_words`` the calls of :func:`cluster_mask_words`,
which the kernels' path never makes (utils/timing.py).

Dead lanes (a negative ``tmax``; ``intersect`` passes -FLT_MAX) flag
nothing, are swept by nothing and return a miss, (-1, FLT_MAX), on this
engine's path, in kernel and plain version alike (``dead`` of
:func:`closest_hit_plain`); the reference, and the plain version without
``dead``, return for them what their group's clusters give.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import timing
from ..utils.math import addcmul_rounds_once, cross
from .traverse import FLT_MAX, NULL_PRIMITIVE, segment_rays

PLUCKER_EPS2 = 1.1920929e-07 ** 2  # det² threshold == |det| >= eps
ROW = 128  # lanes per culling row of the reference (and of the quad engine)
GROUP = 32  # lanes that share a culling decision on this engine: one warp
MAX_CLUSTERS = 1024  # the kernels keep a warp's words in shared memory
# a ray of the kernels passes over a cluster whose box, grown by SKIP_SLACK
# times the scene's scale, it misses or enters beyond its reach (best t so
# far, or the segment's range) widened by SKIP_MARGIN
# (:func:`lane_skip_flags_plain`; kSkipSlack, kSkipMargin in the kernels)
SKIP_SLACK = 2e-4
SKIP_MARGIN = 1.0 + 1e-4

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
# per plane (det, bx, by, t·det), the slots of its live coefficients, each
# the weight of the feature of the same index, in the kernels' order
PLANE_SLOTS = (range(0, 3), range(0, 6), range(0, 6), range(6, 10))




# ---------------------------------------------------------------------------
# features and the cluster-mask prepass
# ---------------------------------------------------------------------------


def plucker_features(ray_o, ray_d, center):
    """Per-ray features [N, 10] = [d, (o-c) x d, o-c, 1]."""
    o = ray_o - center
    return torch.cat([ray_d, cross(o, ray_d), o, torch.ones_like(o[:, :1])],
                     dim=1).contiguous()


def _pad_rays(ray_o, ray_d, tmax, n_pad: int):
    """Rays padded to ``n_pad`` lanes as the reference pads a ragged last
    group: o = 0, d = 1, tmax = 0 (FLT_MAX without tmax).  Returns
    (o [n_pad, 3], d [n_pad, 3], tm [n_pad])."""
    n = ray_o.shape[0]
    pad = n_pad - n
    o = torch.cat([ray_o, ray_o.new_zeros((pad, 3))])
    d = torch.cat([ray_d, ray_d.new_ones((pad, 3))])
    if tmax is None:
        tm = torch.full((n_pad,), FLT_MAX, device=ray_o.device)
    else:
        tm = torch.cat([tmax, tmax.new_zeros((pad,))])
    return o, d, tm


def lane_cluster_flags_plain(cluster_bounds, ray_o, ray_d, tmax):
    """bool [N, C]: the clusters whose box ``cluster_bounds`` f32 [C, 6]
    (lo, hi) each lane's own ray may hit before its ``tmax`` f32 [N] (None:
    FLT_MAX) — the conservative slab test of the reference prepass, in its
    f32 operations: 1 / d after clamping |d| <= 1e-12 to +1e-12 (the sign
    is lost, as there), (bound - o) * inv, the near and far planes by
    min / max, and ``tf >= max(tn, 0) and tn < tmax``.  The twin of the
    kernels' per-lane test (csrc/slab_cull.cuh)."""
    o, d, cb = ray_o, ray_d, cluster_bounds
    tm = FLT_MAX if tmax is None else tmax[:, None]
    inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, torch.full_like(d, 1e-12))
    n, n_c = o.shape[0], cb.shape[0]
    tn = torch.full((n, n_c), -FLT_MAX, device=o.device)
    tf = torch.full((n, n_c), FLT_MAX, device=o.device)
    for k in range(3):
        a = (cb[None, :, k] - o[:, k, None]) * inv[:, k, None]
        b = (cb[None, :, 3 + k] - o[:, k, None]) * inv[:, k, None]
        tn = torch.maximum(tn, torch.minimum(a, b))
        tf = torch.minimum(tf, torch.maximum(a, b))
    return (tf >= torch.clamp(tn, min=0.0)) & (tn < tm)


def lane_skip_flags_plain(cluster_bounds, ray_o, ray_d, reach):
    """bool [N, C]: the clusters a single ray of the kernels does not pass
    over when its reach is ``reach`` f32 [N] (a closest hit's best t so
    far, a segment's range): the slab test on boxes grown on every side by
    :data:`SKIP_SLACK` times the scene's scale (the largest extent of the
    boxes' union along an axis), entered no later than ``reach`` widened
    by :data:`SKIP_MARGIN`.  The twin of ``slab_reach`` in
    csrc/slab_cull.cuh.  The kernels' results do not depend on it as long
    as it is conservative: no triangle of an unflagged cluster passes the
    f32 planes at a t within ``reach`` (tests/test_torch_plucker.py)."""
    cb = cluster_bounds
    slack = SKIP_SLACK * (cb[:, 3:].amax(0) - cb[:, :3].amin(0)).max()
    grown = torch.cat([cb[:, :3] - slack, cb[:, 3:] + slack], dim=1)
    d = ray_d
    inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, torch.full_like(d, 1e-12))
    lo = (grown[None, :, :3] - ray_o[:, None, :]) * inv[:, None, :]
    hi = (grown[None, :, 3:] - ray_o[:, None, :]) * inv[:, None, :]
    tn = torch.minimum(lo, hi).amax(-1)
    tf = torch.maximum(lo, hi).amin(-1)
    return (tf >= torch.clamp(tn, min=0.0)) & (tn <= (reach * SKIP_MARGIN)[:, None])


def cluster_mask_words(cluster_bounds, ray_o, ray_d, tmax, lanes: int = ROW):
    """Per group of ``lanes`` consecutive lanes, the clusters any of its
    rays may hit before tmax (:func:`lane_cluster_flags_plain`), packed 32
    per int32 word: bit j of word w flags cluster 32·w + j.  Returns int32
    [ceil(N/lanes), ceil(C/32)].

    The same f32 arithmetic as the reference prepass (which groups 128
    lanes), including its padding of the last group (o = 0, d = 1,
    tmax = 0, or FLT_MAX without tmax)."""
    timing.count("prepass.plucker.cluster_mask_words")
    n_pad = -(-ray_o.shape[0] // lanes) * lanes
    o, d, tm = _pad_rays(ray_o, ray_d, tmax, n_pad)
    hit = lane_cluster_flags_plain(cluster_bounds, o, d, tm)  # [n_pad, C]
    return pack_words(hit.view(n_pad // lanes, lanes, -1).any(dim=1))


def pair_counts(cluster_bounds, ray_o, ray_d, tmax, sub: int, num_tris: int,
                chunk_rows: int = 512) -> dict:
    """(lane, triangle) pairs a sweep of these rays visits when a cluster
    is swept by every lane of a group that flags it: per :data:`ROW`-lane
    row (``row``), per :data:`GROUP`-lane warp (``warp``) and per lane
    (``lane``: each lane's own flagged clusters, what the data needs under
    this culling).  Padding lanes vote, as in the sweeps, and are not
    counted.  Without cluster bounds every lane visits every triangle.  A
    measurement helper: floats, one host sync per chunk of rows."""
    n = ray_o.shape[0]
    if cluster_bounds is None:
        return dict.fromkeys(("row", "warp", "lane"), float(n) * num_tris)
    n_c = cluster_bounds.shape[0]
    tris = torch.clamp(num_tris - torch.arange(n_c, device=ray_o.device) * sub,
                       0, sub).double()
    out = dict.fromkeys(("row", "warp", "lane"), 0.0)
    step = chunk_rows * ROW
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        n_pad = -(-(hi - lo) // ROW) * ROW
        o, d, tm = _pad_rays(ray_o[lo:hi], ray_d[lo:hi],
                             None if tmax is None else tmax[lo:hi], n_pad)
        own = lane_cluster_flags_plain(cluster_bounds, o, d, tm)
        real = (torch.arange(n_pad, device=o.device) < hi - lo)
        for name, size in (("row", ROW), ("warp", GROUP), ("lane", 1)):
            grp = own.view(-1, size, n_c).any(1)
            lanes = real.view(-1, size).sum(1).double()
            out[name] += float((grp.double() @ tris) @ lanes)
    return out


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


def unpack_coeffs(packed):
    """The packed table f32 [T, 20] back as planes f32 [T, 4, 10]."""
    flat = packed.new_zeros((packed.shape[0], 40))
    flat[:, list(LIVE_SLOTS)] = packed[:, :len(LIVE_SLOTS)]
    return flat.view(-1, 4, 10)


def _planes(coeffs, feats):
    """(det, bx, by, t·det) [R, T] for feature rows ``feats`` [R, 10] and
    planes ``coeffs`` [T, 4, 10] (or packed, [T, 20]).

    On the card, in the kernels' arithmetic (:func:`kernel_planes`): a
    matrix product there sums in the order and with the fusion of the
    cuBLAS kernel it picks for each chunk's shape, so its last bits would
    follow the chunking (on env_teapot's 800x800 primaries, the chunks of
    one cluster rounded 1,572 winners' t otherwise).  On the CPU, one
    matrix product: its sums are the ones the parity tests against the JAX
    package pin."""
    if coeffs.dim() == 2:
        coeffs = unpack_coeffs(coeffs)
    if feats.is_cuda:
        return kernel_planes(coeffs, feats)
    t = coeffs.shape[0]
    q = (feats @ coeffs.reshape(t * 4, 10).t()).view(-1, t, 4)
    return q.unbind(-1)


def kernel_planes(coeffs, feats):
    """(det, bx, by, t·det) [R, T] as the kernels compute them
    (csrc/plucker_planes.cuh::planes), bit for bit: each plane over its
    :data:`PLANE_SLOTS` in order, the first term a product and the others
    fused multiply-adds, ``torch.addcmul`` (which rounds once on the card;
    raises on a device where it does not).  ``coeffs`` [T, 4, 10]."""
    if not addcmul_rounds_once(feats.device):
        raise RuntimeError(f"torch.addcmul is not a fused multiply-add on {feats.device}")
    out = []
    for k, (first, *rest) in enumerate(PLANE_SLOTS):
        acc = coeffs[None, :, k, first] * feats[:, first, None]
        for j in rest:
            acc = torch.addcmul(acc, coeffs[None, :, k, j], feats[:, j, None])
        out.append(acc)
    return tuple(out)


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


def dead_lanes(tmax):
    """bool [N]: the lanes a negative ``tmax`` marks dead (None: none)."""
    return None if tmax is None else tmax < 0


def closest_hit_plain(coeffs, feats, mask, sub, lanes: int = GROUP, dead=None):
    """Plain torch closest hit.  ``coeffs`` f32 [T, 4, 10] (or the packed
    table f32 [T, 20]), ``feats`` f32 [N, 10], ``mask`` int32
    [ceil(N/lanes), W] cluster words of :func:`cluster_mask_words` at the
    same ``lanes`` (None: sweep every triangle), ``sub`` triangles per
    cluster.  Returns (prim i32 [N], dist f32 [N]): the exact minimum t
    over the triangles of the clusters the lane's group flags, ties to the
    lower id; misses are (-1, FLT_MAX), and so are the lanes of ``dead``
    (bool [N], :func:`dead_lanes`; None: a dead lane gets what its group's
    clusters give, as in the reference)."""
    timing.count("plain.plucker.closest_hit")
    prim, dist = sweep_closest(coeffs, feats, mask_flags(mask, sub, coeffs.shape[0]),
                               lanes, sub, hit_t)
    if dead is not None:
        prim = torch.where(dead, NULL_PRIMITIVE, prim)
        dist = torch.where(dead, FLT_MAX, dist)
    return prim, dist


def occlusion_plain(coeffs, feats, tm, mask, sub, lanes: int = GROUP):
    """Plain torch any-hit: True where some (flagged) triangle blocks the
    segment of range ``tm`` f32 [N].  Arguments as :func:`closest_hit_plain`."""
    timing.count("plain.plucker.occlusion")
    return sweep_any(coeffs, feats, mask_flags(mask, sub, coeffs.shape[0]),
                     lanes, sub, lambda c, f, lo, hi: blocks(c, f, tm[lo:hi]))


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


def _check_inputs(packed, feats, cluster_bounds, ray_o, ray_d, tmax, sub):
    """Raise on what the kernels do not take; returns (triangles per
    cluster, clusters) as the kernels count them: without bounds, one
    cluster of every triangle."""
    n, num_tris = feats.shape[0], packed.shape[0]
    lane_inputs = [("feats", feats, (n, 10)), ("ray_o", ray_o, (n, 3)),
                   ("ray_d", ray_d, (n, 3))]
    if tmax is not None:
        lane_inputs.append(("tmax", tmax, (n,)))
    for name, t, shape in lane_inputs:
        if not (t.is_cuda and t.dtype == torch.float32 and t.shape == shape
                and t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {list(shape)} on "
                             f"the card")
    if not (packed.is_cuda and packed.dtype == torch.float32 and packed.dim() == 2
            and packed.shape[1] == PACKED_WIDTH and packed.is_contiguous()
            and packed.data_ptr() % 16 == 0):
        raise ValueError(f"the packed table must be 16-byte aligned contiguous "
                         f"float32 [T, {PACKED_WIDTH}] on the card, got "
                         f"{tuple(packed.shape)}")
    if cluster_bounds is None:
        return max(num_tris, 1), 1
    n_c = -(-num_tris // sub) if sub >= 1 else -1
    cb = cluster_bounds
    if not (cb.is_cuda and cb.dtype == torch.float32 and cb.shape == (n_c, 6)
            and cb.is_contiguous()):
        raise ValueError(f"cluster_bounds must be contiguous float32 [{n_c}, 6] on "
                         f"the card: one box per cluster of {sub} triangles")
    if n_c > MAX_CLUSTERS:
        raise ValueError(f"the Plücker kernels take at most {MAX_CLUSTERS} "
                         f"clusters, got {n_c}")
    return sub, n_c


def _launch(entry, packed, feats, cluster_bounds, ray_o, ray_d, tmax, sub, outs):
    """Launch C entry point ``entry`` of csrc/plucker.cu on the current
    stream; raises if the launch is refused."""
    import ctypes

    from ._build import load_library

    sub, n_c = _check_inputs(packed, feats, cluster_bounds, ray_o, ray_d, tmax, sub)

    def p(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    lib = load_library("plucker")
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    with torch.cuda.device(feats.device):
        err = getattr(lib, entry)(
            p(packed), packed.shape[0], sub, p(cluster_bounds), n_c, p(ray_o),
            p(ray_d), p(tmax), p(feats), feats.shape[0], *(p(t) for t in outs),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def closest_hit_cuda(packed, feats, cluster_bounds, ray_o, ray_d, tmax, sub):
    """The closest-hit kernel (``plucker_closest_hit`` in csrc/plucker.cu)
    on the scene's packed table ``packed`` f32 [T, 20]: each warp runs the
    slab test of ``ray_o``, ``ray_d`` f32 [N, 3] and ``tmax`` f32 [N]
    (None: FLT_MAX) against ``cluster_bounds`` f32 [C, 6] (None: every
    triangle is swept) and sweeps the clusters it flags; a lane with a
    negative ``tmax`` misses.  Same results as :func:`closest_hit_plain`
    on ``cluster_mask_words(..., lanes=GROUP)`` with
    ``dead=dead_lanes(tmax)``."""
    n = feats.shape[0]
    prim = torch.empty((n,), dtype=torch.int32, device=feats.device)
    dist = torch.empty((n,), dtype=torch.float32, device=feats.device)
    if n == 0:
        return prim, dist
    _launch("plucker_closest_hit", packed, feats, cluster_bounds, ray_o, ray_d,
            tmax, sub, (prim, dist))
    timing.count("launch.plucker.closest_hit")
    return prim, dist


def occlusion_cuda(packed, feats, cluster_bounds, ray_o, ray_d, tm, sub):
    """The shadow kernel (``plucker_occlusion`` in csrc/plucker.cu):
    arguments as :func:`closest_hit_cuda`, with the segments' range ``tm``
    f32 [N] bounding both the culling and the hits.  Same results as
    :func:`occlusion_plain` on ``cluster_mask_words(..., lanes=GROUP)``."""
    if tm is None:
        raise ValueError("the shadow kernel needs the segments' range tm")
    n = feats.shape[0]
    occ = torch.empty((n,), dtype=torch.int32, device=feats.device)
    if n == 0:
        return occ.bool()
    _launch("plucker_occlusion", packed, feats, cluster_bounds, ray_o, ray_d, tm,
            sub, (occ,))
    timing.count("launch.plucker.occlusion")
    return occ.bool()


def _group_words(cluster_bounds, ray_o, ray_d, tmax, lanes):
    if cluster_bounds is None:
        return None
    return cluster_mask_words(cluster_bounds, ray_o, ray_d, tmax, lanes)


def closest_hit(coeffs, feats, cluster_bounds, ray_o, ray_d, tmax, sub, packed=None,
                plain: bool = False):
    """Closest-hit sweep culled per :data:`GROUP` lanes: the kernel for
    CUDA tensors (on the scene's ``packed`` table, which it then needs),
    the plain version on the prepass words for CPU tensors, or with
    ``plain`` on any device."""
    if feats.is_cuda and not plain:
        if packed is None:
            raise ValueError("the CUDA Plücker closest hit needs the scene's "
                             "packed table")
        return closest_hit_cuda(packed, feats, cluster_bounds, ray_o.contiguous(),
                                ray_d.contiguous(), tmax, sub)
    mask = _group_words(cluster_bounds, ray_o, ray_d, tmax, GROUP)
    return closest_hit_plain(coeffs, feats, mask, sub, dead=dead_lanes(tmax))


def occlusion(coeffs, feats, cluster_bounds, ray_o, ray_d, tm, sub, packed=None,
              plain: bool = False):
    """Shadow sweep culled per :data:`GROUP` lanes: the kernel for CUDA
    tensors (on the scene's ``packed`` table), the plain version on the
    prepass words for CPU tensors, or with ``plain`` on any device."""
    if feats.is_cuda and not plain:
        if packed is None:
            raise ValueError("the CUDA Plücker shadow sweep needs the scene's "
                             "packed table")
        return occlusion_cuda(packed, feats, cluster_bounds, ray_o.contiguous(),
                              ray_d.contiguous(), tm, sub)
    mask = _group_words(cluster_bounds, ray_o, ray_d, tm, GROUP)
    return occlusion_plain(coeffs, feats, tm, mask, sub)


# ---------------------------------------------------------------------------
# scene-level entry points
# ---------------------------------------------------------------------------


def intersect_plucker(coeffs, center, cluster_bounds, sub, ray_o, ray_d,
                      tmax=None, plain: bool = False, packed=None):
    """Closest hit of rays against the stored triangles; (prim i32 [N],
    selector-grade dist f32 [N]).  ``tmax`` (f32 [N]) bounds only the
    culling (-FLT_MAX marks a dead lane, which flags nothing and
    misses).  ``plain`` selects the plain
    torch sweep on any device; ``packed`` is the scene's packed table,
    which the kernel reads."""
    feats = plucker_features(ray_o, ray_d, center)
    return closest_hit(coeffs, feats, cluster_bounds, ray_o, ray_d, tmax, sub, packed,
                       plain)


def occlusion_plucker(coeffs, center, cluster_bounds, sub, x, y,
                      plain: bool = False, packed=None):
    """True where segment x->y is blocked (bool [N]).  A zero-length
    segment (y == x, a masked lane) has d = 0, so det = 0: never blocked."""
    ray_o, ray_d, tm = segment_rays(x, y)
    feats = plucker_features(ray_o, ray_d, center)
    return occlusion(coeffs, feats, cluster_bounds, ray_o, ray_d, tm.contiguous(), sub,
                     packed, plain)


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
