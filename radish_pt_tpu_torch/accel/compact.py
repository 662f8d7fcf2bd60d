"""Compact work-list engine: the prepass, the work list and the compact
closest-hit and shadow sweeps.

Port of ``radish_pt_tpu/accel/pallas_kernels.py:962-1807``, the engine the
reference picks above 131,072 triangles: ``intersect_plucker_compact``
(:1622, kernel ``_plucker_compact_kernel`` :1291),
``occlusion_plucker_compact`` (:1726, kernel ``_plucker_compact_occl_kernel``
:1393) and their sphere prepass ``_sphere_flags`` (:1182, kernel
``_sphere_flag_kernel`` :1151).

The scene is stored in 64-triangle culling clusters; ``g`` consecutive
clusters form a unit (g = 1 up to ``SPHERE_UNIT_MAX`` clusters).  Lanes go
in row groups of ``LANES`` = 256.  Per sweep:

1. the prepass flags, per (row group, unit), whether any lane's ray may hit
   the unit within its range, with a conservative entry distance ``tn`` —
   the exact per-ray slab test (:func:`_row_flags`) up to
   ``PER_RAY_PREPASS_MAX`` clusters, the bounding-sphere test
   (:func:`sphere_flags`) above;
2. :func:`work_list` compacts the flagged pairs into per-row-group slices
   ordered near to far;
3. the sweep visits only those pairs (:func:`closest_hit`,
   :func:`occlusion`), with the decision planes of :mod:`.plucker`.  Both
   kernels cull once more inside the walk, per lane: each lane tests its
   own ray against the unit's bounding sphere (:func:`unit_spheres`,
   :func:`lane_unit_flags_plain`) and wants the unit only if it can still
   find a nearer hit (a blocker, within its segment) there; a warp sweeps
   a unit with all its lanes when most want it, and one wanting ray at a
   time, its threads spread over the unit's triangles, when few do.  They
   read the triangles' live coefficients from the packed table
   (:func:`.plucker.numpy_packed_coeffs`).  Both are built once per scene.

Each of the three kernels (``csrc/compact.cu``) has a plain torch version in
this module with one contract; the dispatchers take the plain version for
CPU tensors and launch the kernel (or raise) for CUDA tensors.  The plain
sweeps evaluate every (lane, triangle) pair of the lane's row-group units,
mask-gated and dense: none of the kernels' list walk or early exit.
It counts ``launch.compact.*`` kernel launches and ``plain.compact.*``
plain-version calls (utils/timing.py).

Not carried over from the TPU: the ``work_per_row`` budget with its dense
fallback, ``fan``, the ``COMPACT_MAX_LANES`` split, the bf16 operand splits
and the packed work words.  The work list's length is data-dependent, so
building it costs one host sync per sweep.
"""

from __future__ import annotations

import torch

from ..utils import timing
from .plucker import (PACKED_WIDTH, ROW, blocks, hit_t, plucker_features,
                      sweep_any, sweep_closest)
from .traverse import FLT_MAX, NULL_PRIMITIVE, segment_rays

CLUSTER_SUB = 64  # triangles per culling cluster
GROUP = 2  # 128-lane rows per row group (COMPACT_TUNING["group"], :968)
LANES = GROUP * ROW  # lanes per row group == threads per kernel block
# the slab prepass materializes [rays, units] f32; above this many clusters
# the sphere prepass takes over (:977)
PER_RAY_PREPASS_MAX = 256
# above this many clusters, g consecutive clusters merge into one unit (:981)
SPHERE_UNIT_MAX = 4096
SPHERE_NEG = -1e37  # a plane constant that never flags (:1075)
WARP = 32  # lanes of one warp of the closest-hit kernel
# a unit is skipped once the best t, widened by this margin, is below its
# entry distance (the reference's test, :1389; kSkipMargin in the kernel)
SKIP_MARGIN = 1.0 + 1e-4
# the non-zero terms of each sphere plane (A, C, E), in summation order;
# term 15 is the constant (feature 15 is 1)
SPHERE_TERMS = ((0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 15),
                (10, 11, 12, 13, 15),
                (10, 11, 12, 13, 14, 15))
_PLAIN_PAIRS = 1 << 25  # (lane, triangle) pairs per plain-sweep chunk
# f32 operations per pair: a (lane, unit) pair of the sphere prepass sums
# 11 + 5 + 6 plane terms unfused (22 multiplies, 19 adds) and C - 2r (1);
# a (lane, triangle) pair of the sweeps is the Plücker engine's
FLOPS_PER_PAIR = {"sphere_flags": 42, "closest_hit": 41, "occlusion": 43}




# ---------------------------------------------------------------------------
# prepass
# ---------------------------------------------------------------------------


def _coarsen_bounds(cluster_bounds, g: int):
    """Merge ``g`` consecutive cluster AABBs into one unit AABB.  Padding
    units get inverted boxes (lo = FLT_MAX, hi = -FLT_MAX): never flagged."""
    pad = -cluster_bounds.shape[0] % g
    f = torch.nn.functional.pad
    lo = f(cluster_bounds[:, 0:3], (0, 0, 0, pad), value=FLT_MAX)
    hi = f(cluster_bounds[:, 3:6], (0, 0, 0, pad), value=-FLT_MAX)
    return torch.cat([lo.view(-1, g, 3).amin(1), hi.view(-1, g, 3).amax(1)], 1)


def _pad_rays(ray_o, ray_d, tmax, n_pad):
    """Pad a wavefront to ``n_pad`` lanes: o = 0, d = 1, tmax = -FLT_MAX
    (padding lanes flag nothing).  ``tmax`` None means FLT_MAX."""
    pad = n_pad - ray_o.shape[0]
    o = torch.cat([ray_o, ray_o.new_zeros((pad, 3))])
    d = torch.cat([ray_d, ray_d.new_ones((pad, 3))])
    if tmax is None:
        tmax = torch.full((ray_o.shape[0],), FLT_MAX, device=ray_o.device)
    return o, d, torch.cat([tmax, tmax.new_full((pad,), -FLT_MAX)])


def _row_flags(cull_bounds, o, d, tm, rows, lanes: int = ROW,
               with_tn: bool = False):
    """Per-(``lanes``-ray group, unit) visit flags, bool [rows, C]: the
    exact per-ray slab test OR-reduced over the group.  ``with_tn`` also
    returns f32 [rows, C] entry distances: min over the group's flagging
    lanes of max(slab entry, 0), FLT_MAX where no lane flags."""
    n_c = cull_bounds.shape[0]
    inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, torch.full_like(d, 1e-12))
    tn = torch.full((rows * lanes, n_c), -FLT_MAX, device=o.device)
    tf = torch.full((rows * lanes, n_c), FLT_MAX, device=o.device)
    for k in range(3):
        a = (cull_bounds[None, :, k] - o[:, k, None]) * inv[:, k, None]
        b = (cull_bounds[None, :, 3 + k] - o[:, k, None]) * inv[:, k, None]
        tn = torch.maximum(tn, torch.minimum(a, b))
        tf = torch.minimum(tf, torch.maximum(a, b))
    hit = (tf >= torch.clamp(tn, min=0.0)) & (tn < tm[:, None])
    flags = hit.view(rows, lanes, n_c).any(dim=1)
    if not with_tn:
        return flags
    tn_pos = torch.where(hit, torch.clamp(tn, min=0.0), FLT_MAX)
    return flags, tn_pos.view(rows, lanes, n_c).amin(dim=1)


def _sphere_feats(o, d, tm):
    """Per-ray sphere-test features f32 [N, 16] = [dd6, (m x d)3, |m|², d.o,
    d3, tm, 1] with m = o x d (o relative to the scene centre).  tm is
    clamped to ±1e37, and tm <= 0 (an empty window: dead lanes, masked
    shadow segments) becomes -1e37, which plane E rejects (:1079-1101)."""
    mm = torch.linalg.cross(o, d)
    dd6 = torch.stack([d[:, 0] * d[:, 0], d[:, 1] * d[:, 1], d[:, 2] * d[:, 2],
                       d[:, 0] * d[:, 1], d[:, 0] * d[:, 2], d[:, 1] * d[:, 2]], 1)
    md = torch.linalg.cross(mm, d)
    m2 = torch.sum(mm * mm, dim=1, keepdim=True)
    do = torch.sum(d * o, dim=1, keepdim=True)
    tmc = torch.where(tm > 0.0, torch.clamp(tm, -1e37, 1e37), SPHERE_NEG)
    return torch.cat([dd6, md, m2, do, d, tmc[:, None], torch.ones_like(m2)],
                     1).contiguous()


def _sphere_plane_coeffs(unit_bounds, center):
    """f32 [3, 16, C] coefficients of the planes A, C, E over the sphere
    features (:1104-1148): the unit's bounding sphere (box centre, half
    diagonal) plus the reference's slack terms.  Inverted (padding) boxes
    get a -1e37 constant and never flag."""
    lo, hi = unit_bounds[:, 0:3], unit_bounds[:, 3:6]
    valid = torch.all(hi >= lo, dim=1)
    lo = torch.where(valid[:, None], lo, 0.0)
    hi = torch.where(valid[:, None], hi, 0.0)
    p = 0.5 * (lo + hi) - center[None]
    r = 0.5 * torch.linalg.norm(hi - lo, dim=1)
    scale = torch.max(torch.where(valid, torch.linalg.norm(p, dim=1) + r, 0.0))
    pp = torch.sum(p * p, dim=1)
    rr = r * r + 2e-4 * scale * scale + 1e-12
    rl = r + 2e-4 * scale + 1e-6
    z = torch.zeros_like(r)
    one = torch.ones_like(r)
    a = torch.stack(
        [p[:, 0] ** 2 - pp, p[:, 1] ** 2 - pp, p[:, 2] ** 2 - pp,
         2 * p[:, 0] * p[:, 1], 2 * p[:, 0] * p[:, 2], 2 * p[:, 1] * p[:, 2],
         -2 * p[:, 0], -2 * p[:, 1], -2 * p[:, 2], -one, z, z, z, z, z,
         torch.where(valid, rr, SPHERE_NEG)], 0)
    c = torch.stack([z, z, z, z, z, z, z, z, z, z, -one, p[:, 0], p[:, 1],
                     p[:, 2], z, torch.where(valid, rl, SPHERE_NEG)], 0)
    e = torch.stack([z, z, z, z, z, z, z, z, z, z, one, -p[:, 0], -p[:, 1],
                     -p[:, 2], one, torch.where(valid, rl, SPHERE_NEG)], 0)
    return torch.stack([a, c, e]).contiguous()


def sphere_flags_plain(feats, planes):
    """Plain torch sphere prepass.  ``feats`` f32 [rows * LANES, 16]
    (:func:`_sphere_feats` of padded rays), ``planes`` f32 [3, 16, C].
    Returns (flags bool [rows, C], tn f32 [rows, C]): a lane flags a unit
    when min(A, C, E) >= 0, and tn is the min over the row group's flagging
    lanes of max(C - 2·rl, 0) (the sphere window's start), FLT_MAX where
    none flags.  Each plane is summed over its :data:`SPHERE_TERMS` in
    order, one multiply and one add per term, as the kernel sums it."""
    timing.count("plain.compact.sphere_flags")
    rows, n_c = feats.shape[0] // LANES, planes.shape[2]
    rl2 = 2.0 * torch.clamp(planes[1, 15], min=0.0)
    flags = torch.empty((rows, n_c), dtype=torch.bool, device=feats.device)
    tn = torch.empty((rows, n_c), dtype=torch.float32, device=feats.device)
    step = max(1, (1 << 24) // (LANES * n_c))  # row groups per chunk
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        f = feats[r0 * LANES:r1 * LANES]
        vals = []
        for plane, terms in zip(planes, SPHERE_TERMS):
            acc = f[:, terms[0], None] * plane[terms[0]]
            for k in terms[1:]:
                acc = acc + f[:, k, None] * plane[k]
            vals.append(acc)
        a, c, e = vals
        hit = torch.minimum(torch.minimum(a, c), e) >= 0.0
        entry = torch.where(hit, torch.clamp(c - rl2, min=0.0), FLT_MAX)
        flags[r0:r1] = hit.view(r1 - r0, LANES, n_c).any(dim=1)
        tn[r0:r1] = entry.view(r1 - r0, LANES, n_c).amin(dim=1)
    return flags, tn


def sphere_flags_cuda(feats, planes):
    """The sphere-prepass kernel (``compact_sphere_flags`` in
    csrc/compact.cu); same contract as :func:`sphere_flags_plain`."""
    if not (feats.is_cuda and planes.is_cuda):
        raise ValueError("the CUDA sphere prepass takes CUDA tensors")
    if feats.dtype != torch.float32 or planes.dtype != torch.float32:
        raise TypeError("feats and planes must be float32")
    if (feats.dim() != 2 or feats.shape[1] != 16 or feats.shape[0] % LANES
            or planes.dim() != 3 or planes.shape[:2] != (3, 16)):
        raise ValueError(f"feats must be [rows * {LANES}, 16] and planes "
                         f"[3, 16, C]; got {tuple(feats.shape)}, "
                         f"{tuple(planes.shape)}")
    if not (feats.is_contiguous() and planes.is_contiguous()):
        raise ValueError("feats and planes must be contiguous")
    rows, n_c = feats.shape[0] // LANES, planes.shape[2]
    flags = torch.empty((rows, n_c), dtype=torch.bool, device=feats.device)
    tn = torch.empty((rows, n_c), dtype=torch.float32, device=feats.device)
    if rows == 0 or n_c == 0:
        return flags, tn
    lib, stream, p = _lib(feats)
    with torch.cuda.device(feats.device):
        err = lib.compact_sphere_flags(p(feats), p(planes), rows, n_c, p(flags),
                                       p(tn), stream)
    _raise_on(err, "compact_sphere_flags")
    timing.count("launch.compact.sphere_flags")
    return flags, tn


def sphere_flags(feats, planes):
    """Sphere prepass: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if feats.is_cuda:
        return sphere_flags_cuda(feats, planes)
    return sphere_flags_plain(feats, planes)


def _units(cluster_bounds):
    """(unit AABBs [U, 6], g clusters per unit)."""
    g = -(-cluster_bounds.shape[0] // SPHERE_UNIT_MAX)
    return (cluster_bounds if g == 1 else _coarsen_bounds(cluster_bounds, g)), g


def sphere_operands(center, cluster_bounds, ray_o, ray_d, tmax=None):
    """The sphere prepass's inputs for a wavefront: (feats f32
    [rows * LANES, 16] of the padded rays, planes f32 [3, 16, U])."""
    cull, _ = _units(cluster_bounds)
    rows = -(-ray_o.shape[0] // LANES)
    o, d, tm = _pad_rays(ray_o, ray_d, tmax, rows * LANES)
    return _sphere_feats(o - center, d, tm), _sphere_plane_coeffs(cull, center)


def prepass(center, cluster_bounds, ray_o, ray_d, tmax=None, plain=False):
    """Flags and entry distances per (row group, unit) for a wavefront:
    (flags bool [rows, U], tn f32 [rows, U], g clusters per unit), with
    ``rows`` = ceil(N / LANES).  ``tmax`` (f32 [N]) bounds each ray's
    window (None: unbounded); a negative one flags nothing."""
    cull, g = _units(cluster_bounds)
    if cluster_bounds.shape[0] > PER_RAY_PREPASS_MAX:
        feats, planes = sphere_operands(center, cluster_bounds, ray_o, ray_d, tmax)
        flags, tn = (sphere_flags_plain if plain else sphere_flags)(feats, planes)
        return flags, tn, g
    rows = -(-ray_o.shape[0] // LANES)
    o, d, tm = _pad_rays(ray_o, ray_d, tmax, rows * LANES)
    flags, tn = _row_flags(cull, o, d, tm, rows, LANES, with_tn=True)
    return flags, tn, g


def unit_spheres(cluster_bounds, center):
    """Per-unit bounding spheres f32 [U, 4] = (centre relative to
    ``center``, radius): the unit AABB's centre and half diagonal plus the
    prepass's slack (2e-4 of the scene's scale + 1e-6, as plane C of
    :func:`_sphere_plane_coeffs`), far above f32 rounding.  Padding units
    get radius -1 and never pass.  Built once per scene."""
    cull, _ = _units(cluster_bounds)
    lo, hi = cull[:, 0:3], cull[:, 3:6]
    valid = torch.all(hi >= lo, dim=1)
    lo = torch.where(valid[:, None], lo, 0.0)
    hi = torch.where(valid[:, None], hi, 0.0)
    p = 0.5 * (lo + hi) - center[None]
    r = 0.5 * torch.linalg.norm(hi - lo, dim=1)
    scale = torch.max(torch.where(valid, torch.linalg.norm(p, dim=1) + r, 0.0))
    rl = torch.where(valid, r + 2e-4 * scale + 1e-6, -1.0)
    return torch.cat([p, rl[:, None]], 1).contiguous()


def lane_unit_flags_plain(spheres, feats, tmax, with_entry: bool = False):
    """Each lane's own sphere test, bool [N, U]: the plain twin of the
    closest-hit kernel's ``lane_passes``.  ``spheres`` f32 [U, 4] of
    :func:`unit_spheres`, ``feats`` f32 [N, 10] Plücker features (unit
    directions, origins relative to the scene centre), ``tmax`` f32 [N]: a
    negative one marks a dead lane, which flags nothing; it bounds nothing
    else, as the sweep's contract does not bound hits by it.  With q =
    centre - o a lane flags a unit when |q x d|² <= r² and q.d + r >= 0;
    ``with_entry`` also returns max(q.d - r, 0) f32 [N, U], a lower bound
    of t over the sphere.  Unfused f32 operations in the kernel's order:
    bit-equal to it.  Materializes [N, U]: chunk large wavefronts."""
    d, o = feats[:, None, 0:3], feats[:, None, 6:9]
    q = spheres[None, :, 0:3] - o
    r = spheres[None, :, 3]
    ts = q[..., 0] * d[..., 0] + q[..., 1] * d[..., 1] + q[..., 2] * d[..., 2]
    wx = q[..., 1] * d[..., 2] - q[..., 2] * d[..., 1]
    wy = q[..., 2] * d[..., 0] - q[..., 0] * d[..., 2]
    wz = q[..., 0] * d[..., 1] - q[..., 1] * d[..., 0]
    d2 = wx * wx + wy * wy + wz * wz
    flags = ((r >= 0.0) & (d2 <= r * r) & (ts + r >= 0.0)
             & (tmax >= 0.0)[:, None])
    if not with_entry:
        return flags
    return flags, torch.clamp(ts - r, min=0.0)


def pair_counts(spheres, feats, tmax, flags, dist, g: int, num_tris: int,
                chunk_rows: int = 32) -> dict:
    """The (lane, triangle) pairs a sweep of this wavefront visits when it
    culls per row group of :data:`LANES` lanes (``row``: the units of
    ``flags`` bool [rows, U], for every lane of the group), per warp of
    :data:`WARP` lanes (``warp``: the listed units some lane of the warp
    flags itself, :func:`lane_unit_flags_plain`) and per lane (``lane``);
    and the same three with a unit counted only for lanes whose own entry
    distance is within reach of their ``dist`` f32 [N], a closest hit's
    final t or a shadow segment's range (``row_cut``, ``warp_cut``,
    ``lane_cut``: what a walk that knew each lane's answer would visit;
    ``lane_cut`` is what the data needs).  A measurement helper: floats,
    one host sync per chunk."""
    n, n_units = feats.shape[0], spheres.shape[0]
    unit_tris = CLUSTER_SUB * g
    tris = torch.clamp(num_tris - torch.arange(n_units, device=feats.device)
                       * unit_tris, 0, unit_tris).double()
    out = dict.fromkeys(("row", "warp", "lane", "row_cut", "warp_cut", "lane_cut"),
                        0.0)
    reach = dist * SKIP_MARGIN  # FLT_MAX (a miss) overflows to inf: any unit
    for r0 in range(0, flags.shape[0], chunk_rows):
        r1 = min(flags.shape[0], r0 + chunk_rows)
        lo, hi = r0 * LANES, min(n, r1 * LANES)
        pad = (r1 - r0) * LANES - (hi - lo)
        own, entry = lane_unit_flags_plain(spheres, feats[lo:hi], tmax[lo:hi], True)
        cut = own & (entry <= reach[lo:hi, None])
        real = torch.nn.functional.pad(
            torch.ones(hi - lo, dtype=torch.bool, device=feats.device), (0, pad))
        for key, lane in (("", own), ("_cut", cut)):
            lane = torch.nn.functional.pad(lane, (0, 0, 0, pad))
            lane = lane & flags[r0:r1].repeat_interleave(LANES, 0)
            for name, size in (("row", LANES), ("warp", WARP), ("lane", 1)):
                grp = lane.view(-1, size, n_units).any(1)
                if name == "row" and not key:
                    grp = flags[r0:r1]  # every listed unit, as the list has it
                lanes = real.view(-1, size).sum(1).double()
                out[name + key] += float((grp.double() * tris).sum(1) @ lanes)
    return out


def work_list(flags, tn):
    """Compact the flagged (row group, unit) pairs into a row-major,
    near-to-far work list: (items i32 [W] unit ids, item_tn f32 [W],
    offsets i32 [rows + 1]), row group r's items being
    ``items[offsets[r]:offsets[r + 1]]`` in ascending tn.  One sort on an
    exact int64 key ``row << 32 | bits(tn)``: tn >= 0, so its f32 bits
    order like the floats.  ``nonzero`` costs a host sync."""
    rows = flags.shape[0]
    timing.host_sync()
    row, unit = torch.nonzero(flags, as_tuple=True)
    t = tn[row, unit].abs()  # -0.0 -> +0.0, whose bits sort first
    key = (row << 32) | t.view(torch.int32).to(torch.int64)
    order = torch.argsort(key, stable=True)
    offsets = torch.zeros(rows + 1, dtype=torch.int32, device=flags.device)
    offsets[1:] = torch.cumsum(torch.bincount(row, minlength=rows), 0)
    return (unit[order].to(torch.int32).contiguous(), t[order].contiguous(),
            offsets)


# ---------------------------------------------------------------------------
# plain sweeps
# ---------------------------------------------------------------------------


def closest_hit_plain(coeffs, feats, tmax, flags, g):
    """Plain torch compact closest hit.  ``coeffs`` f32 [T, 4, 10],
    ``feats`` f32 [N, 10], ``tmax`` f32 [N] (negative: a dead lane),
    ``flags`` bool [ceil(N / LANES), U] from :func:`prepass`, ``g``
    clusters per unit.  Returns (prim i32 [N], dist f32 [N]): the exact
    minimum t over the lane's row-group units, ties to the lower id;
    misses and dead lanes are (-1, FLT_MAX)."""
    timing.count("plain.compact.closest_hit")
    prim, dist = sweep_closest(coeffs, feats, flags, LANES, CLUSTER_SUB * g, hit_t,
                               _PLAIN_PAIRS)
    live = tmax >= 0.0
    return (torch.where(live, prim, NULL_PRIMITIVE),
            torch.where(live, dist, FLT_MAX))


def occlusion_plain(coeffs, feats, tm, flags, g):
    """Plain torch compact any-hit: True where a triangle of the lane's
    row-group units blocks the segment of range ``tm`` f32 [N].  Other
    arguments as :func:`closest_hit_plain`."""
    timing.count("plain.compact.occlusion")
    return sweep_any(coeffs, feats, flags, LANES, CLUSTER_SUB * g,
                     lambda c, f, lo, hi: blocks(c, f, tm[lo:hi]), _PLAIN_PAIRS)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/compact.cu)
# ---------------------------------------------------------------------------


def _lib(like):
    import ctypes

    from ._build import load_library

    stream = torch.cuda.current_stream(like.device).cuda_stream
    return (load_library("compact"), ctypes.c_void_p(stream),
            lambda t: ctypes.c_void_p(t.data_ptr()))


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _launch_sweep(entry, packed, spheres, feats, lane_f32, items, item_tn, offsets, g,
                  outs):
    """Check a sweep kernel's inputs and launch C entry point ``entry`` on
    them: the scene's packed table ``packed`` f32 [T, 20] (read 16 bytes at
    a time) and unit spheres ``spheres`` f32 [U, 4], the per-lane range
    ``lane_f32`` f32 [N] and the work list of :func:`work_list`."""
    tensors = (packed, spheres, feats, lane_f32, items, item_tn, offsets)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA compact sweep takes CUDA tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the compact sweep's inputs must be contiguous")
    n = feats.shape[0]
    if (packed.dtype != torch.float32 or packed.dim() != 2
            or packed.shape[1] != PACKED_WIDTH or packed.data_ptr() % 16):
        raise ValueError(f"the packed table must be 16-byte aligned f32 "
                         f"[T, {PACKED_WIDTH}], got {tuple(packed.shape)}")
    if feats.dtype != torch.float32 or feats.dim() != 2 or feats.shape[1] != 10:
        raise ValueError(f"feats must be f32 [N, 10], got {tuple(feats.shape)}")
    if lane_f32.dtype != torch.float32 or lane_f32.shape != (n,):
        raise ValueError("the per-lane range must be f32 [N]")
    if items.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError("items and offsets must be int32")
    if item_tn.dtype != torch.float32 or item_tn.shape != items.shape:
        raise ValueError("item_tn must be f32, one per item")
    if offsets.shape != (-(-n // LANES) + 1,):
        raise ValueError(f"offsets must be [ceil(N / {LANES}) + 1]")
    if g < 1:
        raise ValueError("g must be >= 1")
    n_units = -(-packed.shape[0] // (CLUSTER_SUB * g))
    if (spheres.dtype != torch.float32 or spheres.shape != (n_units, 4)
            or spheres.data_ptr() % 16):
        raise ValueError(f"spheres must be 16-byte aligned f32 [{n_units}, 4], "
                         f"one per unit")
    if n == 0:
        return
    lib, stream, p = _lib(feats)
    with torch.cuda.device(feats.device):
        err = getattr(lib, entry)(
            p(packed), packed.shape[0], CLUSTER_SUB * g, p(spheres), p(feats),
            p(lane_f32), n, p(items), p(item_tn), p(offsets), offsets.shape[0] - 1,
            *(p(t) for t in outs), stream)
    _raise_on(err, entry)


def closest_hit_cuda(packed, spheres, feats, tmax, items, item_tn, offsets, g):
    """The compact closest-hit kernel (``compact_closest_hit`` in
    csrc/compact.cu) over the work list ``items, item_tn, offsets`` of
    :func:`work_list`, on the scene's packed table ``packed`` f32 [T, 20]
    and unit spheres ``spheres`` f32 [U, 4]; same results as
    :func:`closest_hit_plain` on the flags the list was built from."""
    n = feats.shape[0]
    prim = torch.empty((n,), dtype=torch.int32, device=feats.device)
    dist = torch.empty((n,), dtype=torch.float32, device=feats.device)
    _launch_sweep("compact_closest_hit", packed, spheres, feats, tmax, items, item_tn,
                  offsets, g, (prim, dist))
    timing.count("launch.compact.closest_hit")
    return prim, dist


def occlusion_cuda(packed, spheres, feats, tm, items, item_tn, offsets, g):
    """The compact shadow kernel (``compact_occlusion`` in csrc/compact.cu)
    over the work list of :func:`work_list`, on the scene's packed table
    and unit spheres, as :func:`closest_hit_cuda`: each lane sweeps only
    the listed units its own segment of range ``tm`` f32 [N] can reach.
    Same results as :func:`occlusion_plain` on the flags the list was built
    from; a segment of negative range is never blocked."""
    occ = torch.empty((feats.shape[0],), dtype=torch.int32, device=feats.device)
    _launch_sweep("compact_occlusion", packed, spheres, feats, tm, items, item_tn,
                  offsets, g, (occ,))
    timing.count("launch.compact.occlusion")
    return occ.bool()


def closest_hit(coeffs, feats, tmax, flags, tn, g, packed=None, spheres=None):
    """Compact closest hit: the work list and the kernel for CUDA tensors
    (on the scene's ``packed`` table and unit ``spheres``, which it then
    needs), the plain version for CPU tensors."""
    if feats.is_cuda:
        _require_tables(packed, spheres, "closest hit")
        return closest_hit_cuda(packed, spheres, feats, tmax,
                                *work_list(flags, tn), g)
    return closest_hit_plain(coeffs, feats, tmax, flags, g)


def occlusion(coeffs, feats, tm, flags, tn, g, packed=None, spheres=None):
    """Compact shadow sweep: the work list and the kernel for CUDA tensors
    (on the scene's ``packed`` table and unit ``spheres``, which it then
    needs), the plain version for CPU tensors."""
    if feats.is_cuda:
        _require_tables(packed, spheres, "shadow sweep")
        return occlusion_cuda(packed, spheres, feats, tm, *work_list(flags, tn), g)
    return occlusion_plain(coeffs, feats, tm, flags, g)


def _require_tables(packed, spheres, what):
    if packed is None or spheres is None:
        raise ValueError(f"the CUDA compact {what} needs the scene's packed table "
                         f"and unit spheres")


# ---------------------------------------------------------------------------
# scene-level entry points
# ---------------------------------------------------------------------------


def intersect_compact(coeffs, center, cluster_bounds, ray_o, ray_d, tmax=None,
                      plain: bool = False, packed=None, spheres=None):
    """Closest hit through the compact engine: (prim i32 [N] positional
    ids, selector-grade dist f32 [N]).  ``tmax`` (f32 [N]) bounds the
    prepass; a lane with negative tmax (the engines pass -FLT_MAX) is dead
    and misses.  ``plain`` selects the plain versions on any device;
    ``packed`` and ``spheres`` are the scene's packed table and unit
    spheres, which the kernel reads."""
    if tmax is None:
        tmax = torch.full((ray_o.shape[0],), FLT_MAX, device=ray_o.device)
    flags, tn, g = prepass(center, cluster_bounds, ray_o, ray_d, tmax, plain)
    feats = plucker_features(ray_o, ray_d, center)
    if plain:
        return closest_hit_plain(coeffs, feats, tmax, flags, g)
    return closest_hit(coeffs, feats, tmax.contiguous(), flags, tn, g, packed,
                       spheres)


def occlusion_compact(coeffs, center, cluster_bounds, x, y, plain: bool = False,
                      packed=None, spheres=None):
    """True where segment x->y is blocked (bool [N]), the segment inset as
    :func:`segment_rays` does.  A zero-length segment (y == x) has a
    negative range and flags nothing: never blocked.  ``plain``, ``packed``
    and ``spheres`` as for :func:`intersect_compact`."""
    ray_o, ray_d, tm = segment_rays(x, y)
    flags, tn, g = prepass(center, cluster_bounds, ray_o, ray_d, tm, plain)
    feats = plucker_features(ray_o, ray_d, center)
    if plain:
        return occlusion_plain(coeffs, feats, tm, flags, g)
    return occlusion(coeffs, feats, tm.contiguous(), flags, tn, g, packed, spheres)
