"""Ray–triangle intersection without culling clusters: the brute-force
oracle and the MTBVH walk.

Port of ``radish_pt_tpu/accel/traverse.py``:
* ``pack_tris``, ``intersect_brute`` and ``occlusion_brute`` (reference
  ``naiveIntersect`` / ``naiveTestOcclusion``, scene.h:218-260):
  component-wise Möller–Trumbore with a sign-normalized determinant over
  all [N] x [T] pairs, chunked over rays and triangles so memory stays
  bounded.  Plain torch on any device; the sweep engines are held against
  it.
* the ``"bvh"`` engine: ``pack_bvh``, ``get_dir_class``, ``_slab_core``
  and the stackless walk over the 6-way threaded BVH of
  :mod:`.bvh` (``DevScene::intersect`` / ``testOcclusion`` /
  ``visualizedIntersect``, scene.h:262-372): closest hit, any-hit and the
  traversal heatmap.  The JAX package walks in lockstep in XLA
  (``intersect_bvh`` :408, ``occlusion_bvh`` :469,
  ``intersect_bvh_heatmap`` :570), with a deferred-leaf register and tail
  compaction that work round XLA's gathers; the port has no such stages.
  Each walk has two implementations with one contract: ``*_plain``, a
  lockstep torch walk that tests a leaf the step it reaches it, and
  ``*_cuda``, the hand-written kernels of ``csrc/bvh.cu`` (every
  operation rounded as the plain version rounds it, so ids, distances,
  barycentrics, shadow bits and counts are its bits): the closest hit and
  the any-hit walk run as persistent warps over a queue of the live lanes
  by direction class, which the binning kernel (``bin_by_dir_class_cuda``;
  plain version :func:`bin_by_dir_class`) builds first, in one launch, into
  a workspace of six regions of N lanes, one a class, and
  :data:`WS_COUNTERS` counters (int32 [6N + 16], about 15 MB at 800x800);
  the heatmap walks as warps of 32 rays that visit, a step at a time, the
  least node row any of their lanes is at (its plain model:
  :func:`heatmap_warp_model`).  A lane whose range is not above 0
  can meet no triangle (a pair counts only at 0 < t < range) and is
  settled before its walk, by either version.  The entry points ``intersect_bvh`` / ``occlusion_bvh`` /
  ``intersect_bvh_heatmap`` take the plain version for CPU tensors and
  launch the kernels (or raise) for CUDA tensors; they count
  ``launch.traverse.*`` kernel launches (one a binning, before each
  closest hit and shadow walk) and ``plain.traverse.*`` plain-version
  calls, per walk and for the binning (utils/timing.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import timing

NULL_PRIMITIVE = -1
RAY_OFFSET = 1e-5  # reference makeOffsetedRay (intersections.h:16-18)
SHADOW_EPS = 1e-4  # shadow segments stop this short of their end
FLT_MAX = 3.402823466e38


def pack_tris(tri_v) -> np.ndarray:
    """Pack triangles as f32[T, 9] = v0.xyz, e01.xyz, e02.xyz."""
    v = np.asarray(tri_v).reshape(-1, 3, 3)
    out = np.empty((v.shape[0], 9), np.float32)
    out[:, 0:3] = v[:, 0]
    out[:, 3:6] = v[:, 1] - v[:, 0]
    out[:, 6:9] = v[:, 2] - v[:, 0]
    return out


def _mt_core(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
             ox, oy, oz, dx, dy, dz):
    """Component-wise Möller–Trumbore with sign-normalized determinant
    (intersections.h:20-68).  Returns (hit, dist, bary_x, bary_y)."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det0 = e1x * px + e1y * py + e1z * pz
    sign = torch.where(det0 < 0.0, -1.0, 1.0)
    det = torch.abs(det0)
    sx = (ox - v0x) * sign
    sy = (oy - v0y) * sign
    sz = (oz - v0z) * sign
    bx = sx * px + sy * py + sz * pz
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    by = dx * qx + dy * qy + dz * qz
    inv_det = 1.0 / torch.clamp(det, min=1e-30)
    dist = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ((det >= 1.1920929e-07) & (bx >= 0.0) & (bx <= det) & (by >= 0.0)
           & (bx + by <= det) & (dist > 0.0))
    return hit, dist, bx * inv_det, by * inv_det


def intersect_brute(tri_packed, ray_o, ray_d, chunk: int = 2048,
                    ray_chunk: int = 8192):
    """All-pairs closest hit over ``tri_packed`` f32[T, 9].  Returns
    (prim_id i32 [N], dist f32 [N], bary f32 [N, 2]); ties go to the lower
    triangle id."""
    n = ray_o.shape[0]
    num_tris = tri_packed.shape[0]
    dev = ray_o.device
    prim = torch.full((n,), NULL_PRIMITIVE, dtype=torch.int32, device=dev)
    best = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    bary = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    for r0 in range(0, n, ray_chunk):
        r1 = min(n, r0 + ray_chunk)
        o = [ray_o[r0:r1, k:k + 1] for k in range(3)]
        d = [ray_d[r0:r1, k:k + 1] for k in range(3)]
        for c0 in range(0, num_tris, chunk):
            tc = tri_packed[c0:c0 + chunk]
            cols = [tc[None, :, k] for k in range(9)]
            hit, dist, bx, by = _mt_core(*cols, *o, *d)
            dist = torch.where(hit, dist, FLT_MAX)
            cd, j = torch.min(dist, dim=1)  # first minimum: lower id on ties
            upd = cd < best[r0:r1]
            jj = j[:, None]
            prim[r0:r1] = torch.where(upd, (j + c0).to(torch.int32), prim[r0:r1])
            best[r0:r1] = torch.where(upd, cd, best[r0:r1])
            cb = torch.cat([bx.gather(1, jj), by.gather(1, jj)], dim=1)
            bary[r0:r1] = torch.where(upd[:, None], cb, bary[r0:r1])
    return prim, best, bary


def segment_rays(x, y):
    """Shadow segment x->y as (origin, unit dir, range): the origin is
    inset by 1e-5 along the segment and the range ends 1e-4 short of y
    (scene.h:244-260).  A zero-length segment gets a zero direction."""
    d = y - x
    dist = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-24))
    dirn = d / dist[..., None]
    return x + dirn * RAY_OFFSET, dirn, dist - SHADOW_EPS


def occlusion_brute(tri_packed, x, y, chunk: int = 2048):
    """Any-hit between points x and y — ``naiveTestOcclusion``
    (scene.h:244-260).  Returns bool [N] (True = occluded)."""
    ori, dirn, max_dist = segment_rays(x, y)
    prim, hit_dist, _ = intersect_brute(tri_packed, ori, dirn, chunk)
    return (prim != NULL_PRIMITIVE) & (hit_dist < max_dist)


# ---------------------------------------------------------------------------
# MTBVH walk: packing and per-lane primitives
# ---------------------------------------------------------------------------


def pack_bvh(bvh) -> np.ndarray:
    """Pack the 6-way threaded BVH into one f32[6B, 8] table: row =
    [bmin.x, bmin.y, bmin.z, bmax.x, bmax.y, bmax.z, leaf, miss], the int32
    fields (leaf row or -1; miss link) bit-cast into f32 columns."""
    leaf = np.asarray(bvh.node_leaf).reshape(-1)
    aabb = np.asarray(bvh.node_aabb).reshape(-1)
    miss = np.asarray(bvh.node_miss).reshape(-1)
    out = np.empty((leaf.shape[0], 8), np.float32)
    out[:, 0:3] = np.asarray(bvh.bounds_min)[aabb]
    out[:, 3:6] = np.asarray(bvh.bounds_max)[aabb]
    out[:, 6] = leaf.astype(np.int32).view(np.float32)
    out[:, 7] = miss.astype(np.int32).view(np.float32)
    return out


def get_dir_class(d):
    """One of 6 axis-sign classes of a direction — ``DevScene::getMTBVHId``
    (scene.h:114-129).  Like the reference, the walk passes the *negated*
    ray direction."""
    ax, ay, az = (torch.abs(d[..., k]) for k in range(3))
    x_cls = torch.where(d[..., 0] > 0, 0, 1)
    y_cls = torch.where(d[..., 1] > 0, 2, 3)
    z_cls = torch.where(d[..., 2] > 0, 4, 5)
    return torch.where(ax > ay, torch.where(ax > az, x_cls, z_cls),
                       torch.where(ay > az, y_cls, z_cls)).to(torch.int32)


def _slab_core(bminx, bminy, bminz, bmaxx, bmaxy, bmaxz, ox, oy, oz, ix, iy, iz):
    """Component-wise slab test (``AABB::intersect``, bvh.h:91-155); i* =
    1/d* per ray.  Returns (hit, t_near); t_near may be negative with the
    origin inside.  An origin on a slab plane with that direction
    component 0 gives 0 * inf = NaN: the axis's minimum and maximum keep
    the NaN and ``nan_to_num`` turns it into -FLT_MAX / +FLT_MAX (and any
    infinity into +-FLT_MAX), so the axis constrains nothing — the JAX
    package's ``jnp.nan_to_num(..., nan=-inf)``, whose default clamp of
    infinities also catches the -inf it writes."""
    def axis(bmin, bmax, o, inv):
        t1 = (bmin - o) * inv
        t2 = (bmax - o) * inv
        return (torch.nan_to_num(torch.minimum(t1, t2), nan=-FLT_MAX),
                torch.nan_to_num(torch.maximum(t1, t2), nan=FLT_MAX))

    lx, hx = axis(bminx, bmaxx, ox, ix)
    ly, hy = axis(bminy, bmaxy, oy, iy)
    lz, hz = axis(bminz, bmaxz, oz, iz)
    t_near = torch.maximum(lx, torch.maximum(ly, lz))
    t_far = torch.minimum(hx, torch.minimum(hy, hz))
    return (t_far >= 0.0) & (t_far >= t_near), t_near


# ---------------------------------------------------------------------------
# MTBVH walk: plain torch versions
# ---------------------------------------------------------------------------

# f32 operations a lane spends, counted from csrc/bvh.cu: a node visit's
# slab test (six differences, six products, six NaN tests, three minima and
# three maxima, two for t_near and two for t_far, the verdict's three
# comparisons); a (lane, triangle) pair of a leaf: mt_pair.cuh's 55
# (accel/dense.py)
FLOPS_PER_NODE = 31
FLOPS_PER_PAIR = 55
NODE_BYTES = 32  # a row of the node table
DIR_CLASSES = 6
WARP = 32  # the lanes of a warp: the heatmap kernel's unit of coherence
WS_COUNTERS = 16  # int32 counters after the binning kernel's six regions (csrc/bvh.cu)



def _walk(leaf_tris, bvh_packed, ray_o, ray_d, tmax=None, any_hit=False, stats=None):
    """The stackless MTBVH walk (scene.h:262-372) of every lane in
    lockstep, one node a step: a lane descends (``node + 1``) where the
    node's box is hit nearer than its current best (at first its range
    ``tmax``, else FLT_MAX), else it jumps to ``miss``, and it is done at
    node B.  A leaf it descends into is tested at once, all L slots by
    Möller–Trumbore (``_mt_core``), and the first minimum in slot order
    replaces the best when strictly nearer.  With ``any_hit`` a lane is
    done at its first leaf with a hit below its range.  A lane whose range
    is not above 0 (or NaN) is settled before its walk, with no visit: a
    pair counts only at 0 < t < range, so it can meet no triangle (a
    closest hit's dead lane, ``tmax = -FLT_MAX``, is a miss).

    Returns (slot i64 [N] (-1: none), dist (the best hit's t, FLT_MAX
    without one), bx, by, steps i32 [N]: the nodes each lane descended
    into, blocked bool [N]).  ``stats`` (a dict) receives per lane the node
    visits, the leaves tested and the (lane, triangle) pairs tested (an
    any-hit lane's last leaf up to its blocking slot), and which node rows
    and leaves any lane touched."""
    size = bvh_packed.shape[0] // 6
    L = leaf_tris.shape[1] // 9
    n, dev = ray_o.shape[0], ray_o.device
    rows_i = bvh_packed.view(torch.int32)
    base = get_dir_class(-ray_d).long() * size
    o = [ray_o[:, k] for k in range(3)]
    d = [ray_d[:, k] for k in range(3)]
    inv = [1.0 / c for c in d]
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    c_dist = (tmax.clone() if tmax is not None
              else torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev))
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bx = torch.zeros(n, dtype=torch.float32, device=dev)
    by = torch.zeros_like(bx)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    if stats is not None:
        visits = torch.zeros(n, dtype=torch.int64, device=dev)
        leaf_visits = torch.zeros(n, dtype=torch.int64, device=dev)
        pairs = torch.zeros(n, dtype=torch.int64, device=dev)
        rows_seen = torch.zeros(rows_i.shape[0], dtype=torch.bool, device=dev)
        leaves_seen = torch.zeros(leaf_tris.shape[0], dtype=torch.bool, device=dev)
    act = torch.arange(n, device=dev)
    if tmax is not None:
        act = act[c_dist > 0]
    while act.numel():
        r = base[act] + node[act]
        row = rows_i[r]
        box = row.view(torch.float32)
        hit, t_near = _slab_core(*box[:, :6].unbind(1), *(c[act] for c in o),
                                 *(c[act] for c in inv))
        desc = hit & (t_near < c_dist[act])
        steps[act] += desc.to(torch.int32)
        leaf = row[:, 6]
        at_leaf = desc & (leaf != NULL_PRIMITIVE)
        if stats is not None:
            visits[act] += 1
            rows_seen[r] = True
        la = act[at_leaf]
        if la.numel():
            lrow = leaf[at_leaf].long()
            tri = leaf_tris[lrow].view(-1, L, 9)
            h, t, b0, b1 = _mt_core(*tri.unbind(-1), *(c[la, None] for c in o),
                                    *(c[la, None] for c in d))
            if any_hit:
                blk = h & (t < tmax[la, None])
                newly = blk.any(1)
                blocked[la] = newly
                if stats is not None:
                    first = torch.argmax(blk.to(torch.int8), dim=1)  # the first True
                    pairs[la] += torch.where(newly, first + 1, L)
            else:
                t = torch.where(h, t, FLT_MAX)
                lt, j = torch.min(t, dim=1)  # first minimum: the lower slot on ties
                upd = (lt < FLT_MAX) & (lt < c_dist[la])
                u, ju = la[upd], j[upd, None]
                c_dist[u] = lt[upd]
                slot[u] = lrow[upd] * L + ju[:, 0]
                bx[u] = b0[upd].gather(1, ju)[:, 0]
                by[u] = b1[upd].gather(1, ju)[:, 0]
                if stats is not None:
                    pairs[la] += L
            if stats is not None:
                leaf_visits[la] += 1
                leaves_seen[lrow] = True
        nxt = torch.where(desc, node[act] + 1, row[:, 7].long())
        if any_hit:
            nxt = torch.where(blocked[act], size, nxt)
        node[act] = nxt
        act = act[nxt < size]
    if stats is not None:
        stats.update(visits=visits, leaf_visits=leaf_visits, pairs=pairs, rows=rows_seen,
                     leaves=leaves_seen)
    return slot, torch.where(slot >= 0, c_dist, FLT_MAX), bx, by, steps, blocked


def intersect_bvh_plain(leaf_tris, leaf_map, bvh_packed, ray_o, ray_d, tmax=None,
                        stats=None):
    """Closest hit by the MTBVH walk (``DevScene::intersect``, scene.h:262-301)
    over the packed node table ``bvh_packed`` f32 [6B, 8] and the padded
    leaf-major triangles ``leaf_tris`` f32 [R, L*9]; ``leaf_map`` i32 [R*L]
    maps a slot to its stored triangle.  ``tmax`` (f32 [N], optional) is
    each lane's range: only hits below it count, and a lane whose range is
    not above 0 (a dead lane: ``-FLT_MAX``, as the sweeps take it) is
    settled as a miss before its walk.  Returns (prim i32 [N], dist f32
    [N], bary f32 [N, 2]); a miss is (-1, FLT_MAX, (0, 0)).  The JAX
    package's ``intersect_bvh`` visits more nodes (its deferred leaves
    prune with a stale best) but tests the same leaves in the same order,
    so it returns the same winners."""
    timing.count("plain.traverse.closest_hit")
    slot, dist, bx, by, _, _ = _walk(leaf_tris, bvh_packed, ray_o, ray_d, tmax, stats=stats)
    prim = torch.where(slot >= 0, leaf_map[torch.clamp(slot, min=0)], NULL_PRIMITIVE)
    return prim.to(torch.int32), dist, torch.stack([bx, by], dim=-1)


def occlusion_bvh_plain(leaf_tris, bvh_packed, ray_o, ray_d, tmax, stats=None):
    """Any-hit by the MTBVH walk (``DevScene::testOcclusion``,
    scene.h:303-334): True where some triangle is hit at t < ``tmax`` f32
    [N]; a lane descends into boxes entered before ``tmax`` and stops at
    its first blocking leaf.  A lane whose range is not above 0 (or NaN) is
    never blocked and walks nothing."""
    timing.count("plain.traverse.occlusion")
    return _walk(leaf_tris, bvh_packed, ray_o, ray_d, tmax, any_hit=True, stats=stats)[5]


def intersect_bvh_heatmap_plain(leaf_tris, bvh_packed, ray_o, ray_d, stats=None):
    """The closest-hit walk's count of descended nodes per lane, i32 [N]
    (``DevScene::visualizedIntersect``, scene.h:336-372)."""
    timing.count("plain.traverse.heatmap")
    return _walk(leaf_tris, bvh_packed, ray_o, ray_d, stats=stats)[4]


def heatmap_warp_model(leaf_tris, bvh_packed, ray_o, ray_d, warp: int = WARP, stats=None):
    """The plain model of the heatmap kernel's warp-coherent walk
    (``bvh_heatmap_kernel`` in csrc/bvh.cu).  Lanes go ``warp`` at a time in
    launch order.  A lane's key is the row of ``bvh_packed`` it is at, class
    x B + node, and a lane that is done is past every row.  Each step a
    warp takes its least key m; only its lanes at m visit row m, with the
    plain walk's slab test and leaf test, then move to node + 1 (descended)
    or the node's miss link.  Each lane walks its own threaded order, so the
    counts are :func:`intersect_bvh_heatmap_plain`'s; a warp's steps are
    the rows its lanes visit between them.

    Returns (descended nodes i32 [N], steps i64 [ceil(N / warp)]: the rows
    each warp loaded).  ``stats`` (a dict) receives "leaf_steps" i64 [W],
    the steps at which some lane of the warp tested a leaf, and "visits"
    i64 [N], each lane's node visits."""
    size = bvh_packed.shape[0] // 6
    L = leaf_tris.shape[1] // 9
    n, dev = ray_o.shape[0], ray_o.device
    n_w = -(-n // warp)
    done = DIR_CLASSES * size  # past every row (INT_MAX in the kernel)
    rows_i = bvh_packed.view(torch.int32)
    base = get_dir_class(-ray_d).long() * size
    o = [ray_o[:, k] for k in range(3)]
    d = [ray_d[:, k] for k in range(3)]
    inv = [1.0 / c for c in d]
    # the lanes' keys by warp, the last warp padded with lanes that are done
    key = torch.full((n_w * warp,), done, dtype=torch.int64, device=dev)
    key[:n] = base
    c_dist = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    visits = torch.zeros(n, dtype=torch.int64, device=dev)
    warp_steps = torch.zeros(n_w, dtype=torch.int64, device=dev)
    leaf_steps = torch.zeros_like(warp_steps)
    while n:
        least = key.view(n_w, warp).min(1).values
        walking = least < done
        if not bool(walking.any()):
            break
        warp_steps += walking
        act = torch.nonzero((key.view(n_w, warp) == least[:, None]).view(-1)
                            & (key < done))[:, 0]
        r = key[act]
        row = rows_i[r]
        hit, t_near = _slab_core(*row.view(torch.float32)[:, :6].unbind(1),
                                 *(c[act] for c in o), *(c[act] for c in inv))
        desc = hit & (t_near < c_dist[act])
        steps[act] += desc.to(torch.int32)
        visits[act] += 1
        at_leaf = desc & (row[:, 6] != NULL_PRIMITIVE)
        la = act[at_leaf]
        if la.numel():
            leaf_steps[torch.unique(la // warp)] += 1
            tri = leaf_tris[row[at_leaf, 6].long()].view(-1, L, 9)
            h, t, _, _ = _mt_core(*tri.unbind(-1), *(c[la, None] for c in o),
                                  *(c[la, None] for c in d))
            lt = torch.min(torch.where(h, t, FLT_MAX), dim=1).values
            c_dist[la] = torch.where(lt < c_dist[la], lt, c_dist[la])
        nxt = torch.where(desc, r - base[act] + 1, row[:, 7].long())
        key[act] = torch.where(nxt < size, base[act] + nxt, done)
    if stats is not None:
        stats.update(leaf_steps=leaf_steps, visits=visits)
    return steps, warp_steps


def bin_by_dir_class(ray_d, tmax=None):
    """The live lanes (range above 0; every lane without ``tmax``) in a
    stable class-major order: (order i64 [live], counts i64 [6]), the
    classes ``get_dir_class(-ray_d)``, the threaded order each lane walks.
    The plain version of the binning kernel (``bvh_bin_kernel``), whose
    order within a class may differ: it keeps launch order only within a
    warp's and a block's share of a class."""
    timing.count("plain.traverse.bin")
    cls = get_dir_class(-ray_d).long()
    live = torch.ones_like(cls, dtype=torch.bool) if tmax is None else tmax > 0
    key = torch.where(live, cls, DIR_CLASSES)
    order = torch.argsort(key, stable=True)[: int(live.sum())]
    return order, torch.bincount(cls[live], minlength=DIR_CLASSES)


# ---------------------------------------------------------------------------
# MTBVH walk: CUDA kernels (csrc/bvh.cu)
# ---------------------------------------------------------------------------


def _check_walk_inputs(leaf_tris, bvh_packed, ray_o, ray_d, *extra):
    """Raise on what the walk kernels do not take; ``extra``: further
    (name, tensor, dtype) operands."""
    tensors = (("leaf_tris", leaf_tris, torch.float32), ("bvh_packed", bvh_packed, torch.float32),
               ("ray_o", ray_o, torch.float32), ("ray_d", ray_d, torch.float32), *extra)
    if not all(t.is_cuda for _, t, _ in tensors):
        raise ValueError("the CUDA walk takes CUDA tensors")
    for name, t, dtype in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}")
    if bvh_packed.dim() != 2 or bvh_packed.shape[1] != 8 or bvh_packed.shape[0] % 6:
        raise ValueError(f"bvh_packed must be [6B, 8], got {tuple(bvh_packed.shape)}")
    if leaf_tris.dim() != 2 or leaf_tris.shape[1] % 9:
        raise ValueError(f"leaf_tris must be [R, L*9], got {tuple(leaf_tris.shape)}")
    if ray_o.dim() != 2 or ray_o.shape[1] != 3 or ray_d.shape != ray_o.shape:
        raise ValueError(f"rays must be [N, 3], got {tuple(ray_o.shape)} and "
                         f"{tuple(ray_d.shape)}")


def _ptr(t):
    import ctypes

    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(fn, device, *args):
    """C entry point ``fn`` of csrc/bvh.cu on the current stream of
    ``device``; raises on a refused launch."""
    import ctypes

    from ._build import load_library
    from .dense import _raise_on

    lib = load_library("bvh")
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, ctypes.c_void_p(stream))
    _raise_on(err, fn)


# what the binning kernel writes for a dead lane (csrc/bvh.cu DeadOut)
MISS_OUT, UNBLOCKED_OUT, NO_OUT = 0, 1, 2


def bin_cuda(ray_d, tmax, dead_out=NO_OUT, outs=(None, None, None)):
    """The binning kernel (``bvh_bin`` in csrc/bvh.cu, one launch after a
    memset of its counters) on ``ray_d`` and ``tmax`` (None: every lane
    live), no host sync: returns its workspace, i32 [6N + WS_COUNTERS]: the
    live lanes of class k at [kN, kN + count_k), then the counters (lanes
    per class, dead lanes); a dead lane's result goes to ``outs`` as
    ``dead_out`` says (MISS_OUT: (prim, dist, bary); UNBLOCKED_OUT: (occ,
    None, None))."""
    import ctypes

    n = ray_d.shape[0]
    ws = torch.empty((DIR_CLASSES * n + WS_COUNTERS,), dtype=torch.int32, device=ray_d.device)
    _launch("bvh_bin", ray_d.device, _ptr(ray_d), _ptr(tmax), ctypes.c_int(n),
            ctypes.c_int(dead_out), *(_ptr(t) for t in outs), _ptr(ws))
    if n:
        timing.count("launch.traverse.bin")
    return ws


def _walk_launch(fn, what, leaf_tris, bvh_packed, ray_o, ray_d, *args):
    import ctypes

    _launch(fn, ray_o.device, _ptr(bvh_packed), ctypes.c_int(bvh_packed.shape[0] // 6),
            _ptr(leaf_tris), ctypes.c_int(leaf_tris.shape[1] // 9), _ptr(ray_o), _ptr(ray_d),
            ctypes.c_int(ray_o.shape[0]), *(_ptr(a) for a in args))
    timing.count(f"launch.traverse.{what}")


def _check_range(tmax, n):
    if tmax is None:
        return ()
    if tmax.shape != (n,):
        raise ValueError(f"tmax must be [N], got {tuple(tmax.shape)}")
    return (("tmax", tmax, torch.float32),)


def bin_by_dir_class_cuda(ray_d, tmax=None):
    """The binning kernel (``bvh_bin`` in csrc/bvh.cu) alone: (queue i32
    [live]: the live lanes class-major, compacted from the kernel's six
    regions, counts i32 [6]); the same classes and counts as
    :func:`bin_by_dir_class`, the order within a class as the kernel's
    warps and blocks ran (reads the counts on the host)."""
    n = ray_d.shape[0]
    extra = _check_range(tmax, n)
    if not all(t.is_cuda for t in (ray_d, *(x for _, x, _ in extra))):
        raise ValueError("the binning kernel takes CUDA tensors")
    for name, t, dtype in (("ray_d", ray_d, torch.float32), *extra):
        if not t.is_contiguous() or t.dtype != dtype:
            raise ValueError(f"{name} must be contiguous {dtype}")
    if ray_d.dim() != 2 or ray_d.shape[1] != 3:
        raise ValueError(f"ray_d must be [N, 3], got {tuple(ray_d.shape)}")
    ws = bin_cuda(ray_d, tmax, NO_OUT)
    counts = ws[DIR_CLASSES * n:DIR_CLASSES * n + DIR_CLASSES]
    timing.host_sync()
    queue = torch.cat([ws[k * n:k * n + c] for k, c in enumerate(counts.tolist())])
    return queue, counts


def intersect_bvh_cuda(leaf_tris, leaf_map, bvh_packed, ray_o, ray_d, tmax=None):
    """The binning kernel, then the closest-hit kernel (``bvh_closest_hit``
    in csrc/bvh.cu); same contract as :func:`intersect_bvh_plain`."""
    n, dev = ray_o.shape[0], ray_o.device
    _check_walk_inputs(leaf_tris, bvh_packed, ray_o, ray_d, ("leaf_map", leaf_map, torch.int32),
                       *_check_range(tmax, n))
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    bary = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n:
        ws = bin_cuda(ray_d, tmax, MISS_OUT, (prim, dist, bary))
        _walk_launch("bvh_closest_hit", "closest_hit", leaf_tris, bvh_packed, ray_o, ray_d,
                     tmax, leaf_map, prim, dist, bary, ws)
    return prim, dist, bary


def occlusion_bvh_cuda(leaf_tris, bvh_packed, ray_o, ray_d, tmax):
    """The binning kernel, then the shadow kernel (``bvh_occlusion`` in
    csrc/bvh.cu); same contract as :func:`occlusion_bvh_plain`."""
    n = ray_o.shape[0]
    if tmax is None:
        raise ValueError("the shadow walk takes a range")
    _check_walk_inputs(leaf_tris, bvh_packed, ray_o, ray_d, *_check_range(tmax, n))
    occ = torch.empty((n,), dtype=torch.int32, device=ray_o.device)
    if n:
        ws = bin_cuda(ray_d, tmax, UNBLOCKED_OUT, (occ, None, None))
        _walk_launch("bvh_occlusion", "occlusion", leaf_tris, bvh_packed, ray_o, ray_d,
                     tmax, occ, ws)
    return occ.bool()


def intersect_bvh_heatmap_cuda(leaf_tris, bvh_packed, ray_o, ray_d):
    """The heatmap kernel (``bvh_heatmap`` in csrc/bvh.cu); same contract
    as :func:`intersect_bvh_heatmap_plain`."""
    _check_walk_inputs(leaf_tris, bvh_packed, ray_o, ray_d)
    n = ray_o.shape[0]
    steps = torch.empty((n,), dtype=torch.int32, device=ray_o.device)
    if n:
        _walk_launch("bvh_heatmap", "heatmap", leaf_tris, bvh_packed, ray_o, ray_d, steps)
    return steps


# ---------------------------------------------------------------------------
# MTBVH walk: entry points (the kernel for CUDA tensors, the plain version
# for CPU tensors)
# ---------------------------------------------------------------------------


def intersect_bvh(leaf_tris, leaf_map, bvh_packed, ray_o, ray_d, tmax=None,
                  plain: bool = False):
    """Closest hit of rays ``ray_o``/``ray_d`` f32 [N, 3] by the MTBVH
    walk: (prim i32 [N], dist f32 [N], bary f32 [N, 2]); ``tmax`` f32 [N]
    (optional) each lane's range, ``-FLT_MAX`` for a dead lane, which
    misses without a walk.  ``plain`` takes the plain version on any
    device."""
    ray_o, ray_d = ray_o.contiguous(), ray_d.contiguous()
    if tmax is not None:
        tmax = tmax.contiguous()
    if ray_o.is_cuda and not plain:
        return intersect_bvh_cuda(leaf_tris, leaf_map, bvh_packed, ray_o, ray_d, tmax)
    return intersect_bvh_plain(leaf_tris, leaf_map, bvh_packed, ray_o, ray_d, tmax)


def occlusion_bvh(leaf_tris, bvh_packed, x, y, plain: bool = False):
    """True where segment x -> y is blocked (bool [N]): the origin inset by
    1e-5 along the segment, the range ending 1e-4 short of y
    (``occlusion_bvh``, :func:`segment_rays`).  A zero-length segment has a
    zero direction and a negative range: never blocked, and not walked."""
    ray_o, ray_d, tmax = (t.contiguous() for t in segment_rays(x, y))
    if ray_o.is_cuda and not plain:
        return occlusion_bvh_cuda(leaf_tris, bvh_packed, ray_o, ray_d, tmax)
    return occlusion_bvh_plain(leaf_tris, bvh_packed, ray_o, ray_d, tmax)


def intersect_bvh_heatmap(leaf_tris, bvh_packed, ray_o, ray_d, plain: bool = False):
    """Descended nodes per ray, i32 [N] (the BVH heatmap)."""
    ray_o, ray_d = ray_o.contiguous(), ray_d.contiguous()
    if ray_o.is_cuda and not plain:
        return intersect_bvh_heatmap_cuda(leaf_tris, bvh_packed, ray_o, ray_d)
    return intersect_bvh_heatmap_plain(leaf_tris, bvh_packed, ray_o, ray_d)
