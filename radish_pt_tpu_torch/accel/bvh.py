"""SAH BVH builder + MTBVH (6-way threaded, stackless) flattening,
with multi-triangle leaves laid out for dense TPU testing.

Numpy copy of ``radish_pt_tpu/accel/bvh.py`` (the port builds its scenes
without jax; tests pin both builders to identical output), and the entry
point of its native twin (``radish_pt_tpu_torch/native``).  Its leaf order
is the triangle storage order of every engine, and the ``"bvh"`` engine and
the heatmap walk it (:mod:`radish_pt_tpu_torch.accel.traverse`).

Host-side re-implementation of the reference builder idea
(``reference/src/bvh.cpp:12-183``: 16-bucket SAH binning + the 6-way
near-to-far threaded orders of Hachisuka's MTBVH, TDF 2015) with one crucial
TPU-specific change: **leaves hold up to ``leaf_size`` triangles** stored in
a padded, leaf-major f32[n_leaves, L*9] table.  A lockstep traversal then
does ~10x fewer gather-bound node steps, and each leaf visit is a dense
[rays, L] Möller–Trumbore batch — exactly the VPU's preferred shape.  With
``leaf_size=1`` the layout degenerates to the reference's one-prim leaves.

Layout contract (shared with :mod:`radish_pt_tpu_torch.accel.traverse`):
* ``node_*[6, B]`` arrays follow the per-direction-class near-to-far DFS
  preorder; ``miss[i]`` jumps over node i's whole subtree.
* ``node_leaf`` is -1 for interior nodes, else the leaf row index into
  ``leaf_tris``; padding slots hold degenerate triangles (never hit).
* ``leaf_map[leaf_row * L + j]`` maps a dense-test slot back to the original
  primitive id (-1 for padding).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native

NULL_PRIMITIVE = -1
NUM_BUCKETS = 16
DEFAULT_LEAF_SIZE = 16


@dataclass
class BVH:
    """Host-side BVH; all arrays numpy."""

    bounds_min: np.ndarray  # float32 [B, 3] by tree-node id
    bounds_max: np.ndarray  # float32 [B, 3]
    node_leaf: np.ndarray  # int32 [6, B]  (-1 interior, else leaf row)
    node_aabb: np.ndarray  # int32 [6, B]  tree-node id for bounds lookup
    node_miss: np.ndarray  # int32 [6, B]
    leaf_tris: np.ndarray  # float32 [n_leaves, L * 9] padded packed tris
    leaf_map: np.ndarray  # int32 [n_leaves * L] -> original prim id
    leaf_size: int
    depth: int

    @property
    def size(self) -> int:
        return int(self.bounds_min.shape[0])

    @property
    def num_leaves(self) -> int:
        return int(self.leaf_tris.shape[0])


def build_bvh(vertices: np.ndarray, leaf_size: int = DEFAULT_LEAF_SIZE) -> BVH:
    """Build the SAH BVH with <=leaf_size-triangle leaves + 6 threaded orders.

    ``vertices``: float32 [3T, 3] flat triangle soup.  The native C++
    builder (``radish_pt_tpu_torch/native``), equal to
    :func:`build_bvh_numpy` array for array; ``RADISH_NATIVE=0`` selects
    the numpy builder.
    """
    if native.enabled():
        return BVH(**native.build_bvh(vertices, leaf_size))
    return build_bvh_numpy(vertices, leaf_size)


def build_bvh_numpy(vertices: np.ndarray, leaf_size: int = DEFAULT_LEAF_SIZE) -> BVH:
    """Pure-numpy builder: the plain version the native twin equals.  Its
    SAH cost runs in float64 (``count_prefix / n_sub``), its areas in f32."""
    v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3, 3)
    num_prims = v.shape[0]
    assert num_prims > 0

    prim_min = v.min(axis=1)
    prim_max = v.max(axis=1)
    prim_center = (prim_min + prim_max) * 0.5

    order = np.arange(num_prims, dtype=np.int32)

    # -------- pass 1: binary tree with explicit child links --------
    n_bmin: list = []
    n_bmax: list = []
    n_left: list = []  # -1 for leaf
    n_right: list = []
    n_leafrow: list = []  # leaf row or -1
    leaf_prims: list = []  # per leaf: original prim ids (np arrays)

    stack = [(0, num_prims - 1, -1, False)]  # (start, end, parent, is_right)
    depth = 0
    # iterative construction; children patched into parents after creation
    while stack:
        depth = max(depth, len(stack))
        start, end, parent, is_right = stack.pop()
        my = len(n_bmin)
        if parent >= 0:
            (n_right if is_right else n_left)[parent] = my

        ids = order[start : end + 1]
        n_bmin.append(prim_min[ids].min(axis=0))
        n_bmax.append(prim_max[ids].max(axis=0))
        n_left.append(-1)
        n_right.append(-1)
        n_sub = end - start + 1

        if n_sub <= leaf_size:
            n_leafrow.append(len(leaf_prims))
            leaf_prims.append(ids.copy())
            continue
        n_leafrow.append(-1)

        centers = prim_center[ids]
        c_min = centers.min(axis=0)
        c_max = centers.max(axis=0)
        axis = int(np.argmax(c_max - c_min))
        extent = c_max[axis] - c_min[axis]

        if extent <= 0.0:
            mid = start + n_sub // 2 - 1
        else:
            t = (centers[:, axis] - c_min[axis]) / extent
            bucket = np.clip((t * NUM_BUCKETS).astype(np.int32), 0, NUM_BUCKETS - 1)
            counts = np.bincount(bucket, minlength=NUM_BUCKETS)
            b_min = np.full((NUM_BUCKETS, 3), np.inf, np.float32)
            b_max = np.full((NUM_BUCKETS, 3), -np.inf, np.float32)
            np.minimum.at(b_min, bucket, prim_min[ids])
            np.maximum.at(b_max, bucket, prim_max[ids])

            l_min = np.minimum.accumulate(b_min, axis=0)
            l_max = np.maximum.accumulate(b_max, axis=0)
            r_min = np.minimum.accumulate(b_min[::-1], axis=0)[::-1]
            r_max = np.maximum.accumulate(b_max[::-1], axis=0)[::-1]
            count_prefix = np.cumsum(counts)

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return 2.0 * (
                    d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
                )

            # SAH lerp form like the reference (bvh.cpp:103-111)
            la = area(l_min, l_max)[: NUM_BUCKETS - 1]
            ra = area(r_min, r_max)[1:]
            frac = count_prefix[: NUM_BUCKETS - 1] / n_sub
            sah = la * (1.0 - frac) + ra * frac
            valid = (count_prefix[: NUM_BUCKETS - 1] > 0) & (
                count_prefix[: NUM_BUCKETS - 1] < n_sub
            )
            sah = np.where(valid, sah, np.inf)
            div_bucket = int(np.argmin(sah))

            left_mask = bucket <= div_bucket
            n_left_count = int(left_mask.sum())
            if n_left_count == 0 or n_left_count == n_sub:
                mid = start + n_sub // 2 - 1
            else:
                order[start : end + 1] = np.concatenate(
                    [ids[left_mask], ids[~left_mask]]
                )
                mid = start + n_left_count - 1

        # push right then left so left is processed first (stable ids)
        stack.append((mid + 1, end, my, True))
        stack.append((start, mid, my, False))

    bounds_min = np.asarray(n_bmin, np.float32)
    bounds_max = np.asarray(n_bmax, np.float32)
    left = np.asarray(n_left, np.int32)
    right = np.asarray(n_right, np.int32)
    leafrow = np.asarray(n_leafrow, np.int32)
    size = bounds_min.shape[0]

    # -------- leaf-major padded triangle table --------
    n_leaves = len(leaf_prims)
    L = leaf_size
    leaf_tris = np.zeros((n_leaves, L, 9), np.float32)
    leaf_map = np.full((n_leaves * L,), NULL_PRIMITIVE, np.int32)
    for row, ids in enumerate(leaf_prims):
        tv = v[ids]
        leaf_tris[row, : len(ids), 0:3] = tv[:, 0]
        leaf_tris[row, : len(ids), 3:6] = tv[:, 1] - tv[:, 0]
        leaf_tris[row, : len(ids), 6:9] = tv[:, 2] - tv[:, 0]
        leaf_map[row * L : row * L + len(ids)] = ids

    # -------- pass 2: the 6 near-to-far threaded DFS orders --------
    center = (bounds_min + bounds_max) * 0.5
    node_leaf6 = np.empty((6, size), np.int32)
    node_aabb6 = np.empty((6, size), np.int32)
    node_miss6 = np.empty((6, size), np.int32)

    # subtree sizes via reverse topological accumulation
    sub_size = np.ones(size, np.int64)
    for i in range(size - 1, -1, -1):
        if left[i] >= 0:
            sub_size[i] = 1 + sub_size[left[i]] + sub_size[right[i]]

    for d in range(6):
        axis = d // 2
        flip = bool(d & 1)
        new_id = 0
        stack2 = [0]
        while stack2:
            orig = stack2.pop()
            node_leaf6[d, new_id] = leafrow[orig]
            node_aabb6[d, new_id] = orig
            node_miss6[d, new_id] = new_id + sub_size[orig]
            new_id += 1
            if left[orig] < 0:
                continue
            lc, rc = left[orig], right[orig]
            # reference convention (bvh.cpp:171-177): classes are picked at
            # traversal time with the NEGATED ray direction, so even classes
            # serve negative-axis rays -> larger-center child first.
            near, far = lc, rc
            if (center[lc, axis] < center[rc, axis]) != flip:
                near, far = rc, lc
            stack2.append(far)
            stack2.append(near)

    return BVH(
        bounds_min=bounds_min,
        bounds_max=bounds_max,
        node_leaf=node_leaf6,
        node_aabb=node_aabb6,
        node_miss=node_miss6,
        leaf_tris=leaf_tris.reshape(n_leaves, L * 9),
        leaf_map=leaf_map,
        leaf_size=L,
        depth=depth,
    )
