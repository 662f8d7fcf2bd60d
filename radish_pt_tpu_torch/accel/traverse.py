"""Brute-force ray–triangle intersection: the port's oracle engine.

Port of ``pack_tris``, ``intersect_brute`` and ``occlusion_brute`` from
``radish_pt_tpu/accel/traverse.py`` (reference ``naiveIntersect`` /
``naiveTestOcclusion``, scene.h:218-260): component-wise Möller–Trumbore with
a sign-normalized determinant over all [N] x [T] pairs, chunked over rays
and triangles so memory stays bounded.  Plain torch on any device; the
Plücker sweeps (accel/plucker.py) are held against it.
"""

from __future__ import annotations

import numpy as np
import torch

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
