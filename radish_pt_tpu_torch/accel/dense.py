"""Dense Möller–Trumbore closest-hit and shadow sweeps: the dense engine.

Port of the reference's ``pallas_brute`` engine,
``radish_pt_tpu/accel/pallas_kernels.py``: ``intersect_brute_pallas`` (:140,
kernel ``_brute_kernel`` :37) and ``occlusion_brute_pallas`` (:193), which
reuses it.  Every ray meets every triangle of ``tri_packed`` f32 [T, 9]
(v0, e1, e2): no culling, winners with barycentrics, so surfaces are
recovered by interpolation (``surface_info``), not from t.

Each sweep has two implementations with one contract:
* ``*_cuda``: the hand-written kernels of ``csrc/dense.cu`` (one thread per
  ray, triangles staged through shared memory, every operation rounded on
  its own in :func:`.traverse._mt_core`'s order, so prim, dist and bary
  are the plain version's bits);
* ``*_plain``: the port's Möller–Trumbore oracle (:mod:`.traverse`), called
  through this module so that its calls are counted.
``closest_hit`` / ``occlusion`` take the plain version for CPU tensors and
launch the kernel (or raise) for CUDA tensors.  They count ``launch.dense.*``
kernel launches and ``plain.dense.*`` plain-version calls (utils/timing.py).  The
scene-level plain path is the ``"brute"`` engine, which computes the same
function.
"""

from __future__ import annotations

import torch

from ..utils import timing
from . import traverse as trv

# f32 operations per (ray, triangle) pair, counted from csrc/dense.cu:
# the cross products p and q (12 products, 6 differences), det, bx, by
# and e2·q (12 products, 8 sums), s = (o - v0)·sign (3 differences, 3
# products), bx + by, the reciprocal and t's product (47), the six
# comparisons of the hit test, abs and the sign (55); the winner's two
# barycentric products and the running minimum are not counted
FLOPS_PER_PAIR = {"closest_hit": 55, "occlusion": 55}




# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def closest_hit_plain(tri_packed, ray_o, ray_d):
    """Plain torch closest hit of rays ``ray_o``/``ray_d`` f32 [N, 3]
    against every triangle of ``tri_packed`` f32 [T, 9].  Returns (prim i32
    [N], dist f32 [N], bary f32 [N, 2]): the minimum t, ties to the lower
    id; a miss is (-1, FLT_MAX, (0, 0))."""
    timing.count("plain.dense.closest_hit")
    return trv.intersect_brute(tri_packed, ray_o, ray_d)


def occlusion_plain(tri_packed, ray_o, ray_d, tmax):
    """Plain torch any-hit: True where some triangle is hit at t < ``tmax``
    f32 [N] (the nearest hit is below ``tmax`` exactly when some hit is)."""
    timing.count("plain.dense.occlusion")
    prim, dist, _ = trv.intersect_brute(tri_packed, ray_o, ray_d)
    return (prim != trv.NULL_PRIMITIVE) & (dist < tmax)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/dense.cu)
# ---------------------------------------------------------------------------


def _check_inputs(tri_packed, ray_o, ray_d):
    if not (tri_packed.is_cuda and ray_o.is_cuda and ray_d.is_cuda):
        raise ValueError("the CUDA sweep takes CUDA tensors")
    for name, t in (("tri_packed", tri_packed), ("ray_o", ray_o), ("ray_d", ray_d)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tri_packed.dim() != 2 or tri_packed.shape[1] != 9:
        raise ValueError(f"tri_packed must be [T, 9], got {tuple(tri_packed.shape)}")
    if ray_o.dim() != 2 or ray_o.shape[1] != 3 or ray_d.shape != ray_o.shape:
        raise ValueError(f"rays must be [N, 3], got {tuple(ray_o.shape)} and "
                         f"{tuple(ray_d.shape)}")


def _launch_args(tri_packed, ray_o, ray_d):
    import ctypes

    from ._build import load_library

    lib = load_library("dense")
    stream = torch.cuda.current_stream(ray_o.device).cuda_stream
    args = (ctypes.c_void_p(tri_packed.data_ptr()), ctypes.c_int(tri_packed.shape[0]),
            ctypes.c_void_p(ray_o.data_ptr()), ctypes.c_void_p(ray_d.data_ptr()))
    return lib, args, ctypes.c_void_p(stream)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def closest_hit_cuda(tri_packed, ray_o, ray_d):
    """The closest-hit kernel (``dense_closest_hit`` in csrc/dense.cu); same
    contract as :func:`closest_hit_plain`."""
    _check_inputs(tri_packed, ray_o, ray_d)
    n, dev = ray_o.shape[0], ray_o.device
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    bary = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return prim, dist, bary
    import ctypes

    lib, args, stream = _launch_args(tri_packed, ray_o, ray_d)
    with torch.cuda.device(dev):
        err = lib.dense_closest_hit(
            *args, ctypes.c_int(n), ctypes.c_void_p(prim.data_ptr()),
            ctypes.c_void_p(dist.data_ptr()), ctypes.c_void_p(bary.data_ptr()), stream)
    _raise_on(err, "dense_closest_hit")
    timing.count("launch.dense.closest_hit")
    return prim, dist, bary


def occlusion_cuda(tri_packed, ray_o, ray_d, tmax):
    """The shadow kernel (``dense_occlusion`` in csrc/dense.cu); same
    contract as :func:`occlusion_plain`."""
    _check_inputs(tri_packed, ray_o, ray_d)
    n, dev = ray_o.shape[0], ray_o.device
    if not (tmax.is_cuda and tmax.dtype == torch.float32 and tmax.shape == (n,)
            and tmax.is_contiguous()):
        raise ValueError("tmax must be contiguous float32 [N] on the card")
    occ = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return occ.bool()
    import ctypes

    lib, args, stream = _launch_args(tri_packed, ray_o, ray_d)
    with torch.cuda.device(dev):
        err = lib.dense_occlusion(*args, ctypes.c_void_p(tmax.data_ptr()),
                                  ctypes.c_int(n), ctypes.c_void_p(occ.data_ptr()),
                                  stream)
    _raise_on(err, "dense_occlusion")
    timing.count("launch.dense.occlusion")
    return occ.bool()


def closest_hit(tri_packed, ray_o, ray_d):
    """Closest-hit sweep: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if ray_o.is_cuda:
        return closest_hit_cuda(tri_packed, ray_o, ray_d)
    return closest_hit_plain(tri_packed, ray_o, ray_d)


def occlusion(tri_packed, ray_o, ray_d, tmax):
    """Shadow sweep: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if ray_o.is_cuda:
        return occlusion_cuda(tri_packed, ray_o, ray_d, tmax)
    return occlusion_plain(tri_packed, ray_o, ray_d, tmax)


# ---------------------------------------------------------------------------
# scene-level entry points
# ---------------------------------------------------------------------------


def intersect_dense(tri_packed, ray_o, ray_d):
    """Closest hit of rays against every stored triangle: (prim i32 [N],
    dist f32 [N], bary f32 [N, 2])."""
    return closest_hit(tri_packed, ray_o.contiguous(), ray_d.contiguous())


def occlusion_dense(tri_packed, x, y):
    """True where segment x -> y is blocked (bool [N]): the origin inset by
    1e-5 along the segment, the range ending 1e-4 short of y
    (``occlusion_brute_pallas``).  A zero-length segment has a zero
    direction, so det = 0: never blocked."""
    ray_o, ray_d, tmax = trv.segment_rays(x, y)
    return occlusion(tri_packed, ray_o.contiguous(), ray_d.contiguous(),
                     tmax.contiguous())
