"""The wavefront's cluster-signature sort key.

Port of ``_sort_key`` (``radish_pt_tpu/scene/device_scene.py:547``), which
the JAX package computes in XLA (no Pallas body): the rays of a wavefront
are sorted on it before a sweep, so that the lanes of one warp want the
same clusters (``intersect_sorted``, ``test_occlusion_sorted`` and the
sliced bounce loop, ``render/pathtrace.py``).

* :func:`key_boxes`: the cluster boxes pair-reduced into super-clusters as
  the reference does (:572-585): pairs while C > 256, and once at the first
  level when C > 64; an odd count is padded with the last box.  They depend
  only on the scene, so the scene keeps them (``DeviceScene.key_bounds``).
* the key: a slab test of every ray against every super-cluster box, then
  (first box the ray can reach (8 bits) << 14) | (the second, an absolute
  id (8 bits) << 6) | (count clamped to 63); the band engine's count-major
  form is (count << 16) | (first << 8) | second.  ``tmax`` bounds the test
  (``tn < tmax``: a shadow segment's end); a lane that ``active`` marks
  dead gets :data:`DEAD_KEY_BIT` and sorts after every live lane.

Two departures from the reference, on purpose:
* the reference's Morton fallback (:624-638) is left out: the pairing
  always ends with C <= 256, so it cannot be reached;
* a missing first or second box is C + 1 clamped to 255, as in the
  reference, except that with C = 256 — where 255 is a real cluster — a
  ray that reaches no box also carries :data:`MISS_KEY_BIT`, so misses no
  longer sort among the rays that reach cluster 255 (the reference's
  sentinel aliases it).

Two implementations with one contract: :func:`signature_key_plain`, the
eager slab test on [N, C] tensors, and :func:`signature_key_cuda`, the
hand-written kernel of ``csrc/sort_key.cu`` (one launch a call, no
workspace: the boxes staged in shared memory a block, ``KEY_RAYS`` rays a
thread, every operation rounded as the plain version rounds it): their
keys are equal as integers on every lane.  The kernel takes a finite path
(``fminf`` / ``fmaxf``, no NaN rule) on a warp whose rays are all in
:func:`finite_path_lanes`, with every box finite: there no product of the
slab test is NaN, so it gives the same verdicts.  :func:`signature_key`
takes the plain version for CPU tensors and launches the kernel (or
raises) for CUDA tensors.  It counts ``launch.sort_key.signature_key`` (one a
call with N > 0) and ``plain.sort_key.signature_key`` (utils/timing.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import timing

DEAD_KEY_BIT = 1 << 24  # above every live key bit
MISS_KEY_BIT = 1 << 22  # a ray that reaches no box when C = 256
MAX_KEY_BOXES = 256  # the pairing's bound on C (and the kernel's)
PAIR_MIN = 64  # the first level pairs above this many clusters
# f32 operations per (ray, box) of the slab test, counted from
# csrc/sort_key.cu: 6 differences, 6 products, 6 min / max of the slab
# ends, 6 updates of tn and tf, max(tn, 0) and the comparison (26); a
# range adds one comparison.  A ray adds its 3 reciprocals.
OPS_PER_BOX = 26
OPS_PER_RAY = 3




def key_boxes(cluster_bounds) -> np.ndarray:
    """The super-cluster boxes the key is computed on, f32 [C', 6]: the
    cluster boxes ``cluster_bounds`` [C, 6] pair-reduced while C > 256,
    and once at the first level when C > 64 (min of the lower corners, max
    of the upper; an odd count padded with the last box)."""
    cb = np.asarray(cluster_bounds, np.float32)
    first = True
    while cb.shape[0] > 1 and (cb.shape[0] > MAX_KEY_BOXES
                               or (first and cb.shape[0] > PAIR_MIN)):
        if cb.shape[0] % 2:
            cb = np.concatenate([cb, cb[-1:]])
        pairs = cb.reshape(-1, 2, 6)
        cb = np.concatenate([pairs[:, :, 0:3].min(1), pairs[:, :, 3:6].max(1)], axis=1)
        first = False
    return cb


def miss_extra(n_c: int) -> int:
    """What a ray that reaches none of ``n_c`` boxes adds to its key."""
    return MISS_KEY_BIT if n_c >= MAX_KEY_BOXES else 0


def miss_key(n_c: int, band: bool = False) -> int:
    """The key of a live ray that reaches none of ``n_c`` boxes."""
    none = min(n_c + 1, 255)
    return ((none << 8) | none if band else (none << 14) | (none << 6)) + miss_extra(n_c)


# ---------------------------------------------------------------------------
# plain torch version
# ---------------------------------------------------------------------------


def signature_key_plain(boxes, ray_o, ray_d, tmax=None, active=None, band=False):
    """The sort key, i32 [N], of rays ``ray_o``/``ray_d`` f32 [N, 3]
    against ``boxes`` f32 [C, 6] (C <= 256): the eager [N, C] slab test.
    ``tmax``: None, a float (every lane's range) or f32 [N]; ``active``:
    None or bool [N] (False adds :data:`DEAD_KEY_BIT`); ``band``: the
    count-major form."""
    timing.count("plain.sort_key.signature_key")
    n, n_c = ray_o.shape[0], boxes.shape[0]
    inv = 1.0 / torch.where(torch.abs(ray_d) > 1e-12, ray_d, 1e-12)
    tn = torch.full((n, n_c), -3.4e38, dtype=torch.float32, device=ray_o.device)
    tf = torch.full((n, n_c), 3.4e38, dtype=torch.float32, device=ray_o.device)
    for k in range(3):
        a = (boxes[None, :, k] - ray_o[:, k, None]) * inv[:, k, None]
        b = (boxes[None, :, 3 + k] - ray_o[:, k, None]) * inv[:, k, None]
        tn = torch.maximum(tn, torch.minimum(a, b))
        tf = torch.minimum(tf, torch.maximum(a, b))
    hit = tf >= torch.clamp(tn, min=0.0)
    if tmax is not None:
        hit = hit & (tn < (tmax if not isinstance(tmax, torch.Tensor) else tmax[:, None]))
    hit8 = hit.to(torch.int8)
    count = hit8.sum(1, dtype=torch.int32)
    none = n_c + 1
    first = torch.where(count > 0, hit8.argmax(1).to(torch.int32), none)
    ids = torch.arange(n_c, dtype=torch.int32, device=ray_o.device)
    rest = (hit & (ids[None, :] != first[:, None])).to(torch.int8)
    second = torch.where(count > 1, rest.argmax(1).to(torch.int32), none)
    f8, s8 = torch.clamp(first, max=255), torch.clamp(second, max=255)
    cnt = torch.clamp(count, max=63)
    key = (cnt << 16) | (f8 << 8) | s8 if band else (f8 << 14) | (s8 << 6) | cnt
    key = key + torch.where(count == 0, miss_extra(n_c), 0).to(torch.int32)
    if active is not None:
        key = key + torch.where(active, 0, DEAD_KEY_BIT).to(torch.int32)
    return key


def finite_path_lanes(ray_o, ray_d):
    """bool [N]: the rays the kernel's finite path may take (a warp of
    them, with every box finite): a finite origin and no zero in ``inv =
    1 / (|d| > 1e-12 ? d : 1e-12)``, that is no infinite direction
    component.  ``inv`` is always finite, so for a finite box ``box - o``
    is finite or +-inf and ``(box - o) * inv`` never NaN: ``fmin`` /
    ``fmax`` there give ``minimum`` / ``maximum``'s verdicts."""
    inv = 1.0 / torch.where(torch.abs(ray_d) > 1e-12, ray_d, 1e-12)
    return torch.isfinite(ray_o).all(1) & (inv != 0).all(1)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/sort_key.cu)
# ---------------------------------------------------------------------------


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def signature_key_cuda(boxes, ray_o, ray_d, tmax=None, active=None, band=False):
    """The key kernel (``signature_key`` in csrc/sort_key.cu); same contract
    as :func:`signature_key_plain`."""
    from ._build import load_library
    from .dense import _raise_on

    n, n_c = ray_o.shape[0], boxes.shape[0]
    tensors = [("boxes", boxes, torch.float32), ("ray_o", ray_o, torch.float32),
               ("ray_d", ray_d, torch.float32)]
    if isinstance(tmax, torch.Tensor):
        tensors.append(("tmax", tmax, torch.float32))
    if active is not None:
        tensors.append(("active", active, torch.bool))
    for name, t, dtype in tensors:
        if not t.is_cuda:
            raise ValueError("the key kernel takes CUDA tensors")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")
    if boxes.dim() != 2 or boxes.shape[1] != 6 or not 1 <= n_c <= MAX_KEY_BOXES:
        raise ValueError(f"boxes must be [C, 6] with 1 <= C <= 256, got {tuple(boxes.shape)}")
    if ray_o.shape != (n, 3) or ray_d.shape != (n, 3):
        raise ValueError(f"rays must be [N, 3], got {tuple(ray_o.shape)}, {tuple(ray_d.shape)}")
    if isinstance(tmax, torch.Tensor) and tmax.shape != (n,):
        raise ValueError(f"tmax must be [N], got {tuple(tmax.shape)}")
    if active is not None and active.shape != (n,):
        raise ValueError(f"active must be [N], got {tuple(active.shape)}")
    key = torch.empty((n,), dtype=torch.int32, device=ray_o.device)
    mode = 0 if tmax is None else 2 if isinstance(tmax, torch.Tensor) else 1
    lib = load_library("sort_key")
    stream = torch.cuda.current_stream(ray_o.device).cuda_stream
    with torch.cuda.device(ray_o.device):
        err = lib.signature_key(
            _ptr(boxes), ctypes.c_int(n_c), _ptr(ray_o), _ptr(ray_d),
            _ptr(tmax if mode == 2 else None), ctypes.c_float(tmax if mode == 1 else 0.0),
            ctypes.c_int(mode), _ptr(active), ctypes.c_int(n), ctypes.c_int(int(band)),
            ctypes.c_int(miss_extra(n_c)), _ptr(key), ctypes.c_void_p(stream))
    _raise_on(err, "signature_key")
    if n:
        timing.count("launch.sort_key.signature_key")
    return key


def signature_key(boxes, ray_o, ray_d, tmax=None, active=None, band=False,
                  plain: bool = False):
    """The sort key of rays ``ray_o``/``ray_d`` (see
    :func:`signature_key_plain`): the kernel for CUDA tensors, the plain
    version for CPU tensors or with ``plain``."""
    ray_o, ray_d = ray_o.contiguous(), ray_d.contiguous()
    if ray_o.is_cuda and not plain:
        if isinstance(tmax, torch.Tensor):
            tmax = tmax.contiguous()
        if active is not None:
            active = active.contiguous()
        return signature_key_cuda(boxes, ray_o, ray_d, tmax, active, band)
    return signature_key_plain(boxes, ray_o, ray_d, tmax, active, band)
