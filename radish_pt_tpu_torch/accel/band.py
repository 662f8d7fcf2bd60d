"""Banded Plücker closest-hit and shadow sweeps: the opt-in band engine.

Port of ``radish_pt_tpu/accel/pallas_kernels.py:2508-3080``:
``intersect_plucker_band`` (:2960, kernel ``_band_kernel`` :2687) and
``occlusion_plucker_band`` (:3028, kernel ``_band_occl_kernel`` :2777).

The planes are the Plücker engine's (:mod:`.plucker`: ``sweep_coeffs``
[T, 4, 10] over features [d, o x d, o, 1]); the scene is stored in fixed
64-triangle culling clusters, as for the compact engine.  What the band
engine changes is the culling granularity: each 128-lane row is cut into
``g`` bands of 128/g lanes (g a power of two, 1 to 128; the reference's
default is 8, ``BAND_TUNING`` :2551), the slab prepass flags clusters per
band (:func:`band_mask_words`, the reference's ``_band_mask_bits`` :2577
packed 32 clusters a word), and each lane sweeps exactly the clusters its
own band flags.  Winners are the exact minimum t over those triangles,
ties to the lower id; a segment is blocked when
min(v, t·det·det, tm·det² - t·det·det) >= 0 for one of them, with
:func:`.traverse.segment_rays` segments (a zero-length one has d = 0, so
det = 0: never blocked).

Each sweep has a kernel (``csrc/band.cu``) and a plain torch version with
one contract; ``closest_hit`` / ``occlusion`` take the plain version for
CPU tensors and launch the kernel (or raise) for CUDA tensors.
``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` plain-version calls.

Not carried over from the TPU: the pass split (``_band_pass_split``), the
16-bit SMEM words, the union guard and the concatenated [G*16, 256]
coefficient scratch (VMEM artefacts), ``BAND_MAX_LANES``, and the
exhausted band's sweep of its pass's cluster 0 (:2663-2666), which can
report a hit beyond a lane's tmax that its band never flagged.
"""

from __future__ import annotations

import torch

from . import compact as cpt
# the sweeps do the Plücker engine's arithmetic, FLOPS_PER_PAIR included
from .plucker import (FLOPS_PER_PAIR, ROW, blocks, hit_t,  # noqa: F401
                      mask_flags, pack_words, plucker_features, sweep_any,
                      sweep_closest)
from .traverse import segment_rays

CLUSTER_SUB = 64  # triangles per culling cluster (fixed for this engine)
DEFAULT_G = 8  # bands per 128-lane row (BAND_TUNING, :2551)
MIN_TRIS = 1024  # at or below this the reference builds no clusters
_PREPASS_ELEMS = 1 << 25  # (lane, cluster) pairs per prepass chunk
_PLAIN_PAIRS = 1 << 24  # (lane, triangle) pairs per plain-sweep chunk

LAUNCHES = {"closest_hit": 0, "occlusion": 0}
PLAIN_CALLS = {"closest_hit": 0, "occlusion": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def check_g(g: int) -> int:
    """``g`` if it is a power of two from 1 to 128, else ValueError."""
    if not (isinstance(g, int) and 1 <= g <= ROW and g & (g - 1) == 0):
        raise ValueError(f"bands per row must be a power of two from 1 to "
                         f"{ROW}, got {g!r}")
    return g


# ---------------------------------------------------------------------------
# the band-mask prepass
# ---------------------------------------------------------------------------


def band_mask_words(cluster_bounds, ray_o, ray_d, tmax, g: int):
    """Per band of 128/g lanes, the clusters any of its rays may hit before
    its tmax (the exact per-ray slab test OR-reduced over the band), packed
    32 per int32 word: int32 [ceil(N/128)·g, ceil(C/32)], band b of row r
    at row r·g + b, bit j of word w flagging cluster 32·w + j.  Rays are
    padded to whole rows as the reference pads them (``_pad_rays``: o = 0,
    d = 1, tmax = -FLT_MAX, so padding lanes flag nothing); ``tmax`` None
    means FLT_MAX.  Chunked over bands to bound the [lanes, C] temporaries."""
    lanes = ROW // check_g(g)
    n_pad = -(-ray_o.shape[0] // ROW) * ROW
    o, d, tm = cpt._pad_rays(ray_o, ray_d, tmax, n_pad)
    n_c = cluster_bounds.shape[0]
    step = max(1, _PREPASS_ELEMS // (lanes * n_c)) * lanes  # lanes per chunk
    flags = [cpt._row_flags(cluster_bounds, o[lo:lo + step], d[lo:lo + step],
                            tm[lo:lo + step], min(step, n_pad - lo) // lanes, lanes)
             for lo in range(0, n_pad, step)]
    return pack_words(torch.cat(flags))


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def closest_hit_plain(coeffs, feats, mask, g):
    """Plain torch banded closest hit.  ``coeffs`` f32 [T, 4, 10] (T whole
    64-triangle clusters), ``feats`` f32 [N, 10], ``mask`` int32 band words
    of :func:`band_mask_words`, ``g`` bands per row.  Returns (prim i32 [N],
    dist f32 [N]): the exact minimum t over the triangles of the clusters
    the lane's band flags, ties to the lower id; misses are (-1, FLT_MAX)."""
    PLAIN_CALLS["closest_hit"] += 1
    flags = mask_flags(mask, CLUSTER_SUB, coeffs.shape[0])
    return sweep_closest(coeffs, feats, flags, ROW // g, CLUSTER_SUB, hit_t,
                         _PLAIN_PAIRS)


def occlusion_plain(coeffs, feats, tm, mask, g):
    """Plain torch banded any-hit: True where a triangle of a cluster the
    lane's band flags blocks the segment of range ``tm`` f32 [N].  Other
    arguments as :func:`closest_hit_plain`."""
    PLAIN_CALLS["occlusion"] += 1
    flags = mask_flags(mask, CLUSTER_SUB, coeffs.shape[0])
    return sweep_any(coeffs, feats, flags, ROW // g, CLUSTER_SUB,
                     lambda c, f, lo, hi: blocks(c, f, tm[lo:hi]), _PLAIN_PAIRS)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/band.cu)
# ---------------------------------------------------------------------------


def _check_inputs(coeffs, feats, mask, g):
    check_g(g)
    if not (coeffs.is_cuda and feats.is_cuda and mask.is_cuda):
        raise ValueError("the CUDA band sweep takes CUDA tensors")
    if coeffs.dtype != torch.float32 or feats.dtype != torch.float32:
        raise TypeError("coeffs and feats must be float32")
    if coeffs.dim() != 3 or coeffs.shape[1:] != (4, 10):
        raise ValueError(f"coeffs must be [T, 4, 10], got {tuple(coeffs.shape)}")
    if feats.dim() != 2 or feats.shape[1] != 10:
        raise ValueError(f"feats must be [N, 10], got {tuple(feats.shape)}")
    if not (coeffs.is_contiguous() and feats.is_contiguous() and mask.is_contiguous()):
        raise ValueError("coeffs, feats and mask must be contiguous")
    bands = -(-feats.shape[0] // ROW) * g
    if mask.dtype != torch.int32 or mask.dim() != 2 or mask.shape[0] != bands:
        raise ValueError(f"mask must be int32 [ceil(N/128)·g, W] = [{bands}, W], "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    if coeffs.shape[0] % CLUSTER_SUB or mask.shape[1] * 32 < coeffs.shape[0] // CLUSTER_SUB:
        raise ValueError("coeffs rows must be whole 64-triangle clusters covered "
                         "by the mask words")


def _launch(fn: str, coeffs, feats, mask, g, extra):
    import ctypes

    from ._build import load_library

    lib = load_library("band")
    p = ctypes.c_void_p
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    with torch.cuda.device(feats.device):
        err = getattr(lib, fn)(
            p(coeffs.data_ptr()), coeffs.shape[0], p(feats.data_ptr()),
            feats.shape[0], p(mask.data_ptr()), mask.shape[1], g,
            *(p(t.data_ptr()) for t in extra), p(stream))
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")


def closest_hit_cuda(coeffs, feats, mask, g):
    """The banded closest-hit kernel (``band_closest_hit`` in
    csrc/band.cu); same contract as :func:`closest_hit_plain`."""
    _check_inputs(coeffs, feats, mask, g)
    n = feats.shape[0]
    prim = torch.empty((n,), dtype=torch.int32, device=feats.device)
    dist = torch.empty((n,), dtype=torch.float32, device=feats.device)
    if n == 0:
        return prim, dist
    _launch("band_closest_hit", coeffs, feats, mask, g, (prim, dist))
    LAUNCHES["closest_hit"] += 1
    return prim, dist


def occlusion_cuda(coeffs, feats, tm, mask, g):
    """The banded shadow kernel (``band_occlusion`` in csrc/band.cu); same
    contract as :func:`occlusion_plain`."""
    _check_inputs(coeffs, feats, mask, g)
    n = feats.shape[0]
    if not (tm.is_cuda and tm.dtype == torch.float32 and tm.shape == (n,)
            and tm.is_contiguous()):
        raise ValueError("tm must be contiguous float32 [N] on the card")
    occ = torch.empty((n,), dtype=torch.int32, device=feats.device)
    if n == 0:
        return occ.bool()
    _launch("band_occlusion", coeffs, feats, mask, g, (tm, occ))
    LAUNCHES["occlusion"] += 1
    return occ.bool()


def closest_hit(coeffs, feats, mask, g):
    """Banded closest hit: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if feats.is_cuda:
        return closest_hit_cuda(coeffs, feats, mask, g)
    return closest_hit_plain(coeffs, feats, mask, g)


def occlusion(coeffs, feats, tm, mask, g):
    """Banded shadow sweep: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if feats.is_cuda:
        return occlusion_cuda(coeffs, feats, tm, mask, g)
    return occlusion_plain(coeffs, feats, tm, mask, g)


# ---------------------------------------------------------------------------
# scene-level entry points
# ---------------------------------------------------------------------------


def _require_clusters(cluster_bounds):
    if cluster_bounds is None:
        raise ValueError("the band engine needs 64-triangle culling clusters "
                         f"(scenes above {MIN_TRIS} triangles)")


def intersect_band(coeffs, center, cluster_bounds, g, ray_o, ray_d, tmax=None,
                   plain: bool = False):
    """Closest hit through the band engine: (prim i32 [N] positional ids,
    selector-grade dist f32 [N]).  ``tmax`` (f32 [N]) bounds only the
    prepass (-FLT_MAX marks a dead lane, which flags nothing).  ``plain``
    selects the plain versions on any device."""
    _require_clusters(cluster_bounds)
    feats = plucker_features(ray_o, ray_d, center)
    mask = band_mask_words(cluster_bounds, ray_o, ray_d, tmax, g)
    sweep = closest_hit_plain if plain else closest_hit
    return sweep(coeffs, feats, mask, g)


def occlusion_band(coeffs, center, cluster_bounds, g, x, y, plain: bool = False):
    """True where segment x -> y is blocked (bool [N]), the segment inset
    as :func:`.traverse.segment_rays` does.  A zero-length segment (y == x)
    has a negative range and d = 0: never blocked."""
    _require_clusters(cluster_bounds)
    ray_o, ray_d, tm = segment_rays(x, y)
    feats = plucker_features(ray_o, ray_d, center)
    mask = band_mask_words(cluster_bounds, ray_o, ray_d, tm, g)
    sweep = occlusion_plain if plain else occlusion
    return sweep(coeffs, feats, tm.contiguous(), mask, g)
