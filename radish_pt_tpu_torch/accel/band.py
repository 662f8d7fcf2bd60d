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
one contract: the plain version on :func:`band_mask_words`' words.
``closest_hit`` / ``occlusion`` take the plain version for CPU tensors and
launch the kernel (or raise) for CUDA tensors.  Both kernels vote their
bands' words themselves from the cluster boxes and the rays
(:func:`band_words_plain` is the vote in plain torch, equal to
:func:`band_mask_words` bit for bit) and sweep the packed table with
triangles across a warp's threads and the rays one at a time, a ray
passing over the clusters its own grown box cannot reach within its best
t or its segment's range (:func:`.plucker.lane_skip_flags_plain`: no
result moves), so the card path calls :func:`band_mask_words` never.
Dead lanes (a negative ``tmax``) flag nothing, are swept by nothing and
miss, in the kernel and in ``closest_hit_plain(..., dead=...)`` alike; a
segment with a negative range (zero-length) is never blocked.
It counts ``launch.band.*`` kernel launches, ``plain.band.*`` plain-version
calls and ``prepass.band.band_mask_words`` (utils/timing.py).

Not carried over from the TPU: the pass split (``_band_pass_split``), the
16-bit SMEM words, the union guard and the concatenated [G*16, 256]
coefficient scratch (VMEM artefacts), ``BAND_MAX_LANES``, and the
exhausted band's sweep of its pass's cluster 0 (:2663-2666), which can
report a hit beyond a lane's tmax that its band never flagged.
"""

from __future__ import annotations

import torch

from ..utils import timing
from . import compact as cpt
# the sweeps do the Plücker engine's arithmetic, FLOPS_PER_PAIR included
from .plucker import (FLOPS_PER_PAIR, PACKED_WIDTH, ROW, blocks,  # noqa: F401
                      dead_lanes, hit_t, lane_cluster_flags_plain,
                      lane_skip_flags_plain, mask_flags, pack_words,
                      plucker_features, sweep_any, sweep_closest)
from .traverse import FLT_MAX, NULL_PRIMITIVE, segment_rays

CLUSTER_SUB = 64  # triangles per culling cluster (fixed for this engine)
WORD = 32  # clusters per mask word
WARP = 32  # lanes of a warp of the kernels
DEFAULT_G = 8  # bands per 128-lane row (BAND_TUNING, :2551)
MIN_TRIS = 1024  # at or below this the reference builds no clusters
_PREPASS_ELEMS = 1 << 25  # (lane, cluster) pairs per prepass chunk
_PLAIN_PAIRS = 1 << 24  # (lane, triangle) pairs per plain-sweep chunk




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
    timing.count("prepass.band.band_mask_words")
    lanes = ROW // check_g(g)
    n_pad = -(-ray_o.shape[0] // ROW) * ROW
    o, d, tm = cpt._pad_rays(ray_o, ray_d, tmax, n_pad)
    n_c = cluster_bounds.shape[0]
    step = max(1, _PREPASS_ELEMS // (lanes * n_c)) * lanes  # lanes per chunk
    flags = [cpt._row_flags(cluster_bounds, o[lo:lo + step], d[lo:lo + step],
                            tm[lo:lo + step], min(step, n_pad - lo) // lanes, lanes)
             for lo in range(0, n_pad, step)]
    return pack_words(torch.cat(flags))


def word_bounds(cluster_bounds):
    """f32 [ceil(C/32), 6]: per word of 32 clusters (the last ragged), the
    box (lo, hi) that encloses their boxes ``cluster_bounds`` f32 [C, 6],
    each taken as (min(lo, hi), max(lo, hi)) per axis — the slab test reads
    a box's two planes per axis alike, so that box flags what the cluster's
    does.  The closest-hit kernel's first level of its vote; built once per
    scene."""
    pad = -cluster_bounds.shape[0] % WORD
    lo = torch.minimum(cluster_bounds[:, :3], cluster_bounds[:, 3:])
    hi = torch.maximum(cluster_bounds[:, :3], cluster_bounds[:, 3:])
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=FLT_MAX)
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-FLT_MAX)
    return torch.cat([lo.view(-1, WORD, 3).amin(1), hi.view(-1, WORD, 3).amax(1)],
                     1).contiguous()


def _padded_rows(ray_o, ray_d, tmax):
    """Rays padded to whole 128-lane rows as :func:`band_mask_words` pads
    them (padding lanes flag nothing), and the count of real lanes."""
    n_pad = -(-ray_o.shape[0] // ROW) * ROW
    return (*cpt._pad_rays(ray_o, ray_d, tmax, n_pad), ray_o.shape[0])


def band_words_plain(cluster_bounds, words_box, ray_o, ray_d, tmax, g: int):
    """The kernels' vote in plain torch: int32 band words as
    :func:`band_mask_words` returns them.  Per warp of :data:`WARP` lanes,
    each lane's slab test of each word's box ``words_box`` (:func:`word_bounds`);
    the word's 32 cluster boxes are tested only where some lane of the warp
    passes it; a band's flags are the OR of its lanes'.  Equal to
    :func:`band_mask_words` bit for bit: a lane that passes a cluster's box
    passes its word's box (the slab test is monotone under box containment
    in f32)."""
    lanes = ROW // check_g(g)
    o, d, tm, _ = _padded_rows(ray_o, ray_d, tmax)
    n_c = cluster_bounds.shape[0]
    passes = lane_cluster_flags_plain(words_box, o, d, tm)  # [lanes, W]
    warp_passes = passes.view(-1, WARP, passes.shape[1]).any(1).repeat_interleave(WARP, 0)
    own = lane_cluster_flags_plain(cluster_bounds, o, d, tm)
    own &= warp_passes[:, torch.arange(n_c, device=o.device) // WORD]
    return pack_words(own.view(-1, lanes, n_c).any(1))


def pair_counts(cluster_bounds, ray_o, ray_d, tmax, g: int, num_tris: int, dist=None,
                chunk_rows: int = 256) -> dict:
    """(lane, triangle) pairs a sweep of these rays (or segments, ``tmax``
    their range) visits when a cluster is swept by every lane of a group
    that flags it: per band of 128/g lanes (``band``: the engine's
    contract), per warp of :data:`WARP` lanes (``warp``: what a lane of a
    sweep with rays across the threads idles through) and per lane
    (``lane``: each lane's own flagged clusters, which hold its winner or
    its blocker); with ``dist`` f32 [N] (each lane's final t, or a
    segment's range) also ``lane_cut``: each lane's own flagged clusters
    that its grown box test admits at that reach
    (:func:`.plucker.lane_skip_flags_plain`; what a walk that knew each
    lane's answer sweeps for it).  Padding lanes flag nothing and are not
    counted; a lane with a negative ``tmax`` (dead, or a zero-length
    segment) is settled before any sweep and counts no pair of its own.  A
    measurement helper: floats, one host sync per chunk of rows."""
    n_c, dev = cluster_bounds.shape[0], ray_o.device
    tris = torch.clamp(num_tris - torch.arange(n_c, device=dev) * CLUSTER_SUB, 0,
                       CLUSTER_SUB).double()
    out = dict.fromkeys(("band", "warp", "lane") + (() if dist is None else ("lane_cut",)),
                        0.0)
    step = chunk_rows * ROW
    for lo in range(0, ray_o.shape[0], step):
        hi = min(ray_o.shape[0], lo + step)
        o, d, tm, n = _padded_rows(ray_o[lo:hi], ray_d[lo:hi],
                                   None if tmax is None else tmax[lo:hi])
        own = lane_cluster_flags_plain(cluster_bounds, o, d, tm)
        real = (torch.arange(o.shape[0], device=dev) < n).double()
        settles = (real > 0) & (tm >= 0)  # the lanes a sweep must settle
        groups = (("band", ROW // g), ("warp", WARP), ("lane", 1))
        if dist is not None:
            reach = torch.nn.functional.pad(dist[lo:hi], (0, o.shape[0] - n))
            cut = own & lane_skip_flags_plain(cluster_bounds, o, d, reach)
            groups += (("lane_cut", 1),)
        for name, size in groups:
            grp = (cut if name == "lane_cut" else own).view(-1, size, n_c).any(1)
            lanes = settles.double() if size == 1 else real.view(-1, size).sum(1)
            out[name] += float((grp.double() @ tris) @ lanes)
    return out


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def closest_hit_plain(coeffs, feats, mask, g, dead=None):
    """Plain torch banded closest hit.  ``coeffs`` f32 [T, 4, 10] (T whole
    64-triangle clusters), ``feats`` f32 [N, 10], ``mask`` int32 band words
    of :func:`band_mask_words`, ``g`` bands per row.  Returns (prim i32 [N],
    dist f32 [N]): the exact minimum t over the triangles of the clusters
    the lane's band flags, ties to the lower id; misses are (-1, FLT_MAX),
    and so are the lanes of ``dead`` (bool [N], :func:`.plucker.dead_lanes`;
    None: a dead lane gets what its band's clusters give, as in the
    reference)."""
    timing.count("plain.band.closest_hit")
    flags = mask_flags(mask, CLUSTER_SUB, coeffs.shape[0])
    prim, dist = sweep_closest(coeffs, feats, flags, ROW // g, CLUSTER_SUB, hit_t,
                               _PLAIN_PAIRS)
    if dead is not None:
        prim = torch.where(dead, NULL_PRIMITIVE, prim)
        dist = torch.where(dead, FLT_MAX, dist)
    return prim, dist


def occlusion_plain(coeffs, feats, tm, mask, g):
    """Plain torch banded any-hit: True where a triangle of a cluster the
    lane's band flags blocks the segment of range ``tm`` f32 [N].  Other
    arguments as :func:`closest_hit_plain`."""
    timing.count("plain.band.occlusion")
    flags = mask_flags(mask, CLUSTER_SUB, coeffs.shape[0])
    return sweep_any(coeffs, feats, flags, ROW // g, CLUSTER_SUB,
                     lambda c, f, lo, hi: blocks(c, f, tm[lo:hi]), _PLAIN_PAIRS)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/band.cu)
# ---------------------------------------------------------------------------


def _check_inputs(packed, feats, cluster_bounds, words_box, ray_o, ray_d, tmax, g):
    """Raise on what the kernels do not take: the packed table ``packed``
    f32 [T, 20] of whole 64-triangle clusters, one box of ``cluster_bounds``
    [C, 6] each, the word boxes ``words_box`` [ceil(C/32), 6], and per lane
    ``feats`` [N, 10], ``ray_o``, ``ray_d`` [N, 3], ``tmax`` [N] (None: no
    range), all contiguous float32 on the card."""
    check_g(g)
    n, num_tris = feats.shape[0], packed.shape[0]
    n_c = cluster_bounds.shape[0] if cluster_bounds is not None else -1
    lane_inputs = [("feats", feats, (n, 10)), ("ray_o", ray_o, (n, 3)),
                   ("ray_d", ray_d, (n, 3)), ("cluster_bounds", cluster_bounds, (n_c, 6)),
                   ("words_box", words_box, (-(-n_c // WORD), 6))]
    if tmax is not None:
        lane_inputs.append(("tmax", tmax, (n,)))
    for name, t, shape in lane_inputs:
        if not (t is not None and t.is_cuda and t.dtype == torch.float32
                and t.shape == shape and t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {list(shape)} on the card")
    if not (packed.is_cuda and packed.dtype == torch.float32 and packed.dim() == 2
            and packed.shape[1] == PACKED_WIDTH and packed.is_contiguous()
            and packed.data_ptr() % 16 == 0):
        raise ValueError(f"the packed table must be 16-byte aligned contiguous float32 "
                         f"[T, {PACKED_WIDTH}] on the card, got {tuple(packed.shape)}")
    if num_tris % CLUSTER_SUB or num_tris // CLUSTER_SUB != n_c:
        raise ValueError(f"the packed table must be {n_c} whole clusters of "
                         f"{CLUSTER_SUB} triangles, one per box")


def _launch(fn: str, *args):
    """C entry point ``fn`` of csrc/band.cu on the current stream: tensors
    go as their data pointers (None as null), ints as they are; raises if
    the launch is refused."""
    import ctypes

    from ._build import load_library

    lib = load_library("band")
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    stream = torch.cuda.current_stream(dev).cuda_stream
    conv = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else ctypes.c_void_p(None) if a is None else a for a in args]
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*conv, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")


def closest_hit_cuda(packed, feats, cluster_bounds, words_box, ray_o, ray_d, tmax, g):
    """The banded closest-hit kernel (``band_closest_hit`` in csrc/band.cu)
    on the scene's packed table ``packed`` f32 [T, 20]: each band votes its
    words from ``cluster_bounds`` f32 [C, 6], ``words_box`` f32
    [ceil(C/32), 6] (:func:`word_bounds`) and its rays ``ray_o``, ``ray_d``
    f32 [N, 3], ``tmax`` f32 [N] (None: FLT_MAX), and each lane sweeps its
    band's clusters.  Same results as :func:`closest_hit_plain` on
    :func:`band_mask_words` with ``dead=dead_lanes(tmax)``."""
    _check_inputs(packed, feats, cluster_bounds, words_box, ray_o, ray_d, tmax, g)
    n = feats.shape[0]
    prim = torch.empty((n,), dtype=torch.int32, device=feats.device)
    dist = torch.empty((n,), dtype=torch.float32, device=feats.device)
    if n == 0:
        return prim, dist
    _launch("band_closest_hit", packed, packed.shape[0], cluster_bounds, words_box,
            cluster_bounds.shape[0], ray_o, ray_d, tmax, feats, n, g, prim, dist)
    timing.count("launch.band.closest_hit")
    return prim, dist


def occlusion_cuda(packed, feats, cluster_bounds, words_box, ray_o, ray_d, tm, g):
    """The banded shadow kernel (``band_occlusion`` in csrc/band.cu):
    arguments as :func:`closest_hit_cuda`, with the segments' range ``tm``
    f32 [N] bounding both the vote and the hits.  Same results as
    :func:`occlusion_plain` on ``band_mask_words(cluster_bounds, ray_o,
    ray_d, tm, g)``."""
    if tm is None:
        raise ValueError("the band shadow kernel needs the segments' range tm")
    _check_inputs(packed, feats, cluster_bounds, words_box, ray_o, ray_d, tm, g)
    n = feats.shape[0]
    occ = torch.empty((n,), dtype=torch.int32, device=feats.device)
    if n == 0:
        return occ.bool()
    _launch("band_occlusion", packed, packed.shape[0], cluster_bounds, words_box,
            cluster_bounds.shape[0], ray_o, ray_d, tm, feats, n, g, occ)
    timing.count("launch.band.occlusion")
    return occ.bool()


def closest_hit(coeffs, feats, cluster_bounds, ray_o, ray_d, tmax, g, packed=None,
                words_box=None):
    """Banded closest hit: the kernel for CUDA tensors (on the scene's
    ``packed`` table and word boxes ``words_box``, which it then needs),
    the plain version on :func:`band_mask_words` for CPU tensors; dead
    lanes miss."""
    if feats.is_cuda:
        if packed is None or words_box is None:
            raise ValueError("the CUDA band closest hit needs the scene's packed table "
                             "and word boxes")
        return closest_hit_cuda(packed, feats, cluster_bounds, words_box,
                                ray_o.contiguous(), ray_d.contiguous(), tmax, g)
    mask = band_mask_words(cluster_bounds, ray_o, ray_d, tmax, g)
    return closest_hit_plain(coeffs, feats, mask, g, dead=dead_lanes(tmax))


def occlusion(coeffs, feats, cluster_bounds, ray_o, ray_d, tm, g, packed=None,
              words_box=None):
    """Banded shadow sweep of the segments (``ray_o``, ``ray_d``, range
    ``tm``): the kernel for CUDA tensors (on the scene's ``packed`` table
    and word boxes ``words_box``, which it then needs), the plain version
    on :func:`band_mask_words` for CPU tensors."""
    if feats.is_cuda:
        if packed is None or words_box is None:
            raise ValueError("the CUDA band shadow sweep needs the scene's packed table "
                             "and word boxes")
        return occlusion_cuda(packed, feats, cluster_bounds, words_box, ray_o.contiguous(),
                              ray_d.contiguous(), tm, g)
    mask = band_mask_words(cluster_bounds, ray_o, ray_d, tm, g)
    return occlusion_plain(coeffs, feats, tm, mask, g)


# ---------------------------------------------------------------------------
# scene-level entry points
# ---------------------------------------------------------------------------


def _require_clusters(cluster_bounds):
    if cluster_bounds is None:
        raise ValueError("the band engine needs 64-triangle culling clusters "
                         f"(scenes above {MIN_TRIS} triangles)")


def intersect_band(coeffs, center, cluster_bounds, g, ray_o, ray_d, tmax=None,
                   plain: bool = False, packed=None, words_box=None):
    """Closest hit through the band engine: (prim i32 [N] positional ids,
    selector-grade dist f32 [N]).  ``tmax`` (f32 [N]) bounds only the
    culling (-FLT_MAX marks a dead lane, which flags nothing and misses).
    ``plain`` selects the plain versions on any device; ``packed`` and
    ``words_box`` are the scene's packed table and word boxes, which the
    kernel reads."""
    _require_clusters(cluster_bounds)
    feats = plucker_features(ray_o, ray_d, center)
    if plain:
        mask = band_mask_words(cluster_bounds, ray_o, ray_d, tmax, g)
        return closest_hit_plain(coeffs, feats, mask, g, dead=dead_lanes(tmax))
    return closest_hit(coeffs, feats, cluster_bounds, ray_o, ray_d, tmax, g, packed,
                       words_box)


def occlusion_band(coeffs, center, cluster_bounds, g, x, y, plain: bool = False,
                   packed=None, words_box=None):
    """True where segment x -> y is blocked (bool [N]), the segment inset
    as :func:`.traverse.segment_rays` does.  A zero-length segment (y == x)
    has a negative range and d = 0: never blocked.  ``plain`` selects the
    plain version on any device; ``packed`` and ``words_box`` are the
    scene's packed table and word boxes, which the kernel reads."""
    _require_clusters(cluster_bounds)
    ray_o, ray_d, tm = segment_rays(x, y)
    feats = plucker_features(ray_o, ray_d, center)
    tm = tm.contiguous()
    if plain:
        mask = band_mask_words(cluster_bounds, ray_o, ray_d, tm, g)
        return occlusion_plain(coeffs, feats, tm, mask, g)
    return occlusion(coeffs, feats, cluster_bounds, ray_o, ray_d, tm, g, packed, words_box)
