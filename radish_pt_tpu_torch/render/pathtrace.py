"""Wavefront path tracer with MIS next-event estimation.

Port of ``radish_pt_tpu/render/pathtrace.py`` (reference
``singleKernelPT``, pathtrace.cu:149-291): the per-thread bounce loop is a
lockstep wavefront over all pixels, each bounce running NEE, BSDF sampling
and the extension ray on [N]-shaped tensors.  Two bounce loops, as in the
reference:

* the dense loop (reference :216-313): every lane goes through every
  bounce, dead lanes masked out; its extension rays go through
  ``intersect_sorted_ids`` and its shadow rays through
  ``test_occlusion_sorted`` (signature-sorted sweeps);
* the sliced loop (:func:`_sliced_bounce_loop`, reference :533-836),
  where the scene has clusters, at least 2,000 triangles and the trace at
  least one bounce: after bounce 1, each bounce sorts the pending
  extension rays once on (dead bit | cluster signature), which packs the
  live lanes into a prefix in signature order, and advances only that
  prefix, rounded up to whole slices of ``S = ceil(N / n_slices)`` lanes
  (a multiple of 128), as one pass.  The live count is read on the host
  once a bounce (the reference's ``while_loop`` trip count), so the loop
  cannot be captured in a CUDA graph.

Both loops give every lane the same bits: a lane's math is the same in
both, the shared sampler pointer advances 7 draws a bounce in both, each
lane's scramble rides the sorts, and the sliced loop carries the previous
vertex (``prev_pos``) instead of rebuilding it from the ray.  The sweeps
cull per group of lanes, and a ray that grazes a cluster's box gets what
its group's flags allow: so both loops sweep the live lanes in the same
order, (key, lane id), from the front of the wavefront, and a dead or
masked lane flags no cluster (``scene/device_scene.py::intersect_sorted_ids``,
``test_occlusion_sorted``).  After every closest hit one call of
:func:`.surface.surface` (the kernel of csrc/surface.cu on the card,
:func:`surface_plain` on the CPU) recovers the surface, fetches the
material and does the hit's accounting.
``path_trace(..., n_slices=0)`` runs the dense loop; a batched block that
is captured as a CUDA graph does (render/renderer.py).

On the sweep engines (Plücker, compact, quad, band) the lanes start in
tile order (each 128-lane culling row an 8x16 pixel tile) and go back to
raster order at the end; the sliced loop's lane ids index the tile-order
lanes, and its accumulators go back to them before that.

The looper and the accumulation's iteration may be 0-d tensors on the
scene's device, and a frame of the dense loop then reads nothing from the
host: a block of frames can be captured as one CUDA graph
(render/graph.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..accel import sort_key as sk
from ..bsdf import materials as bsdf
from ..sampling import rng
from ..sampling.alias import alias_sample
from ..scene import camera as cam_mod
from ..scene import device_scene as dsc
from ..scene import engines
from ..utils import math as m
from ..utils import timing
from . import surface as sf
from . import vertex as vx

NULL_PRIMITIVE = -1
TILE_W, TILE_H = 16, 8  # 128 lanes = one 8x16 pixel tile


@functools.lru_cache(maxsize=8)
def _tile_perm(w: int, h: int, device) -> torch.Tensor:
    """Tile-order lane permutation, on ``device``: 128 consecutive lanes
    cover an 8x16 pixel tile instead of a 128-pixel scanline strip."""
    perm = (np.arange(w * h, dtype=np.int32)
            .reshape(h // TILE_H, TILE_H, w // TILE_W, TILE_W)
            .transpose(0, 2, 1, 3).reshape(-1))
    return torch.from_numpy(np.ascontiguousarray(perm)).to(device)


def _untile(x, w: int, h: int):
    """[N, ...] tile-order lanes -> pixel (raster) order, as a transpose."""
    tail = x.shape[1:]
    x = x.reshape(h // TILE_H, w // TILE_W, TILE_H, TILE_W, *tail)
    return x.permute(0, 2, 1, 3, *range(4, 4 + len(tail))).reshape(w * h, *tail)


def _lanes(ds, cam, pixel_idx=None):
    """(pixel index per lane, untile fn | None): an explicit shard of
    global flat pixel indices (``pixel_idx``, i32 on the scene's device) in
    its own order; a full frame in tile order on the sweep engines
    (Plücker, compact, quad, band) when it divides into tiles, in raster
    order otherwise (the JAX package's ``_tiled_lanes``)."""
    dev = ds.device
    if pixel_idx is not None:
        return pixel_idx, None
    if (engines.of(ds).sweep and cam.width % TILE_W == 0
            and cam.height % TILE_H == 0):
        return (_tile_perm(cam.width, cam.height, dev),
                lambda x: _untile(x, cam.width, cam.height))
    return torch.arange(cam.width * cam.height, dtype=torch.int32, device=dev), None


def sample_aperture(ds: dsc.DeviceScene, r2):
    """A lens point in [-1,1]^2: the centre of a texel of the aperture mask,
    drawn by the alias table over its luminance (scene.cpp:171-188), or the
    uniform disk without a mask."""
    if not ds.has_aperture:
        return m.concentric_sample_disk(r2[..., 0], r2[..., 1])
    pix = alias_sample(ds.aperture_alias_prob, ds.aperture_alias_idx,
                       r2[..., 0], r2[..., 1])
    w = ds.tex_width[ds.aperture_tex]
    h = ds.tex_height[ds.aperture_tex]
    y = pix // w
    x = pix - y * w
    u = (x.to(torch.float32) + 0.5) / w.to(torch.float32)
    v = (y.to(torch.float32) + 0.5) / h.to(torch.float32)
    return torch.stack([u * 2.0 - 1.0, v * 2.0 - 1.0], dim=-1)


def _gen_primary(ds, cam, sampler, pixel_idx):
    """Primary ray generation with jitter + aperture (4 draws)."""
    x = pixel_idx % cam.width
    y = pixel_idx // cam.width
    r4, sampler = rng.sample_4d(ds.sobol, sampler)
    p_ap = sample_aperture(ds, r4[..., 2:4])
    ray_o, ray_d = cam_mod.sample_rays(cam, x, y, r4, p_aperture=p_ap)
    return ray_o, ray_d, sampler


def _light_visible_side(ds, norm, ray_d):
    """Single-sided emission test for a ray hitting a light."""
    if not ds.single_sided:
        return torch.ones(norm.shape[:-1], dtype=torch.bool, device=norm.device)
    return m.dot(norm, ray_d) < 0.0


def _mask3(cond, x):
    return torch.where(cond[..., None], x, torch.zeros_like(x))


# the sliced loop's gate (reference :202-204): scenes of at least this many
# stored triangles, with clusters
SLICED_MIN_TRIS = 2000
# slices a bounce when ``n_slices`` is None, by device type: the JAX
# package's CPU default (4); on the card 16, whose frames took the least
# device time of 4, 8 and 16 on teapot, teapot_hires, glass and env_teapot
# (chip_smoke.py phase 6; PERF.md section 6)
DEFAULT_SLICES = {"cpu": 4, "cuda": 16}
SLICE_LANES = 128  # a slice is a whole number of 128-lane rows


def path_trace(ds: dsc.DeviceScene, cam: cam_mod.Camera, looper, max_depth: int,
               pixel_idx=None, n_slices: int | None = None, stats: dict | None = None):
    """Full-MIS path trace, one sample per pixel; ``looper`` is an int or
    an integer 0-d tensor on the scene's device.

    ``pixel_idx`` (i32 [n], on the scene's device): trace only these
    global flat pixel indices, in this order (a tile of a mesh,
    parallel/sharding.py); the sampler is seeded by the pixel id, so a
    shard draws the numbers the full frame draws for its pixels.  Both
    bounce loops run on a shard; the sliced loop slices the shard's lanes.

    ``n_slices``: 0 runs the dense loop; otherwise the sliced loop runs
    where the gate puts it (clusters, ``max_depth`` >= 1, at least
    :data:`SLICED_MIN_TRIS` triangles) with that many slices a wavefront,
    :data:`DEFAULT_SLICES` for None.  ``stats`` (a dict, optional) gets the
    loop that ran (``"loop"``), and from the sliced loop the slice width
    (``"slice"``) and the live lanes of each extension wavefront, bounce 1
    first (``"live"``).

    Returns (direct [N,3], indirect [N,3]) in raster order (``pixel_idx``'s
    order for a shard) — the reference's split: ``direct`` holds
    primary-visible emission + first-vertex NEE, everything else lands in
    ``indirect`` (pathtrace.cu:203,244,269).

    Device stages (utils/timing.py): ``primary``, then a bounce's ``nee``,
    ``bsdf``, ``extend`` and ``hit``, then ``accumulate`` at the end (the
    caller's scrub and accumulation).
    """
    timing.mark("primary", ds.device)
    idx, untile = _lanes(ds, cam, pixel_idx)
    sampler = rng.make_sampler(looper, idx)

    ray_o, ray_d, sampler = _gen_primary(ds, cam, sampler, idx)
    prim, bary = dsc.intersect_primary_ids(ds, ray_o, ray_d)
    # the primary hit's emission or the env map into ``direct``; active: a
    # hit that is not a light
    hit = sf.surface(ds, prim, bary, ray_o, ray_d, sf.PRIMARY)
    direct, active, mat, norm = hit.acc, hit.active, hit.mat, hit.norm
    indirect = torch.zeros_like(direct)
    throughput = torch.ones_like(ray_d)
    if n_slices is None:
        n_slices = DEFAULT_SLICES[ds.device.type]
    sliced = (n_slices > 0 and ds.cluster_bounds is not None and max_depth >= 1
              and ds.num_triangles >= SLICED_MIN_TRIS)
    if stats is not None:
        stats["loop"] = "sliced" if sliced else "dense"
    state = (ds, sampler, active, throughput, direct, indirect, hit.pos, norm, ray_d, mat,
             max_depth)
    if sliced:
        direct, indirect = _sliced_bounce_loop(*state, n_slices, stats)
    else:
        direct, indirect = _dense_bounce_loop(*state)
    if untile is not None:  # back to pixel order (pure transpose)
        direct, indirect = untile(direct), untile(indirect)
    timing.mark("accumulate", ds.device)
    return direct, indirect


def _nee_contrib(ds, sampler, active, mat, norm, wo, pos, throughput):
    """Next-event estimation with MIS at the current vertex
    (pathtrace.cu:195-207; reference :316-342) before its shadow test, 4
    draws: (shadow segment's end [N, 3], ok [N], contrib [N, 3], sampler).
    ``ok``: the lanes whose light sample counts if the segment from ``pos``
    is clear; ``contrib`` is their MIS-weighted contribution as if it were,
    zero on the other lanes."""
    is_delta = mat.mtype == dsc.MAT_DIELECTRIC
    r4, sampler = rng.sample_4d(ds.sobol, sampler)
    li, wi, dist, light_pdf = dsc.sample_direct_light_no_vis(ds, pos, r4)
    ok = (light_pdf > 0.0) & active & ~is_delta & (m.dot(norm, wi) > 0.0)
    f = bsdf.bsdf_eval(mat, norm, wo, wi, types=ds.mat_types)
    b_pdf = bsdf.bsdf_pdf(mat, norm, wo, wi, types=ds.mat_types)
    mis_w = m.power_heuristic(light_pdf, b_pdf)
    contrib = throughput * f * li * (
        m.sat_dot(norm, wi) / torch.clamp(light_pdf, min=1e-12) * mis_w)[..., None]
    return pos + wi * dist[..., None], ok, _mask3(ok, contrib), sampler


def _bsdf_advance(ds, sampler, active, mat, norm, wo, throughput):
    """BSDF importance sample + throughput update (pathtrace.cu:210-223;
    reference :345-357), 3 draws: (sampler, active, throughput, new_dir,
    pdf, delta_sample)."""
    r3, sampler = rng.sample_3d(ds.sobol, sampler)
    samp = bsdf.bsdf_sample(mat, norm, wo, r3, types=ds.mat_types)
    bad = bsdf.is_invalid(samp.type) | (samp.pdf < 1e-8)
    active = active & ~bad
    delta_sample = bsdf.is_delta(samp.type)
    cos_term = torch.where(delta_sample, torch.ones_like(samp.pdf),
                           m.abs_dot(norm, samp.dir))
    throughput = throughput * samp.bsdf * (
        cos_term / torch.clamp(samp.pdf, min=1e-12))[..., None]
    return sampler, active, throughput, samp.dir, samp.pdf, delta_sample


def vertex_plain(ds, sampler, active, mat, norm, ray_d, pos, throughput) -> vx.Vertex:
    """One path vertex (pathtrace.cu:187-223) but its shadow test, as eager
    torch operations: the two-sided shading normal, NEE's light sample
    and unoccluded MIS contribution, the BSDF sample.  The plain version
    of csrc/vertex.cu (render/vertex.py), which gives the same
    :class:`.vertex.Vertex` bit for bit."""
    timing.count("plain.vertex.vertex")
    wo = -ray_d
    is_delta_bsdf = mat.mtype == dsc.MAT_DIELECTRIC
    # two-sided shading for non-delta materials (pathtrace.cu:190-193)
    flip = (~is_delta_bsdf) & (m.dot(norm, wo) < 0.0)
    norm = torch.where(flip[..., None], -norm, norm)
    seg_end, ok, contrib, sampler = _nee_contrib(ds, sampler, active, mat, norm, wo, pos,
                                                 throughput)
    sampler, active, throughput, new_dir, pdf, delta = _bsdf_advance(
        ds, sampler, active, mat, norm, wo, throughput)
    return vx.Vertex(seg_end=seg_end, ok=ok, contrib=contrib, sampler=sampler, active=active,
                     throughput=throughput, new_dir=new_dir, pdf=pdf, delta=delta)


def _vertex(ds, sampler, active, mat, norm, ray_d, pos, throughput, lane=None):
    """One path vertex (pathtrace.cu:187-223): :func:`.vertex.vertex`
    (the kernel on the card, :func:`vertex_plain` on the CPU), then NEE's
    shadow test on its segments (``lane``: the lanes' ids, None for lanes
    in lane order, the shadow sort's tie-break) and the contribution zeroed
    where blocked.  Returns (NEE contrib, sampler, active, throughput,
    new_dir, pdf, delta_sample).  Device stages ``nee`` (the vertex and the
    shadow test), then ``bsdf`` (the contribution's resolve)."""
    timing.mark("nee", ds.device)
    v = vx.vertex(ds, sampler, active, mat, norm, ray_d, pos, throughput)
    occ = dsc.test_occlusion_sorted(ds, pos, v.seg_end, mask=v.ok, lane=lane)
    timing.mark("bsdf", ds.device)
    contrib = torch.where(occ[..., None], 0.0, v.contrib)
    return contrib, v.sampler, v.active, v.throughput, v.new_dir, v.pdf, v.delta


def _shade_hit(ds, acc, active, throughput, prim, pos, norm, uv, mat_id, ray_d, pdf,
               delta, prev_pos):
    """The extension ray's accounting (pathtrace.cu:229-272): an escaped
    ray sees the env map, MIS-weighted against NEE's env sampler, and an
    emissive hit its radiance, MIS-weighted against NEE's light sampler
    (full weight after a delta sample), both into ``acc``.  Returns (acc,
    active, material, shading normal) at the hit.  Part of the plain
    version of csrc/surface.cu (:func:`surface_plain`)."""
    miss = active & (prim == NULL_PRIMITIVE)
    if ds.has_env:
        env_pdf = dsc.env_map_pdf(ds, ray_d)
        w_env = torch.where(delta, torch.ones_like(env_pdf),
                            m.power_heuristic(pdf, env_pdf))
        acc = acc + _mask3(miss, dsc.env_radiance(ds, ray_d) * throughput * w_env[..., None])
    active = active & ~miss

    mat, norm = dsc.get_textured_material(ds, mat_id, uv, norm)
    hit_light = active & (mat.mtype == dsc.MAT_LIGHT)
    light_vis = _light_visible_side(ds, norm, ray_d)
    light_pdf_hit = dsc.area_light_hit_pdf(ds, mat.base_color, prev_pos, pos, norm)
    w_light = torch.where(delta, torch.ones_like(light_pdf_hit),
                          m.power_heuristic(pdf, light_pdf_hit))
    acc = acc + _mask3(hit_light & light_vis,
                       mat.base_color * throughput * w_light[..., None])
    return acc, active & ~hit_light, mat, norm


def surface_plain(ds, prim, bary, ray_o, ray_d, path=None) -> sf.Surface:
    """The closest hit's surface (render/surface.py) as eager torch
    operations: the surface recovered from the winners ``prim`` (from the
    winner id, ``bary`` None, or by interpolation:
    ``dsc.surface_from_ids``), the material (``dsc.get_textured_material``)
    and, with ``path``, the hit's accounting (:func:`_shade_hit`; the
    primaries', :data:`.surface.PRIMARY`, as a bounce from every lane alive
    with throughput 1 after a delta sample and nothing accumulated).  The
    plain version of csrc/surface.cu, which gives the same
    :class:`.surface.Surface` bit for bit."""
    timing.count("plain.surface.surface")
    pos, norm, uv, mat_id = dsc.surface_from_ids(ds, prim, bary, ray_o, ray_d)
    if path is None:
        mat, norm = dsc.get_textured_material(ds, mat_id, uv, norm)
        return sf.Surface(pos=pos, norm=norm, mat=mat, mat_id=mat_id)
    if path == sf.PRIMARY:
        ones = torch.ones_like(prim, dtype=torch.bool)
        path = sf.PathState(acc=torch.zeros_like(ray_d), active=ones,
                            throughput=torch.ones_like(ray_d), pdf=torch.ones_like(ray_d[:, 0]),
                            delta=ones, prev_pos=ray_o)
    acc, active, mat, norm = _shade_hit(ds, path.acc, path.active, path.throughput, prim, pos,
                                        norm, uv, mat_id, ray_d, path.pdf, path.delta,
                                        path.prev_pos)
    return sf.Surface(pos=pos, norm=norm, mat=mat, mat_id=mat_id, acc=acc, active=active)


def _dense_bounce_loop(ds, sampler, active, throughput, direct, indirect, pos, norm,
                       ray_d, mat, max_depth):
    """Every lane through every bounce (reference :216-313), the extension
    and shadow rays through the signature-sorted sweeps."""
    for depth in range(1, max_depth + 1):
        contrib, sampler, active, throughput, new_dir, pdf, delta = _vertex(
            ds, sampler, active, mat, norm, ray_d, pos, throughput)
        # first-vertex NEE -> direct, the rest -> indirect (pathtrace.cu:203)
        if depth == 1:
            direct = direct + contrib
        else:
            indirect = indirect + contrib
        # ---- extend ray (pathtrace.cu:225-228) ----
        timing.mark("extend", ds.device)
        ray_o = pos + new_dir * 1e-5
        prim, bary = dsc.intersect_sorted_ids(ds, ray_o, new_dir, active=active)
        timing.mark("hit", ds.device)
        hit = sf.surface(ds, prim, bary, ray_o, new_dir,
                         sf.PathState(acc=indirect, active=active, throughput=throughput,
                                      pdf=pdf, delta=delta, prev_pos=pos))
        indirect, active, mat, norm = hit.acc, hit.active, hit.mat, hit.norm
        pos, ray_d = hit.pos, new_dir
    return direct, indirect


# the sliced loop's per-lane carry: f32 columns [N, 16] and int64 [N, 2]
_THR, _ACC, _ORG, _DIR, _PREV, _PDF = (slice(0, 3), slice(3, 6), slice(6, 9),
                                        slice(9, 12), slice(12, 15), 15)
_LANE, _SCRAMBLE = 0, 1  # lane << 1 | delta sample; the sampler's scramble


def _slice_width(n: int, n_slices: int) -> int:
    """ceil(n / n_slices) lanes, rounded up to whole 128-lane rows."""
    s = -(-n // n_slices)
    return -(-s // SLICE_LANES) * SLICE_LANES


def _carry(throughput, acc, ray_o, ray_d, prev_pos, pdf, lane_delta, scramble):
    """The sliced loop's carry: (f32 [N, 16], int64 [N, 2])."""
    return (torch.cat([throughput, acc, ray_o, ray_d, prev_pos, pdf[:, None]], dim=1),
            torch.stack([lane_delta, scramble], dim=1))


def _advance(ds, ptr, key, fcol, icol, with_vertex: bool):
    """One bounce of the sliced loop on a prefix of sorted lanes (reference
    ``advance`` :626-718): the extension sweep of the rays the last vertex
    sampled, its accounting, then (``with_vertex``) NEE and the BSDF
    sample at the hit and the next rays' sort key.  Returns the new acc
    alone (the tail bounce), else (key, f32 carry, int carry, sampler
    pointer)."""
    act = key < sk.DEAD_KEY_BIT
    thr, acc, pdf, prev = fcol[:, _THR], fcol[:, _ACC], fcol[:, _PDF], fcol[:, _PREV]
    o, d = fcol[:, _ORG].contiguous(), fcol[:, _DIR].contiguous()
    delta = (icol[:, _LANE] & 1) == 1
    prim, bary = dsc.intersect_ids(ds, o, d, act)
    timing.mark("hit", ds.device)
    hit = sf.surface(ds, prim, bary, o, d, sf.PathState(acc=acc, active=act, throughput=thr,
                                                         pdf=pdf, delta=delta, prev_pos=prev))
    acc, act, mat, norm, pos = hit.acc, hit.active, hit.mat, hit.norm, hit.pos
    if not with_vertex:
        return acc
    smp = rng.SamplerState(scramble=icol[:, _SCRAMBLE], ptr=ptr)
    contrib, smp, act, thr, new_dir, pdf, delta = _vertex(ds, smp, act, mat, norm, d, pos,
                                                          thr, icol[:, _LANE] >> 1)
    ray_o = pos + new_dir * 1e-5
    key = dsc._sort_key(ds, ray_o, new_dir, active=act)
    lane_delta = ((icol[:, _LANE] >> 1) << 1) | delta.to(torch.int64)
    return (key, *_carry(thr, acc + contrib, ray_o, new_dir, pos, pdf, lane_delta,
                         smp.scramble), smp.ptr)


def _sliced_bounce_loop(ds, sampler, active, throughput, direct, indirect, pos, norm,
                        ray_d, mat, max_depth, n_slices, stats=None):
    """Wavefront compaction by one sort a bounce (reference :533-836).

    Bounce 1's vertex runs on the whole wavefront (its NEE into
    ``direct``).  Then each bounce sorts the lanes that may be live (a
    prefix of the wavefront) on their pending rays' key — (dead bit |
    cluster signature), so the live lanes come first, in signature order —
    with their carry (throughput, accumulator, ray, previous vertex, BSDF
    pdf, lane id | delta flag, scramble), ties broken by lane id as in the
    dense loop's sorted sweeps, reads the live count on the host,
    and advances the live prefix rounded up to whole slices as one pass
    (the reference's ``m`` slices of ``S`` lanes; the bits are the same):
    sweep, env-miss and emissive-hit MIS, surface, NEE, BSDF sample, next
    key.  The last bounce only sweeps and accounts.  Lanes past the prefix
    are dead and stay as they are; the lane ids stay a permutation, so one
    scatter delivers the accumulators to lane order, added to
    ``indirect`` in the dense loop's order of addition."""
    n, dev = pos.shape[0], pos.device
    width = _slice_width(n, n_slices)
    contrib, sampler, active, throughput, new_dir, pdf, delta = _vertex(
        ds, sampler, active, mat, norm, ray_d, pos, throughput)
    direct = direct + contrib
    ray_o = pos + new_dir * 1e-5
    key = dsc._sort_key(ds, ray_o, new_dir, active=active)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    fcol, icol = _carry(throughput, torch.zeros_like(throughput), ray_o, new_dir, pos, pdf,
                        (lane << 1) | delta.to(torch.int64), sampler.scramble)
    ptr, extent, live_counts = sampler.ptr, n, []
    for bounce in range(1, max_depth + 1):
        timing.mark("extend", ds.device)
        # compact and order the pending rays on (key, lane id), as the
        # dense loop's sorted sweeps order them; lanes at or past
        # ``extent`` are dead since an earlier bounce
        order = dsc.lane_order(key[:extent], icol[:extent, _LANE] >> 1)
        key_s = key[:extent].index_select(0, order)
        fcol[:extent] = fcol[:extent].index_select(0, order)
        icol[:extent] = icol[:extent].index_select(0, order)
        live = int((key_s < sk.DEAD_KEY_BIT).sum())  # the bounce's one host read
        timing.host_sync()
        live_counts.append(live)
        extent = min(n, -(-live // width) * width)
        if extent == 0:
            break
        out = _advance(ds, ptr, key_s[:extent], fcol[:extent], icol[:extent],
                       with_vertex=bounce < max_depth)
        if bounce == max_depth:
            fcol[:extent, _ACC] = out
        else:
            key, fcol[:extent], icol[:extent], ptr = out
    if stats is not None:
        stats.update(slice=width, live=live_counts)
    acc = torch.empty_like(indirect).index_copy_(0, icol[:, _LANE] >> 1, fcol[:, _ACC])
    return direct, indirect + acc


def path_trace_direct(ds: dsc.DeviceScene, cam: cam_mod.Camera, looper,
                      pixel_idx=None):
    """One-bounce direct lighting — ``PTDirectKernel`` (pathtrace.cu:293-345):
    primary-visible emission plus one NEE sample per pixel.  Returns
    direct [N, 3] in raster order (``pixel_idx`` as :func:`path_trace`).
    Device stages ``primary``, ``nee``, ``accumulate``."""
    timing.mark("primary", ds.device)
    idx, untile = _lanes(ds, cam, pixel_idx)
    sampler = rng.make_sampler(looper, idx)

    ray_o, ray_d, sampler = _gen_primary(ds, cam, sampler, idx)
    prim, bary = dsc.intersect_primary_ids(ds, ray_o, ray_d)
    hit = sf.surface(ds, prim, bary, ray_o, ray_d, sf.PRIMARY)
    direct, mat, norm = hit.acc, hit.mat, hit.norm

    wo = -ray_d
    is_delta_bsdf = mat.mtype == dsc.MAT_DIELECTRIC
    flip = (~is_delta_bsdf) & (m.dot(norm, wo) < 0.0)
    norm = torch.where(flip[..., None], -norm, norm)

    shade = hit.active & ~is_delta_bsdf
    timing.mark("nee", ds.device)
    r4, sampler = rng.sample_4d(ds.sobol, sampler)
    li, wi, light_pdf = dsc.sample_direct_light(ds, hit.pos, r4, mask=shade,
                                                shade_normal=norm)
    ok = shade & (light_pdf > 0.0)
    f = bsdf.bsdf_eval(mat, norm, wo, wi, types=ds.mat_types)
    contrib = f * li * (m.sat_dot(norm, wi)
                        / torch.clamp(light_pdf, min=1e-12))[..., None]
    direct = direct + _mask3(ok, contrib)
    if untile is not None:
        direct = untile(direct)
    timing.mark("accumulate", ds.device)
    return direct


def scrub_and_compress(img):
    """NaN/Inf guard + HDR->LDR range compression before accumulation
    (pathtrace.cu:279-286)."""
    bad = torch.any(~torch.isfinite(img), dim=-1, keepdim=True)
    img = torch.where(bad, torch.zeros_like(img), img)
    return m.hdr_to_ldr(img)


def accumulate(prev, new, iteration):
    """Running mean: (prev * iter + new) / (iter + 1) (pathtrace.cu:287-290).
    ``iteration`` is an f32 0-d tensor on ``prev``'s device, or an int."""
    it = iteration
    if not isinstance(it, torch.Tensor):  # a fill, not a copy from the host
        it = torch.full((), float(it), dtype=torch.float32, device=prev.device)
    return (prev * it + new) / (it + 1.0)
