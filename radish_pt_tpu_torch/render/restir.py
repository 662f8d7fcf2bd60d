"""ReSTIR direct illumination: RIS + temporal + spatial reservoir reuse.

Port of ``radish_pt_tpu/render/restir.py`` (reference
``ReSTIRDirectKernel`` + ``Reservoir<T>``, restir.cu:97-233,
restir.h:10-101).  Reservoirs are image-shaped tensors; each stage —
candidate RIS, the winner's shadow test, temporal merge, spatial merge,
shading — is a function over the whole wavefront, in raster order.  The
spatial pass reads a *completed* post-temporal reservoir image, so every
neighbour is from this frame (the reference's per-block ``__syncthreads``
race, restir.cu:177-181, cannot happen).

The weighted-reservoir update uses the correct rule ``rand * weight < w``
everywhere; the reference's ``Reservoir::update`` (restir.h:21) tests the
truthiness of a float instead.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..bsdf import materials as bsdf
from ..config import ReservoirReuse
from ..sampling import rng
from ..scene import camera as cam_mod
from ..scene import device_scene as dsc
from ..utils import math as m
from ..utils import timing
from . import gbuffer as gb
from . import ris
from . import surface as sf
from .gbuffer import NULL_PRIMITIVE, GBufferFrame, GBufferOut


@dataclass
class DirectReservoir:
    """Per-pixel light-sample reservoir — ``Reservoir<LightLiSample>``
    (restir.h:90-101) as tensors."""

    li: torch.Tensor  # f32 [N, 3] candidate radiance
    wi: torch.Tensor  # f32 [N, 3] direction to the light
    dist: torch.Tensor  # f32 [N] distance to the light sample
    num: torch.Tensor  # f32 [N] effective sample count M
    weight: torch.Tensor  # f32 [N] sum of RIS weights

    def replace(self, **kw) -> "DirectReservoir":
        return dataclasses.replace(self, **kw)


def empty_reservoir(n: int, device="cuda") -> DirectReservoir:
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
    return DirectReservoir(li=z3, wi=z3, dist=z, num=z, weight=z)


def _update(res: DirectReservoir, li, wi, dist, w, rand) -> DirectReservoir:
    """WRS update (the correct rule; cf. restir.h:17-24)."""
    weight = res.weight + w
    take = rand * weight < w
    return DirectReservoir(
        li=torch.where(take[..., None], li, res.li),
        wi=torch.where(take[..., None], wi, res.wi),
        dist=torch.where(take, dist, res.dist),
        num=res.num + 1.0,
        weight=weight,
    )


def _merge(res: DirectReservoir, rhs: DirectReservoir, rand, enable) -> DirectReservoir:
    """Reservoir merge (restir.h:51-58), masked by ``enable``."""
    weight = res.weight + rhs.weight
    num = res.num + rhs.num
    take = enable & (rand * weight < rhs.weight)
    return DirectReservoir(
        li=torch.where(take[..., None], rhs.li, res.li),
        wi=torch.where(take[..., None], rhs.wi, res.wi),
        dist=torch.where(take, rhs.dist, res.dist),
        num=torch.where(enable, num, res.num),
        weight=torch.where(enable, weight, res.weight),
    )


def _pre_clamped_merge(res, rhs, rand, enable, clamp: int):
    """``preClampedMerge<M>``: clamp the history of ``rhs`` to (M - 1) x
    ours before merging (restir.h:70-78)."""
    big = (rhs.num > (clamp - 1) * res.num) & (res.num > 0) & (rhs.num > 0)
    scale = torch.where(big, (clamp - 1) * res.num / torch.clamp(rhs.num, min=1e-12),
                        torch.ones_like(res.num))
    rhs = rhs.replace(weight=rhs.weight * scale, num=rhs.num * scale)
    return _merge(res, rhs, rand, enable)


def _invalid(res: DirectReservoir):
    return ~torch.isfinite(res.weight) | (res.weight < 0.0)


def _check_validity(res: DirectReservoir) -> DirectReservoir:
    bad = _invalid(res)
    zero = torch.zeros_like(res.weight)
    return res.replace(weight=torch.where(bad, zero, res.weight),
                       num=torch.where(bad, zero, res.num))


def _p_hat(res: DirectReservoir, mat, norm, wo, types=None):
    """Target function p^ = Li * f * cos (restir.h:31-35)."""
    f = bsdf.bsdf_eval(mat, norm, wo, res.wi, types=types)
    return res.li * f * m.sat_dot(norm, res.wi)[..., None]


def _big_w(res: DirectReservoir, p_hat_vec):
    """Unbiased contribution weight W (restir.h:37-40); toScalar = length."""
    scalar = m.length(p_hat_vec)
    return res.weight / torch.clamp(scalar * res.num, min=1e-12)


def _pack(res: DirectReservoir, *extra):
    """Reservoir (+ extra columns) as one [N, 9+] tensor, so a neighbour
    fetch is one gather."""
    cols = [res.li, res.wi, res.dist[:, None], res.num[:, None],
            res.weight[:, None]]
    cols += [e if e.dim() == 2 else e[:, None] for e in extra]
    return torch.cat(cols, dim=1)


def _unpack(row) -> DirectReservoir:
    return DirectReservoir(li=row[..., 0:3], wi=row[..., 3:6], dist=row[..., 6],
                           num=row[..., 7], weight=row[..., 8])


def _mask_empty(res: DirectReservoir, valid) -> DirectReservoir:
    """Invalid lanes become an empty reservoir (the ``T()`` the reference's
    neighbour finders return)."""
    v3 = valid[..., None]
    return DirectReservoir(
        li=torch.where(v3, res.li, torch.zeros_like(res.li)),
        wi=torch.where(v3, res.wi, torch.zeros_like(res.wi)),
        dist=torch.where(valid, res.dist, torch.zeros_like(res.dist)),
        num=torch.where(valid, res.num, torch.zeros_like(res.num)),
        weight=torch.where(valid, res.weight, torch.zeros_like(res.weight)),
    )


def temporal_rows(reservoir: DirectReservoir, last: GBufferFrame):
    """The packed [n, 13] rows a temporal gather reads: last frame's
    reservoir, its decoded normal and its prim id."""
    return _pack(reservoir, gb.decoded_normal(last), last.prim_id.to(torch.float32))


def find_temporal_neighbor(reservoir: DirectReservoir, motion, cur: GBufferFrame,
                           last: GBufferFrame, pixel_offset=None) -> DirectReservoir:
    """Last frame's reservoirs gathered through the motion indices, with the
    geometric tests of findTemporalNeighbor (restir.cu:20-40) — one packed
    gather (:func:`temporal_neighbor` of :func:`temporal_rows`)."""
    return temporal_neighbor(temporal_rows(reservoir, last), motion, cur, pixel_offset)


def temporal_neighbor(rows, motion, cur: GBufferFrame, pixel_offset=None) -> DirectReservoir:
    """:func:`find_temporal_neighbor` on last frame's packed ``rows``.

    ``pixel_offset`` (a tile of a mesh holding only its own rows): the
    global flat index of the tile's first pixel, an int or an integer
    tensor of one element.  ``motion`` stays a global index; a gather that
    lands outside the tile is rejected, so a tile seam behaves as an image
    border (parallel/sharding.py).  A tile given the whole image's rows
    passes None and gathers as the full frame does."""
    n = rows.shape[0]
    local = motion if pixel_offset is None else motion - pixel_offset
    row = rows[torch.clamp(local, 0, n - 1).long()]
    ok = (motion >= 0) & (local >= 0) & (local < n)
    ok &= cur.prim_id > NULL_PRIMITIVE
    ok &= row[..., 12].to(torch.int32) == cur.prim_id
    ok &= m.abs_dot(gb.decoded_normal(cur), row[..., 9:12]) >= 0.1
    return _mask_empty(_unpack(row), ok)


def _neighbor_ok(row, px, py, p_idx, width, height, cur: GBufferFrame):
    """The geometric tests of a spatial neighbour's fetched row [N, 15]."""
    ok = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    # exact fetched-row identity: rejects clamped or wrapped rows
    ok &= row[..., 14].to(torch.int32) == p_idx
    ok &= row[..., 13].to(torch.int32) == cur.prim_id
    ok &= m.dot(row[..., 9:12], gb.decoded_normal(cur)) >= 0.1
    ok &= torch.abs(row[..., 12] - cur.depth) <= cur.depth * 0.1
    return ok


def _spatial_neighbor(packed, x, y, width: int, height: int, cur: GBufferFrame,
                      rand2, pixel_offset=0):
    """One disk-sampled spatial neighbour with geometry tests
    (findSpatialNeighborDisk, restir.cu:43-80) — one gather.  ``x``, ``y``
    are global; the gather is into the tile's rows (``pixel_offset``: the
    global index of its first pixel), and a candidate outside the tile is
    rejected."""
    p = m.concentric_sample_disk(rand2[..., 0], rand2[..., 1]) * 5.0
    px = (x.to(torch.float32) + 0.5 + p[..., 0]).to(torch.int32)
    py = (y.to(torch.float32) + 0.5 + p[..., 1]).to(torch.int32)
    p_idx = py * width + px
    local = p_idx - pixel_offset
    n_local = packed.shape[0]
    row = packed[torch.clamp(local, 0, n_local - 1).long()]
    ok = _neighbor_ok(row, px, py, p_idx, width, height, cur)
    ok &= (local >= 0) & (local < n_local)
    ok &= ~((px == x) & (py == y))
    return _mask_empty(_unpack(row), ok)


def _shared_offset(looper, k):
    """Neighbour ``k``'s disk offset (dx, dy) shared by every pixel of frame
    ``looper``: a hash of (looper, k) through the disk warp, rounded half
    to even, in f32 as the reference's traced scalars.  ``looper`` is an
    integer tensor and ``k`` an int or an integer tensor; they broadcast,
    and (dx, dy) are int32 tensors on ``looper``'s device."""
    a = (looper.to(torch.int64) * 31 + (2 * k + 1)) & m.U32
    h1 = m.utilhash(a)
    h2 = m.utilhash(h1 ^ 0x9E3779B9)
    p = m.concentric_sample_disk(m.u32_to_unit(h1), m.u32_to_unit(h2)) * 5.0
    d = torch.round(p).to(torch.int32)
    return d[..., 0], d[..., 1]


# the spatial neighbours' reach: |dx|, |dy| <= 5 (a disk of radius 5,
# rounded or truncated), so a pixel's neighbours lie within HALO * W + HALO
# flat indices of it
HALO = 5


def spatial_rows(temp: DirectReservoir, cur: GBufferFrame, idx):
    """The packed [n, 15] rows a spatial gather reads: the post-temporal
    reservoir, the decoded normal, depth, prim id and global pixel index
    (``idx``) of each lane."""
    return _pack(temp, gb.decoded_normal(cur), cur.depth, cur.prim_id.to(torch.float32),
                 idx.to(torch.float32))


def merge_spatial(temp: DirectReservoir, cur: GBufferFrame, width: int, height: int,
                  sampler, table, num_neighbors: int = 5, looper=None, pixel_idx=None,
                  halo=None):
    """Merge 5 disk neighbours of the COMPLETED post-temporal reservoir image
    (mergeSpatialNeighborDirect, restir.cu:82-95).

    With ``looper`` (the renderer's branch: an int or an integer 0-d
    tensor), each neighbour's disk offset (dx, dy) is shared by all pixels
    and turned per (frame, neighbour) by a hash; the lane at (x, y) fetches
    the row of pixel (x + dx, y + dy) from the packed rows, and a neighbour
    outside the image is rejected (on the full frame this is the gather
    ``((y + dy) mod H) * W + (x + dx) mod W`` a roll by (-dy, -dx) would
    bring).  Without it, or on a tile that is not whole rows and has no
    ``halo``, each pixel draws its own offsets (two draws a neighbour) and
    gathers.

    ``pixel_idx`` (a tile of a mesh): the tile's global flat pixel indices,
    contiguous and ascending.  Without ``halo`` the rows are the tile's
    own, and a candidate outside it is rejected by the packed global-index
    column, as a wrapped row is: a tile seam behaves as an image border.
    ``halo`` = (rows, base): the full frame's :func:`spatial_rows` from
    global pixel ``base`` on, covering the tile and :data:`HALO` rows and
    columns on either side (parallel/sharding.py gathers them from the
    tiles that hold them); the tile then takes the full frame's branch and
    neighbours, and its result equals the full frame's rows for the tile."""
    n = temp.weight.shape[0]
    dev = temp.weight.device
    lane = torch.arange(n, dtype=torch.int32, device=dev)
    idx, offset = (lane, 0) if pixel_idx is None else (pixel_idx, pixel_idx[:1])
    x = idx % width
    y = idx // width
    rows, base = (spatial_rows(temp, cur, idx), offset) if halo is None else halo
    out = empty_reservoir(n, device=dev)
    if looper is None or (halo is None and n % width != 0):
        for _ in range(num_neighbors):
            r2, sampler = rng.sample_2d(table, sampler)
            nb = _spatial_neighbor(rows, x, y, width, height, cur, r2, pixel_offset=base)
            r1, sampler = rng.sample_1d(table, sampler)
            out = _merge(out, nb, r1, ~_invalid(nb) & (nb.num > 0))
        return out, sampler

    if not isinstance(looper, torch.Tensor):  # a fill, not a copy from the host
        looper = torch.full((), int(looper), dtype=torch.int64, device=dev)
    dxs, dys = _shared_offset(looper, torch.arange(num_neighbors, device=dev))
    for k in range(num_neighbors):
        dx, dy = dxs[k], dys[k]
        px, py = x + dx, y + dy
        p_idx = py * width + px
        row = rows[torch.clamp(p_idx - base, 0, rows.shape[0] - 1).long()]
        ok = _neighbor_ok(row, px, py, p_idx, width, height, cur)
        ok = ok & ~((dx == 0) & (dy == 0))
        nb = _mask_empty(_unpack(row), ok)
        r1, sampler = rng.sample_1d(table, sampler)
        out = _merge(out, nb, r1, ~_invalid(nb) & (nb.num > 0))
    return out, sampler


@dataclass
class Lanes:
    """A wavefront's shading state between the ReSTIR stages
    (:func:`restir_candidates`, :func:`restir_temporal`,
    :func:`restir_shade`)."""

    direct: torch.Tensor  # f32 [N, 3] emission and environment so far
    mat: dsc.SurfaceMaterial  # white base colour (demodulated)
    norm: torch.Tensor  # f32 [N, 3] shading normal, facing the viewer
    wo: torch.Tensor  # f32 [N, 3]
    shade: torch.Tensor  # bool [N] a hit that is not a light
    sampler: rng.SamplerState


def ris_plain(ds: dsc.DeviceScene, pos, mat: dsc.SurfaceMaterial, norm, wo, sampler,
              reservoir_size: int):
    """Candidate RIS in eager torch operations, the plain version of
    csrc/ris.cu: each lane draws ``reservoir_size`` light samples without
    visibility from ``pos`` and keeps one in a weighted reservoir, weighed
    by p^ = Li * f * cos over the light pdf (ReSTIRDirectKernel's candidate
    loop, before the winner's shadow test at restir.cu:158).  Returns
    (reservoir, sampler after the 5 x ``reservoir_size`` draws)."""
    timing.count("plain.ris.ris")
    table = ds.sobol
    res = empty_reservoir(pos.shape[0], device=pos.device)
    for _ in range(reservoir_size):
        r4, sampler = rng.sample_4d(table, sampler)
        li, wi, dist, pdf = dsc.sample_direct_light_no_vis(ds, pos, r4)
        f = bsdf.bsdf_eval(mat, norm, wo, wi, types=ds.mat_types)
        p_hat = li * f * m.sat_dot(norm, wi)[..., None]
        w = m.length(p_hat) / torch.clamp(pdf, min=1e-12)
        w = torch.where(torch.isfinite(w) & (pdf > 0.0), w, torch.zeros_like(w))
        r1, sampler = rng.sample_1d(table, sampler)
        res = _update(res, li, wi, dist, w, r1)
    return res, sampler


def candidate_ris(ds: dsc.DeviceScene, pos, mat: dsc.SurfaceMaterial, norm, wo, sampler,
                  reservoir_size: int):
    """:func:`ris_plain` on CPU tensors; on CUDA tensors one launch of the
    kernel of csrc/ris.cu (render/ris.py), the same reservoir and sampler
    state.  ``mat`` has the white base colour the kernel shades with."""
    if not pos.is_cuda:
        return ris_plain(ds, pos, mat, norm, wo, sampler, reservoir_size)
    li, wi, dist, num, weight, scramble = ris.ris_cuda(ds, pos, mat, norm, wo, sampler,
                                                       reservoir_size)
    return (DirectReservoir(li=li, wi=wi, dist=dist, num=num, weight=weight),
            rng.SamplerState(scramble=scramble, ptr=sampler.ptr + 5 * reservoir_size))


def restir_candidates(ds: dsc.DeviceScene, cam: cam_mod.Camera, looper, idx,
                      reservoir_size: int = 32):
    """Stage 1 of a ReSTIR frame on the lanes of global pixels ``idx``: the
    primary hit, candidate RIS over ``reservoir_size`` light samples and
    the winner's shadow test.  Returns (:class:`Lanes`, reservoir).  Device
    stages (utils/timing.py) ``primary``, ``ris``, ``shadow``."""
    from .pathtrace import _gen_primary

    timing.mark("primary", ds.device)
    sampler = rng.make_sampler(looper, idx)

    ray_o, ray_d, sampler = _gen_primary(ds, cam, sampler, idx)
    prim, bary = dsc.intersect_primary_ids(ds, ray_o, ray_d)
    hit = prim != NULL_PRIMITIVE
    direct = torch.where(hit[..., None], torch.zeros_like(ray_d),
                         dsc.env_radiance(ds, ray_d))

    surf = sf.surface(ds, prim, bary, ray_o, ray_d)
    mat, norm = surf.mat, surf.norm
    # demodulate: shade with white albedo; the G-buffer's albedo
    # re-modulates at the end (restir.cu:125,200)
    mat = dataclasses.replace(mat, base_color=torch.ones_like(mat.base_color))
    is_light = hit & (mat.mtype == dsc.MAT_LIGHT)
    direct = direct + torch.where(is_light[..., None], mat.base_color,
                                  torch.zeros_like(direct))

    wo = -ray_d
    is_delta = mat.mtype == dsc.MAT_DIELECTRIC
    flip = (~is_delta) & (m.dot(norm, wo) < 0.0)
    norm = torch.where(flip[..., None], -norm, norm)
    shade = hit & ~is_light

    # ---- candidate RIS over ``reservoir_size`` light samples without
    # visibility ----
    timing.mark("ris", ds.device)
    res, sampler = candidate_ris(ds, surf.pos, mat, norm, wo, sampler, reservoir_size)

    # ---- one shadow test, on the winner (restir.cu:158-163); lanes that
    # cannot shade get zero-length segments and zero weight ----
    timing.mark("shadow", ds.device)
    vis = shade & (res.weight > 0.0)
    target = surf.pos + res.wi * res.dist[..., None]
    occluded = dsc.test_occlusion_sorted(ds, surf.pos, target, mask=vis)
    res = res.replace(weight=torch.where(vis & ~occluded, res.weight,
                                         torch.zeros_like(res.weight)))
    return Lanes(direct=direct, mat=mat, norm=norm, wo=wo, shade=shade,
                 sampler=sampler), res


def restir_temporal(lanes: Lanes, res: DirectReservoir, rows, gbuf: GBufferOut, first_frame,
                    temporal_clamp: int, table, pixel_offset=None):
    """Stage 2: temporal reuse, last frame's reservoir gathered from its
    packed ``rows`` (:func:`temporal_rows`) through the motion indices and
    merged with the history clamp.  ``first_frame`` a bool or a bool 0-d
    tensor; ``pixel_offset`` as :func:`temporal_neighbor`.  Returns
    (lanes, reservoir); ``_check_validity`` of the reservoir is what the
    next frame reuses.  The caller marks device stage ``temporal`` before
    it (utils/timing.py), and before packing ``rows`` where it packs them
    in the same block."""
    temporal = temporal_neighbor(rows, gbuf.motion, gbuf.frame, pixel_offset)
    r1, sampler = rng.sample_1d(table, lanes.sampler)
    ok = ~_invalid(temporal) & (temporal.num > 0)
    if isinstance(first_frame, torch.Tensor):
        ok = ok & ~first_frame
    elif first_frame:
        ok = torch.zeros_like(ok)
    return (dataclasses.replace(lanes, sampler=sampler),
            _pre_clamped_merge(res, temporal, r1, ok, temporal_clamp))


def restir_shade(ds: dsc.DeviceScene, cam: cam_mod.Camera, looper, lanes: Lanes,
                 res: DirectReservoir, reservoir_out: DirectReservoir, gbuf: GBufferOut,
                 spatial: bool, pixel_idx=None, halo=None):
    """Stage 3: spatial reuse on the completed post-temporal image
    ``reservoir_out`` (with ``spatial``; ``pixel_idx`` and ``halo`` as
    :func:`merge_spatial`), then shading (restir.cu:189-194).  Returns the
    direct light [N, 3], re-modulated by the G-buffer's albedo.  Device
    stages ``spatial`` (with ``spatial``), ``shade``, then ``accumulate`` at
    the end (the caller's scrub and accumulation)."""
    sampler = lanes.sampler
    if spatial:
        timing.mark("spatial", ds.device)
        nb, sampler = merge_spatial(reservoir_out, gbuf.frame, cam.width, cam.height,
                                    sampler, ds.sobol, looper=looper, pixel_idx=pixel_idx,
                                    halo=halo)
        r1, sampler = rng.sample_1d(ds.sobol, sampler)
        ok = ~_invalid(nb) & (nb.num > 0) & ~_invalid(res)
        res = _merge(res, nb, r1, ok)

    timing.mark("shade", ds.device)
    p_hat = _p_hat(res, lanes.mat, lanes.norm, lanes.wo, types=ds.mat_types)
    contrib = p_hat * _big_w(res, p_hat)[..., None]
    ok = lanes.shade & ~_invalid(res) & (res.num > 0)
    contrib = torch.where(ok[..., None], contrib, torch.zeros_like(contrib))
    bad = torch.any(~torch.isfinite(contrib), dim=-1, keepdim=True)
    direct = lanes.direct + torch.where(bad, torch.zeros_like(contrib), contrib)
    direct = direct * gbuf.albedo
    timing.mark("accumulate", ds.device)
    return direct


def restir_direct(ds: dsc.DeviceScene, cam: cam_mod.Camera, looper,
                  gbuf: GBufferOut, last_frame: GBufferFrame,
                  last_reservoir: DirectReservoir, first_frame, reuse: int,
                  reservoir_size: int = 32, temporal_clamp: int = 20, pixel_idx=None):
    """The ReSTIR DI pass (ReSTIRDirectKernel, restir.cu:97-203): the three
    stages on one wavefront.  ``looper`` is an int or an integer 0-d
    tensor, ``first_frame`` a bool or a bool 0-d tensor, on the scene's
    device.  ``pixel_idx`` (a tile of a mesh holding only its own state):
    the tile's global flat pixel indices, contiguous and ascending, on the
    scene's device; temporal and spatial reuse then treat the tile's seams
    as image borders (parallel/sharding.py).

    Returns (direct [N, 3] shaded with white albedo and re-modulated by the
    G-buffer's, reservoir_out): ``reservoir_out`` is the post-temporal,
    pre-spatial reservoir the next frame reuses (the reference's
    ``tempReservoir``, restir.cu:173,186-187)."""
    if pixel_idx is None:
        idx, pixel_offset = torch.arange(cam.width * cam.height, dtype=torch.int32,
                                         device=ds.device), None
    else:
        idx, pixel_offset = pixel_idx, pixel_idx[:1]
    lanes, res = restir_candidates(ds, cam, looper, idx, reservoir_size)
    if reuse & ReservoirReuse.TEMPORAL:
        timing.mark("temporal", ds.device)
        lanes, res = restir_temporal(lanes, res, temporal_rows(last_reservoir, last_frame),
                                     gbuf, first_frame, temporal_clamp, ds.sobol,
                                     pixel_offset)
    reservoir_out = _check_validity(res)
    direct = restir_shade(ds, cam, looper, lanes, res, reservoir_out, gbuf,
                          bool(reuse & ReservoirReuse.SPATIAL), pixel_idx)
    return direct, reservoir_out
