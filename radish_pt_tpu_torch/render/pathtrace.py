"""Wavefront path tracer with MIS next-event estimation.

Port of ``radish_pt_tpu/render/pathtrace.py`` (reference
``singleKernelPT``, pathtrace.cu:149-291): the per-thread bounce loop is a
lockstep masked wavefront over all pixels — every bounce runs NEE, BSDF
sampling and the extension ray on [N]-shaped tensors with dead lanes masked
out, exactly as the reference's dense loop (pathtrace.py:216-313).

The reference also has a sliced compaction loop and a signature sort of the
rays; both only reorder independent per-lane work.  Its tests pin the
sliced loop bitwise to the dense loop on one case only (teapot at 48x48,
depth 3, tests/test_pathtrace.py), not in general; the port runs the dense
loop.  On the sweep engines (Plücker, compact, quad, band) the lanes run in
tile order (each 128-lane culling row is an 8x16 pixel tile) and go back to
raster order at the end.

The looper and the accumulation's iteration may be 0-d tensors on the
scene's device, and a frame then reads nothing from the host: a block of
frames can be captured as one CUDA graph (render/graph.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..bsdf import materials as bsdf
from ..sampling import rng
from ..sampling.alias import alias_sample
from ..scene import camera as cam_mod
from ..scene import device_scene as dsc
from ..utils import math as m

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


def _lanes(ds, cam):
    """(pixel index per lane, untile fn | None): tile order on the sweep
    engines (Plücker, compact) when the frame divides into tiles, raster
    order otherwise."""
    dev = ds.device
    if (ds.intersector in dsc.SWEEP_ENGINES and cam.width % TILE_W == 0
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


def path_trace(ds: dsc.DeviceScene, cam: cam_mod.Camera, looper, max_depth: int):
    """Full-MIS path trace, one sample per pixel; ``looper`` is an int or
    an integer 0-d tensor on the scene's device.

    Returns (direct [N,3], indirect [N,3]) in raster order — the reference's
    split: ``direct`` holds primary-visible emission + first-vertex NEE,
    everything else lands in ``indirect`` (pathtrace.cu:203,244,269).
    """
    idx, untile = _lanes(ds, cam)
    sampler = rng.make_sampler(looper, idx)

    ray_o, ray_d, sampler = _gen_primary(ds, cam, sampler, idx)
    it = dsc.intersect(ds, ray_o, ray_d)

    hit = it.prim_id != NULL_PRIMITIVE
    direct = _mask3(~hit, dsc.env_radiance(ds, ray_d))

    mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
    is_light = hit & (mat.mtype == dsc.MAT_LIGHT)
    light_vis = _light_visible_side(ds, norm, ray_d)
    direct = direct + _mask3(is_light & light_vis, mat.base_color)
    indirect = torch.zeros_like(direct)

    active = hit & ~is_light
    throughput = torch.ones_like(ray_d)
    pos = it.pos

    for depth in range(1, max_depth + 1):
        # one bounce of the reference loop (pathtrace.cu:187-272)
        wo = -ray_d
        is_delta_bsdf = mat.mtype == dsc.MAT_DIELECTRIC
        # two-sided shading for non-delta materials (pathtrace.cu:190-193)
        flip = (~is_delta_bsdf) & (m.dot(norm, wo) < 0.0)
        norm = torch.where(flip[..., None], -norm, norm)

        # ---- NEE with MIS (pathtrace.cu:195-207): 4 draws ----
        r4, sampler = rng.sample_4d(ds.sobol, sampler)
        li, wi, light_pdf = dsc.sample_direct_light(
            ds, pos, r4, mask=active & ~is_delta_bsdf, shade_normal=norm)
        nee_ok = active & (~is_delta_bsdf) & (light_pdf > 0.0)
        f = bsdf.bsdf_eval(mat, norm, wo, wi, types=ds.mat_types)
        b_pdf = bsdf.bsdf_pdf(mat, norm, wo, wi, types=ds.mat_types)
        mis_w = m.power_heuristic(light_pdf, b_pdf)
        contrib = throughput * f * li * (
            m.sat_dot(norm, wi) / torch.clamp(light_pdf, min=1e-12) * mis_w
        )[..., None]
        contrib = _mask3(nee_ok, contrib)
        # first-vertex NEE -> direct, the rest -> indirect (pathtrace.cu:203)
        if depth == 1:
            direct = direct + contrib
        else:
            indirect = indirect + contrib

        # ---- BSDF sample (pathtrace.cu:210-223): 3 draws ----
        r3, sampler = rng.sample_3d(ds.sobol, sampler)
        samp = bsdf.bsdf_sample(mat, norm, wo, r3, types=ds.mat_types)
        bad = bsdf.is_invalid(samp.type) | (samp.pdf < 1e-8)
        active = active & ~bad
        delta_sample = bsdf.is_delta(samp.type)
        cos_term = torch.where(delta_sample, torch.ones_like(samp.pdf),
                               m.abs_dot(norm, samp.dir))
        throughput = throughput * samp.bsdf * (
            cos_term / torch.clamp(samp.pdf, min=1e-12))[..., None]

        # ---- extend ray (pathtrace.cu:225-228) ----
        prev_pos = pos
        ray_d = samp.dir
        ray_o = prev_pos + ray_d * 1e-5
        it = dsc.intersect(ds, ray_o, ray_d, active=active)
        pos = it.pos

        miss = active & (it.prim_id == NULL_PRIMITIVE)
        if ds.has_env:
            # an escaped ray sees the env map, MIS-weighted against NEE's
            # env sampler (full weight after a delta sample)
            env_pdf = dsc.env_map_pdf(ds, ray_d)
            w_env = torch.where(delta_sample, torch.ones_like(env_pdf),
                                m.power_heuristic(samp.pdf, env_pdf))
            indirect = indirect + _mask3(
                miss, dsc.env_radiance(ds, ray_d) * throughput * w_env[..., None])
        active = active & ~miss

        mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
        hit_light = active & (mat.mtype == dsc.MAT_LIGHT)
        light_vis = _light_visible_side(ds, norm, ray_d)
        light_pdf_hit = dsc.area_light_hit_pdf(ds, mat.base_color, prev_pos,
                                               pos, norm)
        w_light = torch.where(delta_sample, torch.ones_like(light_pdf_hit),
                              m.power_heuristic(samp.pdf, light_pdf_hit))
        indirect = indirect + _mask3(
            hit_light & light_vis, mat.base_color * throughput * w_light[..., None])
        active = active & ~hit_light

    if untile is not None:  # back to pixel order (pure transpose)
        direct, indirect = untile(direct), untile(indirect)
    return direct, indirect


def path_trace_direct(ds: dsc.DeviceScene, cam: cam_mod.Camera, looper):
    """One-bounce direct lighting — ``PTDirectKernel`` (pathtrace.cu:293-345):
    primary-visible emission plus one NEE sample per pixel.  Returns
    direct [N, 3] in raster order."""
    idx, untile = _lanes(ds, cam)
    sampler = rng.make_sampler(looper, idx)

    ray_o, ray_d, sampler = _gen_primary(ds, cam, sampler, idx)
    it = dsc.intersect(ds, ray_o, ray_d)
    hit = it.prim_id != NULL_PRIMITIVE
    direct = _mask3(~hit, dsc.env_radiance(ds, ray_d))

    mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
    is_light = hit & (mat.mtype == dsc.MAT_LIGHT)
    light_vis = _light_visible_side(ds, norm, ray_d)
    direct = direct + _mask3(is_light & light_vis, mat.base_color)

    wo = -ray_d
    is_delta_bsdf = mat.mtype == dsc.MAT_DIELECTRIC
    flip = (~is_delta_bsdf) & (m.dot(norm, wo) < 0.0)
    norm = torch.where(flip[..., None], -norm, norm)

    shade = hit & ~is_light & ~is_delta_bsdf
    r4, sampler = rng.sample_4d(ds.sobol, sampler)
    li, wi, light_pdf = dsc.sample_direct_light(ds, it.pos, r4, mask=shade,
                                                shade_normal=norm)
    ok = shade & (light_pdf > 0.0)
    f = bsdf.bsdf_eval(mat, norm, wo, wi, types=ds.mat_types)
    contrib = f * li * (m.sat_dot(norm, wi)
                        / torch.clamp(light_pdf, min=1e-12))[..., None]
    direct = direct + _mask3(ok, contrib)
    if untile is not None:
        direct = untile(direct)
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
