"""Full-MIS path tracing with next-event estimation, the plain reference:
a frozen copy of the port's ``render/pathtrace.py`` (its dense bounce
loop, in lane order; the port's sorted and sliced loops give every lane the
same bits), over the exhaustive intersection of :mod:`.shading`.

The lanes may be any pixels of any frames: ``path_trace`` takes a looper a
lane (:mod:`.sampler`), and a pixel's path depends on nothing but its
pixel id and its frame's looper.
"""

from __future__ import annotations

import torch

from . import camera as cam_mod
from . import materials as bsdf
from . import precision as prec
from . import sampler as rng
from . import shading as dsc
from . import vmath as m
from .sampler import alias_sample

NULL_PRIMITIVE = -1


def sample_aperture(ds: dsc.Scene, r2):
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
    u = (x.to(prec.FT) + 0.5) / w.to(prec.FT)
    v = (y.to(prec.FT) + 0.5) / h.to(prec.FT)
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


def path_trace(ds: dsc.Scene, cam: cam_mod.Camera, looper, max_depth: int, pixel_idx):
    """Full-MIS path trace, one sample a lane: lane i traces pixel
    ``pixel_idx[i]`` at looper ``looper`` (0-d, or one a lane).  Returns
    (direct [N, 3], indirect [N, 3]), the reference's split: ``direct``
    holds primary-visible emission + first-vertex NEE."""
    sampler = rng.make_sampler(looper, pixel_idx)
    ray_o, ray_d, sampler = _gen_primary(ds, cam, sampler, pixel_idx)
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
    return _dense_bounce_loop(ds, sampler, active, throughput, direct, indirect, it.pos,
                              norm, ray_d, mat, max_depth)


def _nee_contrib(ds, sampler, active, mat, norm, wo, pos, throughput):
    """Next-event estimation with MIS at the current vertex
    (pathtrace.cu:195-207; reference :316-342), 4 draws: (contrib [N,3],
    zero on masked lanes, sampler)."""
    is_delta = mat.mtype == dsc.MAT_DIELECTRIC
    r4, sampler = rng.sample_4d(ds.sobol, sampler)
    li, wi, light_pdf = dsc.sample_direct_light(
        ds, pos, r4, mask=active & ~is_delta, shade_normal=norm)
    nee_ok = active & (~is_delta) & (light_pdf > 0.0)
    f = bsdf.bsdf_eval(mat, norm, wo, wi, types=ds.mat_types)
    b_pdf = bsdf.bsdf_pdf(mat, norm, wo, wi, types=ds.mat_types)
    mis_w = m.power_heuristic(light_pdf, b_pdf)
    contrib = throughput * f * li * (
        m.sat_dot(norm, wi) / torch.clamp(light_pdf, min=1e-12) * mis_w)[..., None]
    return _mask3(nee_ok, contrib), sampler


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


def _vertex(ds, sampler, active, mat, norm, ray_d, pos, throughput):
    """One path vertex (pathtrace.cu:187-223): two-sided shading normal,
    NEE, BSDF sample.  Returns (NEE contrib, sampler, active, throughput,
    new_dir, pdf, delta_sample)."""
    wo = -ray_d
    is_delta_bsdf = mat.mtype == dsc.MAT_DIELECTRIC
    # two-sided shading for non-delta materials (pathtrace.cu:190-193)
    flip = (~is_delta_bsdf) & (m.dot(norm, wo) < 0.0)
    norm = torch.where(flip[..., None], -norm, norm)
    contrib, sampler = _nee_contrib(ds, sampler, active, mat, norm, wo, pos, throughput)
    return (contrib, *_bsdf_advance(ds, sampler, active, mat, norm, wo, throughput))


def _shade_hit(ds, acc, active, throughput, prim, pos, norm, uv, mat_id, ray_d, pdf,
               delta, prev_pos):
    """The extension ray's accounting (pathtrace.cu:229-272): an escaped
    ray sees the env map, MIS-weighted against NEE's env sampler, and an
    emissive hit its radiance, MIS-weighted against NEE's light sampler
    (full weight after a delta sample), both into ``acc``.  Returns (acc,
    active, material, shading normal) at the hit."""
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


def _dense_bounce_loop(ds, sampler, active, throughput, direct, indirect, pos, norm,
                       ray_d, mat, max_depth):
    """Every lane through every bounce (reference :216-313)."""
    for depth in range(1, max_depth + 1):
        contrib, sampler, active, throughput, new_dir, pdf, delta = _vertex(
            ds, sampler, active, mat, norm, ray_d, pos, throughput)
        # first-vertex NEE -> direct, the rest -> indirect (pathtrace.cu:203)
        if depth == 1:
            direct = direct + contrib
        else:
            indirect = indirect + contrib
        # ---- extend ray (pathtrace.cu:225-228) ----
        it = dsc.intersect(ds, pos + new_dir * 1e-5, new_dir, active=active)
        indirect, active, mat, norm = _shade_hit(
            ds, indirect, active, throughput, it.prim_id, it.pos, it.norm, it.uv,
            it.mat_id, new_dir, pdf, delta, pos)
        pos, ray_d = it.pos, new_dir
    return direct, indirect


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
    if not isinstance(it, torch.Tensor):
        it = torch.full((), float(it), dtype=prec.FT, device=prev.device)
    return (prev * it + new) / (it + 1.0)
