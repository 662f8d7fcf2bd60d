"""Physically based BSDFs: Lambertian, GGX metallic-workflow, dielectric.

Port of ``radish_pt_tpu/bsdf/materials.py`` (reference material.h:128-275):
every lane evaluates the lobes of the material types present and the result
is selected by the material-type mask, in the reference's operation order.

* Lambertian — cosine hemisphere (material.h:141-147)
* MetallicWorkflow — GGX VNDF sampling (Heitz, JCGT 2018; material.h:99-126)
  with the metallic-dependent diffuse/specular lobe mix (material.h:215-233)
* Dielectric — exact Fresnel reflect/refract with 1/eta^2 radiance scaling
  (material.h:159-183)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .shading import (
    MAT_DIELECTRIC,
    MAT_LAMBERTIAN,
    MAT_METALLIC_WORKFLOW,
    SurfaceMaterial,
)
from . import vmath as m

# BSDF sample type flags (material.h:18-26)
DIFFUSE = 1 << 0
GLOSSY = 1 << 1
SPECULAR = 1 << 2
REFLECTION = 1 << 4
TRANSMISSION = 1 << 5
INVALID = 1 << 15


@dataclass
class BSDFSample:
    dir: torch.Tensor  # [N, 3]
    bsdf: torch.Tensor  # [N, 3]
    pdf: torch.Tensor  # [N]
    type: torch.Tensor  # [N] int32 flag bits


def is_delta(sample_type) -> torch.Tensor:
    return (sample_type & SPECULAR) != 0


def is_invalid(sample_type) -> torch.Tensor:
    return (sample_type & INVALID) != 0


# ---------------------------------------------------------------------------
# GGX microfacet pieces (material.h:68-126)
# ---------------------------------------------------------------------------


def schlick_g(cos_theta, alpha):
    a = alpha * 0.5
    return cos_theta / (cos_theta * (1.0 - a) + a)


def smith_g(cos_wo, cos_wi, alpha):
    return schlick_g(torch.abs(cos_wo), alpha) * schlick_g(torch.abs(cos_wi), alpha)


def ggx_distribution(cos_theta, alpha):
    alpha2 = alpha * alpha
    denom = (cos_theta * cos_theta) * (alpha2 - 1.0) + 1.0
    d = alpha2 / torch.clamp(denom * denom * m.PI, min=1e-12)
    return torch.where(cos_theta < 1e-6, torch.zeros_like(d), d)


def ggx_pdf(n, mvec, wo, alpha):
    return (ggx_distribution(m.dot(n, mvec), alpha)
            * schlick_g(m.dot(n, wo), alpha)
            * m.abs_dot(mvec, wo)
            / torch.clamp(m.abs_dot(n, wo), min=1e-12))


def ggx_sample_vndf(n, wo, alpha, r2):
    """Sample the GGX visible-normal distribution (material.h:106-126)."""
    frame = m.local_ref_matrix(n)
    t_axis, b_axis, n_axis = frame[..., 0, :], frame[..., 1, :], frame[..., 2, :]
    wo_local = torch.stack(
        [m.dot(wo, t_axis), m.dot(wo, b_axis), m.dot(wo, n_axis)], dim=-1)
    vh = m.normalize(wo_local * torch.stack(
        [alpha, alpha, torch.ones_like(alpha)], dim=-1))
    len_sq = vh[..., 0] * vh[..., 0] + vh[..., 1] * vh[..., 1]
    inv_len = 1.0 / torch.sqrt(torch.clamp(len_sq, min=1e-24))
    x_axis = m.const((1.0, 0.0, 0.0), vh.dtype, vh.device)
    t1 = torch.where(
        (len_sq > 0.0)[..., None],
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(len_sq)], dim=-1)
        * inv_len[..., None],
        x_axis,
    )
    t2 = m.cross(vh, t1)

    p = m.concentric_sample_disk(r2[..., 0], r2[..., 1])
    s = 0.5 * (vh[..., 2] + 1.0)
    py = ((1.0 - s) * torch.sqrt(torch.clamp(1.0 - p[..., 0] * p[..., 0], min=0.0))
          + s * p[..., 1])
    px = p[..., 0]
    pz = torch.sqrt(torch.clamp(1.0 - px * px - py * py, min=0.0))
    h = t1 * px[..., None] + t2 * py[..., None] + vh * pz[..., None]
    h = torch.stack([h[..., 0] * alpha, h[..., 1] * alpha,
                     torch.clamp(h[..., 2], min=0.0)], dim=-1)
    h_world = t_axis * h[..., 0:1] + b_axis * h[..., 1:2] + n_axis * h[..., 2:3]
    return m.normalize(h_world)


# ---------------------------------------------------------------------------
# per-lobe eval / pdf
# ---------------------------------------------------------------------------


def _lambertian_eval(mat: SurfaceMaterial, n, wo, wi):
    return mat.base_color * m.INV_PI


def _lambertian_pdf(mat, n, wo, wi):
    return m.sat_dot(n, wi) * m.INV_PI


def _metallic_eval(mat: SurfaceMaterial, n, wo, wi):
    alpha = mat.roughness * mat.roughness
    h = m.normalize(wo + wi)
    cos_o = m.dot(n, wo)
    cos_i = m.dot(n, wi)
    f0 = 0.08 + (mat.base_color - 0.08) * mat.metallic[..., None]
    f = m.fresnel_schlick(m.dot(h, wo), f0)
    d = ggx_distribution(m.dot(n, h), alpha)
    g = smith_g(cos_o, cos_i, alpha)
    diffuse = mat.base_color * m.INV_PI * (1.0 - mat.metallic)[..., None]
    spec = (g * d / torch.clamp(4.0 * cos_i * cos_o, min=1e-12))[..., None]
    out = diffuse * (1.0 - f) + spec * f
    return torch.where((cos_i * cos_o < 1e-7)[..., None], torch.zeros_like(out), out)


def _metallic_pdf(mat, n, wo, wi):
    alpha = mat.roughness * mat.roughness
    h = m.normalize(wo + wi)
    spec_w = 1.0 / (2.0 - mat.metallic)
    diff_pdf = m.sat_dot(n, wi) * m.INV_PI
    spec_pdf = ggx_pdf(n, h, wo, alpha) / torch.clamp(4.0 * m.abs_dot(h, wo), min=1e-12)
    return diff_pdf * (1.0 - spec_w) + spec_pdf * spec_w


def _has(types, ty) -> bool:
    return types is None or ty in types


def bsdf_eval(mat: SurfaceMaterial, n, wo, wi, types=None):
    """f(wo, wi) — Material::BSDF (material.h:235-246).  Dielectric and Light
    contribute zero.  ``types``: MAT_* types present (absent lobes are not
    computed)."""
    t = mat.mtype[..., None]
    out = torch.zeros_like(mat.base_color)
    if _has(types, MAT_METALLIC_WORKFLOW):
        out = torch.where(t == MAT_METALLIC_WORKFLOW,
                          _metallic_eval(mat, n, wo, wi), out)
    if _has(types, MAT_LAMBERTIAN):
        out = torch.where(t == MAT_LAMBERTIAN, _lambertian_eval(mat, n, wo, wi), out)
    return out


def bsdf_pdf(mat: SurfaceMaterial, n, wo, wi, types=None):
    """pdf(wo, wi) — Material::pdf (material.h:248-258)."""
    t = mat.mtype
    out = torch.zeros_like(mat.roughness)
    if _has(types, MAT_METALLIC_WORKFLOW):
        out = torch.where(t == MAT_METALLIC_WORKFLOW,
                          _metallic_pdf(mat, n, wo, wi), out)
    if _has(types, MAT_LAMBERTIAN):
        out = torch.where(t == MAT_LAMBERTIAN, _lambertian_pdf(mat, n, wo, wi), out)
    return out


def _overlay(out: BSDFSample, cond, s: BSDFSample) -> BSDFSample:
    c3 = cond[..., None]
    return BSDFSample(dir=torch.where(c3, s.dir, out.dir),
                      bsdf=torch.where(c3, s.bsdf, out.bsdf),
                      pdf=torch.where(cond, s.pdf, out.pdf),
                      type=torch.where(cond, s.type, out.type))


def bsdf_sample(mat: SurfaceMaterial, n, wo, r3, types=None) -> BSDFSample:
    """Sample an outgoing direction for every lane — Material::sample
    (material.h:260-275).  r3: [N, 3] uniforms."""
    t = mat.mtype
    lanes = n.shape[:-1]

    def flags(v):
        return torch.full(lanes, v, dtype=torch.int32, device=n.device)

    out = BSDFSample(dir=torch.zeros_like(n), bsdf=torch.zeros_like(n),
                     pdf=torch.zeros(lanes, dtype=n.dtype, device=n.device),
                     type=flags(INVALID))

    if _has(types, MAT_LAMBERTIAN) or _has(types, MAT_METALLIC_WORKFLOW):
        # the metallic diffuse lobe reuses the cosine-sampled direction
        lam_dir = m.cosine_sample_hemisphere(n, r3[..., 0], r3[..., 1])

    if _has(types, MAT_LAMBERTIAN):
        lam = BSDFSample(dir=lam_dir, bsdf=mat.base_color * m.INV_PI,
                         pdf=m.sat_dot(n, lam_dir) * m.INV_PI,
                         type=flags(DIFFUSE | REFLECTION))
        out = _overlay(out, t == MAT_LAMBERTIAN, lam)

    if _has(types, MAT_METALLIC_WORKFLOW):
        alpha = mat.roughness * mat.roughness
        h = ggx_sample_vndf(n, wo, alpha, r3[..., 0:2])
        spec_dir = m.normalize(2.0 * m.vdot(h, wo) * h - wo)
        use_diffuse = r3[..., 2] > (1.0 / (2.0 - mat.metallic))
        met_dir = torch.where(use_diffuse[..., None], lam_dir, spec_dir)
        met_bad = m.dot(n, met_dir) < 0.0
        met = BSDFSample(
            dir=met_dir,
            bsdf=_metallic_eval(mat, n, wo, met_dir),
            pdf=_metallic_pdf(mat, n, wo, met_dir),
            type=torch.where(met_bad, INVALID, GLOSSY | REFLECTION).to(torch.int32),
        )
        out = _overlay(out, t == MAT_METALLIC_WORKFLOW, met)

    if _has(types, MAT_DIELECTRIC):
        cos_wo = m.dot(n, wo)
        pdf_refl = m.fresnel(cos_wo, mat.ior)
        refl_dir = m.normalize(2.0 * cos_wo[..., None] * n - wo)
        refr_dir, refr_ok = m.refract(n, wo, mat.ior)
        choose_refl = r3[..., 2] < pdf_refl
        eta = torch.where(cos_wo < 0.0, 1.0 / mat.ior, mat.ior)
        die = BSDFSample(
            dir=torch.where(choose_refl[..., None], refl_dir, refr_dir),
            bsdf=torch.where(choose_refl[..., None], mat.base_color,
                             mat.base_color / (eta * eta)[..., None]),
            pdf=torch.ones_like(pdf_refl),
            type=torch.where(
                (~choose_refl) & (~refr_ok), INVALID,
                torch.where(choose_refl, SPECULAR | REFLECTION,
                            SPECULAR | TRANSMISSION)).to(torch.int32),
        )
        out = _overlay(out, t == MAT_DIELECTRIC, die)

    return out
