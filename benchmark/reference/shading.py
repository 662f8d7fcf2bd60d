"""The reference's scene and its shading: the plain semantics of the
port's default engine, worked out again from the scene file.

Frozen copies of the port's ``scene/device_scene.py`` (textures, surface
recovery from a winner id, materials, env map, light sampling) and of the
light and env tables of ``scene/build.py``, with two changes:

* triangles stay in the scene file's order: no BVH, no clusters, no packed
  tables (a winner's id names its triangle in that order);
* the closest hit and the shadow test are exhaustive Möller–Trumbore over
  every triangle (the port's ``accel/traverse.py::intersect_brute``, its
  oracle), and the surface is recovered from the winner id, as the port's
  sweep engines recover it (``surface_info_from_t``).  The default engine
  culls and sorts, which moves no winner but a ray's that grazes an edge.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from . import precision as prec
from . import vmath as m
from .sampler import alias_sample, build_alias_table, sobol_table

NULL_PRIMITIVE = -1
RAY_OFFSET = 1e-5  # reference makeOffsetedRay (intersections.h:16-18)
SHADOW_EPS = 1e-4  # shadow segments stop this short of their end

NULL_TEXTURE = -1
PROCEDURAL_TEXTURE = -2
INVALID_PDF = -1.0

MAT_LAMBERTIAN = 0
MAT_METALLIC_WORKFLOW = 1
MAT_DIELECTRIC = 2
MAT_DISNEY = 3  # parsed but shaded as metallic workflow (like the reference)
MAT_LIGHT = 4

MATERIAL_TYPE_TOKENS = {
    "Lambertian": MAT_LAMBERTIAN,
    "MetallicWorkflow": MAT_METALLIC_WORKFLOW,
    "Dielectric": MAT_DIELECTRIC,
    "Disney": MAT_DISNEY,
    "Light": MAT_LIGHT,
}


@dataclass
class Scene:
    n_area_lights: int = 0
    has_env: bool = False
    has_aperture: bool = False
    single_sided: bool = True
    mat_types: tuple = None  # MAT_* types present
    env_tex: int = NULL_TEXTURE
    aperture_tex: int = NULL_TEXTURE
    tri_v: torch.Tensor = None  # f32 [T, 3, 3], file order
    # [v0 v1 v2 (9) | n0 n1 n2 (9) | uv0 uv1 uv2 (6) | mat id (1)]
    tri_attr: torch.Tensor = None  # f32 [T, 25]
    tri_packed: torch.Tensor = None  # f32 [T, 9] v0, e1, e2
    mat_type: torch.Tensor = None
    mat_base_color: torch.Tensor = None
    mat_metallic: torch.Tensor = None
    mat_roughness: torch.Tensor = None
    mat_ior: torch.Tensor = None
    mat_color_map: torch.Tensor = None
    mat_normal_map: torch.Tensor = None
    mat_metallic_map: torch.Tensor = None
    mat_roughness_map: torch.Tensor = None
    tex_data: torch.Tensor = None
    tex_offset: torch.Tensor = None
    tex_width: torch.Tensor = None
    tex_height: torch.Tensor = None
    light_prim_ids: torch.Tensor = None
    light_radiance: torch.Tensor = None
    sum_light_power_inv: torch.Tensor = None
    light_alias_prob: torch.Tensor = None
    light_alias_idx: torch.Tensor = None
    env_alias_prob: torch.Tensor = None
    env_alias_idx: torch.Tensor = None
    aperture_alias_prob: torch.Tensor = None
    aperture_alias_idx: torch.Tensor = None
    sobol: torch.Tensor = None  # int64 [SOBOL_NUM * SOBOL_DIM], u32 values

    @property
    def has_lights(self) -> bool:
        return self.n_area_lights > 0 or self.has_env

    @property
    def device(self) -> torch.device:
        return self.tri_attr.device

    def in_float(self, dtype) -> "Scene":
        """The scene with its float tables in ``dtype`` (the control)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dtype) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
            and getattr(self, f.name).is_floating_point()})


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------


def _texture_bilinear(ds: Scene, tex_id, uv):
    """Bilinear texture fetch with wraparound — DevTextureObj::linearSample
    (image.h:42-73).  ``tex_id`` int [N] (must be valid), uv f32 [N, 2]."""
    w = ds.tex_width[tex_id]
    h = ds.tex_height[tex_id]
    off = ds.tex_offset[tex_id]
    fx = uv[..., 0] * w.to(prec.FT) - 0.5
    fy = uv[..., 1] * h.to(prec.FT) - 0.5
    ix = torch.floor(fx).to(torch.int32)
    iy = torch.floor(fy).to(torch.int32)
    tx = fx - ix.to(prec.FT)
    ty = fy - iy.to(prec.FT)

    def wrap(i, n):
        return torch.remainder(torch.remainder(i, n) + n, n)

    x0, x1 = wrap(ix, w), wrap(ix + 1, w)
    y0, y1 = wrap(iy, h), wrap(iy + 1, h)
    c00 = ds.tex_data[(off + y0 * w + x0).long()]
    c10 = ds.tex_data[(off + y0 * w + x1).long()]
    c01 = ds.tex_data[(off + y1 * w + x0).long()]
    c11 = ds.tex_data[(off + y1 * w + x1).long()]
    cx0 = c00 * (1 - tx)[..., None] + c10 * tx[..., None]
    cx1 = c01 * (1 - tx)[..., None] + c11 * tx[..., None]
    return cx0 * (1 - ty)[..., None] + cx1 * ty[..., None]


def procedural_texture(uv):
    """Checker-ish procedural pattern — DevScene::proceduralTexture
    (scene.h:77-86), with the thrust RNG replaced by utilhash."""
    cx = (uv[..., 0] * 1024).to(torch.int32).to(torch.int64)
    cy = (uv[..., 1] * 1024).to(torch.int32).to(torch.int64)
    h1 = m.utilhash(cx * 1024 + cy)  # utilhash wraps to u32 like the i32 math
    h2 = m.utilhash(h1)
    rx = m.u32_to_unit(h1)
    ry = m.u32_to_unit(h2)
    f = (torch.sin(uv[..., 0] * 10.0 * m.TWO_PI + rx * m.TWO_PI) + 1.0) * 0.5
    g = (torch.sin(uv[..., 1] * 10.0 * m.TWO_PI + ry * m.TWO_PI) + 1.0) * 0.5
    return (f * g)[..., None].expand(*uv.shape[:-1], 3)


@dataclass
class Interaction:
    prim_id: torch.Tensor  # i32 [N], -1 on miss
    mat_id: torch.Tensor  # i32 [N]
    pos: torch.Tensor  # f32 [N, 3]
    norm: torch.Tensor  # f32 [N, 3] (shading normal)
    uv: torch.Tensor  # f32 [N, 2]


@dataclass
class SurfaceMaterial:
    """Per-lane material parameters after texture fetches
    (getTexturedMaterialAndSurface, scene.h:88-112)."""

    mtype: torch.Tensor  # i32 [N]
    base_color: torch.Tensor  # f32 [N, 3]
    metallic: torch.Tensor  # f32 [N]
    roughness: torch.Tensor  # f32 [N]
    ior: torch.Tensor  # f32 [N]


def _rows(table, idx):
    """``table[idx]`` with idx clamped into range (the reference's gather
    clamp)."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


def surface_info_from_t(ds: Scene, prim_id, ray_o, ray_d):
    """Position/normal/uv from the winning PRIMITIVE id (Plücker engines).

    The sweep's ``dist`` is selector-grade only; the winner id is robust, so
    the exact distance is recomputed here from the gathered triangle row via
    the ray-plane form t = (v0-o)·n / (d·n), and barycentrics by projecting
    onto the edge basis.
    """
    a = _rows(ds.tri_attr, prim_id)
    v0 = a[:, 0:3]
    e1 = a[:, 3:6] - v0
    e2 = a[:, 6:9] - v0
    gn = m.cross(e1, e2)
    denom = m.dot(ray_d, gn)
    # winners satisfy |d·n| > eps; the guard only protects dead lanes
    t_exact = m.dot(v0 - ray_o, gn) / torch.where(
        torch.abs(denom) > 1e-30, denom, torch.full_like(denom, 1e-30))
    t_exact = torch.clamp(t_exact, 0.0, 1e8)
    p = ray_o + ray_d * t_exact[..., None] - v0
    d11 = m.dot(e1, e1)
    d12 = m.dot(e1, e2)
    d22 = m.dot(e2, e2)
    p1 = m.dot(p, e1)
    p2 = m.dot(p, e2)
    inv = 1.0 / torch.clamp(d11 * d22 - d12 * d12, min=1e-30)
    bx = ((d22 * p1 - d12 * p2) * inv)[..., None]
    by = ((d11 * p2 - d12 * p1) * inv)[..., None]
    bw = 1.0 - bx - by
    pos = v0 + e1 * bx + e2 * by
    norm = m.normalize(a[:, 12:15] * bx + a[:, 15:18] * by + a[:, 9:12] * bw)
    uvi = a[:, 20:22] * bx + a[:, 22:24] * by + a[:, 18:20] * bw
    mat_id = torch.where(prim_id >= 0, a[:, 24].to(torch.int32), -1)
    return pos, norm, uvi, mat_id


# ---------------------------------------------------------------------------
# exhaustive intersection (the port's accel/traverse.py oracle)
# ---------------------------------------------------------------------------


def _mt_core(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
             ox, oy, oz, dx, dy, dz):
    """Component-wise Möller–Trumbore with sign-normalized determinant
    (intersections.h:20-68).  Returns (hit, dist)."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det0 = e1x * px + e1y * py + e1z * pz
    sign = torch.where(det0 < 0.0, -1.0, 1.0).to(det0.dtype)
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
    return hit, dist


# lanes x triangles a block of the exhaustive test: a few hundred MB a
# temporary, so the reference fits beside nothing else on the card
PAIRS_PER_BLOCK = 1 << 24


def closest_ids(ds: Scene, ray_o, ray_d):
    """All-pairs closest hit: (prim_id i32 [N], dist [N]); ties go to the
    lower triangle id."""
    n, dev = ray_o.shape[0], ray_o.device
    num_tris = ds.tri_packed.shape[0]
    tri_chunk = min(num_tris, 2048)
    ray_chunk = max(1, PAIRS_PER_BLOCK // tri_chunk)
    prim = torch.full((n,), NULL_PRIMITIVE, dtype=torch.int32, device=dev)
    big = torch.finfo(prec.FT).max  # FLT_MAX in float32
    best = torch.full((n,), big, dtype=prec.FT, device=dev)
    for r0 in range(0, n, ray_chunk):
        r1 = min(n, r0 + ray_chunk)
        o = [ray_o[r0:r1, k:k + 1] for k in range(3)]
        d = [ray_d[r0:r1, k:k + 1] for k in range(3)]
        for c0 in range(0, num_tris, tri_chunk):
            tc = ds.tri_packed[c0:c0 + tri_chunk]
            hit, dist = _mt_core(*[tc[None, :, k] for k in range(9)], *o, *d)
            dist = torch.where(hit, dist, torch.full_like(dist, big))
            cd, j = torch.min(dist, dim=1)  # first minimum: lower id on ties
            upd = cd < best[r0:r1]
            prim[r0:r1] = torch.where(upd, (j + c0).to(torch.int32), prim[r0:r1])
            best[r0:r1] = torch.where(upd, cd, best[r0:r1])
    return prim, best


def intersect(ds: Scene, ray_o, ray_d, active=None) -> Interaction:
    """Closest hit and the surface recovered from the winner id; lanes that
    ``active`` marks False are dead and miss (prim -1)."""
    prim, _ = closest_ids(ds, ray_o, ray_d)
    if active is not None:
        prim = torch.where(active, prim, -1)
    pos, norm, uv, mat_id = surface_info_from_t(ds, prim, ray_o, ray_d)
    return Interaction(prim_id=prim, mat_id=mat_id, pos=pos, norm=norm, uv=uv)


# the primaries and the bounce rays take the same closest hit here: the
# port sorts them, which moves no winner
intersect_primary = intersect
intersect_sorted = intersect


def test_occlusion(ds: Scene, x, y):
    """True where segment x->y is blocked (naiveTestOcclusion,
    scene.h:244-260): the origin inset by 1e-5 along the segment, the range
    ending 1e-4 short of y."""
    d = y - x
    dist = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-24))
    dirn = d / dist[..., None]
    prim, hit_dist = closest_ids(ds, x + dirn * RAY_OFFSET, dirn)
    return (prim != NULL_PRIMITIVE) & (hit_dist < dist - SHADOW_EPS)


test_occlusion.__test__ = False


def test_occlusion_sorted(ds: Scene, x, y, mask=None):
    """:func:`test_occlusion`; lanes that ``mask`` marks False are not
    blocked."""
    occ = test_occlusion(ds, x, y)
    return occ if mask is None else occ & mask


test_occlusion_sorted.__test__ = False


def get_textured_material(ds: Scene, mat_id, uv, norm):
    """Fetch material params with texture/normal maps applied
    (getTexturedMaterialAndSurface, scene.h:88-112).

    Returns (SurfaceMaterial, shading normal)."""
    mid = torch.clamp(mat_id, min=0).long()
    mtype = _rows(ds.mat_type, mid)
    base = _rows(ds.mat_base_color, mid)
    metallic = _rows(ds.mat_metallic, mid)
    roughness = _rows(ds.mat_roughness, mid)
    ior = _rows(ds.mat_ior, mid)

    cmap = _rows(ds.mat_color_map, mid)
    use_tex = (cmap > NULL_TEXTURE)[..., None]
    use_proc = (cmap == PROCEDURAL_TEXTURE)[..., None]
    has_tex = ds.tex_offset.shape[0] > 0
    tex_col = (_texture_bilinear(ds, torch.clamp(cmap, min=0), uv)
               if has_tex else base)
    base = torch.where(use_proc, procedural_texture(uv),
                       torch.where(use_tex, tex_col, base))

    if has_tex:
        mmap = _rows(ds.mat_metallic_map, mid)
        metallic = torch.where(
            mmap > NULL_TEXTURE,
            _texture_bilinear(ds, torch.clamp(mmap, min=0), uv)[..., 0],
            metallic)
        rmap = _rows(ds.mat_roughness_map, mid)
        roughness = torch.where(
            rmap > NULL_TEXTURE,
            _texture_bilinear(ds, torch.clamp(rmap, min=0), uv)[..., 0],
            roughness)
        nmap = _rows(ds.mat_normal_map, mid)
        mapped = _texture_bilinear(ds, torch.clamp(nmap, min=0), uv)
        local_n = m.normalize(mapped - 0.5)
        norm = torch.where((nmap > NULL_TEXTURE)[..., None],
                           m.local_to_world(norm, local_n), norm)

    return SurfaceMaterial(mtype=mtype, base_color=base, metallic=metallic,
                           roughness=roughness, ior=ior), norm


# ---------------------------------------------------------------------------
# environment map
# ---------------------------------------------------------------------------


def env_radiance(ds: Scene, dir):
    """Env-map radiance for a direction (equirect, bilinear;
    pathtrace.cu:233-236); zero without an env map."""
    if not ds.has_env:
        return torch.zeros_like(dir)
    tex_id = torch.full(dir.shape[:-1], ds.env_tex, dtype=torch.int32,
                        device=dir.device)
    return _texture_bilinear(ds, tex_id, m.to_plane(dir))


def _env_pdf(ds: Scene, radiance):
    """The env sampler's solid-angle pdf for a texel of ``radiance``:
    lum * W * H / (sumPower * 2pi^2), the consistent form (module
    docstring)."""
    w = ds.tex_width[ds.env_tex].to(prec.FT)
    h = ds.tex_height[ds.env_tex].to(prec.FT)
    return (m.luminance(radiance) * ds.sum_light_power_inv * w * h
            * (m.INV_PI * m.INV_PI) * 0.5)


def env_map_pdf(ds: Scene, wi):
    """Solid-angle pdf of the env-map light sampler in direction ``wi``
    (``environmentMapPdf``, scene.h:374-378, in the consistent form)."""
    return _env_pdf(ds, env_radiance(ds, wi))


def _sample_env_map(ds: Scene, r2):
    """Alias-sample the env map (sampleEnvMapNoVisbility, scene.h:401-414):
    returns (radiance [N, 3], wi [N, 3], pdf_solid_angle [N]) at the
    centre of the chosen texel."""
    pix = alias_sample(ds.env_alias_prob, ds.env_alias_idx, r2[..., 0], r2[..., 1])
    w = ds.tex_width[ds.env_tex]
    h = ds.tex_height[ds.env_tex]
    y = pix // w
    x = pix - y * w
    radiance = ds.tex_data[(ds.tex_offset[ds.env_tex] + pix).long()]
    uv = torch.stack([(x.to(prec.FT) + 0.5) / w.to(prec.FT),
                      (y.to(prec.FT) + 0.5) / h.to(prec.FT)], dim=-1)
    return radiance, m.to_sphere(uv), _env_pdf(ds, radiance)


# ---------------------------------------------------------------------------
# direct-light sampling
# ---------------------------------------------------------------------------


def sample_direct_light_no_vis(ds: Scene, pos, r4):
    """One light sample per lane WITHOUT visibility —
    ``sampleDirectLightNoVisibility`` (scene.h:458-492).

    Returns (radiance [N,3], wi [N,3], dist [N], pdf [N]); pdf <= 0 marks an
    invalid sample.  The pdfs are the reference package's consistent forms
    (module docstring).  The area branch runs when the scene has area
    lights, the env branch when it has an env map (the sampler's last slot,
    scene.h:426-427: its lanes get the texel's direction, ``dist`` 1e6 and
    the env pdf), so an env map alone lights a scene.
    """
    n_lanes = pos.shape[0]
    zero3 = torch.zeros_like(pos)
    invalid = torch.full((n_lanes,), INVALID_PDF, device=pos.device)
    zero = torch.zeros(n_lanes, device=pos.device)
    if not ds.has_lights:
        return zero3, zero3, zero, invalid

    light_id = alias_sample(ds.light_alias_prob, ds.light_alias_idx,
                            r4[..., 0], r4[..., 1])
    num_area = ds.n_area_lights
    radiance, wi, dist, pdf = zero3, zero3, zero, invalid
    if num_area > 0:
        lid = torch.clamp(light_id, 0, num_area - 1).long()
        tri = ds.tri_v[ds.light_prim_ids.long()][lid]  # [N, 3, 3]
        v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
        sampled = m.sample_triangle_uniform(v0, v1, v2, r4[..., 2], r4[..., 3])
        normal = m.triangle_normal(v0, v1, v2)
        radiance = ds.light_radiance[lid]
        to_sampled = sampled - pos
        dist = m.length(to_sampled)
        wi = to_sampled / torch.clamp(dist, min=1e-12)[..., None]
        pdf_area = m.luminance(radiance) * (2.0 * m.PI) * ds.sum_light_power_inv
        pdf = m.pdf_area_to_solid_angle(pdf_area, pos, sampled, normal)
        if ds.single_sided:
            facing = m.dot(normal, -wi) > 1e-6
            pdf = torch.where(facing, pdf, invalid)
    if ds.has_env:
        env_rad, env_wi, env_pdf = _sample_env_map(ds, r4[..., 2:4])
        is_env = light_id == num_area
        radiance = torch.where(is_env[..., None], env_rad, radiance)
        wi = torch.where(is_env[..., None], env_wi, wi)
        dist = torch.where(is_env, torch.full_like(dist, 1e6), dist)
        pdf = torch.where(is_env, env_pdf, pdf)
    return radiance, wi, dist, pdf


def sample_direct_light(ds: Scene, pos, r4, mask=None, shade_normal=None):
    """Light sample WITH a shadow test (sampleDirectLight, scene.h:419-456).
    Returns (radiance, wi, pdf); pdf <= 0 when invalid or occluded.

    Lanes that cannot use the sample (``mask`` False, or the sample below
    the horizon of ``shade_normal``) are masked in the shadow test, which
    is :func:`test_occlusion_sorted`; their pdf is invalid."""
    radiance, wi, dist, pdf = sample_direct_light_no_vis(ds, pos, r4)
    ok = pdf > 0.0
    if mask is not None:
        ok = ok & mask
    if shade_normal is not None:
        ok = ok & (m.dot(shade_normal, wi) > 0.0)
    occ = test_occlusion_sorted(ds, pos, pos + wi * dist[..., None], mask=ok)
    pdf = torch.where(ok & ~occ, pdf, torch.full_like(pdf, INVALID_PDF))
    return radiance, wi, pdf


def area_light_hit_pdf(ds: Scene, radiance, prev_pos, hit_pos, hit_norm):
    """Solid-angle pdf NEE would assign to an emissive hit — the MIS weight
    of BSDF paths (pathtrace.cu:260-268)."""
    pdf_area = m.luminance(radiance) * (2.0 * m.PI) * ds.sum_light_power_inv
    return m.pdf_area_to_solid_angle(pdf_area, prev_pos, hit_pos, hit_norm)


def pack_textures(images: list[np.ndarray]):
    """Concatenate [H,W,3] float images into one flat [P,3] atlas + meta."""
    if not images:
        return (np.zeros((1, 3), np.float32), np.zeros((0,), np.int32),
                np.zeros((0,), np.int32), np.zeros((0,), np.int32))
    data, offsets, widths, heights = [], [], [], []
    off = 0
    for img in images:
        h, w = img.shape[:2]
        data.append(img.reshape(-1, 3).astype(np.float32))
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        off += h * w
    return (np.concatenate(data, axis=0), np.asarray(offsets, np.int32),
            np.asarray(widths, np.int32), np.asarray(heights, np.int32))


# ---------------------------------------------------------------------------
# the scene from its file (the port's scene/build.py, file order)
# ---------------------------------------------------------------------------


def _luminance_np(c: np.ndarray) -> np.ndarray:
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def build_scene(desc, device) -> Scene:
    """Flatten the instances in file order, extract the lights, build the
    light, env and aperture alias tables and the Sobol table
    (createLightSampler, scene.cpp:145-188)."""
    from .parser import HostMaterial

    verts, norms, uvs, mat_ids = [], [], [], []
    light_prims, light_radiance, light_power = [], [], []
    prim_base = 0
    for inst in desc.instances:
        mesh = inst.mesh
        M = inst.transform
        nrm_mat = np.linalg.inv(M[:3, :3]).T
        v = mesh.vertices @ M[:3, :3].T + M[:3, 3]
        n = mesh.normals @ nrm_mat.T
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        verts.append(v.astype(np.float32))
        norms.append(n.astype(np.float32))
        uvs.append(mesh.texcoords.astype(np.float32))
        t = mesh.num_triangles
        mat_ids.append(np.full(t, inst.material_id, np.int32))
        mat = desc.materials[inst.material_id]
        if mat.mtype == MAT_LIGHT:
            tv = v.reshape(-1, 3, 3)
            area = np.linalg.norm(
                np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=-1) * 0.5
            rad = np.asarray(mat.base_color, np.float32)
            power_unit = float(_luminance_np(rad)) * 2.0 * np.pi
            for k in range(t):
                light_prims.append(prim_base + k)
                light_radiance.append(rad)
                light_power.append(power_unit * float(area[k]))
        prim_base += t
    if prim_base == 0:
        raise ValueError("No mesh data loaded")
    tri_v = np.concatenate(verts).reshape(-1, 3, 3)
    tri_n = np.concatenate(norms).reshape(-1, 3, 3)
    tri_uv = np.concatenate(uvs).reshape(-1, 3, 2)
    material_ids = np.concatenate(mat_ids)

    has_env = desc.env_tex_id != NULL_TEXTURE
    env_prob, env_alias = np.ones(1, np.float32), np.zeros(1, np.int32)
    light_weights = list(light_power)
    if has_env:
        env_img = desc.textures[desc.env_tex_id]
        h = env_img.shape[0]
        sin_theta = np.sin((0.5 + np.arange(h)) / h * np.pi).astype(np.float32)
        env_table = build_alias_table(
            (_luminance_np(env_img) * sin_theta[:, None]).reshape(-1))
        env_prob, env_alias = env_table.prob, env_table.alias
        light_weights.append(env_table.total)
    if light_weights:
        light_table = build_alias_table(np.asarray(light_weights, np.float64))
        sum_power_inv = 1.0 / max(light_table.total, 1e-12)
        la_prob, la_idx = light_table.prob, light_table.alias
    else:
        sum_power_inv, la_prob, la_idx = 0.0, np.ones(1, np.float32), np.zeros(1, np.int32)
    has_aperture = desc.aperture_tex_id != NULL_TEXTURE
    ap_prob, ap_idx = np.ones(1, np.float32), np.zeros(1, np.int32)
    if has_aperture:
        ap_table = build_alias_table(
            _luminance_np(desc.textures[desc.aperture_tex_id]).reshape(-1))
        ap_prob, ap_idx = ap_table.prob, ap_table.alias

    tri_packed = np.empty((tri_v.shape[0], 9), np.float32)
    tri_packed[:, 0:3] = tri_v[:, 0]
    tri_packed[:, 3:6] = tri_v[:, 1] - tri_v[:, 0]
    tri_packed[:, 6:9] = tri_v[:, 2] - tri_v[:, 0]
    tex_data, tex_off, tex_w, tex_h = pack_textures(desc.textures)
    mats = desc.materials if desc.materials else [HostMaterial()]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    tri_attr = np.concatenate(
        [tri_v.reshape(-1, 9), tri_n.reshape(-1, 9), tri_uv.reshape(-1, 6),
         material_ids.reshape(-1, 1).astype(np.float32)], axis=1)
    return Scene(
        n_area_lights=len(light_prims), has_env=has_env, has_aperture=has_aperture,
        single_sided=desc.settings.scene_light_single_sided,
        mat_types=tuple(sorted({mt.mtype for mt in mats})),
        env_tex=int(desc.env_tex_id), aperture_tex=int(desc.aperture_tex_id),
        tri_v=f32(tri_v), tri_attr=f32(tri_attr), tri_packed=f32(tri_packed),
        mat_type=i32([mt.mtype for mt in mats]),
        mat_base_color=f32([mt.base_color for mt in mats]),
        mat_metallic=f32([mt.metallic for mt in mats]),
        mat_roughness=f32([mt.roughness for mt in mats]),
        mat_ior=f32([mt.ior for mt in mats]),
        mat_color_map=i32([mt.color_map for mt in mats]),
        mat_normal_map=i32([mt.normal_map for mt in mats]),
        mat_metallic_map=i32([mt.metallic_map for mt in mats]),
        mat_roughness_map=i32([mt.roughness_map for mt in mats]),
        tex_data=f32(tex_data), tex_offset=i32(tex_off), tex_width=i32(tex_w),
        tex_height=i32(tex_h),
        light_prim_ids=i32(light_prims if light_prims else [0]),
        light_radiance=f32(np.asarray(light_radiance, np.float32).reshape(-1, 3)
                           if light_radiance else np.zeros((1, 3))),
        sum_light_power_inv=f32(sum_power_inv),
        light_alias_prob=f32(la_prob), light_alias_idx=i32(la_idx),
        env_alias_prob=f32(env_prob), env_alias_idx=i32(env_alias),
        aperture_alias_prob=f32(ap_prob), aperture_alias_idx=i32(ap_idx),
        sobol=sobol_table(device),
    )


def load_scene(path: str, device):
    """(Scene, Camera, SceneDesc) of the scene file at ``path``."""
    from .camera import make_camera
    from .parser import parse_scene

    desc = parse_scene(path)
    cam = make_camera(desc.width, desc.height, desc.cam_position, desc.cam_rotation,
                      fov_y=desc.fov_y, lens_radius=desc.lens_radius,
                      focal_dist=desc.focal_dist, device=device)
    return build_scene(desc, device), cam, desc
