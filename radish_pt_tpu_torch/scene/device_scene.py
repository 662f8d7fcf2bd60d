"""DeviceScene: the on-device scene as a dataclass of torch tensors.

Port of ``radish_pt_tpu/scene/device_scene.py`` (reference scene.h:73-518).
Where the reference is a ``flax.struct`` pytree of jnp arrays, the port is a
plain dataclass of tensors with ``.to(device)``; every "method" is a batched
function over [N] wavefront lanes.

Conventions (as in the reference):
* ``[N]`` wavefront lanes; ``[T]`` triangles in stored order (BVH leaf order,
  padded to whole culling clusters); ``[M]`` materials; ``[L]`` area lights
  (+1 alias slot for the env map, the last, when the scene has one).
* The env map's and the area lights' pdfs are the reference package's
  consistent ones: pdf_area = lum * 2pi / sumPower for an area light and
  lum * W * H / (sumPower * 2pi^2) for the env map.  The reference
  renderer drops the 1/pi^2 in ``environmentMapPdf`` (scene.h:374-378)
  but keeps it in ``sampleEnvironmentMap`` (scene.h:397-398); the JAX
  package uses the consistent form for NEE and MIS alike, and so does the
  port (a kept quirk of the reference package, not a fix of the port's).
* Lights emit into the half-space of their geometric normal when
  ``single_sided`` is set.

The intersection engine (``intersector``) is named by one of
:mod:`.engines`' names; :func:`intersect_ids` and :func:`test_occlusion`
call its record's closest hit and shadow test.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..accel import band as bnd
from ..accel import compact as cpt
from ..accel import plucker as plk
from ..accel import quad as qd
from ..accel import sort_key as sk
from ..sampling.alias import alias_sample
from ..utils import math as m
from ..utils import timing
from . import engines

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

# static (non-tensor) fields, shared with the JAX scene's metadata
META_FIELDS = ("intersector", "n_area_lights", "has_env", "has_aperture",
               "single_sided", "mat_types", "cluster_sub", "env_tex",
               "aperture_tex", "sort_primaries")


@dataclass
class DeviceScene:
    # --- static metadata ---
    intersector: str = "plucker"
    # the primaries are signature-sorted (intersect_primary): a sweep
    # engine with clusters (the reference's build.py:382-386)
    sort_primaries: bool = False
    n_area_lights: int = 0
    has_env: bool = False
    has_aperture: bool = False
    single_sided: bool = True
    mat_types: tuple = None  # MAT_* types present (None = evaluate all)
    # some material has a texture map (an image or the procedural colour,
    # a metallic, roughness or normal map); False: none is looked up
    textured: bool = True
    cluster_sub: int = 64  # triangles per culling cluster
    band_g: int = bnd.DEFAULT_G  # bands per 128-lane row (band engine)
    env_tex: int = NULL_TEXTURE
    aperture_tex: int = NULL_TEXTURE

    # --- geometry (stored order == winner ids) ---
    tri_v: torch.Tensor = None  # f32 [T, 3, 3]
    # [v0 v1 v2 (9) | n0 n1 n2 (9) | uv0 uv1 uv2 (6) | mat id (1)]
    tri_attr: torch.Tensor = None  # f32 [T, 25]
    tri_packed: torch.Tensor = None  # f32 [T, 9] v0, e1, e2 (brute engine)
    # the MTBVH walk's tables, kept for every engine (the heatmap reads
    # them): per direction class and node [bmin, bmax, leaf, miss] (ints
    # bit-cast), each leaf's L triangles (v0, e1, e2; zero padding), and
    # slot -> stored triangle id (-1 for padding)
    bvh_packed: torch.Tensor = None  # f32 [6B, 8]
    leaf_tris: torch.Tensor = None  # f32 [R, L*9]
    leaf_map: torch.Tensor = None  # i32 [R*L]
    cluster_bounds: torch.Tensor = None  # f32 [C, 6] or None (no culling)
    # the sort key's super-cluster boxes (accel/sort_key.py::key_boxes;
    # None without clusters)
    key_bounds: torch.Tensor = None  # f32 [C' <= 256, 6]
    # Plücker decision planes over features [d, o x d, o, 1] with o centred
    # on sweep_center: plane 0 det, 1 bx, 2 by, 3 t*det
    sweep_coeffs: torch.Tensor = None  # f32 [T, 4, 10]
    sweep_center: torch.Tensor = None  # f32 [3]
    # the planes' 19 live coefficients, 80 aligned bytes a triangle
    # (accel/plucker.py::numpy_packed_coeffs): the operand of the Plücker
    # kernels, the compact sweeps and the band sweeps
    sweep_packed: torch.Tensor = None  # f32 [T, 20]
    # bounding spheres of the compact engine's units, centred on
    # sweep_center (accel/compact.py::unit_spheres; None without clusters)
    unit_spheres: torch.Tensor = None  # f32 [U, 4]
    # per word of 32 clusters, the box of their boxes
    # (accel/band.py::word_bounds): the first level of the band sweeps'
    # vote (None without clusters)
    word_bounds: torch.Tensor = None  # f32 [W, 6]
    # quad engine: forms q1..q6 over the 27 ray monomials of
    # accel/quad.py::quad_features, the closest hit's 63 live coefficients
    # packed and the shadow sweep's 81 (None on the other engines)
    quad_coeffs: torch.Tensor = None  # f32 [T, 6, 28]
    quad_packed: torch.Tensor = None  # f32 [T, 64]
    quad_occl_packed: torch.Tensor = None  # f32 [T, 84]

    # --- materials SoA ---
    mat_type: torch.Tensor = None  # i32 [M]
    mat_base_color: torch.Tensor = None  # f32 [M, 3]
    mat_metallic: torch.Tensor = None  # f32 [M]
    mat_roughness: torch.Tensor = None  # f32 [M]
    mat_ior: torch.Tensor = None  # f32 [M]
    mat_color_map: torch.Tensor = None  # i32 [M]
    mat_normal_map: torch.Tensor = None  # i32 [M]
    mat_metallic_map: torch.Tensor = None  # i32 [M]
    mat_roughness_map: torch.Tensor = None  # i32 [M]

    # --- texture atlas ---
    tex_data: torch.Tensor = None  # f32 [P, 3]
    tex_offset: torch.Tensor = None  # i32 [K]
    tex_width: torch.Tensor = None  # i32 [K]
    tex_height: torch.Tensor = None  # i32 [K]

    # --- lights ---
    light_prim_ids: torch.Tensor = None  # i32 [L]
    light_radiance: torch.Tensor = None  # f32 [L, 3]
    sum_light_power_inv: torch.Tensor = None  # f32 scalar
    light_alias_prob: torch.Tensor = None  # f32 [L(+1 env)]
    light_alias_idx: torch.Tensor = None  # i32 [L(+1 env)]
    env_alias_prob: torch.Tensor = None  # f32 [envW*envH] (or [1])
    env_alias_idx: torch.Tensor = None  # i32
    aperture_alias_prob: torch.Tensor = None  # f32 [maskW*maskH] (or [1])
    aperture_alias_idx: torch.Tensor = None  # i32

    # --- sampler ---
    sobol: torch.Tensor = None  # int64 [SOBOL_NUM * SOBOL_DIM], u32 values

    @property
    def num_triangles(self) -> int:
        return self.tri_v.shape[0]

    @property
    def has_lights(self) -> bool:
        return self.n_area_lights > 0 or self.has_env

    @property
    def device(self) -> torch.device:
        return self.tri_attr.device

    def replace(self, **kw) -> "DeviceScene":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "DeviceScene":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def scene_from_jax(fields: dict, meta: dict, intersector: str | None = None,
                   device="cpu") -> DeviceScene:
    """The port's scene from a JAX ``DeviceScene`` whose array leaves were
    pulled to numpy (``fields``: name -> ndarray) and whose static fields
    are in ``meta`` — both packages then compute on identical scene bytes.
    It has a JAX scene to start from, so it runs only where JAX runs, the
    parity tests on a CPU: unlike the entry points, ``device`` defaults to
    ``"cpu"``.

    The JAX scene stores its Plücker planes M-stacked per cluster
    ([t_pad//sub, 4*sub, K]); f32 planes (K=10) are re-laid out to the
    port's [T, 4, 10], other layouts (bf16 splits, the quad engine's forms,
    the band engine's transposed table) are rebuilt in f32 from
    ``tri_packed`` (the port keeps no bf16 splits), and so are the quad
    engine's forms.  The BVH walk's tables (``bvh_packed``, ``leaf_tris``,
    ``leaf_map``) come across as they are.  The JAX engine maps to
    ``"compact"``, ``"quad"``, ``"band"`` and ``"dense"`` for
    ``pallas_compact``, ``pallas_quad``, ``pallas_band`` and
    ``pallas_brute``, to ``"plucker"`` for the other Pallas sweeps and to
    ``"brute"`` otherwise (the reference's BVH walk returns the brute-force
    winners); pass ``intersector`` to choose another (``"bvh"`` walks the
    JAX scene's own tables).
    """
    if intersector is None:
        engine = str(meta["intersector"])
        named = {"pallas_compact": "compact", "pallas_quad": "quad",
                 "pallas_band": "band", "pallas_brute": "dense"}
        intersector = named.get(engine, "plucker" if engine.startswith("pallas_")
                                else "brute")
    kw = {k: meta[k] for k in META_FIELDS if k != "intersector"}
    kw["mat_types"] = None if meta["mat_types"] is None else tuple(meta["mat_types"])
    kw["textured"] = any(
        bool(np.any(np.asarray(fields[f]) != NULL_TEXTURE))
        for f in ("mat_color_map", "mat_normal_map", "mat_metallic_map", "mat_roughness_map"))

    def t(name, dtype=None):
        a = fields.get(name)
        if a is None:
            return None
        a = np.asarray(a)
        if dtype is not None:
            a = a.astype(dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    tri_packed = np.asarray(fields["tri_packed"], np.float32)
    n_tris = tri_packed.shape[0]
    coeffs = fields.get("sweep_coeffs")
    if coeffs is not None and coeffs.shape[-1] == 10 and coeffs.dtype == np.float32:
        g = coeffs.shape[1] // 4
        coeffs = (np.asarray(coeffs).reshape(-1, 4, g, 10)
                  .transpose(0, 2, 1, 3).reshape(-1, 4, 10)[:n_tris])
        center = np.asarray(fields["sweep_center"], np.float32)
    else:
        coeffs, center = plk.numpy_coeffs(tri_packed)
    quad = quad_packed = quad_occl_packed = None
    if engines.get(intersector).forms:
        quad = qd.numpy_quad_coeffs(tri_packed, center)
        quad_packed = torch.from_numpy(qd.numpy_quad_packed(quad)).to(device)
        quad_occl_packed = torch.from_numpy(qd.numpy_quad_occl_packed(quad)).to(device)
        quad = torch.from_numpy(quad).to(device)
    bounds = t("cluster_bounds", np.float32)
    center_t = torch.from_numpy(center).to(device)
    return DeviceScene(
        intersector=intersector, **kw,
        tri_v=t("tri_v", np.float32),
        tri_attr=t("tri_attr", np.float32),
        tri_packed=t("tri_packed", np.float32),
        bvh_packed=t("bvh_packed", np.float32),
        leaf_tris=t("leaf_tris", np.float32),
        leaf_map=t("leaf_map", np.int32),
        cluster_bounds=bounds,
        key_bounds=(None if bounds is None else
                    torch.from_numpy(sk.key_boxes(fields["cluster_bounds"])).to(device)),
        sweep_coeffs=torch.from_numpy(np.ascontiguousarray(coeffs)).to(device),
        sweep_center=center_t,
        sweep_packed=torch.from_numpy(plk.numpy_packed_coeffs(coeffs)).to(device),
        unit_spheres=(None if bounds is None
                      else cpt.unit_spheres(bounds, center_t)),
        word_bounds=None if bounds is None else bnd.word_bounds(bounds),
        quad_coeffs=quad,
        quad_packed=quad_packed,
        quad_occl_packed=quad_occl_packed,
        mat_type=t("mat_type", np.int32),
        mat_base_color=t("mat_base_color", np.float32),
        mat_metallic=t("mat_metallic", np.float32),
        mat_roughness=t("mat_roughness", np.float32),
        mat_ior=t("mat_ior", np.float32),
        mat_color_map=t("mat_color_map", np.int32),
        mat_normal_map=t("mat_normal_map", np.int32),
        mat_metallic_map=t("mat_metallic_map", np.int32),
        mat_roughness_map=t("mat_roughness_map", np.int32),
        tex_data=t("tex_data", np.float32),
        tex_offset=t("tex_offset", np.int32),
        tex_width=t("tex_width", np.int32),
        tex_height=t("tex_height", np.int32),
        light_prim_ids=t("light_prim_ids", np.int32),
        light_radiance=t("light_radiance", np.float32),
        sum_light_power_inv=t("sum_light_power_inv", np.float32),
        light_alias_prob=t("light_alias_prob", np.float32),
        light_alias_idx=t("light_alias_idx", np.int32),
        env_alias_prob=t("env_alias_prob", np.float32),
        env_alias_idx=t("env_alias_idx", np.int32),
        aperture_alias_prob=t("aperture_alias_prob", np.float32),
        aperture_alias_idx=t("aperture_alias_idx", np.int32),
        sobol=t("sobol", np.int64),
    )


# ---------------------------------------------------------------------------
# textures
# ---------------------------------------------------------------------------


def _texture_bilinear(ds: DeviceScene, tex_id, uv):
    """Bilinear texture fetch with wraparound — DevTextureObj::linearSample
    (image.h:42-73).  ``tex_id`` int [N] (must be valid), uv f32 [N, 2]."""
    w = ds.tex_width[tex_id]
    h = ds.tex_height[tex_id]
    off = ds.tex_offset[tex_id]
    fx = uv[..., 0] * w.to(torch.float32) - 0.5
    fy = uv[..., 1] * h.to(torch.float32) - 0.5
    ix = torch.floor(fx).to(torch.int32)
    iy = torch.floor(fy).to(torch.int32)
    tx = fx - ix.to(torch.float32)
    ty = fy - iy.to(torch.float32)

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


# ---------------------------------------------------------------------------
# surface interaction
# ---------------------------------------------------------------------------


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


def surface_info(ds: DeviceScene, prim_id, bary) -> tuple:
    """Interpolate position/normal/uv from barycentrics (scene.h:147-165).
    Also returns mat_id (f32 col 24, exact), -1 where prim_id < 0.  Part of
    the plain version of csrc/surface.cu (render/surface.py)."""
    a = _rows(ds.tri_attr, prim_id)
    bx = bary[..., 0:1]
    by = bary[..., 1:2]
    bw = 1.0 - bx - by
    pos = a[:, 3:6] * bx + a[:, 6:9] * by + a[:, 0:3] * bw
    norm = m.normalize(a[:, 12:15] * bx + a[:, 15:18] * by + a[:, 9:12] * bw)
    uvi = a[:, 20:22] * bx + a[:, 22:24] * by + a[:, 18:20] * bw
    mat_id = torch.where(prim_id >= 0, a[:, 24].to(torch.int32), -1)
    return pos, norm, uvi, mat_id


def surface_info_from_t(ds: DeviceScene, prim_id, ray_o, ray_d):
    """Position/normal/uv from the winning PRIMITIVE id (Plücker engines).

    The sweep's ``dist`` is selector-grade only; the winner id is robust, so
    the exact distance is recomputed here from the gathered triangle row via
    the ray-plane form t = (v0-o)·n / (d·n), and barycentrics by projecting
    onto the edge basis.  Part of the plain version of csrc/surface.cu
    (render/surface.py).
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


def intersect_ids(ds: DeviceScene, ray_o, ray_d, active=None):
    """Closest hit without surface recovery: (prim i32 [N], bary f32 [N, 2]
    | None), from the scene's engine (``intersect_ids``, reference
    :490-519).  The sweep engines return no barycentrics (their
    surface comes from the winner id, :func:`surface_info_from_t`); the
    dense, bvh and brute engines return theirs.

    ``active`` (bool [N], optional): lanes marked False are DEAD — the
    sweeps' culling gets ``tmax = -FLT_MAX`` for them so they flag no
    clusters, and the BVH walks the same range, so they are settled as
    misses without a walk — and return prim_id -1."""
    prim, bary = engines.of(ds).closest_hit(ds, ray_o, ray_d, active)
    if active is not None:
        prim = torch.where(active, prim, -1)
    return prim, bary


def surface_from_ids(ds: DeviceScene, prim, bary, ray_o, ray_d):
    """Surface recovery for :func:`intersect_ids` winners, the engine's own:
    from the winner id on the sweep engines (``bary`` None), by
    interpolation elsewhere.  Returns (pos, norm, uv, mat_id)."""
    if bary is None:
        return surface_info_from_t(ds, prim, ray_o, ray_d)
    return surface_info(ds, prim, bary)


def _interaction(ds: DeviceScene, prim, bary, ray_o, ray_d) -> Interaction:
    """The winners ``prim`` (``bary``) of the rays with their surface
    (:func:`surface_from_ids`)."""
    pos, norm, uv, mat_id = surface_from_ids(ds, prim, bary, ray_o, ray_d)
    return Interaction(prim_id=prim, mat_id=mat_id, pos=pos, norm=norm, uv=uv)


def intersect(ds: DeviceScene, ray_o, ray_d, active=None) -> Interaction:
    """Closest hit + surface interpolation (DevScene::intersect,
    scene.h:262-301), dispatched on the scene's engine; ``active`` as
    :func:`intersect_ids`.  Nothing reads a dead lane's pos / norm / uv
    (the path tracer masks them), which differ by engine.
    """
    return _interaction(ds, *intersect_ids(ds, ray_o, ray_d, active), ray_o, ray_d)


def _sort_key(ds: DeviceScene, ray_o, ray_d, tmax=None, active=None):
    """The wavefront's sort key (reference ``_sort_key`` :547): the rays'
    cluster signatures against the scene's super-cluster boxes
    (``key_bounds``), count-major on the band engine, with
    ``sk.DEAD_KEY_BIT`` on the lanes ``active`` marks dead
    (:mod:`radish_pt_tpu_torch.accel.sort_key`: the kernel on the card)."""
    eng = engines.of(ds)
    return sk.signature_key(ds.key_bounds, ray_o, ray_d, tmax, active,
                            band=eng.group == "band", plain=eng.plain)


def _scatter(order, sorted_vals):
    """``sorted_vals`` put back in lane order: out[order[j]] = sorted_vals[j]."""
    return torch.empty_like(sorted_vals).index_copy_(0, order, sorted_vals)


def lane_order(key, lane=None):
    """The permutation that sorts lanes on (``key``, lane id): a stable
    sort of ``key`` when the lanes are in lane order (``lane`` None), else
    one sort of the composite (key << 32) | lane."""
    if lane is None:
        return torch.sort(key, stable=True)[1]
    return torch.sort((key.to(torch.int64) << 32) | lane)[1]


def intersect_sorted_ids(ds: DeviceScene, ray_o, ray_d, active=None):
    """Closest hit of a divergent wavefront (bounce rays; reference
    :354-438) without surface recovery: the rays sorted on (cluster
    signature, lane id), dead lanes (the key's dead bit) last, swept in
    that order by the engine (dead lanes get ``tmax = -FLT_MAX`` and flag
    no cluster), the winners put back in lane order by a scatter on the
    lane ids.  Returns :func:`intersect_ids`' (prim, bary | None) in lane
    order.  Each lane's math is :func:`intersect_ids`'; the sweeps cull per
    group of lanes, and a ray that grazes a cluster's box gets the winner
    its group's flags allow, so it may differ from the unsorted sweep's.
    The live lanes in (key, lane) order are the sliced bounce loop's order
    too, so both loops give every lane the same bits.  A scene without
    clusters has no key: :func:`intersect_ids` as it is.

    Tracing: counter ``isect.sorted_wavefronts``; the reordering, the key
    through the gathers and then the scatter, between the inner marks
    ``reorder`` and ``reorder_end`` (utils/timing.py)."""
    if ds.cluster_bounds is None:
        return intersect_ids(ds, ray_o, ray_d, active)
    timing.count("isect.sorted_wavefronts")
    timing.mark("reorder", ds.device)
    order = lane_order(_sort_key(ds, ray_o, ray_d, active=active))
    act_s = None if active is None else active.index_select(0, order)
    o_s, d_s = ray_o.index_select(0, order), ray_d.index_select(0, order)
    timing.mark("reorder_end", ds.device)
    prim_s, bary_s = intersect_ids(ds, o_s, d_s, act_s)
    timing.mark("reorder", ds.device)
    prim = _scatter(order, prim_s)
    bary = None if bary_s is None else _scatter(order, bary_s)
    timing.mark("reorder_end", ds.device)
    return prim, bary


def intersect_sorted(ds: DeviceScene, ray_o, ray_d, active=None) -> Interaction:
    """:func:`intersect_sorted_ids` and the surface recovered in lane
    order (:func:`surface_from_ids`)."""
    return _interaction(ds, *intersect_sorted_ids(ds, ray_o, ray_d, active), ray_o, ray_d)


def intersect_primary_ids(ds: DeviceScene, ray_o, ray_d):
    """The primaries' closest hit without surface recovery:
    signature-sorted when the scene has ``sort_primaries`` (a sweep engine
    with clusters), :func:`intersect_ids` otherwise (reference
    :641-647)."""
    if ds.sort_primaries:
        return intersect_sorted_ids(ds, ray_o, ray_d)
    return intersect_ids(ds, ray_o, ray_d)


def intersect_primary(ds: DeviceScene, ray_o, ray_d) -> Interaction:
    """:func:`intersect_primary_ids` and the surface recovered
    (:func:`surface_from_ids`)."""
    return _interaction(ds, *intersect_primary_ids(ds, ray_o, ray_d), ray_o, ray_d)


def test_occlusion_sorted(ds: DeviceScene, x, y, mask=None, lane=None):
    """:func:`test_occlusion` of a divergent shadow wavefront, the segments
    sorted on their signature bounded at the segment's end (``tmax`` 1 on
    the unnormalised segment); the bits are put back in lane order
    (reference :650-681).  ``mask``: lanes marked False are not blocked;
    they sort last.

    The sweeps cull per group of lanes (a warp, a band, a row), and a
    segment that grazes a cluster's box gets the bits its group's flags
    allow, so which segments share a group is part of the result.  The
    segments go in the order of (key, lane id) (``lane``: each segment's
    lane id; None for lanes in lane order), and a masked lane becomes a
    zero-length segment beyond every cluster box, which flags no cluster:
    a segment then shares its group with the same segments whatever else
    the wavefront holds, and gets the same bit.  Tracing as
    :func:`intersect_sorted`'s."""
    if ds.cluster_bounds is None:
        if mask is not None:
            y = torch.where(mask[..., None], y, x)
        occ = test_occlusion(ds, x, y)
    else:
        if mask is not None:
            far = ds.key_bounds[:, 3:6].amax(0) + 1.0
            x = torch.where(mask[..., None], x, far)
            y = torch.where(mask[..., None], y, far)
        timing.count("isect.sorted_wavefronts")
        timing.mark("reorder", ds.device)
        order = lane_order(_sort_key(ds, x, y - x, tmax=1.0, active=mask), lane)
        x_s, y_s = x.index_select(0, order), y.index_select(0, order)
        timing.mark("reorder_end", ds.device)
        occ_s = test_occlusion(ds, x_s, y_s)
        timing.mark("reorder", ds.device)
        occ = _scatter(order, occ_s)
        timing.mark("reorder_end", ds.device)
    return occ if mask is None else occ & mask


test_occlusion_sorted.__test__ = False  # a scene function, not a pytest test


def test_occlusion(ds: DeviceScene, x, y):
    """True where segment x->y is blocked (testOcclusion, scene.h:303-334)."""
    return engines.of(ds).occlusion(ds, x, y)

test_occlusion.__test__ = False  # a scene function, not a pytest test


def get_textured_material(ds: DeviceScene, mat_id, uv, norm):
    """Fetch material params with texture/normal maps applied
    (getTexturedMaterialAndSurface, scene.h:88-112).  Part of the plain
    version of csrc/surface.cu (render/surface.py).

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


def env_radiance(ds: DeviceScene, dir):
    """Env-map radiance for a direction (equirect, bilinear;
    pathtrace.cu:233-236); zero without an env map."""
    if not ds.has_env:
        return torch.zeros_like(dir)
    tex_id = torch.full(dir.shape[:-1], ds.env_tex, dtype=torch.int32,
                        device=dir.device)
    return _texture_bilinear(ds, tex_id, m.to_plane(dir))


def _env_pdf(ds: DeviceScene, radiance):
    """The env sampler's solid-angle pdf for a texel of ``radiance``:
    lum * W * H / (sumPower * 2pi^2), the consistent form (module
    docstring)."""
    w = ds.tex_width[ds.env_tex].to(torch.float32)
    h = ds.tex_height[ds.env_tex].to(torch.float32)
    return (m.luminance(radiance) * ds.sum_light_power_inv * w * h
            * (m.INV_PI * m.INV_PI) * 0.5)


def env_map_pdf(ds: DeviceScene, wi):
    """Solid-angle pdf of the env-map light sampler in direction ``wi``
    (``environmentMapPdf``, scene.h:374-378, in the consistent form)."""
    return _env_pdf(ds, env_radiance(ds, wi))


def _sample_env_map(ds: DeviceScene, r2):
    """Alias-sample the env map (sampleEnvMapNoVisbility, scene.h:401-414):
    returns (radiance [N, 3], wi [N, 3], pdf_solid_angle [N]) at the
    centre of the chosen texel."""
    pix = alias_sample(ds.env_alias_prob, ds.env_alias_idx, r2[..., 0], r2[..., 1])
    w = ds.tex_width[ds.env_tex]
    h = ds.tex_height[ds.env_tex]
    y = pix // w
    x = pix - y * w
    radiance = ds.tex_data[(ds.tex_offset[ds.env_tex] + pix).long()]
    uv = torch.stack([(x.to(torch.float32) + 0.5) / w.to(torch.float32),
                      (y.to(torch.float32) + 0.5) / h.to(torch.float32)], dim=-1)
    return radiance, m.to_sphere(uv), _env_pdf(ds, radiance)


# ---------------------------------------------------------------------------
# direct-light sampling
# ---------------------------------------------------------------------------


def sample_direct_light_no_vis(ds: DeviceScene, pos, r4):
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


def sample_direct_light(ds: DeviceScene, pos, r4, mask=None, shade_normal=None):
    """Light sample WITH a shadow test (sampleDirectLight, scene.h:419-456).
    Returns (radiance, wi, pdf); pdf <= 0 when invalid or occluded.

    Lanes that cannot use the sample (``mask`` False, or the sample below
    the horizon of ``shade_normal``) are masked in the shadow test, which
    is :func:`test_occlusion_sorted` on lanes in lane order; their pdf is
    invalid."""
    radiance, wi, dist, pdf = sample_direct_light_no_vis(ds, pos, r4)
    ok = pdf > 0.0
    if mask is not None:
        ok = ok & mask
    if shade_normal is not None:
        ok = ok & (m.dot(shade_normal, wi) > 0.0)
    occ = test_occlusion_sorted(ds, pos, pos + wi * dist[..., None], mask=ok)
    pdf = torch.where(ok & ~occ, pdf, torch.full_like(pdf, INVALID_PDF))
    return radiance, wi, pdf


def area_light_hit_pdf(ds: DeviceScene, radiance, prev_pos, hit_pos, hit_norm):
    """Solid-angle pdf NEE would assign to an emissive hit — the MIS weight
    of BSDF paths (pathtrace.cu:260-268)."""
    pdf_area = m.luminance(radiance) * (2.0 * m.PI) * ds.sum_light_power_inv
    return m.pdf_area_to_solid_angle(pdf_area, prev_pos, hit_pos, hit_norm)


# ---------------------------------------------------------------------------
# host-side assembly helper
# ---------------------------------------------------------------------------


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
