"""Host-side scene build: flatten instances, extract lights, build alias
tables, BVH leaf order and culling clusters, and assemble the
:class:`DeviceScene`.

Port of ``radish_pt_tpu/scene/build.py`` in numpy, producing the layout of
the reference's ``pallas_mxu`` engine (build.py:296-416) or, for the
compact, quad and band engines, of its ``pallas_compact``, ``pallas_quad``
and ``pallas_band`` engines:

* triangles stored in BVH leaf (DFS) order, so a winner's position in the
  stored table IS its primitive id;
* above 1024 triangles (always, for the compact engine; the band engine
  refuses smaller scenes), area-optimal cluster cuts of at most
  ``cluster_sub_for(T)`` triangles (the Plücker and quad engines; 64 for
  the compact and band engines), each padded to a whole cluster of slots
  with zero triangles (which never hit), with per-cluster AABBs for the
  culling prepass and the light ids remapped through the padding;
* the Plücker planes of every stored triangle, in f32, centred on the
  scene (accel/plucker.py), and for the quad engine its quadratic forms
  (accel/quad.py);
* for every engine, the BVH walk's tables (build.py:416-422): the packed
  node table, the leaf-major triangles and the leaf slot map, its ids
  mapped through the storage order and the cluster padding, so a slot
  names its stored triangle (the ``"bvh"`` engine walks them; the
  heatmap tracer reads them whatever the engine).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..accel.band import word_bounds
from ..accel.bvh import build_bvh
from ..accel.compact import unit_spheres
from ..accel.plucker import numpy_coeffs, numpy_packed_coeffs
from ..accel.quad import numpy_quad_coeffs, numpy_quad_occl_packed, numpy_quad_packed
from ..accel.sort_key import key_boxes
from ..accel.traverse import pack_bvh, pack_tris
from ..sampling.alias import build_alias_table
from ..sampling.sobol import load_sobol_table
from ..utils import timing
from . import engines
from .camera import Camera, make_camera
from .device_scene import MAT_LIGHT, NULL_TEXTURE, DeviceScene, pack_textures
from .parser import SceneDesc

CLUSTER_SUB = 64  # default triangles per culling cluster
BIG_SCENE_TRIS = 16384
PLUCKER_MAX_TRIS = 131072  # above this the reference switches engines
CLUSTER_MIN_TRIS = 1024  # below this every ray sweeps every triangle


def choose_intersector(num_tris: int, intersector: str | None = None) -> str:
    """The engine for a scene: ``intersector`` if given, else the Plücker
    sweeps up to ``PLUCKER_MAX_TRIS`` triangles and the compact work-list
    engine above (the reference's choice, build.py:281-290; the quad, band,
    dense and bvh engines are only ever chosen by name)."""
    if intersector is None:
        return "plucker" if num_tris <= PLUCKER_MAX_TRIS else "compact"
    if intersector not in engines.NAMES:
        raise ValueError(f"unknown intersector {intersector!r}; "
                         f"choose from {engines.NAMES}")
    return intersector


def cluster_sub_for(num_tris: int) -> int:
    """Per-scene culling-cluster size (the reference's ``cluster_sub_for``,
    pallas_kernels.py:2153): 128 up to 6144 triangles, 64 for mid scenes,
    512 for big ones."""
    if BIG_SCENE_TRIS < num_tris <= PLUCKER_MAX_TRIS:
        return 512
    if num_tris <= 6144:
        return 128
    return CLUSTER_SUB


def _luminance_np(c: np.ndarray) -> np.ndarray:
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _box_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 0] * d[..., 2])


def _cluster_lambda(pmin: np.ndarray, pmax: np.ndarray, lam_frac: float):
    """The cuts' cost a cluster: ``lam_frac`` of the scene box's area."""
    return lam_frac * _box_area(pmin.min(axis=0), pmax.max(axis=0))


def _cluster_cuts(pmin: np.ndarray, pmax: np.ndarray, sub: int = 64,
                  lam_frac: float = 0.005, chunk: int = 4096) -> np.ndarray:
    """Area-optimal segmentation of the leaf-ordered triangles into culling
    clusters of <= ``sub`` triangles: the native C++ DP
    (``radish_pt_tpu_torch/native``), equal to :func:`_cluster_cuts_numpy`
    cut for cut; ``RADISH_NATIVE=0`` selects the numpy DP.  Returns the cut
    positions, int64 [n_segments + 1] from 0 to T."""
    if native.enabled():
        return native.cluster_cuts(pmin, pmax, sub, _cluster_lambda(pmin, pmax, lam_frac),
                                   chunk)
    return _cluster_cuts_numpy(pmin, pmax, sub, lam_frac, chunk)


def _cluster_cuts_numpy(pmin: np.ndarray, pmax: np.ndarray, sub: int = 64,
                        lam_frac: float = 0.005, chunk: int = 4096) -> np.ndarray:
    """The numpy DP of the reference's ``_cluster_cuts`` (build.py:97):
    minimizes sum(segment AABB area) + lambda * n_segments over windows of
    ``sub``, exactly per ``chunk``, the last chunk padded to a whole one."""
    T = pmin.shape[0]
    lam = _cluster_lambda(pmin, pmax, lam_frac)

    n_chunks = -(-T // chunk)
    T_pad = n_chunks * chunk
    # pad with copies of the last triangle: zero extra area, cut dropped
    pmin_p = np.concatenate([pmin, np.repeat(pmin[-1:], T_pad - T, axis=0)])
    pmax_p = np.concatenate([pmax, np.repeat(pmax[-1:], T_pad - T, axis=0)])

    # A_k[k, i] = area of (i-k .. i), window boxes by running min/max
    lo = pmin_p.copy()
    hi = pmax_p.copy()
    A_k = np.empty((sub, T_pad), np.float32)
    A_k[0] = _box_area(lo, hi)
    for k in range(1, sub):
        lo[k:] = np.minimum(lo[k:], pmin_p[:-k])
        hi[k:] = np.maximum(hi[k:], pmax_p[:-k])
        A_k[k] = _box_area(lo, hi)
    A_k = A_k.reshape(sub, n_chunks, chunk)

    ks = np.arange(sub)
    cost = np.zeros((n_chunks, chunk + 1), np.float32)
    back = np.zeros((n_chunks, chunk + 1), np.int32)
    rows = np.arange(n_chunks)
    for i in range(chunk):
        kmax = min(sub, i + 1)
        c = cost[:, i - ks[:kmax]] + A_k[:kmax, :, i].T + lam
        b = np.argmin(c, axis=1)
        cost[:, i + 1] = c[rows, b]
        back[:, i + 1] = i - b  # segment start (within chunk)

    cuts = []
    for ci in range(n_chunks):
        base = ci * chunk
        i = chunk
        cc = []
        while i > 0:
            cc.append(base + i)
            i = back[ci, i]
        cuts.extend(cc[::-1])
    cuts = np.asarray([0] + cuts, np.int64)
    return np.unique(np.minimum(cuts, T))  # drop padded-tail cut points


def build_device_scene(scene: SceneDesc, use_sobol: bool = True,
                       device="cuda", intersector: str | None = None
                       ) -> tuple[DeviceScene, Camera]:
    """Build the device scene + camera from a parsed scene.  ``intersector``
    names the engine (see :func:`choose_intersector`; None: by size)."""
    verts, norms, uvs, mat_ids = [], [], [], []
    light_prims, light_radiance, light_power = [], [], []

    prim_base = 0
    for inst in scene.instances:
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

        mat = scene.materials[inst.material_id]
        if mat.mtype == MAT_LIGHT:
            # every light triangle is an emitter record (scene.cpp:204-219)
            tv = v.reshape(-1, 3, 3)
            area = np.linalg.norm(
                np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=-1
            ) * 0.5
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
    num_tris = tri_v.shape[0]
    intersector = choose_intersector(num_tris, intersector)
    eng = engines.get(intersector)
    if eng.group == "band" and num_tris <= CLUSTER_MIN_TRIS:
        raise ValueError(
            f"the band engine needs culling clusters, which the reference "
            f"builds only above {CLUSTER_MIN_TRIS} triangles; this scene has "
            f"{num_tris}")

    # ---- light + env samplers (createLightSampler, scene.cpp:145-169) ----
    # the env map's total goes last among the light weights: light id
    # ``n_area_lights`` is the env slot
    has_env = scene.env_tex_id != NULL_TEXTURE
    env_prob = np.ones(1, np.float32)
    env_alias = np.zeros(1, np.int32)
    light_weights = list(light_power)
    if has_env:
        env_img = scene.textures[scene.env_tex_id]
        h = env_img.shape[0]
        sin_theta = np.sin((0.5 + np.arange(h)) / h * np.pi).astype(np.float32)
        env_table = build_alias_table(
            (_luminance_np(env_img) * sin_theta[:, None]).reshape(-1))
        env_prob, env_alias = env_table.prob, env_table.alias
        light_weights.append(env_table.total)

    n_area_lights = len(light_prims)
    if light_weights:
        light_table = build_alias_table(np.asarray(light_weights, np.float64))
        sum_power_inv = 1.0 / max(light_table.total, 1e-12)
        la_prob, la_idx = light_table.prob, light_table.alias
    else:
        sum_power_inv = 0.0
        la_prob = np.ones(1, np.float32)
        la_idx = np.zeros(1, np.int32)

    # ---- aperture sampler (createApertureSampler, scene.cpp:171-188) ----
    has_aperture = scene.aperture_tex_id != NULL_TEXTURE
    ap_prob = np.ones(1, np.float32)
    ap_idx = np.zeros(1, np.int32)
    if has_aperture:
        ap_table = build_alias_table(
            _luminance_np(scene.textures[scene.aperture_tex_id]).reshape(-1))
        ap_prob, ap_idx = ap_table.prob, ap_table.alias

    # ---- storage order: BVH leaf (DFS) order ----
    with timing.span("setup.bvh"):
        bvh = build_bvh(tri_v.reshape(-1, 3))
    lm = np.asarray(bvh.leaf_map)
    tri_order = lm[lm >= 0].astype(np.int32)
    assert tri_order.size == num_tris, "leaf_map must cover every triangle"
    inv_order = np.empty_like(tri_order)
    inv_order[tri_order] = np.arange(num_tris, dtype=np.int32)
    tri_v = tri_v[tri_order]
    tri_n = tri_n[tri_order]
    tri_uv = tri_uv[tri_order]
    material_ids = material_ids[tri_order]
    light_prims = [int(inv_order[p]) for p in light_prims]
    leaf_map = np.where(lm >= 0, inv_order[np.clip(lm, 0, None)], lm)

    # ---- culling clusters, each padded to ``csub`` slots ----
    # (the compact engine's work list is its cull: it always has clusters;
    # it, the band engine and the bvh engine take the fixed 64-triangle
    # size, as the reference's build.py:321-327)
    cluster_bounds = None
    csub = CLUSTER_SUB
    if num_tris > CLUSTER_MIN_TRIS or eng.prepass == "work list":
        csub = CLUSTER_SUB if eng.fixed_clusters else cluster_sub_for(num_tris)
        cuts = _cluster_cuts(tri_v.min(axis=1).astype(np.float32),
                             tri_v.max(axis=1).astype(np.float32), sub=csub)
        n_clusters = cuts.size - 1
        t_pad = n_clusters * csub
        slot_of_pos = np.empty(num_tris, np.int32)
        cb = np.empty((n_clusters, 6), np.float32)
        for ci in range(n_clusters):
            a, b = int(cuts[ci]), int(cuts[ci + 1])
            slot_of_pos[a:b] = ci * csub + np.arange(b - a)
            g = tri_v[a:b].reshape(-1, 3)
            cb[ci, 0:3] = g.min(axis=0)
            cb[ci, 3:6] = g.max(axis=0)
        cluster_bounds = cb

        def _pad(arr):
            out = np.zeros((t_pad,) + arr.shape[1:], arr.dtype)
            out[slot_of_pos] = arr
            return out

        tri_v = _pad(tri_v)
        tri_n = _pad(tri_n)
        tri_uv = _pad(tri_uv)
        material_ids = _pad(material_ids)
        light_prims = [int(slot_of_pos[p]) for p in light_prims]
        leaf_map = np.where(leaf_map >= 0, slot_of_pos[np.clip(leaf_map, 0, None)],
                            leaf_map)

    tri_packed = pack_tris(tri_v)
    coeffs, center = numpy_coeffs(tri_packed)
    quad = numpy_quad_coeffs(tri_packed, center) if eng.forms else None
    tex_data, tex_off, tex_w, tex_h = pack_textures(scene.textures)

    from .parser import HostMaterial

    mats = scene.materials if scene.materials else [HostMaterial()]

    with timing.span("setup.sobol"):
        sobol = load_sobol_table().astype(np.int64) if use_sobol else None

    def upload(a):  # a copy from pageable host memory: the host waits
        timing.host_sync()
        return torch.as_tensor(a, device=device)

    def f32(a):
        return upload(np.asarray(a, np.float32))

    def i32(a):
        return upload(np.asarray(a, np.int32))

    tri_attr = np.concatenate(
        [tri_v.reshape(-1, 9), tri_n.reshape(-1, 9), tri_uv.reshape(-1, 6),
         # material id as f32 col 24 (exact to 2^24)
         material_ids.reshape(-1, 1).astype(np.float32)], axis=1)
    with timing.span("setup.upload"):
        bounds = None if cluster_bounds is None else f32(cluster_bounds)
        ds = DeviceScene(
            intersector=intersector,
            # the primaries sort on their cluster signature on a sweep engine
            # with clusters (build.py:382-386)
            sort_primaries=eng.sweep and cluster_bounds is not None,
            n_area_lights=n_area_lights,
            has_env=has_env,
            has_aperture=has_aperture,
            single_sided=scene.settings.scene_light_single_sided,
            mat_types=tuple(sorted({m.mtype for m in mats})),
            textured=any(t != NULL_TEXTURE for m in mats for t in (
                m.color_map, m.normal_map, m.metallic_map, m.roughness_map)),
            cluster_sub=csub,
            env_tex=int(scene.env_tex_id),
            aperture_tex=int(scene.aperture_tex_id),
            tri_v=f32(tri_v),
            tri_attr=f32(tri_attr),
            tri_packed=f32(tri_packed),
            bvh_packed=f32(pack_bvh(bvh)),
            leaf_tris=f32(bvh.leaf_tris),
            leaf_map=i32(leaf_map),
            cluster_bounds=bounds,
            key_bounds=None if bounds is None else f32(key_boxes(cluster_bounds)),
            sweep_coeffs=f32(coeffs),
            sweep_center=f32(center),
            sweep_packed=f32(numpy_packed_coeffs(coeffs)),
            unit_spheres=None if bounds is None else unit_spheres(bounds, f32(center)),
            word_bounds=None if bounds is None else word_bounds(bounds),
            quad_coeffs=None if quad is None else f32(quad),
            quad_packed=None if quad is None else f32(numpy_quad_packed(quad)),
            quad_occl_packed=None if quad is None else f32(numpy_quad_occl_packed(quad)),
            mat_type=i32([m.mtype for m in mats]),
            mat_base_color=f32([m.base_color for m in mats]),
            mat_metallic=f32([m.metallic for m in mats]),
            mat_roughness=f32([m.roughness for m in mats]),
            mat_ior=f32([m.ior for m in mats]),
            mat_color_map=i32([m.color_map for m in mats]),
            mat_normal_map=i32([m.normal_map for m in mats]),
            mat_metallic_map=i32([m.metallic_map for m in mats]),
            mat_roughness_map=i32([m.roughness_map for m in mats]),
            tex_data=f32(tex_data),
            tex_offset=i32(tex_off),
            tex_width=i32(tex_w),
            tex_height=i32(tex_h),
            light_prim_ids=i32(light_prims if light_prims else [0]),
            light_radiance=f32(np.asarray(light_radiance, np.float32).reshape(-1, 3)
                               if light_radiance else np.zeros((1, 3))),
            sum_light_power_inv=f32(sum_power_inv),
            light_alias_prob=f32(la_prob),
            light_alias_idx=i32(la_idx),
            env_alias_prob=f32(env_prob),
            env_alias_idx=i32(env_alias),
            aperture_alias_prob=f32(ap_prob),
            aperture_alias_idx=i32(ap_idx),
            sobol=None if sobol is None else upload(sobol),
        )
        cam = make_camera(scene.width, scene.height, scene.cam_position,
                          scene.cam_rotation, fov_y=scene.fov_y,
                          lens_radius=scene.lens_radius,
                          focal_dist=scene.focal_dist, device=device)
    return ds, cam


def load_scene(path: str, device="cuda", intersector: str | None = None):
    """Parse + build in one call; returns (DeviceScene, Camera, SceneDesc).
    ``intersector`` as :func:`build_device_scene`."""
    from .parser import parse_scene

    with timing.span("setup.load_scene"):
        with timing.span("setup.parse"):
            desc = parse_scene(path)
        ds, cam = build_device_scene(desc, use_sobol=desc.settings.use_sobol,
                                     device=device, intersector=intersector)
    return ds, cam, desc
