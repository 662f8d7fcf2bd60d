"""Port parity: scene build, camera rays, surface recovery, materials and
light sampling (radish_pt_tpu_torch vs radish_pt_tpu on the same bytes)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_port_util import SCENES, jax_scene_parts, load_jax_scene, t2n  # noqa: E402

SCENE_FILES = {"cornell": "cornell_box.txt", "teapot": "teapot.txt"}


@pytest.fixture(scope="module")
def scenes():
    """(jax ds, jax cam, port ds, port cam) per scene; the JAX side is the
    reference's own pallas_mxu build."""
    from radish_pt_tpu_torch.scene.build import load_scene

    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for key, fname in SCENE_FILES.items():
            jds, jcam, _ = load_jax_scene(mp, fname)
            tds, tcam, _ = load_scene(os.path.join(SCENES, fname), device="cpu")
            out[key] = (jds, jcam, tds, tcam)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name,textured", [("cornell", False), ("teapot", True)])
def test_textured_flag_from_jax_scene(scenes, name, textured):
    """``scene_from_jax`` derives the static ``textured`` flag from the
    material maps as the port's build does: cornell has none, teapot's
    floor is procedural."""
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    jds, _, tds, _ = scenes[name]
    assert tds.textured is textured
    assert scene_from_jax(*jax_scene_parts(jds)).textured is textured


def _jax_f32_planes(jds):
    """The reference's f32 planes for jds in the port's [T, 4, 10] layout
    (its bf16x3 build of small scenes re-derived in f32 by its own code)."""
    from radish_pt_tpu.accel import pallas_kernels as pk

    tp = jnp.asarray(jds.tri_packed)
    n = tp.shape[0]
    c = pk._plucker_coeffs(tp, jds.sweep_center, jnp.arange(n))[0:4]
    return np.asarray(c).transpose(1, 0, 2)


@pytest.mark.parametrize("name", ["cornell", "teapot"])
def test_load_scene_matches_reference(scenes, name):
    jds, jcam, tds, tcam = scenes[name]
    assert tds.intersector == "plucker" and jds.intersector == "pallas_mxu"
    for k in ("n_area_lights", "single_sided", "mat_types", "cluster_sub",
              "has_env", "has_aperture"):
        assert getattr(tds, k) == getattr(jds, k), k
    ints = ("mat_type", "mat_color_map", "mat_normal_map", "mat_metallic_map",
            "mat_roughness_map", "tex_offset", "tex_width", "tex_height",
            "light_prim_ids", "light_alias_idx")
    for k in ints:
        np.testing.assert_array_equal(t2n(getattr(tds, k)),
                                      np.asarray(getattr(jds, k)), err_msg=k)
    np.testing.assert_array_equal(t2n(tds.sobol).astype(np.uint32),
                                  np.asarray(jds.sobol))
    floats = ("tri_v", "tri_attr", "tri_packed", "mat_base_color",
              "mat_metallic", "mat_roughness", "mat_ior", "tex_data",
              "light_radiance", "sum_light_power_inv", "light_alias_prob",
              "sweep_center")
    for k in floats:
        np.testing.assert_allclose(t2n(getattr(tds, k)),
                                   np.asarray(getattr(jds, k)),
                                   rtol=1e-6, err_msg=k)
    if name == "teapot":
        np.testing.assert_allclose(t2n(tds.cluster_bounds),
                                   np.asarray(jds.cluster_bounds), rtol=1e-6)
        # the reference stores f32 planes M-stacked per cluster, padded to
        # whole 512-triangle chunks with zero planes
        c = np.asarray(jds.sweep_coeffs)
        sub = tds.cluster_sub
        c = c.reshape(-1, 4, sub, 10).transpose(0, 2, 1, 3).reshape(-1, 4, 10)
        t = tds.num_triangles
        assert c.dtype == np.float32 and not c[t:].any()
        want = c[:t]
    else:
        assert tds.cluster_bounds is None and jds.cluster_bounds is None
        want = _jax_f32_planes(jds)
    np.testing.assert_allclose(t2n(tds.sweep_coeffs), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    for k in ("position", "view", "up", "right", "tan_fov_y", "lens_radius",
              "focal_dist"):
        np.testing.assert_allclose(t2n(getattr(tcam, k)),
                                   np.asarray(getattr(jcam, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_scene_from_jax_round_trip(scenes):
    """scene_from_jax carries the reference's bytes over unchanged, and
    on the reference's own build equals the port's build."""
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    jds, _, tds, _ = scenes["teapot"]
    fields, meta = jax_scene_parts(jds)
    ds = scene_from_jax(fields, meta)
    assert ds.intersector == "plucker"
    for k in ("tri_attr", "tri_v", "cluster_bounds", "light_alias_prob",
              "sweep_center"):
        assert t2n(getattr(ds, k)).tobytes() == fields[k].tobytes(), k
    assert (t2n(ds.sobol).astype(np.uint32)).tobytes() == fields["sobol"].tobytes()
    for k in ("tri_attr", "light_prim_ids", "sweep_coeffs", "mat_base_color"):
        np.testing.assert_allclose(t2n(getattr(ds, k)), t2n(getattr(tds, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # a bf16x3 build (cornell) re-derives f32 planes from tri_packed
    jc, _, tc, _ = scenes["cornell"]
    dc = scene_from_jax(*jax_scene_parts(jc))
    np.testing.assert_allclose(t2n(dc.sweep_coeffs), t2n(tc.sweep_coeffs),
                               rtol=1e-6, atol=1e-6)


def test_sample_rays_match(scenes):
    from radish_pt_tpu.scene.camera import sample_rays as jax_rays
    from radish_pt_tpu_torch.scene.camera import sample_rays

    _, jcam, _, tcam = scenes["teapot"]
    jcam = jcam.replace(lens_radius=jnp.float32(0.05))
    tcam = tcam.replace(lens_radius=torch.tensor(0.05))
    rng = np.random.default_rng(2)
    x = rng.integers(0, 800, 4096).astype(np.int32)
    y = rng.integers(0, 800, 4096).astype(np.int32)
    r = rng.uniform(size=(4096, 4)).astype(np.float32)
    jo, jd = jax_rays(jcam, jnp.asarray(x), jnp.asarray(y), jnp.asarray(r))
    to, td = sample_rays(tcam, torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(r))
    np.testing.assert_allclose(t2n(to), np.asarray(jo), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t2n(td), np.asarray(jd), rtol=1e-5, atol=1e-6)


def test_surface_and_material_match(scenes):
    """surface_info_from_t + get_textured_material (teapot's procedural
    floor included) on the reference's winners."""
    from radish_pt_tpu.scene import device_scene as jdsc
    from radish_pt_tpu_torch.scene import device_scene as tdsc

    jds, _, tds, _ = scenes["teapot"]
    rng = np.random.default_rng(3)
    n = 4096
    tri = t2n(tds.tri_v)
    gn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = np.linalg.norm(gn, axis=-1)
    real = np.flatnonzero(area > 1e-6)  # not a padding slot
    prim = rng.choice(real, n).astype(np.int32)
    prim[::17] = -1  # misses
    w = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    target = np.einsum("nk,nkc->nc", w, tri[np.maximum(prim, 0)]).astype(np.float32)
    o = (target + rng.normal(scale=2.0, size=(n, 3))).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    # the plane/barycentric recovery amplifies ulp differences between the
    # two libraries by 1/|cos| on grazing rays and by the edge-basis
    # condition number on sliver triangles (~900 on the spout): hold the
    # tolerance on rays at least 15 degrees off the plane, on triangles of
    # condition number below 100
    p0 = np.maximum(prim, 0)
    nhat = gn[p0] / np.maximum(area[p0], 1e-30)[:, None]
    e1, e2 = tri[p0, 1] - tri[p0, 0], tri[p0, 2] - tri[p0, 0]
    d11, d22, d12 = (e1 * e1).sum(-1), (e2 * e2).sum(-1), (e1 * e2).sum(-1)
    cond = d11 * d22 / np.maximum(d11 * d22 - d12 * d12, 1e-30)
    steep = (np.abs(np.sum(d * nhat, axis=-1)) > np.sin(np.radians(15))) & (cond < 100)
    jr = jdsc.surface_info_from_t(jds, jnp.asarray(prim), jnp.asarray(o),
                                  jnp.asarray(d))
    tr = tdsc.surface_info_from_t(tds, torch.from_numpy(prim),
                                  torch.from_numpy(o), torch.from_numpy(d))
    live = (prim >= 0) & steep
    assert live.mean() > 0.5
    for a, b in zip(tr[:3], jr[:3]):
        np.testing.assert_allclose(t2n(a)[live], np.asarray(b)[live],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t2n(tr[3]), np.asarray(jr[3]))
    jm, jn = jdsc.get_textured_material(jds, jr[3], jr[2], jr[1])
    tm, tn = tdsc.get_textured_material(tds, tr[3], tr[2], tr[1])
    assert (t2n(tm.mtype) == 0).any()  # the procedural floor is in the draw
    for k in ("mtype", "base_color", "metallic", "roughness", "ior"):
        np.testing.assert_allclose(t2n(getattr(tm, k))[live],
                                   np.asarray(getattr(jm, k))[live],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(t2n(tn)[live], np.asarray(jn)[live],
                               rtol=1e-5, atol=1e-5)


def test_procedural_texture_matches():
    from radish_pt_tpu.scene.device_scene import procedural_texture as jproc
    from radish_pt_tpu_torch.scene.device_scene import procedural_texture

    uv = np.random.default_rng(5).uniform(-0.5, 1.5, (8192, 2)).astype(np.float32)
    np.testing.assert_allclose(t2n(procedural_texture(torch.from_numpy(uv))),
                               np.asarray(jproc(jnp.asarray(uv))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["cornell", "teapot"])
def test_sample_direct_light_no_vis_matches(scenes, name):
    from radish_pt_tpu.scene import device_scene as jdsc
    from radish_pt_tpu_torch.scene import device_scene as tdsc

    jds, _, tds, _ = scenes[name]
    rng = np.random.default_rng(6)
    pos = rng.uniform(-3, 3, (4096, 3)).astype(np.float32)
    r4 = rng.uniform(size=(4096, 4)).astype(np.float32)
    want = jdsc.sample_direct_light_no_vis(jds, jnp.asarray(pos), jnp.asarray(r4))
    got = tdsc.sample_direct_light_no_vis(tds, torch.from_numpy(pos),
                                          torch.from_numpy(r4))
    for a, b, k in zip(got, want, ("radiance", "wi", "dist", "pdf")):
        np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert (t2n(got[3]) > 0).mean() > 0.2


def test_textured_materials_match(monkeypatch):
    """Bilinear colour, metallic and roughness maps and a normal map
    (scenes/textured.txt) through get_textured_material."""
    from radish_pt_tpu.scene import device_scene as jdsc
    from radish_pt_tpu_torch.scene import device_scene as tdsc
    from radish_pt_tpu_torch.scene.build import load_scene

    jds, _, _ = load_jax_scene(monkeypatch, "textured.txt")
    tds, _, _ = load_scene(os.path.join(SCENES, "textured.txt"), device="cpu")
    assert tds.tex_offset.shape[0] >= 3
    np.testing.assert_array_equal(t2n(tds.tex_data), np.asarray(jds.tex_data))
    rng = np.random.default_rng(7)
    n = 4096
    mid = rng.integers(0, tds.mat_type.shape[0], n).astype(np.int32)
    uv = rng.uniform(-0.5, 1.5, (n, 2)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    jm, jn = jdsc.get_textured_material(jds, jnp.asarray(mid), jnp.asarray(uv),
                                        jnp.asarray(nrm))
    tm, tn = tdsc.get_textured_material(tds, torch.from_numpy(mid),
                                        torch.from_numpy(uv), torch.from_numpy(nrm))
    for k in ("mtype", "base_color", "metallic", "roughness", "ior"):
        np.testing.assert_allclose(t2n(getattr(tm, k)), np.asarray(getattr(jm, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(t2n(tn), np.asarray(jn), rtol=1e-5, atol=1e-5)
    assert np.abs(t2n(tn) - nrm).max() > 0.1  # the normal map bent normals
