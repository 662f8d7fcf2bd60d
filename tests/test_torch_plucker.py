"""Port parity: the Plücker closest-hit and shadow sweeps and their culling
prepass against the reference's Pallas kernels (run in interpret mode on
the CPU, f32 planes) and against the port's brute-force oracle.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
builds them from csrc/ and holds them against the plain versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_port_util import jax_scene_parts, load_jax_scene, t2n  # noqa: E402

FLT_MAX = 3.402823466e38


@pytest.fixture(scope="module")
def soup_rays():
    """The fixture of tests/test_pallas.py: 40 random triangles, 64 rays."""
    from radish_pt_tpu.accel import traverse as jtrv

    rng = np.random.default_rng(21)
    centers = rng.uniform(-3, 3, size=(40, 1, 3))
    soup = (centers + rng.normal(scale=0.5, size=(40, 3, 3))).astype(np.float32)
    tri_packed = jtrv.pack_tris(soup)
    n = 64
    ray_o = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    targets = soup.mean(axis=1)[rng.integers(0, 40, n)]
    ray_d = targets - ray_o
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    return tri_packed, ray_o, ray_d.astype(np.float32)


@pytest.fixture(scope="module")
def teapot():
    """The reference's pallas_mxu teapot carried across, plus 1024 rays:
    camera rays and rays leaving surface points, every 5th lane dead
    (tmax = -FLT_MAX), a third of the rest bounded by a finite tmax."""
    from radish_pt_tpu_torch.scene.camera import sample_rays
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    mp = pytest.MonkeyPatch()
    try:
        jds, jcam, _ = load_jax_scene(mp, "teapot.txt")
    finally:
        mp.undo()
    fields, meta = jax_scene_parts(jds)
    ds = scene_from_jax(fields, meta)
    from radish_pt_tpu_torch.scene.camera import make_camera

    cam = make_camera(800, 800, np.asarray(jcam.position), np.asarray(jcam.rotation),
                      fov_y=float(jcam.fov_y), device="cpu")
    rng = np.random.default_rng(8)
    n = 1024
    x = torch.from_numpy(rng.integers(0, 800, n // 2).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 800, n // 2).astype(np.int32))
    r = torch.from_numpy(rng.uniform(size=(n // 2, 4)).astype(np.float32))
    o1, d1 = sample_rays(cam, x, y, r)
    tri = t2n(ds.tri_v)
    real = np.flatnonzero(np.abs(tri).sum(axis=(1, 2)) > 0)
    pick = rng.choice(real, n // 2)
    w = rng.dirichlet([1, 1, 1], n // 2).astype(np.float32)
    surf = np.einsum("nk,nkc->nc", w, tri[pick]).astype(np.float32)
    d2 = rng.normal(size=(n // 2, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    o = np.concatenate([t2n(o1), surf + d2 * 1e-3]).astype(np.float32)
    d = np.concatenate([t2n(d1), d2]).astype(np.float32)
    tmax = np.full(n, FLT_MAX, np.float32)
    tmax[1::3] = rng.uniform(0.5, 6.0, tmax[1::3].shape)
    tmax[::5] = -FLT_MAX
    return jds, ds, o, d, tmax


def _jax_isect(tri_packed, o, d, **kw):
    from radish_pt_tpu.accel.pallas_kernels import intersect_plucker_pallas

    p, t = intersect_plucker_pallas(jnp.asarray(tri_packed), jnp.asarray(o),
                                    jnp.asarray(d), interpret=True,
                                    bf16x3=False, **kw)
    return np.asarray(p), np.asarray(t)


def test_closest_hit_matches_pallas_soup(soup_rays):
    from radish_pt_tpu_torch.accel import plucker as plk

    tri_packed, o, d = soup_rays
    coeffs, center = plk.numpy_coeffs(tri_packed)
    prim, dist = plk.intersect_plucker(torch.from_numpy(coeffs),
                                       torch.from_numpy(center), None, 64,
                                       torch.from_numpy(o), torch.from_numpy(d))
    p0, d0 = _jax_isect(tri_packed, o, d)
    np.testing.assert_array_equal(t2n(prim), p0)
    hits = p0 >= 0
    assert hits.mean() > 0.3
    np.testing.assert_allclose(t2n(dist)[hits], d0[hits], rtol=1e-4)


def test_occlusion_matches_pallas_soup(soup_rays):
    from radish_pt_tpu.accel.pallas_kernels import occlusion_plucker_pallas
    from radish_pt_tpu_torch.accel import plucker as plk

    tri_packed, _, _ = soup_rays
    rng = np.random.default_rng(3)
    x = rng.uniform(-4, 4, size=(256, 3)).astype(np.float32)
    y = rng.uniform(-4, 4, size=(256, 3)).astype(np.float32)
    y[::7] = x[::7]  # masked lanes: zero-length segments
    coeffs, center = plk.numpy_coeffs(tri_packed)
    got = plk.occlusion_plucker(torch.from_numpy(coeffs), torch.from_numpy(center),
                                None, 64, torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(occlusion_plucker_pallas(
        jnp.asarray(tri_packed), jnp.asarray(x), jnp.asarray(y),
        interpret=True, bf16x3=False))
    np.testing.assert_array_equal(t2n(got), want)
    assert 0 < want.mean() < 0.9 and not want[::7].any()


def test_closest_hit_matches_pallas_teapot(teapot):
    """Clusters, dead lanes and tmax: prim ids exact on every lane (dead
    lanes included: both sweep their row's flagged clusters)."""
    from radish_pt_tpu_torch.accel import plucker as plk

    jds, ds, o, d, tmax = teapot
    prim, dist = plk.intersect_plucker(
        ds.sweep_coeffs, ds.sweep_center, ds.cluster_bounds, ds.cluster_sub,
        torch.from_numpy(o), torch.from_numpy(d), tmax=torch.from_numpy(tmax))
    p0, d0 = _jax_isect(jds.tri_packed, o, d, cluster_bounds=jds.cluster_bounds,
                        tmax=jnp.asarray(tmax), coeffs_pre=jds.sweep_coeffs,
                        center_pre=jds.sweep_center, cluster_sub=jds.cluster_sub)
    np.testing.assert_array_equal(t2n(prim), p0)
    hits = p0 >= 0
    assert hits[tmax > 0].mean() > 0.3
    np.testing.assert_allclose(t2n(dist)[hits], d0[hits], rtol=1e-4)


def test_occlusion_matches_pallas_teapot(teapot):
    from radish_pt_tpu.accel.pallas_kernels import occlusion_plucker_pallas
    from radish_pt_tpu_torch.accel import plucker as plk

    jds, ds, o, d, tmax = teapot
    seg = np.where(tmax > 0, np.minimum(tmax, 8.0), 0.0).astype(np.float32)
    x = o
    y = (o + d * seg[:, None]).astype(np.float32)  # dead lanes: y == x
    got = plk.occlusion_plucker(ds.sweep_coeffs, ds.sweep_center,
                                ds.cluster_bounds, ds.cluster_sub,
                                torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(occlusion_plucker_pallas(
        jnp.asarray(jds.tri_packed), jnp.asarray(x), jnp.asarray(y),
        cluster_bounds=jds.cluster_bounds, coeffs_pre=jds.sweep_coeffs,
        center_pre=jds.sweep_center, cluster_sub=jds.cluster_sub,
        interpret=True, bf16x3=False))
    np.testing.assert_array_equal(t2n(got), want)
    assert 0.05 < want.mean() < 0.95


@pytest.mark.parametrize("segments", [False, True])
def test_mask_prepass_matches_cluster_mask_bits(teapot, segments):
    """The packed per-row words hold exactly the reference prepass bits."""
    from radish_pt_tpu.accel.pallas_kernels import (
        RAY_BLOCK, _chunking, _cluster_mask_bits)
    from radish_pt_tpu_torch.accel import plucker as plk

    jds, ds, o, d, tmax = teapot
    n = 1000  # a ragged last row
    o, d, tmax = o[:n], d[:n], tmax[:n]
    tm = None if segments else tmax
    if segments:
        tm = np.abs(tmax).clip(max=5.0).astype(np.float32)
    words = plk.cluster_mask_words(ds.cluster_bounds, torch.from_numpy(o),
                                   torch.from_numpy(d),
                                   None if tm is None else torch.from_numpy(tm))
    n_c = ds.cluster_bounds.shape[0]
    got = t2n(plk.unpack_mask(words, n_c))
    sub, tri_chunk, t_pad = _chunking(jds.num_triangles, jds.cluster_sub)
    spc = tri_chunk // sub
    n_blocks = -(-n // RAY_BLOCK)
    bits = np.asarray(_cluster_mask_bits(
        jds.cluster_bounds, jnp.asarray(o), jnp.asarray(d),
        None if tm is None else jnp.asarray(tm), n_blocks, t_pad // tri_chunk,
        spc))
    rows = bits.reshape(-1, bits.shape[-1])[: words.shape[0]]
    want = ((rows[:, :, None] >> np.arange(spc)) & 1).reshape(rows.shape[0], -1)
    np.testing.assert_array_equal(got, want[:, :n_c].astype(bool))
    assert 0 < got.mean() < 1


def test_plain_plucker_matches_brute_oracle(teapot):
    """On live lanes the plain Plücker sweep picks the brute-force MT
    winner (the two formulations are algebraically identical)."""
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import traverse as trv

    _, ds, o, d, tmax = teapot
    live = tmax == FLT_MAX
    ot, dt = torch.from_numpy(o[live]), torch.from_numpy(d[live])
    prim, dist = plk.intersect_plucker(ds.sweep_coeffs, ds.sweep_center,
                                       ds.cluster_bounds, ds.cluster_sub, ot, dt)
    p0, d0, _ = trv.intersect_brute(ds.tri_packed, ot, dt)
    np.testing.assert_array_equal(t2n(prim), t2n(p0))
    hits = t2n(p0) >= 0
    assert hits.mean() > 0.3
    # the sweep's dist is selector-grade: t·det = (o - v0)·n cancels on the
    # short hits of rays leaving a surface (surface_info_from_t recomputes
    # the exact t from the winner id)
    np.testing.assert_allclose(t2n(dist)[hits], t2n(d0)[hits], rtol=1e-3)

    x, y = torch.from_numpy(o), torch.from_numpy(o + d * 3.0)
    occ = plk.occlusion_plucker(ds.sweep_coeffs, ds.sweep_center,
                                ds.cluster_bounds, ds.cluster_sub, x, y)
    np.testing.assert_array_equal(t2n(occ), t2n(trv.occlusion_brute(ds.tri_packed, x, y)))


def test_cpu_tensors_take_the_plain_version(soup_rays):
    from radish_pt_tpu_torch.accel import plucker as plk

    tri_packed, o, d = soup_rays
    coeffs, center = (torch.from_numpy(a) for a in plk.numpy_coeffs(tri_packed))
    plk.reset_counts()
    plk.intersect_plucker(coeffs, center, None, 64, torch.from_numpy(o),
                          torch.from_numpy(d))
    plk.occlusion_plucker(coeffs, center, None, 64, torch.from_numpy(o),
                          torch.from_numpy(o + d))
    assert plk.PLAIN_CALLS == {"closest_hit": 1, "occlusion": 1}
    assert plk.LAUNCHES == {"closest_hit": 0, "occlusion": 0}
    with pytest.raises(ValueError):  # the kernel refuses CPU tensors
        plk.closest_hit_cuda(coeffs, plk.plucker_features(
            torch.from_numpy(o), torch.from_numpy(d), center), None, 64)
