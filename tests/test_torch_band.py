"""Port parity: the band engine (Plücker sweeps culled per band of 128/g
lanes over 64-triangle clusters) against the reference's
``intersect_plucker_band`` / ``occlusion_plucker_band`` and its
``_band_mask_bits`` prepass, run in interpret mode on the CPU, against the
port's brute-force oracle, and a frame through it against the reference's
frame on the same scene bytes.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
builds csrc/band.cu and holds them against the plain versions here.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_port_util import (SCENES, jax_scene_parts, load_jax_scene,  # noqa: E402
                             t2n)

FLT_MAX = 3.402823466e38
GS = (1, 4, 8)


def _cluster_bounds(tp):
    """AABBs of consecutive 64-triangle clusters (tests/test_pallas.py)."""
    v = np.stack([tp[:, 0:3], tp[:, 0:3] + tp[:, 3:6], tp[:, 0:3] + tp[:, 6:9]], 1)
    n_c = -(-tp.shape[0] // 64)
    return np.stack([np.concatenate([v[c * 64:(c + 1) * 64].reshape(-1, 3).min(0),
                                     v[c * 64:(c + 1) * 64].reshape(-1, 3).max(0)])
                     for c in range(n_c)]).astype(np.float32)


@pytest.fixture(scope="module")
def soup():
    """The multi-cluster soup of tests/test_pallas.py: 300 triangles
    sorted along x, zero-padded to 5 whole clusters of 64 as the scene
    build pads them.  256 rays (two rows) in groups of 32 lanes, each group
    aimed at one cluster's triangles from 2-5 units away across x, so the
    bands of a row flag different clusters; every 7th lane dead, every 5th
    bounded by a finite tmax.  256 shadow segments, a seventh of them
    zero-length."""
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel.plucker import numpy_coeffs

    rng = np.random.default_rng(33)
    centers = rng.uniform(-4, 4, size=(300, 1, 3))
    tri = (centers + rng.normal(scale=0.4, size=(300, 3, 3))).astype(np.float32)
    tri = tri[np.argsort(tri[:, :, 0].mean(axis=1), kind="stable")]
    tp = np.concatenate([jtrv.pack_tris(tri), np.zeros((20, 9), np.float32)])
    cb = _cluster_bounds(tp[:300])
    n = 256
    k = (np.arange(n) // 32) % 5  # the group's cluster
    target = tri.mean(axis=1)[np.minimum(64 * k + rng.integers(0, 64, n), 299)]
    away = rng.normal(size=(n, 3)) * [0.1, 1.0, 1.0]
    away /= np.linalg.norm(away, axis=-1, keepdims=True)
    o = (target + away * rng.uniform(2, 5, (n, 1))).astype(np.float32)
    d = target + rng.normal(scale=0.2, size=(n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, FLT_MAX, np.float32)
    tmax[::5] = rng.uniform(2.0, 6.0, tmax[::5].shape)
    tmax[::7] = -FLT_MAX
    x = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    y = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    y[::7] = x[::7]
    coeffs, center = numpy_coeffs(tp)
    return dict(tp=tp, cb=cb, o=o, d=d, tmax=tmax, x=x, y=y, coeffs=coeffs,
                center=center)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ref_flags(cb, o, d, tmax, g):
    """The reference's band bitmasks unpacked to bool [bands, C], band b of
    128-lane row r at row r·g + b."""
    from radish_pt_tpu.accel import pallas_kernels as pk

    n_c = cb.shape[0]
    p, cp, words = pk._band_pass_split(n_c)
    n_blocks = -(-o.shape[0] // pk.RAY_BLOCK)
    packed, _ = pk._band_mask_bits(jnp.asarray(cb), jnp.asarray(o), jnp.asarray(d),
                                   None if tmax is None else jnp.asarray(tmax),
                                   n_blocks, p, cp, g)
    bits = (np.asarray(packed)[..., None] >> np.arange(16)) & 1  # [blk, P, 8, G, w, 16]
    bits = bits.transpose(0, 2, 3, 1, 4, 5).reshape(n_blocks * 8 * g, p * cp)
    return bits[: -(-o.shape[0] // 128) * g, :n_c].astype(bool)


@pytest.mark.parametrize("g", GS)
def test_band_mask_matches_reference(soup, g):
    """The port's 32-bit band words hold exactly _band_mask_bits' bits, for
    ray segments and for rays with dead and bounded lanes."""
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import plucker as plk

    s = soup
    cb, o, d, tmax = _t(s["cb"], s["o"], s["d"], s["tmax"])
    got = t2n(plk.unpack_mask(bnd.band_mask_words(cb, o, d, tmax, g), 5))
    np.testing.assert_array_equal(got, _ref_flags(s["cb"], s["o"], s["d"], s["tmax"], g))
    assert 0.05 < got.mean() and (g == 1 or got.mean() < 0.8)  # bands differ
    so, sd, stm = plk.segment_rays(*_t(s["x"], s["y"]))
    got = t2n(plk.unpack_mask(bnd.band_mask_words(cb, so, sd, stm, g), 5))
    want = _ref_flags(s["cb"], t2n(so), t2n(sd), t2n(stm), g)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def ref_closest(soup):
    """The reference's banded closest hit on the soup at each g."""
    from radish_pt_tpu.accel.pallas_kernels import intersect_plucker_band

    s = soup
    out = {}
    for g in GS:
        p, t = intersect_plucker_band(
            jnp.asarray(s["tp"]), jnp.asarray(s["o"]), jnp.asarray(s["d"]),
            cluster_bounds=jnp.asarray(s["cb"]), tmax=jnp.asarray(s["tmax"]),
            interpret=True, G=g)
        out[g] = np.asarray(p), np.asarray(t)
    return out


@pytest.mark.parametrize("g", GS)
def test_closest_hit_matches_reference_soup(soup, ref_closest, g):
    """Prim ids equal to the reference's on every lane whose reference
    winner lies in a cluster its band flags (or that misses): all live
    unbounded lanes, and equal to the brute-force oracle's there.  The
    reference's band walk also sweeps its pass's cluster 0 for a band that
    ran out of clusters (:2663-2666), which can hand a dead or bounded lane
    a hit its band never flagged; the port sweeps only the band's flags.
    dist within rtol 1e-4 (exact f32 minimum against the reference's
    64-ulp packed key)."""
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import traverse as trv

    s = soup
    coeffs, center, cb, o, d, tmax = _t(s["coeffs"], s["center"], s["cb"], s["o"],
                                        s["d"], s["tmax"])
    bnd.reset_counts()
    prim, dist = (t2n(a) for a in bnd.intersect_band(coeffs, center, cb, g, o, d,
                                                     tmax=tmax))
    assert bnd.PLAIN_CALLS["closest_hit"] == 1 and bnd.LAUNCHES["closest_hit"] == 0
    p0, d0 = ref_closest[g]
    flags = t2n(plk.unpack_mask(bnd.band_mask_words(cb, o, d, tmax, g), 5))
    band = np.arange(256) // (128 // g)
    own = (p0 < 0) | flags[band, np.maximum(p0, 0) // 64]
    live = s["tmax"] == FLT_MAX
    assert own[live].all() and own.mean() > 0.9
    np.testing.assert_array_equal(prim[own], p0[own])
    pb, _, _ = trv.intersect_brute(*_t(s["tp"], s["o"], s["d"]))
    np.testing.assert_array_equal(prim[live], t2n(pb)[live])
    hits = own & (p0 >= 0)
    assert hits[live].mean() > 0.3
    np.testing.assert_allclose(dist[hits], d0[hits], rtol=1e-4)


@pytest.mark.parametrize("g", GS)
def test_occlusion_matches_reference_soup(soup, g):
    """Shadow bits equal to the reference's and the brute-force oracle's;
    zero-length segments (negative range, zero direction) never blocked."""
    from radish_pt_tpu.accel.pallas_kernels import occlusion_plucker_band
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import traverse as trv

    s = soup
    coeffs, center, cb, x, y = _t(s["coeffs"], s["center"], s["cb"], s["x"], s["y"])
    bnd.reset_counts()
    occ = t2n(bnd.occlusion_band(coeffs, center, cb, g, x, y))
    assert bnd.PLAIN_CALLS["occlusion"] == 1
    if g == 4:  # one width against the reference (each call ~6-10 s here)
        want = np.asarray(occlusion_plucker_band(
            jnp.asarray(s["tp"]), jnp.asarray(s["x"]), jnp.asarray(s["y"]),
            cluster_bounds=jnp.asarray(s["cb"]), interpret=True, G=g))
        np.testing.assert_array_equal(occ, want)
    np.testing.assert_array_equal(occ, t2n(trv.occlusion_brute(
        torch.from_numpy(s["tp"]), x, y)))
    assert 0.1 < occ.mean() < 0.9 and not occ[::7].any()


@pytest.fixture(scope="module")
def teapot_band():
    """The reference's pallas_band build of teapot (its numpy host path),
    the port's scene carried across from it, the port's own band build of
    the same file, and 256 rays: camera rays and rays leaving surface
    points, every 5th lane dead, a third of the rest bounded."""
    from radish_pt_tpu_torch.scene.build import load_scene
    from radish_pt_tpu_torch.scene.camera import make_camera, sample_rays
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    mp = pytest.MonkeyPatch()
    try:
        jds, jcam, _ = load_jax_scene(mp, "teapot.txt", "pallas_band")
    finally:
        mp.undo()
    ds = scene_from_jax(*jax_scene_parts(jds))
    own, _, _ = load_scene(os.path.join(SCENES, "teapot.txt"), device="cpu",
                           intersector="band")
    cam = make_camera(800, 800, np.asarray(jcam.position), np.asarray(jcam.rotation),
                      fov_y=float(jcam.fov_y), device="cpu")
    rng = np.random.default_rng(8)
    n = 256
    x = torch.from_numpy(rng.integers(0, 800, n // 2).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 800, n // 2).astype(np.int32))
    r = torch.from_numpy(rng.uniform(size=(n // 2, 4)).astype(np.float32))
    o1, d1 = sample_rays(cam, x, y, r)
    tri = t2n(ds.tri_v)
    real = np.flatnonzero(np.abs(tri).sum(axis=(1, 2)) > 0)
    w = rng.dirichlet([1, 1, 1], n // 2).astype(np.float32)
    surf = np.einsum("nk,nkc->nc", w, tri[rng.choice(real, n // 2)]).astype(np.float32)
    d2 = rng.normal(size=(n // 2, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    o = np.concatenate([t2n(o1), surf + d2 * 1e-3]).astype(np.float32)
    d = np.concatenate([t2n(d1), d2]).astype(np.float32)
    tmax = np.full(n, FLT_MAX, np.float32)
    tmax[1::3] = rng.uniform(0.5, 6.0, tmax[1::3].shape)
    tmax[::5] = -FLT_MAX
    return jds, jcam, ds, own, o, d, tmax


def test_teapot_matches_reference(teapot_band):
    """Teapot's 77 clusters of 64 at the default g = 8: winners as in the
    soup test (every lane whose reference winner its band flagged), and
    the scene carried across from the reference and the port's own build
    give the same winners; shadow bits equal, dead lanes' zero-length
    segments never blocked.  dist within rtol 1e-4, and within 1e-5
    absolute on the short hits of rays that leave a surface 1e-3 away,
    where t·det cancels to the planes' rounding residue."""
    from radish_pt_tpu.accel.pallas_kernels import (intersect_plucker_band,
                                                    occlusion_plucker_band)
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import plucker as plk

    jds, _, ds, own, o, d, tmax = teapot_band
    assert ds.intersector == own.intersector == "band"
    assert ds.cluster_sub == own.cluster_sub == 64 and ds.band_g == 8
    ot, dt, tt = _t(o, d, tmax)
    prim, dist = (t2n(a) for a in bnd.intersect_band(
        ds.sweep_coeffs, ds.sweep_center, ds.cluster_bounds, 8, ot, dt, tmax=tt))
    p0, d0 = (np.asarray(a) for a in intersect_plucker_band(
        jnp.asarray(jds.tri_packed), jnp.asarray(o), jnp.asarray(d),
        cluster_bounds=jds.cluster_bounds, tmax=jnp.asarray(tmax),
        coeffs_pre=jds.sweep_coeffs, center_pre=jds.sweep_center, interpret=True, G=8))
    n_c = ds.cluster_bounds.shape[0]
    flags = t2n(plk.unpack_mask(bnd.band_mask_words(ds.cluster_bounds, ot, dt, tt, 8),
                                n_c))
    own_lane = (p0 < 0) | flags[np.arange(256) // 16, np.maximum(p0, 0) // 64]
    assert own_lane[tmax == FLT_MAX].all() and own_lane.mean() > 0.9
    np.testing.assert_array_equal(prim[own_lane], p0[own_lane])
    hits = own_lane & (p0 >= 0)
    assert hits[tmax > 0].mean() > 0.3
    np.testing.assert_allclose(dist[hits], d0[hits], rtol=1e-4, atol=1e-5)
    p1, _ = bnd.intersect_band(own.sweep_coeffs, own.sweep_center, own.cluster_bounds,
                               8, ot, dt, tmax=tt)
    np.testing.assert_array_equal(t2n(p1), prim)

    seg = np.where(tmax > 0, np.minimum(tmax, 8.0), 0.0).astype(np.float32)
    y = (o + d * seg[:, None]).astype(np.float32)  # dead lanes: y == x
    got = t2n(bnd.occlusion_band(ds.sweep_coeffs, ds.sweep_center, ds.cluster_bounds,
                                 8, ot, torch.from_numpy(y)))
    want = np.asarray(occlusion_plucker_band(
        jnp.asarray(jds.tri_packed), jnp.asarray(o), jnp.asarray(y),
        cluster_bounds=jds.cluster_bounds, coeffs_pre=jds.sweep_coeffs,
        center_pre=jds.sweep_center, interpret=True, G=8))
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want[tmax > 0].mean() < 0.95 and not got[tmax < 0].any()


def test_scene_from_jax_matches_own_build(teapot_band):
    """The reference's band scene stores a transposed [C, 16, 256] plane
    table; the scene carried across rebuilds the [T, 4, 10] planes, equal
    to the port's own build's (same stored order and boxes)."""
    jds, _, ds, own, *_ = teapot_band
    assert np.asarray(jds.sweep_coeffs).shape[1:] == (16, 256)
    assert ds.quad_coeffs is None
    np.testing.assert_array_equal(t2n(ds.tri_v), t2n(own.tri_v))
    np.testing.assert_array_equal(t2n(ds.cluster_bounds), t2n(own.cluster_bounds))
    np.testing.assert_allclose(t2n(ds.sweep_coeffs), t2n(own.sweep_coeffs), rtol=1e-6,
                               atol=1e-6 * float(own.sweep_coeffs.abs().max()))


def test_path_trace_band_matches_reference(teapot_band):
    """The whole slice: teapot 32x32, depth 3, looper 0, through the port's
    band engine (its plain versions on CPU tensors) against the reference's
    frame on the same scene bytes (its brute-force engine: interpret-mode
    Pallas inside a jitted frame is out of reach on the CPU); the bound is
    on the mean."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.scene.camera import make_camera

    jds, jcam, ds, *_ = teapot_band
    res, depth = 32, 3
    jcam = jcam.replace(width=res, height=res)
    jd, ji = (np.asarray(a) for a in jax.jit(jpt.path_trace, static_argnames=(
        "max_depth",))(jds.replace(intersector="brute"), jcam, 0, depth))
    cam = make_camera(res, res, np.asarray(jcam.position), np.asarray(jcam.rotation),
                      fov_y=float(jcam.fov_y), lens_radius=float(jcam.lens_radius),
                      focal_dist=float(jcam.focal_dist), device="cpu")
    bnd.reset_counts()
    d, i = pt.path_trace(ds, cam, 0, depth)
    assert bnd.PLAIN_CALLS == {"closest_hit": depth + 1, "occlusion": depth}
    assert bnd.LAUNCHES == {"closest_hit": 0, "occlusion": 0}
    assert (jd + ji).mean() > 1e-2
    assert np.abs(t2n(d + i) - (jd + ji)).mean() < 2e-2


def test_band_refuses_small_scenes_and_bad_widths():
    """At or below 1,024 triangles the reference builds no clusters and its
    band entry asserts; the port refuses with a ValueError, as it does a
    band count that is not a power of two from 1 to 128."""
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.scene.build import load_scene

    with pytest.raises(ValueError, match="band engine"):
        load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cpu",
                   intersector="band")
    for g in (0, 3, 256):
        with pytest.raises(ValueError, match="power of two"):
            bnd.check_g(g)
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="culling clusters"):
        bnd.intersect_band(torch.zeros((64, 4, 10)), torch.zeros(3), None, 8, o, o)


def test_cpu_tensors_take_the_plain_versions(soup):
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import plucker as plk

    s = soup
    coeffs, center, cb, o, d = _t(s["coeffs"], s["center"], s["cb"], s["o"], s["d"])
    feats = plk.plucker_features(o, d, center)
    mask = bnd.band_mask_words(cb, o, d, None, 8)
    tm = torch.full((256,), 5.0)
    bnd.reset_counts()
    bnd.closest_hit(coeffs, feats, mask, 8)
    bnd.occlusion(coeffs, feats, tm, mask, 8)
    assert bnd.PLAIN_CALLS == {"closest_hit": 1, "occlusion": 1}
    assert bnd.LAUNCHES == {"closest_hit": 0, "occlusion": 0}
    with pytest.raises(ValueError):  # the kernels refuse CPU tensors
        bnd.closest_hit_cuda(coeffs, feats, mask, 8)
    with pytest.raises(ValueError):
        bnd.occlusion_cuda(coeffs, feats, tm, mask, 8)


def test_cli_renders_band_on_cpu(tmp_path, capsys):
    """The CLI's --intersector band and --band-g."""
    from radish_pt_tpu_torch.cli import main

    out = tmp_path / "b.png"
    assert main([os.path.join(SCENES, "teapot.txt"), "--spp", "1", "--res", "16",
                 "16", "--depth", "2", "--device", "cpu", "--intersector", "band",
                 "--band-g", "4", "--out", str(out)]) == 0
    assert "engine band" in capsys.readouterr().out
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
