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

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
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
    """Prim ids equal to the reference's on every live lane whose
    reference winner lies in a cluster its band flags (or that misses):
    all live unbounded lanes, and equal to the brute-force oracle's there.
    The reference's band walk also sweeps its pass's cluster 0 for a band
    that ran out of clusters (:2663-2666), which can hand a dead or bounded
    lane a hit its band never flagged; the port sweeps only the band's
    flags, and a dead lane misses (the reference gives it what its band's
    clusters give).  dist within rtol 1e-4 (exact f32 minimum against the
    reference's 64-ulp packed key)."""
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import traverse as trv

    s = soup
    coeffs, center, cb, o, d, tmax = _t(s["coeffs"], s["center"], s["cb"], s["o"],
                                        s["d"], s["tmax"])
    tally = Tally()
    prim, dist = (t2n(a) for a in bnd.intersect_band(coeffs, center, cb, g, o, d,
                                                     tmax=tmax))
    assert tally("plain.band")["closest_hit"] == 1 and "closest_hit" not in tally("launch.band")
    p0, d0 = ref_closest[g]
    flags = t2n(plk.unpack_mask(bnd.band_mask_words(cb, o, d, tmax, g), 5))
    band = np.arange(256) // (128 // g)
    alive = s["tmax"] >= 0
    own = ((p0 < 0) | flags[band, np.maximum(p0, 0) // 64]) & alive
    live = s["tmax"] == FLT_MAX
    assert own[live].all() and own[alive].mean() > 0.9
    np.testing.assert_array_equal(prim[own], p0[own])
    assert np.all(prim[~alive] == -1) and np.all(dist[~alive] == FLT_MAX)
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
    tally = Tally()
    occ = t2n(bnd.occlusion_band(coeffs, center, cb, g, x, y))
    assert tally("plain.band")["occlusion"] == 1
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
    soup test (every live lane whose reference winner its band flagged;
    dead lanes miss), and
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
    alive = tmax >= 0
    own_lane = ((p0 < 0) | flags[np.arange(256) // 16, np.maximum(p0, 0) // 64]) & alive
    assert own_lane[tmax == FLT_MAX].all() and own_lane[alive].mean() > 0.9
    np.testing.assert_array_equal(prim[own_lane], p0[own_lane])
    assert np.all(prim[~alive] == -1)  # dead lanes miss
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
    tally = Tally()
    d, i = pt.path_trace(ds, cam, 0, depth)
    assert tally("plain.band") == {"closest_hit": depth + 1, "occlusion": depth}
    assert tally("launch.band") == {}
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
    packed, wb = _t(plk.numpy_packed_coeffs(s["coeffs"]))[0], bnd.word_bounds(cb)
    tm = torch.full((256,), 5.0)
    tally = Tally()
    bnd.closest_hit(coeffs, feats, cb, o, d, None, 8, packed, wb)
    bnd.occlusion(coeffs, feats, cb, o, d, tm, 8, packed, wb)
    assert tally("plain.band") == {"closest_hit": 1, "occlusion": 1}
    assert tally("launch.band") == {}
    assert tally("prepass.band") == {"band_mask_words": 2}  # the plain versions' words
    with pytest.raises(ValueError):  # the kernels refuse CPU tensors
        bnd.closest_hit_cuda(packed, feats, cb, wb, o, d, None, 8)
    with pytest.raises(ValueError):
        bnd.occlusion_cuda(packed, feats, cb, wb, o, d, tm, 8)


def test_cli_renders_band_on_cpu(tmp_path, capsys):
    """The CLI's --intersector band and --band-g."""
    from radish_pt_tpu_torch.cli import main

    out = tmp_path / "b.png"
    assert main([os.path.join(SCENES, "teapot.txt"), "--spp", "1", "--res", "16",
                 "16", "--depth", "2", "--device", "cpu", "--intersector", "band",
                 "--band-g", "4", "--out", str(out)]) == 0
    assert "engine band" in capsys.readouterr().out
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# the closest-hit kernel's vote, skip and dead lanes, in plain torch
# ---------------------------------------------------------------------------


def _vote_cases(s, teapot_band):
    """(cluster boxes, ray_o, ray_d, tmax) the vote is held on: the soup's
    rays (dead and bounded lanes) and segments, and the teapot's rays with
    and without a range (77 clusters of 64: three words) and its segments
    (:func:`_teapot_segments`)."""
    from radish_pt_tpu_torch.accel import plucker as plk

    cb, o, d, tmax = _t(s["cb"], s["o"], s["d"], s["tmax"])
    so, sd, stm = plk.segment_rays(*_t(s["x"], s["y"]))
    _, _, ds, _, to, td, ttmax = teapot_band
    to, td, ttmax = _t(to, td, ttmax)
    return [(cb, o, d, tmax), (cb, so, sd, stm), (ds.cluster_bounds, to, td, ttmax),
            (ds.cluster_bounds, to, td, None),
            (ds.cluster_bounds, *plk.segment_rays(*_teapot_segments(teapot_band)))]


def _teapot_segments(teapot_band):
    """Segments (x, y) on teapot: from the fixture's ray origins (camera
    rays, rays leaving surfaces) 3 units along their rays, the dead lanes'
    and every 7th zero-length (a negative range)."""
    *_, o, d, tmax = teapot_band
    y = (o + 3.0 * d).astype(np.float32)
    y[tmax < 0] = o[tmax < 0]
    y[::7] = o[::7]
    return _t(o, y)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32, 64, 128])
def test_kernel_vote_equals_band_mask_words(soup, teapot_band, g):
    """The closest-hit kernel's vote in plain torch (band_words_plain: each
    lane's slab test, the 32 clusters of a word tested only where a lane of
    the warp passes the word's box, ORed per band) gives band_mask_words'
    words bit for bit at every band width, on rays with dead and bounded
    lanes, on segments and without a range."""
    from radish_pt_tpu_torch.accel import band as bnd

    for cb, o, d, tmax in _vote_cases(soup, teapot_band):
        want = bnd.band_mask_words(cb, o, d, tmax, g)
        got = bnd.band_words_plain(cb, bnd.word_bounds(cb), o, d, tmax, g)
        assert got.shape == want.shape
        np.testing.assert_array_equal(t2n(got), t2n(want))


def test_word_boxes_keep_every_cluster(soup, teapot_band):
    """A lane that passes a cluster's box passes its word's box (the slab
    test is monotone under box containment in f32), so the vote's first
    level drops no cluster; on the teapot the word test does rule words
    out: live lanes miss some of the three word boxes (a warp whose lanes
    all miss one skips its 32 clusters)."""
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import plucker as plk

    skipped = 0
    for cb, o, d, tmax in _vote_cases(soup, teapot_band):
        wb = bnd.word_bounds(cb)
        assert wb.shape == (-(-cb.shape[0] // bnd.WORD), 6)
        own = plk.lane_cluster_flags_plain(cb, o, d, tmax)
        word = plk.lane_cluster_flags_plain(wb, o, d, tmax)
        assert not bool((own & ~word[:, torch.arange(cb.shape[0]) // bnd.WORD]).any())
        live = slice(None) if tmax is None else tmax >= 0
        skipped += int((~word[live]).sum())
    assert skipped > 0


@pytest.mark.parametrize("case", ["soup", "teapot"])
def test_lane_skip_is_conservative_on_bands(soup, teapot_band, case):
    """The kernel's per-ray skip on the band layout's 64-triangle clusters
    (slab_reach, the twin of plucker.lane_skip_flags_plain): every (ray,
    triangle) pair that passes the f32 planes at t lies in a cluster the
    skip keeps at reach t, on the case's rays and on rays that leave its
    surfaces 1e-3 away; the skip does pass over clusters."""
    from radish_pt_tpu_torch.accel import plucker as plk

    if case == "soup":
        coeffs, center, cb, o, d, tp = _t(soup["coeffs"], soup["center"], soup["cb"],
                                          soup["o"], soup["d"], soup["tp"])
    else:
        _, _, ds, _, o, d, _ = teapot_band
        coeffs, center, cb, tp = ds.sweep_coeffs, ds.sweep_center, ds.cluster_bounds, \
            ds.tri_packed
        o, d = _t(o, d)
    rng = np.random.default_rng(5)
    tri = t2n(tp)
    real = np.flatnonzero(np.abs(tri[:, 3:]).sum(1) > 0)
    pick = tri[rng.choice(real, 256)]
    w = rng.dirichlet([1, 1, 1], 256).astype(np.float32)
    surf = pick[:, 0:3] + w[:, 1:2] * pick[:, 3:6] + w[:, 2:3] * pick[:, 6:9]
    sd = rng.normal(size=(256, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=-1, keepdims=True)
    n_c = cb.shape[0]
    for ro, rd in ((o, d), _t(surf + sd * 1e-3, sd)):
        t = plk.hit_t(coeffs, plk.plucker_features(ro, rd, center))  # [N, T]
        assert int((t < FLT_MAX).sum()) > ro.shape[0] // 4
        pad = n_c * 64 - t.shape[1]
        near = torch.nn.functional.pad(t, (0, pad), value=FLT_MAX).view(-1, n_c, 64).amin(-1)
        kept = 0.0
        for c_id in range(n_c):
            flagged = plk.lane_skip_flags_plain(cb, ro, rd, near[:, c_id])[:, c_id]
            assert not bool(((near[:, c_id] < FLT_MAX) & ~flagged).any())
            kept += float(plk.lane_skip_flags_plain(cb, ro, rd, torch.full_like(
                near[:, 0], 6.0))[:, c_id].float().mean())
        assert kept / n_c < 0.9


def test_closest_hit_plain_dead_lanes_miss(soup):
    """With ``dead`` the plain closest hit returns (-1, FLT_MAX) for the
    dead lanes (what the kernel returns) and what it returns without
    ``dead`` for the others."""
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import plucker as plk

    s = soup
    coeffs, center, cb, o, d, tmax = _t(s["coeffs"], s["center"], s["cb"], s["o"], s["d"],
                                        s["tmax"])
    feats = plk.plucker_features(o, d, center)
    tmax = tmax.clone()
    tmax[1::3] = FLT_MAX  # dead lanes among hitting ones: every 7th
    mask = bnd.band_mask_words(cb, o, d, None, 8)  # the dead lanes' bands flag
    dead = plk.dead_lanes(tmax)
    p0, d0 = bnd.closest_hit_plain(coeffs, feats, mask, 8)
    p1, d1 = bnd.closest_hit_plain(coeffs, feats, mask, 8, dead=dead)
    assert bool((p0[dead] >= 0).any())  # they would have hit
    assert bool((p1[dead] == -1).all()) and bool((d1[dead] == FLT_MAX).all())
    assert torch.equal(p1[~dead], p0[~dead]) and torch.equal(d1[~dead], d0[~dead])


@pytest.mark.parametrize("g", [1, 8])
def test_pair_counts_are_ordered(soup, teapot_band, g):
    """Per lane never more than per band or per warp, and the cut at each
    lane's final t never more than per lane; padding lanes uncounted."""
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import plucker as plk

    _, _, ds, _, o, d, tmax = teapot_band
    o, d, tmax = _t(o[:200], d[:200], tmax[:200])  # a ragged last row
    feats = plk.plucker_features(o, d, ds.sweep_center)
    mask = bnd.band_mask_words(ds.cluster_bounds, o, d, tmax, g)
    _, dist = bnd.closest_hit_plain(ds.sweep_coeffs, feats, mask, g,
                                    dead=plk.dead_lanes(tmax))
    c = bnd.pair_counts(ds.cluster_bounds, o, d, tmax, g, ds.num_triangles, dist,
                        chunk_rows=1)
    assert 0 < c["lane_cut"] <= c["lane"] <= min(c["band"], c["warp"])
    flags = plk.unpack_mask(mask, ds.cluster_bounds.shape[0])
    lanes = np.minimum(128 // g, 200 - np.arange(flags.shape[0]) * (128 // g)).clip(0)
    assert c["band"] == float((t2n(flags).sum(1) * 64) @ lanes)
    assert c == bnd.pair_counts(ds.cluster_bounds, o, d, tmax, g, ds.num_triangles, dist)


@pytest.mark.parametrize("case", ["soup", "teapot"])
def test_lane_skip_is_conservative_on_band_segments(soup, teapot_band, case):
    """The shadow kernel's per-segment skip on the band layout (slab_reach
    at the segment's range, the twin of plucker.lane_skip_flags_plain):
    every (segment, triangle) pair that blocks the segment under the f32
    planes lies in a cluster the skip keeps at its range — 0 pairs outside
    — and the skip passes over clusters.  Segments with a negative range
    (zero-length) block nothing."""
    from radish_pt_tpu_torch.accel import plucker as plk

    if case == "soup":
        coeffs, center, cb, x, y = _t(soup["coeffs"], soup["center"], soup["cb"],
                                      soup["x"], soup["y"])
    else:
        ds = teapot_band[2]
        coeffs, center, cb = ds.sweep_coeffs, ds.sweep_center, ds.cluster_bounds
        x, y = _teapot_segments(teapot_band)
    so, sd, tm = plk.segment_rays(x, y)
    blocking = plk.blocks(coeffs, plk.plucker_features(so, sd, center), tm)  # [N, T]
    assert int(blocking.sum()) > 20 and not bool(blocking[tm < 0].any())
    keep = plk.lane_skip_flags_plain(cb, so, sd, tm)
    cluster = torch.arange(coeffs.shape[0]) // 64
    assert int((blocking & ~keep[:, cluster]).sum()) == 0
    assert float(keep[tm >= 0].float().mean()) < 0.8


def test_pair_counts_skip_settled_segments(teapot_band):
    """On segments, lanes with a negative range (settled before any sweep)
    count no pair of their own but still shape their band's and warp's
    words, as in the kernels' vote."""
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import plucker as plk

    ds = teapot_band[2]
    so, sd, tm = plk.segment_rays(*_teapot_segments(teapot_band))
    assert bool((tm < 0).any())
    c = bnd.pair_counts(ds.cluster_bounds, so, sd, tm, 8, ds.num_triangles, tm)
    live = tm >= 0
    alone = bnd.pair_counts(ds.cluster_bounds, so[live], sd[live], tm[live], 8,
                            ds.num_triangles, tm[live])
    assert c["lane"] == alone["lane"] and c["lane_cut"] == alone["lane_cut"]
    assert 0 < c["lane_cut"] <= c["lane"] <= min(c["band"], c["warp"])
    flags = plk.unpack_mask(bnd.band_mask_words(ds.cluster_bounds, so, sd, tm, 8), 77)
    lanes = np.minimum(16, 256 - np.arange(flags.shape[0]) * 16).clip(0)
    assert c["band"] == float((t2n(flags).sum(1) * 64) @ lanes)
