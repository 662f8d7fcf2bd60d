"""Port parity: the quad engine (quadratic-form closest-hit and shadow
sweeps over the Plücker engine's clusters) against the reference's
``intersect_quad_pallas`` / ``occlusion_quad_pallas`` run in interpret mode
on the CPU with f32 planes, against the port's brute-force oracle, and a
frame through it against the reference's frame on the same scene bytes.
Also the entry points' default device.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
builds csrc/quad.cu and holds them against the plain versions here.
"""

import inspect
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


def _cluster_bounds(tp, sub=64):
    """AABBs of consecutive ``sub``-triangle clusters (tests/test_pallas.py)."""
    v = np.stack([tp[:, 0:3], tp[:, 0:3] + tp[:, 3:6], tp[:, 0:3] + tp[:, 6:9]], 1)
    n_c = -(-tp.shape[0] // sub)
    return np.stack([np.concatenate([v[c * sub:(c + 1) * sub].reshape(-1, 3).min(0),
                                     v[c * sub:(c + 1) * sub].reshape(-1, 3).max(0)])
                     for c in range(n_c)]).astype(np.float32)


@pytest.fixture(scope="module")
def soup():
    """The multi-cluster fixture of tests/test_pallas.py (300 triangles
    sorted along x into 5 clusters of 64, the last ragged), 256 rays; every
    7th lane dead (tmax = -FLT_MAX), every 5th bounded by a finite tmax."""
    from radish_pt_tpu.accel import traverse as jtrv

    rng = np.random.default_rng(33)
    centers = rng.uniform(-4, 4, size=(300, 1, 3))
    tri = (centers + rng.normal(scale=0.4, size=(300, 3, 3))).astype(np.float32)
    tri = tri[np.argsort(tri[:, :, 0].mean(axis=1), kind="stable")]
    tp = jtrv.pack_tris(tri)
    n = 256
    o = rng.uniform(-7, 7, size=(n, 3)).astype(np.float32)
    d = tri.mean(axis=1)[rng.integers(0, 300, n)] - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, FLT_MAX, np.float32)
    tmax[::5] = rng.uniform(3.0, 9.0, tmax[::5].shape)
    tmax[::7] = -FLT_MAX
    x = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    y = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    y[::7] = x[::7]  # masked lanes: zero-length segments
    return dict(tp=tp, cb=_cluster_bounds(tp), o=o, d=d, tmax=tmax, x=x, y=y)


def _port_planes(tp):
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import quad as qd

    _, center = plk.numpy_coeffs(tp)
    return (torch.from_numpy(qd.numpy_quad_coeffs(tp, center)),
            torch.from_numpy(center))


def _ref_isect(tp, o, d, **kw):
    from radish_pt_tpu.accel.pallas_kernels import intersect_quad_pallas

    p, t = intersect_quad_pallas(jnp.asarray(tp), jnp.asarray(o), jnp.asarray(d),
                                 interpret=True, prec="f32", **kw)
    return np.asarray(p), np.asarray(t)


def test_features_and_forms_match_reference(soup):
    """quad_features and the build-time forms [T, 6, 28] against the
    reference's _quad_features and _quad_coeffs(with_q6=True)."""
    from radish_pt_tpu.accel import pallas_kernels as pk
    from radish_pt_tpu_torch.accel import quad as qd

    coeffs, center = _port_planes(soup["tp"])
    want = np.asarray(pk._quad_coeffs(jnp.asarray(soup["tp"]), jnp.asarray(t2n(center)),
                                      with_q6=True)).transpose(1, 0, 2)
    assert coeffs.shape == (300, 6, 28) and not t2n(coeffs)[:, :, 27].any()
    np.testing.assert_allclose(t2n(coeffs), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    f = qd.quad_features(torch.from_numpy(soup["o"]), torch.from_numpy(soup["d"]), center)
    jf = pk._quad_features(jnp.asarray(soup["o"]), jnp.asarray(soup["d"]),
                           jnp.asarray(t2n(center)))
    np.testing.assert_allclose(t2n(f), np.asarray(jf), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("culled", [False, True])
def test_closest_hit_matches_reference_soup(soup, culled):
    """Prim ids equal on every lane (dead and bounded lanes too: both sweep
    their row's flagged clusters), and the brute-force oracle's on the live
    unbounded lanes; dist within rtol 3e-2 (the forms are selector-grade,
    tests/test_pallas.py:131-144)."""
    from radish_pt_tpu_torch.accel import quad as qd
    from radish_pt_tpu_torch.accel import traverse as trv

    s = soup
    coeffs, center = _port_planes(s["tp"])
    cb = torch.from_numpy(s["cb"]) if culled else None
    tmax = torch.from_numpy(s["tmax"]) if culled else None
    tally = Tally()
    prim, dist = qd.intersect_quad(coeffs, center, cb, 64, torch.from_numpy(s["o"]),
                                   torch.from_numpy(s["d"]), tmax=tmax)
    assert tally("plain.quad")["closest_hit"] == 1 and "closest_hit" not in tally("launch.quad")
    kw = dict(cluster_bounds=jnp.asarray(s["cb"]), tmax=jnp.asarray(s["tmax"])) if culled else {}
    p0, d0 = _ref_isect(s["tp"], s["o"], s["d"], **kw)
    prim, dist = t2n(prim), t2n(dist)
    np.testing.assert_array_equal(prim, p0)
    pb, _, _ = trv.intersect_brute(*(torch.from_numpy(a) for a in (s["tp"], s["o"], s["d"])))
    live = s["tmax"] == FLT_MAX
    np.testing.assert_array_equal(prim[live], t2n(pb)[live])
    hits = p0 >= 0
    assert hits.mean() > 0.3
    np.testing.assert_allclose(dist[hits], d0[hits], rtol=3e-2)


@pytest.mark.parametrize("culled", [False, True])
def test_occlusion_matches_reference_soup(soup, culled):
    """Shadow bits equal, a seventh of the segments zero-length: the
    reference's quad test reports every one of those blocked wherever its
    row sweeps a triangle (all forms are 0), and so does the port."""
    from radish_pt_tpu.accel.pallas_kernels import occlusion_quad_pallas
    from radish_pt_tpu_torch.accel import quad as qd
    from radish_pt_tpu_torch.accel import traverse as trv

    s = soup
    coeffs, center = _port_planes(s["tp"])
    cb = torch.from_numpy(s["cb"]) if culled else None
    x, y = torch.from_numpy(s["x"]), torch.from_numpy(s["y"])
    tally = Tally()
    occ = t2n(qd.occlusion_quad(coeffs, center, cb, 64, x, y))
    assert tally("plain.quad")["occlusion"] == 1
    kw = dict(cluster_bounds=jnp.asarray(s["cb"])) if culled else {}
    want = np.asarray(occlusion_quad_pallas(jnp.asarray(s["tp"]), jnp.asarray(s["x"]),
                                            jnp.asarray(s["y"]), interpret=True,
                                            prec="f32", **kw))
    np.testing.assert_array_equal(occ, want)
    zero = np.zeros(occ.shape, bool)
    zero[::7] = True
    if not culled:
        assert occ[zero].all()  # every row sweeps every triangle
    assert occ[zero].any()
    brute = t2n(trv.occlusion_brute(torch.from_numpy(s["tp"]), x, y))
    np.testing.assert_array_equal(occ[~zero], brute[~zero])
    assert 0.1 < brute[~zero].mean() < 0.9


@pytest.fixture(scope="module")
def teapot_quad():
    """The reference's pallas_quad build of teapot (its numpy host path),
    the port's scene carried across from it, the port's own quad build of
    the same file, and 256 rays: camera rays and rays leaving surface
    points, every 5th lane dead, a third of the rest bounded."""
    from radish_pt_tpu_torch.scene.build import load_scene
    from radish_pt_tpu_torch.scene.camera import make_camera, sample_rays
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    mp = pytest.MonkeyPatch()
    try:
        jds, jcam, _ = load_jax_scene(mp, "teapot.txt", "pallas_quad")
    finally:
        mp.undo()
    ds = scene_from_jax(*jax_scene_parts(jds))
    own, _, _ = load_scene(os.path.join(SCENES, "teapot.txt"), device="cpu",
                           intersector="quad")
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


def test_closest_hit_matches_reference_teapot(teapot_quad):
    """Teapot's 43 clusters of 128, dead lanes and finite tmax: prim ids
    equal on every lane; the scene carried across from the reference and
    the port's own build give the same winners.  dist within rtol 3e-2,
    and within 5e-3 absolute on the hits of rays that leave a surface
    1e-3 away: q5 cancels to the forms' rounding residue there, which is
    absolute (about 1e-3 of the scene's size), not relative to t."""
    from radish_pt_tpu_torch.accel import quad as qd

    jds, _, ds, own, o, d, tmax = teapot_quad
    assert ds.intersector == own.intersector == "quad" and ds.cluster_sub == 128
    args = (torch.from_numpy(o), torch.from_numpy(d))
    prim, dist = qd.intersect_quad(ds.quad_coeffs, ds.sweep_center, ds.cluster_bounds,
                                   ds.cluster_sub, *args, tmax=torch.from_numpy(tmax))
    p0, d0 = _ref_isect(jds.tri_packed, o, d, cluster_bounds=jds.cluster_bounds,
                        tmax=jnp.asarray(tmax), cluster_sub=jds.cluster_sub)
    np.testing.assert_array_equal(t2n(prim), p0)
    hits = p0 >= 0
    assert hits[tmax > 0].mean() > 0.3
    np.testing.assert_allclose(t2n(dist)[hits], d0[hits], rtol=3e-2, atol=5e-3)
    p1, _ = qd.intersect_quad(own.quad_coeffs, own.sweep_center, own.cluster_bounds,
                              own.cluster_sub, *args, tmax=torch.from_numpy(tmax))
    np.testing.assert_array_equal(t2n(p1), t2n(prim))


def test_occlusion_matches_reference_teapot(teapot_quad):
    from radish_pt_tpu.accel.pallas_kernels import occlusion_quad_pallas
    from radish_pt_tpu_torch.accel import quad as qd

    jds, _, ds, _, o, d, tmax = teapot_quad
    seg = np.where(tmax > 0, np.minimum(tmax, 8.0), 0.0).astype(np.float32)
    y = (o + d * seg[:, None]).astype(np.float32)  # dead lanes: y == x
    got = t2n(qd.occlusion_quad(ds.quad_coeffs, ds.sweep_center, ds.cluster_bounds,
                                ds.cluster_sub, torch.from_numpy(o), torch.from_numpy(y)))
    want = np.asarray(occlusion_quad_pallas(
        jnp.asarray(jds.tri_packed), jnp.asarray(o), jnp.asarray(y),
        cluster_bounds=jds.cluster_bounds, cluster_sub=jds.cluster_sub,
        interpret=True, prec="f32"))
    np.testing.assert_array_equal(got, want)
    assert 0.05 < want[tmax > 0].mean() < 0.95


def test_scene_from_jax_rebuilds_f32_forms(teapot_quad):
    """The reference's quad scene stores bf16x6-split forms; the scene
    carried across rebuilds f32 forms from tri_packed, equal to the port's
    own build's (same stored order, boxes and planes)."""
    jds, _, ds, own, *_ = teapot_quad
    assert np.asarray(jds.sweep_coeffs).shape[-1] == 176  # the x6 layout
    np.testing.assert_array_equal(t2n(ds.tri_v), t2n(own.tri_v))
    np.testing.assert_array_equal(t2n(ds.cluster_bounds), t2n(own.cluster_bounds))
    np.testing.assert_allclose(t2n(ds.quad_coeffs), t2n(own.quad_coeffs), rtol=1e-6,
                               atol=1e-6 * float(own.quad_coeffs.abs().max()))


def test_path_trace_quad_matches_reference(teapot_quad):
    """The whole slice: teapot 32x32, depth 3, looper 0, through the port's
    quad engine (its plain versions on CPU tensors) against the reference's
    frame on the same scene bytes (its brute-force engine: interpret-mode
    Pallas inside a jitted frame is out of reach on the CPU); edge-exact
    ties may resolve differently, so the bound is on the mean."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.scene.camera import make_camera

    jds, jcam, ds, *_ = teapot_quad
    res, depth = 32, 3
    jcam = jcam.replace(width=res, height=res)
    jd, ji = (np.asarray(a) for a in jax.jit(jpt.path_trace, static_argnames=(
        "max_depth",))(jds.replace(intersector="brute"), jcam, 0, depth))
    cam = make_camera(res, res, np.asarray(jcam.position), np.asarray(jcam.rotation),
                      fov_y=float(jcam.fov_y), lens_radius=float(jcam.lens_radius),
                      focal_dist=float(jcam.focal_dist), device="cpu")
    tally = Tally()
    d, i = pt.path_trace(ds, cam, 0, depth)
    assert tally("plain.quad") == {"closest_hit": depth + 1, "occlusion": depth}
    assert tally("launch.quad") == {}
    assert (jd + ji).mean() > 1e-2
    assert np.abs(t2n(d + i) - (jd + ji)).mean() < 2e-2


def test_cpu_tensors_take_the_plain_versions(soup):
    from radish_pt_tpu_torch.accel import quad as qd

    coeffs, center = _port_planes(soup["tp"])
    o, d = torch.from_numpy(soup["o"]), torch.from_numpy(soup["d"])
    feats = qd.quad_features(o, d, center)
    occl = torch.from_numpy(qd.numpy_quad_occl_packed(t2n(coeffs)))
    tally = Tally()
    qd.closest_hit(coeffs, feats, None, 64)
    qd.occlusion(coeffs, feats, None, o, d, 64, occl)
    assert tally("plain.quad") == {"closest_hit": 1, "occlusion": 1}
    assert tally("launch.quad") == {}
    packed = torch.from_numpy(qd.numpy_quad_packed(t2n(coeffs)))
    with pytest.raises(ValueError):  # the kernels refuse CPU tensors
        qd.closest_hit_cuda(packed, feats, None, 64)
    with pytest.raises(ValueError):
        qd.occlusion_cuda(occl, feats, None, o, d, 64)


@pytest.mark.parametrize("entry", ["load_scene", "build_device_scene", "Renderer",
                                   "make_camera"])
def test_entry_points_default_to_the_card(entry):
    """A user's call runs on the card unless it asks for the CPU."""
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import build_device_scene, load_scene
    from radish_pt_tpu_torch.scene.camera import make_camera

    fn = {"load_scene": load_scene, "build_device_scene": build_device_scene,
          "Renderer": Renderer.__init__, "make_camera": make_camera}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_renders_quad_on_cpu(tmp_path, capsys):
    from radish_pt_tpu_torch.cli import main

    out = tmp_path / "q.png"
    assert main([os.path.join(SCENES, "teapot.txt"), "--spp", "1", "--res", "16",
                 "16", "--depth", "2", "--device", "cpu", "--intersector", "quad",
                 "--out", str(out)]) == 0
    assert "engine quad" in capsys.readouterr().out
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# the closest-hit kernel's live terms, in plain torch
# ---------------------------------------------------------------------------


def _forms_of(scene, soup, teapot_quad):
    """(forms [T, 6, 28], packed [T, 64], packed shadow table [T, 84],
    centre) of the soup or of teapot."""
    from radish_pt_tpu_torch.accel import quad as qd

    if scene == "soup":
        coeffs, center = _port_planes(soup["tp"])
        c = t2n(coeffs)
        return (coeffs, torch.from_numpy(qd.numpy_quad_packed(c)),
                torch.from_numpy(qd.numpy_quad_occl_packed(c)), center)
    own = teapot_quad[3]
    return own.quad_coeffs, own.quad_packed, own.quad_occl_packed, own.sweep_center


@pytest.mark.parametrize("scene", ["soup", "teapot"])
def test_dropped_terms_are_structural_zeros(soup, teapot_quad, scene):
    """Of the 135 coefficients of q1..q5, the 72 the closest-hit kernel
    leaves out are exactly 0 on every triangle (81 of q1..q6's 162, which
    the shadow kernel leaves out), the packed [T, 64] table is the other
    63, form by form in monomial order, and one zero, and the packed
    shadow table [T, 84] is q1..q6's 81 live ones in the same order (its
    first 63 the closest hit's), and three zeros."""
    from radish_pt_tpu_torch.accel import quad as qd

    coeffs, packed, occl, _ = _forms_of(scene, soup, teapot_quad)
    c, packed, occl = t2n(coeffs), t2n(packed), t2n(occl)
    live = np.zeros((6, 28), bool)
    for p, terms in enumerate(qd.LIVE_TERMS):
        live[p, list(terms)] = True
    assert live[:5].sum() == 63 and (~live[:5, :27]).sum() == 72
    assert live.sum() == 81 and (~live[:, :27]).sum() == 81
    assert not c[:, ~live].any()
    assert all(np.abs(c[:, p][:, live[p]]).sum() > 0 for p in range(6))
    assert qd.FLOPS_PER_PAIR["closest_hit"] == 3 * 29 + 11 + 23 == 121
    assert packed.shape == (c.shape[0], 64) and packed.dtype == np.float32
    assert len(qd.LIVE_SLOTS) == 63 and not packed[:, 63].any()
    np.testing.assert_array_equal(packed[:, :63], c.reshape(-1, 168)[:, list(qd.LIVE_SLOTS)])
    for p, lo in enumerate((0, 15, 30)):  # the kernel's slot ranges
        np.testing.assert_array_equal(packed[:, lo:lo + 15], c[:, p, 0:15])
    np.testing.assert_array_equal(packed[:, 45:51], c[:, 3, 0:6])
    np.testing.assert_array_equal(packed[:, 51:63], c[:, 4, 15:27])
    # the shadow table: q6's 18 live terms after the closest hit's 63
    assert qd.FLOPS_PER_PAIR["occlusion"] == 3 * 29 + 11 + 23 + 35 == 156
    assert qd.OCCL_FLOPS_ALL_TERMS == 6 * 53 == 318
    assert occl.shape == (c.shape[0], 84) and occl.dtype == np.float32
    assert len(qd.OCCL_SLOTS) == 81 and not occl[:, 81:].any()
    np.testing.assert_array_equal(occl[:, :81], c.reshape(-1, 168)[:, list(qd.OCCL_SLOTS)])
    np.testing.assert_array_equal(occl[:, :63], packed[:, :63])
    np.testing.assert_array_equal(occl[:, 63:69], c[:, 5, 0:6])
    np.testing.assert_array_equal(occl[:, 69:81], c[:, 5, 15:27])


@pytest.mark.parametrize("scene", ["soup", "teapot"])
def test_live_terms_give_the_forms_by_value(soup, teapot_quad, scene):
    """Each form summed over its live monomials only, in order, equals the
    sum over all 27 (``forms``) by value on seeded rays: a dropped term
    adds an exact zero.  So the kernels' winners and shadow bits are the
    plain version's: q1..q5 from the closest hit's table, q1..q6 from the
    shadow table, also on unit-parameter segments."""
    from radish_pt_tpu_torch.accel import quad as qd

    coeffs, packed, occl, center = _forms_of(scene, soup, teapot_quad)
    rng = np.random.default_rng(5)
    n = 96
    o = rng.uniform(-7, 7, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    feats = qd.quad_features(torch.from_numpy(o), torch.from_numpy(d), center)
    tris = slice(0, 640)
    full = qd.forms(coeffs[tris], feats, qd.CLOSEST_PLANES)
    live = qd.forms_live(packed[tris], feats)
    assert live.shape == full.shape and live.dtype == torch.float32
    assert bool((live == full).all())
    assert float(full.abs().sum()) > 0 and bool((full.amin(-1) >= 0).any())
    y = rng.uniform(-7, 7, size=(n, 3)).astype(np.float32)
    y[::7] = o[::7]  # zero-length segments: all-zero features
    so, seg = qd.quad_segments(torch.from_numpy(o), torch.from_numpy(y))
    for f in (feats, qd.quad_features(so, seg, center)):
        full = qd.forms(coeffs[tris], f, qd.STORED_PLANES)
        live = qd.forms_live(occl[tris], f, qd.STORED_PLANES)
        assert live.shape == full.shape and bool((live == full).all())
        assert bool((full.amin(-1) >= 0).any())


# ---------------------------------------------------------------------------
# the shadow kernel's vote, skip and zero-length segments, in plain torch
# ---------------------------------------------------------------------------


def _segment_cases(scene, soup, teapot_quad):
    """(forms, cluster boxes, sub, centre, segment origins x, ends y) the
    shadow kernel's culling is held on: the soup's segments, or on teapot's
    quad build segments between surface points, from surface points 3
    units out in a random direction, and from camera-side points; every
    11th zero-length, 200 segments (a ragged last row)."""
    from radish_pt_tpu_torch.accel import quad as qd

    rng = np.random.default_rng(21)
    if scene == "soup":
        coeffs, center = _port_planes(soup["tp"])
        cb = torch.from_numpy(soup["cb"])
        x, y = soup["x"][:200].copy(), soup["y"][:200].copy()
        return coeffs, cb, 64, center, torch.from_numpy(x), torch.from_numpy(y)
    own, o = teapot_quad[3], teapot_quad[4]
    tri = t2n(own.tri_v)
    real = np.flatnonzero(np.abs(tri).sum(axis=(1, 2)) > 0)

    def surface(k):
        w = rng.dirichlet([1, 1, 1], k).astype(np.float32)
        return np.einsum("nk,nkc->nc", w, tri[rng.choice(real, k)]).astype(np.float32)

    x, y = surface(200), surface(200)
    away = rng.normal(size=(200, 3)).astype(np.float32)
    away /= np.linalg.norm(away, axis=-1, keepdims=True)
    y[1::3] = x[1::3] + 3.0 * away[1::3]
    x[2::3] = o[:200][2::3]  # the fixture's camera rays' origins
    y[::11] = x[::11]
    assert qd.zero_segments(qd.quad_features(*qd.quad_segments(
        torch.from_numpy(x), torch.from_numpy(y)), own.sweep_center))[::11].all()
    return (own.quad_coeffs, own.cluster_bounds, own.cluster_sub, own.sweep_center,
            torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("scene", ["soup", "teapot"])
def test_lane_skip_is_conservative_on_quad_segments(soup, teapot_quad, scene):
    """The shadow kernel's per-segment skip (slab_reach on the
    unit-parameter segment at reach 1, the twin of
    plucker.lane_skip_flags_plain): every (segment, triangle) pair whose
    six forms are all >= 0 lies in a cluster the skip keeps at reach 1 —
    0 pairs outside, on segments that are not zero-length (those are
    settled before any sweep) — and the skip culls (segment, cluster)
    pairs: most of them on teapot, where segments are short against the
    scene; on the soup, whose segments cross it, some."""
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import quad as qd

    coeffs, cb, sub, center, x, y = _segment_cases(scene, soup, teapot_quad)
    so, seg = qd.quad_segments(x, y)
    feats = qd.quad_features(so, seg, center)
    live = ~qd.zero_segments(feats)
    blocking = (qd.forms(coeffs, feats, qd.STORED_PLANES).amin(-1) >= 0.0)[live]
    assert int(blocking.sum()) > 20
    keep = plk.lane_skip_flags_plain(cb, so, seg, torch.ones(so.shape[0]))[live]
    cluster = torch.arange(coeffs.shape[0]) // sub
    assert int((blocking & ~keep[:, cluster]).sum()) == 0
    assert float(keep.float().mean()) < (0.5 if scene == "teapot" else 0.8)


@pytest.mark.parametrize("scene", ["soup", "teapot"])
def test_shadow_vote_equals_row_words(soup, teapot_quad, scene):
    """The shadow kernel's vote in plain torch (occl_words_plain: each
    lane's slab test at range 1, ORed per warp and then over the row's
    four warps, padding lanes as the prepass pads them) gives
    cluster_mask_words(cluster_bounds, o, seg, ones) bit for bit,
    zero-length segments and a ragged last row included."""
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import quad as qd

    _, cb, _, _, x, y = _segment_cases(scene, soup, teapot_quad)
    so, seg = qd.quad_segments(x, y)
    want = plk.cluster_mask_words(cb, so, seg, torch.ones(so.shape[0]))
    got = qd.occl_words_plain(cb, so, seg)
    assert got.dtype == torch.int32 and got.shape == want.shape == (2, -(-cb.shape[0] // 32))
    np.testing.assert_array_equal(t2n(got), t2n(want))
    assert bool(plk.unpack_mask(want, cb.shape[0]).any(1).all())


@pytest.mark.parametrize("culled", [False, True])
def test_zero_length_segments_blocked_where_their_row_sweeps(soup, culled):
    """The rule the shadow kernel settles zero-length segments by before
    any sweep, held on the plain version: a segment whose 27 features are
    all 0 is blocked exactly where its row's words flag a cluster (every
    triangle without boxes); the others follow their forms."""
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import quad as qd

    s = soup
    coeffs, center = _port_planes(s["tp"])
    cb = torch.from_numpy(s["cb"]) if culled else None
    so, seg = qd.quad_segments(torch.from_numpy(s["x"]), torch.from_numpy(s["y"]))
    # rows of far segments that flag no cluster, as the last row's lanes
    so[128:] = so[128:] + 1e3
    feats = qd.quad_features(so, seg, center)
    zero = qd.zero_segments(feats)
    assert int(zero.sum()) == 37 and bool(zero[::7].all())
    occ = qd.occlusion(coeffs, feats, cb, so, seg, 64)
    if culled:
        rows = plk.unpack_mask(qd.occl_words_plain(cb, so, seg), 5).any(1)
        assert rows.tolist() == [True, False]
    else:
        rows = torch.ones(2, dtype=torch.bool)
    np.testing.assert_array_equal(t2n(occ[zero]), t2n(rows.repeat_interleave(128)[zero]))
