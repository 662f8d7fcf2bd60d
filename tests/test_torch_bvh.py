"""Port parity for the bvh engine (accel/traverse.py, csrc/bvh.cu): the
port's BVH tables against the JAX ``DeviceScene``'s, its plain MTBVH walks
against the JAX package's ``intersect_bvh`` / ``occlusion_bvh`` /
``intersect_bvh_heatmap`` on teapot (primaries, a bounce-1 wavefront with
dead lanes and its NEE segments), the slab test where 0 * inf gives NaN,
a teapot frame on the engine, the heatmap tracer through ``Renderer``, and
the engine's routing.

Tolerances: prim ids, shadow bits and heatmap counts equal on every lane;
dist within 5e-5 relative and barycentrics within 1e-5 absolute, as
tests/test_torch_dense.py states for the same Möller–Trumbore: the JAX
walk runs under XLA, which contracts products and sums into FMAs, where
the port rounds every operation on its own.  On teapot one lane of each
2,304-lane wavefront differs by more than 1e-5 in a barycentric (2.9e-5
and 1.1e-5, winners with det ~1e-3, where f32 rounding is amplified a
thousandfold); the test counts those lanes and holds each to the exact
(f64) barycentrics of its winner, to which the port's value is nearer
than the JAX walk's.  The JAX ``intersect_bvh`` defers its leaves and so
prunes with a stale best; it visits more nodes but tests the same leaves
in the same order, so the winners agree."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
from torch_port_util import (SCENES, camera_from_jax, jax_scene_parts,  # noqa: E402
                             load_jax_scene, t2n)

REPO = os.path.join(os.path.dirname(__file__), "..")
RES = 48


def _exact_bary(tri_packed, prim, o, d):
    """The barycentrics of winner ``prim`` on each ray, in f64."""
    tri = tri_packed[np.maximum(prim, 0)].astype(np.float64)
    v0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    o, d = o.astype(np.float64), d.astype(np.float64)
    p = np.cross(d, e2)
    det = (e1 * p).sum(1)
    s = o - v0
    return np.stack([(s * p).sum(1), (d * np.cross(s, e1)).sum(1)], 1) / det[:, None]


def _check_closest(got, want, exact=None, max_off=0):
    """Winners equal, dist within 5e-5 relative, barycentrics within 1e-5
    absolute on every lane but at most ``max_off``, each of which must be
    nearer ``exact`` (f64 barycentrics of the winner) than ``want``'s."""
    (pg, tg, bg), (pw, tw, bw) = [tuple(np.asarray(x) for x in r) for r in (got, want)]
    np.testing.assert_array_equal(pg, pw)
    np.testing.assert_allclose(tg, tw, rtol=5e-5, atol=0)
    off = np.abs(bg - bw).max(1) > 1e-5
    assert off.sum() <= max_off, f"{off.sum()} lanes' barycentrics differ by more than 1e-5"
    if off.any():
        nearer = np.abs(bg - exact).max(1) < np.abs(bw - exact).max(1)
        assert nearer[off].all(), np.flatnonzero(off & ~nearer)
    np.testing.assert_allclose(bg[~off], bw[~off], rtol=0, atol=1e-5)


@pytest.mark.parametrize("fname", ["cornell_box.txt", "teapot.txt"])
@pytest.mark.parametrize("jax_engine,engine", [("bvh", "bvh"), ("pallas_mxu", "plucker")])
def test_bvh_tables_match_jax(fname, jax_engine, engine, monkeypatch):
    """The port's own build keeps the JAX build's BVH tables, element for
    element (the int fields of the node table as their bits): the packed
    node table, the leaf-major triangles and the leaf slot map through the
    storage order and the cluster padding (64-triangle clusters on the bvh
    engine, 128 on Plücker's teapot); the scene bridge carries them."""
    from radish_pt_tpu_torch.scene.build import load_scene
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    jds, _, _ = load_jax_scene(monkeypatch, fname, engine=jax_engine)
    ds, _, _ = load_scene(os.path.join(SCENES, fname), device="cpu", intersector=engine)
    assert ds.intersector == engine and ds.cluster_sub == jds.cluster_sub
    bridged = scene_from_jax(*jax_scene_parts(jds), intersector="bvh")
    for name in ("bvh_packed", "leaf_tris", "leaf_map"):
        want = np.asarray(getattr(jds, name))
        for got in (t2n(getattr(ds, name)), t2n(getattr(bridged, name))):
            assert got.shape == want.shape and got.dtype == want.dtype, name
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), name)
    lm = t2n(ds.leaf_map)
    real = lm[lm >= 0]
    # every stored real triangle once; its slot's triangle is the stored one
    assert np.unique(real).size == real.size
    assert np.array_equal(np.sort(real), np.flatnonzero(np.abs(t2n(ds.tri_packed)).sum(1)))
    L = ds.leaf_tris.shape[1] // 9
    slots = np.flatnonzero(lm >= 0)
    np.testing.assert_array_equal(t2n(ds.leaf_tris).reshape(-1, 9)[slots],
                                  t2n(ds.tri_packed)[real])
    assert L == 16
    if fname == "teapot.txt":  # the padding moved the stored ids
        assert (np.sort(real) != np.arange(real.size)).any()


@pytest.fixture(scope="module")
def teapot():
    """The JAX package's teapot (bvh engine, numpy host path), its camera
    at 48x48, the port's scene carried across on the bvh engine, and the
    port's bounce-1 wavefronts of the 48x48 frame (chip_smoke.bounce_one,
    built as ``path_trace`` builds them)."""
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    mp = pytest.MonkeyPatch()
    try:
        jds, jcam, _ = load_jax_scene(mp, "teapot.txt", engine="bvh")
    finally:
        mp.undo()
    ds = scene_from_jax(*jax_scene_parts(jds), intersector="bvh")
    cam = camera_from_jax(jcam, RES, RES)
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    waves = chip_smoke.bounce_one(ds, cam)
    return jds, jcam, ds, cam, waves


def _rays(teapot, what):
    o, d, tmax = teapot[4][what]
    return o.contiguous(), d.contiguous(), tmax >= 0


@pytest.mark.parametrize("what", ["primary", "extension"])
def test_intersect_bvh_plain_matches_jax(teapot, what):
    """2,304 lanes (more than 512, so the JAX walk's tail compaction runs):
    the 48x48 primaries, and the bounce-1 extension rays with their dead
    lanes (the walk reads no range: dead lanes are walked as any ray)."""
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel import traverse as trv

    jds, _, ds, _, _ = teapot
    o, d, live = _rays(teapot, what)
    assert o.shape[0] > 512 and (what == "primary" or 0 < int((~live).sum()) < o.shape[0])
    want = jtrv.intersect_bvh(jds.leaf_tris, jds.leaf_map, jds.bvh_packed,
                              jnp.asarray(t2n(o)), jnp.asarray(t2n(d)))
    tally = Tally()
    got = trv.intersect_bvh_plain(ds.leaf_tris, ds.leaf_map, ds.bvh_packed, o, d)
    assert tally("plain.traverse") == {"closest_hit": 1}
    assert tally("launch.traverse") == {}
    exact = _exact_bary(t2n(ds.tri_packed), t2n(got[0]), t2n(o), t2n(d))
    _check_closest(tuple(t2n(x) for x in got), want, exact, max_off=1)
    hits = t2n(got[0]) >= 0
    assert 0.3 < hits.mean() and (hits.all() if what == "primary" else not hits.all())
    # the brute-force oracle: the same winners (the same arithmetic over
    # every stored triangle, ties to the lower id)
    pb, tb, bb = trv.intersect_brute(ds.tri_packed, o, d)
    assert torch.equal(got[0], pb) and torch.equal(got[1], tb) and torch.equal(got[2], bb)


def test_occlusion_bvh_plain_matches_jax(teapot):
    """The bounce-1 NEE segments (masked lanes zero-length) and segments
    from the primaries' origins to random points along them, some past the
    first hit: the shadow bits equal the JAX walk's on every lane."""
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel import traverse as trv

    jds, _, ds, _, waves = teapot
    x, y, ok = waves["segments"]
    o, d, _ = _rays(teapot, "primary")
    rng = np.random.default_rng(5)
    reach = torch.from_numpy(rng.uniform(0.5, 30, (o.shape[0], 1)).astype(np.float32))
    xs, ys = torch.cat([x, o]), torch.cat([y, o + d * reach])
    want = np.asarray(jtrv.occlusion_bvh(jds.leaf_tris, jds.leaf_map, jds.bvh_packed,
                                         jnp.asarray(t2n(xs)), jnp.asarray(t2n(ys))))
    tally = Tally()
    got = t2n(trv.occlusion_bvh(ds.leaf_tris, ds.bvh_packed, xs, ys))
    assert tally("plain.traverse")["occlusion"] == 1
    np.testing.assert_array_equal(got, want)
    n_seg = x.shape[0]
    assert not got[:n_seg][~t2n(ok)].any()  # zero-length: never blocked
    assert 0.05 < got[:n_seg][t2n(ok)].mean() < 0.95 and 0.05 < got[n_seg:].mean() < 0.95
    np.testing.assert_array_equal(got, t2n(trv.occlusion_brute(ds.tri_packed, xs, ys)))


@pytest.mark.parametrize("what", ["primary", "extension"])
def test_heatmap_plain_matches_jax(teapot, what):
    """Descended nodes per lane equal the JAX heatmap walk's on every
    lane."""
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel import traverse as trv

    jds, _, ds, _, _ = teapot
    o, d, _ = _rays(teapot, what)
    want = np.asarray(jtrv.intersect_bvh_heatmap(jds.leaf_tris, jds.leaf_map,
                                                 jds.bvh_packed, jnp.asarray(t2n(o)),
                                                 jnp.asarray(t2n(d))))
    got = t2n(trv.intersect_bvh_heatmap(ds.leaf_tris, ds.bvh_packed, o, d))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.min() >= 1 and got.max() > 2 * got.min()


def _slab_grid():
    """Every combination of origin and direction components from values on
    and off the unit box's planes, and zero components of both signs."""
    vals_o = np.array([0.0, 0.5, 1.0, -1.0, 2.0], np.float32)
    vals_d = np.array([0.0, -0.0, 1.0, -1.0, 0.5], np.float32)
    og = np.stack(np.meshgrid(vals_o, vals_o, vals_o, indexing="ij"), -1).reshape(-1, 3)
    dg = np.stack(np.meshgrid(vals_d, vals_d, vals_d, indexing="ij"), -1).reshape(-1, 3)
    o = np.repeat(og, len(dg), axis=0)
    d = np.tile(dg, (len(og), 1))
    return o, d


def test_slab_core_nan_cases_match_jax():
    """An origin on a slab plane with that direction component 0 gives
    0 * inf = NaN: the port's slab test keeps the JAX package's verdict
    and t_near (NaN -> -FLT_MAX / +FLT_MAX, infinities clamped) on every
    combination, the NaN cases included."""
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel import traverse as trv

    o, d = _slab_grid()
    with np.errstate(divide="ignore"):
        inv = (np.float32(1.0) / d).astype(np.float32)
    with np.errstate(invalid="ignore"):
        assert np.isnan((np.float32(0.0) - o) * inv).any()  # the NaN cases exist
    lo = np.zeros((1, 3), np.float32)
    hi = np.ones((1, 3), np.float32)
    args = [lo[:, 0], lo[:, 1], lo[:, 2], hi[:, 0], hi[:, 1], hi[:, 2],
            o[:, 0], o[:, 1], o[:, 2], inv[:, 0], inv[:, 1], inv[:, 2]]
    jh, jt = (np.asarray(x) for x in jtrv._slab_core(*(jnp.asarray(a) for a in args)))
    th, tt = trv._slab_core(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    np.testing.assert_array_equal(t2n(th), jh)
    np.testing.assert_array_equal(t2n(tt), jt)
    assert jh.any() and not jh.all()
    # the inverse through torch is the same IEEE division, signed zeros too
    np.testing.assert_array_equal(t2n(1.0 / torch.from_numpy(d)), inv)


def test_walk_on_slab_planes_matches_jax(monkeypatch):
    """Cornell's walls lie on its boxes' planes: rays from points on the
    left wall and on the floor with that axis's direction component 0 walk
    through NaN slab axes; the port's walk gives the JAX walk's winners,
    and the brute-force oracle's."""
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel import traverse as trv
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    jds, _, _ = load_jax_scene(monkeypatch, "cornell_box.txt", engine="bvh")
    ds = scene_from_jax(*jax_scene_parts(jds), intersector="bvh")
    v = t2n(ds.tri_v).reshape(-1, 3)
    lo, hi = v.min(0), v.max(0)
    rng = np.random.default_rng(9)
    n = 600
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    for k, axis in enumerate((0, 1, 2)):  # thirds: on the x, y, z minimum planes
        s = slice(k * n // 3, (k + 1) * n // 3)
        o[s, axis] = lo[axis]
        d[s, axis] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = jtrv.intersect_bvh(jds.leaf_tris, jds.leaf_map, jds.bvh_packed,
                              jnp.asarray(o), jnp.asarray(d))
    got = trv.intersect_bvh_plain(ds.leaf_tris, ds.leaf_map, ds.bvh_packed,
                                  torch.from_numpy(o), torch.from_numpy(d))
    _check_closest(tuple(t2n(x) for x in got), want)
    pb, _, _ = trv.intersect_brute(ds.tri_packed, torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(got[0], pb)
    assert (t2n(got[0]) >= 0).mean() > 0.5
    jh = np.asarray(jtrv.intersect_bvh_heatmap(jds.leaf_tris, jds.leaf_map, jds.bvh_packed,
                                               jnp.asarray(o), jnp.asarray(d)))
    th = t2n(trv.intersect_bvh_heatmap(ds.leaf_tris, ds.bvh_packed, torch.from_numpy(o),
                                       torch.from_numpy(d)))
    np.testing.assert_array_equal(th, jh)


def test_path_trace_bvh_matches_jax(teapot):
    """A 48x48 teapot frame (depth 3, loopers 0-1) on the port's bvh
    engine: equal to the port's brute-force frame bit for bit (the same
    winners, barycentrics and shadow bits), through the plain walks (d + 1
    closest hits and d shadow walks a frame); against the JAX package's
    frame on its BVH walk, the same scene bytes, at most 2 of 2,304 pixels
    beyond 1e-3 and the mean absolute difference below 1e-4.  The JAX
    package's brute-force frame is its BVH frame, pixel for pixel, and
    the port's brute-force frame differs from it on the same pixels
    (measured: 2 and 1 pixels, up to 0.18, means 2.0e-5 and 7.7e-5): where
    a path meets a near-tie, XLA's FMA rounding and the port's separate
    roundings part it, as in the barycentrics above."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, jcam, ds, cam, _ = teapot
    depth = 3
    f = jax.jit(jpt.path_trace, static_argnames=("max_depth",))
    tally = Tally()
    for looper in (0, 1):
        jd, ji = (np.asarray(a) for a in f(jds, jcam.replace(width=RES, height=RES),
                                           looper, depth))
        want = jd + ji
        d, i = pt.path_trace(ds, cam, looper, depth)
        got = t2n(d + i)
        assert want.mean() > 1e-2 and np.isfinite(got).all()
        assert (np.abs(got - want) > 1e-3).any(axis=-1).sum() <= 2
        assert np.abs(got - want).mean() < 1e-4
        db, ib = pt.path_trace(ds.replace(intersector="brute"), cam, looper, depth)
        assert torch.equal(d, db) and torch.equal(i, ib)
    assert tally("plain.traverse") == {"closest_hit": 2 * (depth + 1), "occlusion": 2 * depth}


def test_renderer_heatmap_matches_jax(teapot):
    """``Renderer`` with the BVH heatmap tracer against the JAX renderer's
    image: equal, pixel for pixel ([t, 1 - t, 0], t = steps / max steps,
    the same counts); the displayed image is that frame's."""
    from radish_pt_tpu.config import Settings as JSettings
    from radish_pt_tpu.config import Tracer as JTracer
    from radish_pt_tpu.render.renderer import Renderer as JRenderer
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer

    jds, jcam, ds, cam, _ = teapot
    jr = JRenderer(ds=jds, cam=jcam.replace(width=RES, height=RES),
                   settings=JSettings(tracer=JTracer.BVH_VISUALIZE))
    jr.step()
    want = np.asarray(jr.current_image())
    tally = Tally()
    for engine in ("bvh", "plucker"):  # the heatmap walks whatever the engine
        r = Renderer(ds=ds.replace(intersector=engine), cam=cam,
                     settings=Settings(tracer=Tracer.BVH_VISUALIZE), device="cpu")
        disp = r.step()
        got = t2n(r.current_image())
        np.testing.assert_array_equal(got, want)
        assert disp.shape == (RES, RES, 3)
    assert tally("plain.traverse")["heatmap"] == 2
    assert got[:, 2].max() == 0 and got[:, 0].max() == 1.0 and 0 < got[:, 0].mean() < 1


def test_wrappers_refuse_cpu_tensors(teapot):
    """The kernel wrappers take only CUDA tensors (the CPU goes through the
    plain versions, by the entry points)."""
    from radish_pt_tpu_torch.accel import traverse as trv

    ds = teapot[2]
    o, d, _ = _rays(teapot, "primary")
    with pytest.raises(ValueError, match="CUDA"):
        trv.intersect_bvh_cuda(ds.leaf_tris, ds.leaf_map, ds.bvh_packed, o, d)
    with pytest.raises(ValueError, match="CUDA"):
        trv.occlusion_bvh_cuda(ds.leaf_tris, ds.bvh_packed, o, d, torch.ones(len(o)))
    with pytest.raises(ValueError, match="CUDA"):
        trv.intersect_bvh_heatmap_cuda(ds.leaf_tris, ds.bvh_packed, o, d)


def test_engine_routes_through_walk(teapot):
    """``intersect`` and ``test_occlusion`` on the bvh engine go through the
    walk (counted) and give the brute engine's interactions, dead lanes
    masked (the walk settles them without a walk, so their unread pos /
    norm / uv are the brute engine's on live lanes only); "bvh_plain" is
    the same walk on any device."""
    from radish_pt_tpu_torch.scene import device_scene as dsc

    ds = teapot[2]
    o, d, live = _rays(teapot, "extension")
    tally = Tally()
    a = dsc.intersect(ds, o, d, active=live)
    b = dsc.intersect(ds.replace(intersector="brute"), o, d, active=live)
    c = dsc.intersect(ds.replace(intersector="bvh_plain"), o, d, active=live)
    for name in ("prim_id", "mat_id", "pos", "norm", "uv"):
        assert torch.equal(getattr(a, name)[live], getattr(b, name)[live]), name
        assert torch.equal(getattr(a, name), getattr(c, name)), name
    assert torch.equal(a.prim_id, b.prim_id) and torch.equal(a.mat_id, b.mat_id)
    assert bool((a.prim_id[~live] == -1).all())
    y = o + d * 3.0
    assert torch.equal(dsc.test_occlusion(ds, o, y),
                       dsc.test_occlusion(ds.replace(intersector="brute"), o, y))
    assert tally("plain.traverse") == {"closest_hit": 2, "occlusion": 1}


def test_walk_stats_count_what_the_walk_does(teapot):
    """The plain walk's counts, from which chip_smoke.py bounds the
    kernels: every lane visits at least the root, a closest hit tests
    whole leaves, an any-hit lane stops at its blocking slot, and the rows
    and leaves touched are those the lanes reached."""
    from radish_pt_tpu_torch.accel import traverse as trv

    ds = teapot[2]
    o, d, _ = _rays(teapot, "primary")
    L = ds.leaf_tris.shape[1] // 9
    st = {}
    steps = trv.intersect_bvh_heatmap_plain(ds.leaf_tris, ds.bvh_packed, o, d, stats=st)
    assert bool((st["visits"] >= steps).all()) and bool((st["visits"] >= 1).all())
    assert bool((st["pairs"] % L == 0).all()) and int(st["pairs"].sum()) > 0
    assert 0 < int(st["leaves"].sum()) <= ds.leaf_tris.shape[0]
    assert 0 < int(st["rows"].sum()) <= ds.bvh_packed.shape[0]
    so, sd, tm = trv.segment_rays(o, o + d * 30.0)
    st2 = {}
    occ = trv.occlusion_bvh_plain(ds.leaf_tris, ds.bvh_packed, so, sd, tm, stats=st2)
    assert bool(occ.any()) and bool((st2["pairs"][occ] % L != 0).any())
    assert int(st2["visits"].sum()) < int(st["visits"].sum())


def test_front_ends_offer_bvh(tmp_path):
    """``--tracer bvh`` and ``--intersector bvh`` run on the CPU; the build
    offers the engine by name only; the renderer refuses no tracer; a
    bvh block is captured on the card."""
    from radish_pt_tpu_torch import profile, tune
    from radish_pt_tpu_torch.cli import build_arg_parser, main
    from radish_pt_tpu_torch.scene import engines
    from radish_pt_tpu_torch.scene.build import choose_intersector

    assert "bvh" in engines.NAMES
    assert choose_intersector(4992) == "plucker" and choose_intersector(36, "bvh") == "bvh"
    assert engines.get("bvh").capturable
    args = build_arg_parser().parse_args(["x.txt", "--intersector", "bvh", "--tracer", "bvh"])
    assert (args.intersector, args.tracer) == ("bvh", "bvh")
    assert any("bvh" in stage for _, stage in profile.STAGES)
    assert tune.BVH_VARIANTS
    for flags in (["--tracer", "bvh"], ["--intersector", "bvh"]):
        out = tmp_path / f"{flags[1]}_{flags[0][2:]}.png"
        assert main([os.path.join(SCENES, "teapot.txt"), "--spp", "1", "--res", "16", "16",
                     "--depth", "2", "--device", "cpu", *flags, "--out", str(out)]) == 0
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
