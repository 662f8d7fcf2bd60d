"""Port parity: the compact work-list engine (slab and sphere prepasses, the
work list, the compact closest-hit and shadow sweeps, the scene build that
picks it, and a frame through it) against the reference's compact
functions, run in interpret mode on the CPU with f32 planes, and against
the port's brute-force oracle.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
builds csrc/compact.cu and holds them against the plain versions here.
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
LANES = 256


def _cluster_bounds(tri_packed):
    """AABBs of consecutive 64-triangle clusters (tests/test_pallas.py)."""
    tp = np.asarray(tri_packed)
    v = np.stack([tp[:, 0:3], tp[:, 0:3] + tp[:, 3:6], tp[:, 0:3] + tp[:, 6:9]], 1)
    n_c = -(-tp.shape[0] // 64)
    cb = np.empty((n_c, 6), np.float32)
    for c in range(n_c):
        g = v[c * 64:(c + 1) * 64].reshape(-1, 3)
        cb[c, 0:3], cb[c, 3:6] = g.min(axis=0), g.max(axis=0)
    return cb


@pytest.fixture(scope="module")
def soup():
    """1,000 triangles in 16 spatial clumps (16 clusters, the last one
    ragged) and 700 rays (three row groups, the last ragged), each run of
    64 lanes leaving points 2-5 away from one clump towards points near it
    (so a row group flags a few clumps, not all); every 7th lane dead
    (tmax = -FLT_MAX), every 5th bounded by a finite tmax."""
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel.plucker import numpy_coeffs

    rng = np.random.default_rng(9)
    n_tris, n = 1000, 700
    clumps = rng.uniform(-5, 5, size=(16, 3))
    centers = clumps.repeat(64, axis=0)[:n_tris, None, :]
    tri = (centers + rng.normal(scale=0.3, size=(n_tris, 3, 3))).astype(np.float32)
    tri_packed = jtrv.pack_tris(tri)
    k = (np.arange(n) // 64) % 16
    away = rng.normal(size=(n, 3))
    away /= np.linalg.norm(away, axis=-1, keepdims=True)
    o = (clumps[k] + away * rng.uniform(2, 5, (n, 1))).astype(np.float32)
    d = clumps[k] + rng.normal(scale=0.4, size=(n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, FLT_MAX, np.float32)
    tmax[::5] = rng.uniform(2.0, 12.0, tmax[::5].shape)
    tmax[::7] = -FLT_MAX
    coeffs, center = numpy_coeffs(tri_packed)
    return dict(tri_packed=tri_packed, cb=_cluster_bounds(tri_packed), o=o, d=d,
                tmax=tmax, coeffs=coeffs, center=center)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _padded(s):
    """Both packages' padded rays for the prepass tests."""
    from radish_pt_tpu_torch.accel import compact as cpt

    rows = -(-s["o"].shape[0] // LANES)
    o, d, tm = cpt._pad_rays(*_t(s["o"], s["d"], s["tmax"]), rows * LANES)
    return rows, o, d, tm


def test_slab_flags_and_tn_match_reference(soup):
    """(a) The slab prepass and its entry distances equal the reference's
    _row_flags(with_tn=True) exactly: the same f32 operations."""
    from radish_pt_tpu.accel import pallas_kernels as pk
    from radish_pt_tpu_torch.accel import compact as cpt

    rows, o, d, tm = _padded(soup)
    flags, tn = cpt._row_flags(torch.from_numpy(soup["cb"]), o, d, tm, rows,
                               LANES, with_tn=True)
    jo, jd, jtm = pk._pad_rays(jnp.asarray(soup["o"]), jnp.asarray(soup["d"]),
                               jnp.asarray(soup["tmax"]), rows * LANES)
    jf, jtn = pk._row_flags(jnp.asarray(soup["cb"]), jo, jd, jtm, rows, LANES,
                            with_tn=True)
    np.testing.assert_array_equal(t2n(flags), np.asarray(jf))
    np.testing.assert_array_equal(t2n(tn), np.asarray(jtn))
    assert 0.1 < t2n(flags).mean() < 0.95


def _sphere_inputs(s):
    from radish_pt_tpu_torch.accel import compact as cpt

    rows, o, d, tm = _padded(s)
    cb, center = _t(s["cb"], s["center"])
    return (rows, o, d, tm, cb, center, cpt._sphere_feats(o - center, d, tm),
            cpt._sphere_plane_coeffs(cb, center))


def test_sphere_flags_match_reference(soup):
    """(b) The sphere prepass in f32 against the reference's bf16x3 kernel
    (interpret mode): a superset of the exact slab flags; the same flag on
    >= 99.9% of the (row group, unit) entries, each disagreement decided by
    a lane within one slack term of a plane (the slack covers the bf16
    split's error, pallas_kernels.py:1109-1111); tn within 1e-4 of the
    scene scale where both flag (the split's error is relative to the
    largest term, not to tn)."""
    from radish_pt_tpu.accel import pallas_kernels as pk
    from radish_pt_tpu_torch.accel import compact as cpt

    rows, o, d, tm, cb, center, feats, planes = _sphere_inputs(soup)
    flags, tn = cpt.sphere_flags_plain(feats, planes)
    slab = cpt._row_flags(cb, o, d, tm, rows, LANES)
    assert bool((flags | slab).eq(flags).all())  # superset: no false miss
    assert 0.1 < t2n(flags).mean() < 0.95
    jf, jtn = pk._sphere_flags(jnp.asarray(soup["cb"]), jnp.asarray(soup["center"]),
                               jnp.asarray(t2n(o - center)), jnp.asarray(t2n(d)),
                               jnp.asarray(t2n(tm)), rows, LANES,
                               interpret=True, with_tn=True)
    n_c = cb.shape[0]
    jf, jtn = np.asarray(jf)[:, :n_c], np.asarray(jtn)[:, :n_c]
    f, tn = t2n(flags), t2n(tn)
    diff = f != jf
    assert diff.mean() <= 1e-3
    if diff.any():
        # per lane and unit: each plane's value in units of its slack
        p = t2n(planes).astype(np.float64)
        fe = t2n(feats).astype(np.float64)
        vals = np.einsum("nk,pkc->pnc", fe, p)
        scale = np.max(np.linalg.norm(0.5 * (soup["cb"][:, :3] + soup["cb"][:, 3:])
                                      - soup["center"], axis=1)
                       + 0.5 * np.linalg.norm(soup["cb"][:, 3:] - soup["cb"][:, :3],
                                              axis=1))
        slack = np.array([2e-4 * scale ** 2 + 1e-12, 2e-4 * scale + 1e-6,
                          2e-4 * scale + 1e-6])[:, None, None]
        margin = (vals / slack).min(axis=0).reshape(rows, LANES, n_c).max(axis=1)
        assert np.all(np.abs(margin[diff]) <= 1.0)
    both = f & jf
    np.testing.assert_allclose(tn[both], jtn[both], rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(tn[both]).max())))


def test_padding_units_never_flag(soup):
    """Coarsened boxes enclose their clusters, the padding clusters of the
    last unit (inverted boxes) leaving it unchanged; an inverted-box unit
    never flags in the sphere prepass and its tn stays FLT_MAX.  (The slab
    test, as the reference's, does flag an inverted box, but the port's
    coarsening never makes a unit of padding alone.)"""
    from radish_pt_tpu_torch.accel import compact as cpt

    rows, o, d, tm, cb, center, feats, _ = _sphere_inputs(soup)
    coarse = cpt._coarsen_bounds(cb, 6)  # 16 clusters -> 3 units, 2 padding
    assert coarse.shape == (3, 6)
    np.testing.assert_array_equal(t2n(coarse[2]), np.concatenate(
        [soup["cb"][12:, :3].min(0), soup["cb"][12:, 3:].max(0)]))
    pad_box = torch.tensor([[FLT_MAX] * 3 + [-FLT_MAX] * 3])
    cull = torch.cat([coarse, pad_box])
    sph, tn = cpt.sphere_flags_plain(feats, cpt._sphere_plane_coeffs(cull, center))
    assert not bool(sph[:, -1].any()) and bool(sph[:, 0].any())
    assert bool((t2n(tn[:, -1]) == FLT_MAX).all())


@pytest.mark.parametrize("branch", ["slab", "sphere"])
def test_work_list_covers_flags_near_to_far(soup, branch):
    """(c) Each row group's slice holds exactly its flagged units, in
    ascending tn, with the tn of each (row group, unit) pair."""
    from radish_pt_tpu_torch.accel import compact as cpt

    rows, o, d, tm, cb, _, feats, planes = _sphere_inputs(soup)
    if branch == "slab":
        flags, tn = cpt._row_flags(cb, o, d, tm, rows, LANES, with_tn=True)
    else:
        flags, tn = cpt.sphere_flags_plain(feats, planes)
    items, item_tn, offsets = (t2n(x) for x in cpt.work_list(flags, tn))
    f, tn = t2n(flags), t2n(tn)
    assert offsets[0] == 0 and offsets[-1] == items.size == f.sum()
    for r in range(rows):
        sl = slice(offsets[r], offsets[r + 1])
        assert sorted(items[sl]) == list(np.flatnonzero(f[r]))
        np.testing.assert_array_equal(item_tn[sl], tn[r, items[sl]])
        assert np.all(np.diff(item_tn[sl]) >= 0)


@pytest.fixture
def variant(request, monkeypatch):
    """Prepass branch and unit size, set in both packages (trace-time
    constants in the reference, so its jit caches are cleared around)."""
    from radish_pt_tpu.accel import pallas_kernels as pk
    from radish_pt_tpu_torch.accel import compact as cpt

    sphere, unit_max = request.param
    if sphere:
        monkeypatch.setattr(cpt, "PER_RAY_PREPASS_MAX", 0)
        monkeypatch.setattr(pk, "_PER_RAY_PREPASS_MAX", 0)
    if unit_max:
        monkeypatch.setattr(cpt, "SPHERE_UNIT_MAX", unit_max)
        monkeypatch.setattr(pk, "_SPHERE_UNIT_MAX", unit_max)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


VARIANTS = [(False, None), (True, None), (False, 3), (True, 3)]
VARIANT_IDS = ["slab", "sphere", "slab-g6", "sphere-g6"]


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS, indirect=True)
def test_intersect_compact_matches_reference(soup, variant):
    """(d) Closest hit through each prepass branch, with g = 1 and with
    6-cluster units (the last unit ragged): prim ids exact against the
    reference's compact function and the brute-force oracle on live lanes;
    dead lanes miss.  A finite tmax only bounds the prepass, so a hit
    beyond it depends on how coarsely the engine culls (the reference's
    sphere branch falls back to its per-lane dense sweep here, its padded
    plane columns overflowing the work budget): on such lanes the port
    never returns a hit closer than the true one.  Distances are the exact
    f32 minimum here and the reference's packed-key t (2^-17 relative), so
    rtol 1e-4."""
    from radish_pt_tpu.accel.pallas_kernels import intersect_plucker_compact
    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel import traverse as trv

    s = soup
    coeffs, center, cb, o, d, tmax = _t(s["coeffs"], s["center"], s["cb"], s["o"],
                                        s["d"], s["tmax"])
    tally = Tally()
    prim, dist = cpt.intersect_compact(coeffs, center, cb, o, d, tmax=tmax)
    assert tally("plain.compact")["closest_hit"] == 1
    assert tally("plain.compact").get("sphere_flags", 0) == int(variant[0])
    p0, d0 = intersect_plucker_compact(
        jnp.asarray(s["tri_packed"]), jnp.asarray(s["o"]), jnp.asarray(s["d"]),
        cluster_bounds=jnp.asarray(s["cb"]), tmax=jnp.asarray(s["tmax"]),
        interpret=True, bf16x3=False)
    p0, d0 = np.asarray(p0), np.asarray(d0)
    prim, dist = t2n(prim), t2n(dist)
    pb, tb, _ = (t2n(x) for x in trv.intersect_brute(*_t(s["tri_packed"], s["o"],
                                                         s["d"])))
    live = s["tmax"] > 0
    assert np.all(prim[~live] == -1) and np.all(dist[~live] == FLT_MAX)
    within = live & ((s["tmax"] == FLT_MAX) | (tb <= s["tmax"]))
    assert within.sum() > 0.7 * live.sum()
    np.testing.assert_array_equal(prim[within], p0[within])
    np.testing.assert_array_equal(prim[within], pb[within])
    beyond = live & ~within
    assert beyond.any()
    assert np.all((prim[beyond] == pb[beyond]) | (dist[beyond] >= tb[beyond]))
    hits = within & (p0 >= 0)
    assert hits.sum() > 0.4 * live.sum()
    np.testing.assert_allclose(dist[hits], d0[hits], rtol=1e-4)


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS, indirect=True)
def test_occlusion_compact_matches_reference(soup, variant):
    """(d) Shadow segments, a seventh of them zero-length (y == x, the
    masked lanes): bits exact against the reference's compact function and
    the brute-force oracle."""
    from radish_pt_tpu.accel.pallas_kernels import occlusion_plucker_compact
    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel import traverse as trv

    s = soup
    x, y = _soup_segments(s)
    coeffs, center, cb, xt, yt = _t(s["coeffs"], s["center"], s["cb"], x, y)
    tally = Tally()
    occ = t2n(cpt.occlusion_compact(coeffs, center, cb, xt, yt))
    assert tally("plain.compact")["occlusion"] == 1
    want = np.asarray(occlusion_plucker_compact(
        jnp.asarray(s["tri_packed"]), jnp.asarray(x), jnp.asarray(y),
        cluster_bounds=jnp.asarray(s["cb"]), interpret=True, bf16x3=False))
    np.testing.assert_array_equal(occ, want)
    np.testing.assert_array_equal(
        occ, t2n(trv.occlusion_brute(torch.from_numpy(s["tri_packed"]), xt, yt)))
    assert 0.1 < want.mean() < 0.9 and not occ[::7].any()


def test_cpu_tensors_take_the_plain_versions(soup):
    from radish_pt_tpu_torch.accel import compact as cpt

    rows, o, d, tm, cb, center, feats, planes = _sphere_inputs(soup)
    tally = Tally()
    flags, tn = cpt.sphere_flags(feats, planes)
    assert tally("plain.compact")["sphere_flags"] == 1
    assert tally("launch.compact") == {}
    with pytest.raises(ValueError):  # the kernels refuse CPU tensors
        cpt.sphere_flags_cuda(feats, planes)
    items, item_tn, offsets = cpt.work_list(flags, tn)
    coeffs, = _t(soup["coeffs"])
    from radish_pt_tpu_torch.accel.plucker import numpy_packed_coeffs

    packed, = _t(numpy_packed_coeffs(soup["coeffs"]))
    spheres = cpt.unit_spheres(cb, center)
    with pytest.raises(ValueError):
        cpt.closest_hit_cuda(packed, spheres, feats[:, :10].contiguous(), tm, items,
                             item_tn, offsets, 1)
    with pytest.raises(ValueError):
        cpt.occlusion_cuda(packed, spheres, feats[:, :10].contiguous(), tm, items,
                           item_tn, offsets, 1)


def test_choose_intersector_by_count():
    """(e) The reference's automatic choice (build.py:281-290), on counts."""
    from radish_pt_tpu_torch.scene import engines
    from radish_pt_tpu_torch.scene.build import choose_intersector

    assert choose_intersector(131072) == "plucker"
    assert choose_intersector(131073) == "compact"
    assert choose_intersector(10, "compact") == "compact"
    assert choose_intersector(200_000, "plucker") == "plucker"
    for name in engines.NAMES:
        assert choose_intersector(10, name) == name
    for name in ("pallas_compact", "plucker_plain"):  # a plain twin is not built by name
        with pytest.raises(ValueError):
            choose_intersector(10, name)


@pytest.fixture(scope="module")
def teapot_compact():
    """The reference's pallas_compact build of teapot (its numpy host
    path) and the port's compact build of the same file."""
    from radish_pt_tpu_torch.scene.build import load_scene

    mp = pytest.MonkeyPatch()
    try:
        jds, jcam, _ = load_jax_scene(mp, "teapot.txt", "pallas_compact")
    finally:
        mp.undo()
    tds, tcam, _ = load_scene(os.path.join(SCENES, "teapot.txt"),
                              device="cpu", intersector="compact")
    return jds, jcam, tds, tcam


def test_compact_scene_build_matches_reference(teapot_compact):
    """(e) The compact layout: 64-triangle clusters, the same stored order,
    cluster boxes, light ids and planes as the reference's build."""
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    jds, _, tds, _ = teapot_compact
    assert tds.intersector == "compact" and jds.intersector == "pallas_compact"
    assert tds.cluster_sub == jds.cluster_sub == 64
    np.testing.assert_array_equal(t2n(tds.tri_v), np.asarray(jds.tri_v))
    np.testing.assert_array_equal(t2n(tds.cluster_bounds),
                                  np.asarray(jds.cluster_bounds))
    np.testing.assert_array_equal(t2n(tds.light_prim_ids),
                                  np.asarray(jds.light_prim_ids))
    ds = scene_from_jax(*jax_scene_parts(jds))
    assert ds.intersector == "compact"
    np.testing.assert_allclose(t2n(ds.sweep_coeffs), t2n(tds.sweep_coeffs),
                               rtol=1e-6, atol=1e-6 * float(tds.sweep_coeffs.abs().max()))


def test_path_trace_compact_matches_reference(teapot_compact):
    """(f) The whole slice: teapot 16x16, depth 3, loopers 0-1, through the
    port's compact engine (its plain versions on CPU tensors) against the
    reference's brute-force frames on the same scene bytes; edge-exact
    ties may resolve differently, so the bound is on the mean."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.scene.camera import make_camera
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    jds, jcam, _, _ = teapot_compact
    res, depth = 16, 3
    jcam = jcam.replace(width=res, height=res)
    f = jax.jit(jpt.path_trace, static_argnames=("max_depth",))
    jbrute = jds.replace(intersector="brute")
    ds = scene_from_jax(*jax_scene_parts(jds))
    cam = make_camera(res, res, np.asarray(jcam.position), np.asarray(jcam.rotation),
                      fov_y=float(jcam.fov_y), lens_radius=float(jcam.lens_radius),
                      focal_dist=float(jcam.focal_dist), device="cpu")
    tally = Tally()
    for lp in (0, 1):
        jd, ji = (np.asarray(x) for x in f(jbrute, jcam, lp, depth))
        d, i = pt.path_trace(ds, cam, lp, depth)
        err = np.abs(t2n(d + i) - (jd + ji)).mean()
        assert err < 1e-3, err
        assert (jd + ji).mean() > 1e-2
    assert tally("plain.compact")["closest_hit"] == 2 * (depth + 1)
    assert tally("plain.compact")["occlusion"] == 2 * depth
    assert "closest_hit" not in tally("launch.compact")


def test_cli_renders_compact_on_cpu(tmp_path, capsys):
    """(g) The CLI's --intersector flag."""
    from radish_pt_tpu_torch.cli import main

    out = tmp_path / "t.png"
    assert main([os.path.join(SCENES, "teapot.txt"), "--spp", "1", "--res", "16",
                 "16", "--depth", "2", "--device", "cpu", "--intersector",
                 "compact", "--out", str(out)]) == 0
    assert "engine compact" in capsys.readouterr().out
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# the closest-hit kernel's operands and per-lane culling, in plain torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene", ["soup", "teapot"])
def test_packed_table_holds_the_live_coefficients(soup, teapot_compact, scene):
    """The packed [T, 20] table is the 19 live slots of the planes in the
    kernels' staging order and one zero; the 21 slots it drops are exactly
    0 on every triangle, so no product is lost."""
    from radish_pt_tpu_torch.accel import plucker as plk

    if scene == "soup":
        coeffs = soup["coeffs"]
        packed = plk.numpy_packed_coeffs(coeffs)
    else:
        tds = teapot_compact[2]
        coeffs, packed = t2n(tds.sweep_coeffs), t2n(tds.sweep_packed)
    flat = coeffs.reshape(-1, 40)
    live = list(plk.LIVE_SLOTS)
    dropped = sorted(set(range(40)) - set(live))
    assert len(live) == 19 and len(dropped) == 21
    assert packed.shape == (flat.shape[0], 20) and packed.dtype == np.float32
    np.testing.assert_array_equal(packed[:, :19], flat[:, live])
    assert not packed[:, 19].any()
    assert not flat[:, dropped].any()
    assert np.abs(packed).sum() > 0
    # the order plucker_planes.cuh reads: det, bx, by, t·det
    np.testing.assert_array_equal(packed[:, 0:3], coeffs[:, 0, 0:3])
    np.testing.assert_array_equal(packed[:, 3:9], coeffs[:, 1, 0:6])
    np.testing.assert_array_equal(packed[:, 9:15], coeffs[:, 2, 0:6])
    np.testing.assert_array_equal(packed[:, 15:19], coeffs[:, 3, 6:10])


def _lane_culling(s, g_clusters=None):
    """The soup's wavefront through the prepass and the per-lane test."""
    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel.plucker import plucker_features

    coeffs, center, cb, o, d, tmax = _t(s["coeffs"], s["center"], s["cb"], s["o"],
                                        s["d"], s["tmax"])
    flags, tn, g = cpt.prepass(center, cb, o, d, tmax)
    feats = plucker_features(o, d, center)
    spheres = cpt.unit_spheres(cb, center)
    own, entry = cpt.lane_unit_flags_plain(spheres, feats, tmax, with_entry=True)
    return coeffs, feats, tmax, flags, g, spheres, own, entry


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS, indirect=True)
def test_lane_flags_are_conservative(soup, variant):
    """(c) Every live lane's brute-force winner lies in a unit the lane
    flags itself, at or beyond the lane's entry distance for that unit; a
    dead lane flags nothing; and the closest hit restricted to each lane's
    own flags (what the kernel's per-warp culling may at most leave out)
    gives the prim ids and distances of the row group's flags on every
    lane, bit for bit, and the reference's compact function's on the lanes
    test_intersect_compact_matches_reference compares (prim ids exact,
    dist rtol 1e-4: the reference's packed-key t)."""
    from radish_pt_tpu.accel.pallas_kernels import intersect_plucker_compact
    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel import traverse as trv
    from radish_pt_tpu_torch.accel.plucker import hit_t, sweep_closest

    s = soup
    coeffs, feats, tmax, flags, g, spheres, own, entry = _lane_culling(s)
    assert spheres.shape == (flags.shape[1], 4)
    pb, tb, _ = (t2n(x) for x in trv.intersect_brute(*_t(s["tri_packed"], s["o"],
                                                         s["d"])))
    live = s["tmax"] >= 0
    assert not bool(own[torch.from_numpy(~live)].any())
    hit = live & (pb >= 0)
    assert hit.sum() > 0.4 * live.sum()
    lanes = np.flatnonzero(hit)
    unit = pb[lanes] // (cpt.CLUSTER_SUB * g)
    assert bool(own[lanes, unit].all())
    assert np.all(t2n(entry)[lanes, unit] <= tb[lanes] * (1 + 1e-6))
    if g == 1:  # fewer units per lane than per row group: the test bites
        assert float(own.float().sum(1).mean()) < 0.5 * float(flags.float().sum(1).mean())

    p_row, d_row = cpt.closest_hit_plain(coeffs, feats, tmax, flags, g)
    mine = own & flags.repeat_interleave(cpt.LANES, 0)[:own.shape[0]]
    p_own, d_own = sweep_closest(coeffs, feats, mine, 1, cpt.CLUSTER_SUB * g, hit_t)
    np.testing.assert_array_equal(t2n(p_own), t2n(p_row))
    np.testing.assert_array_equal(t2n(d_own), t2n(d_row))
    p0, d0 = intersect_plucker_compact(
        jnp.asarray(s["tri_packed"]), jnp.asarray(s["o"]), jnp.asarray(s["d"]),
        cluster_bounds=jnp.asarray(s["cb"]), tmax=jnp.asarray(s["tmax"]),
        interpret=True, bf16x3=False)
    p0, d0 = np.asarray(p0), np.asarray(d0)
    within = (s["tmax"] > 0) & ((s["tmax"] == FLT_MAX) | (tb <= s["tmax"]))
    np.testing.assert_array_equal(t2n(p_own)[within], p0[within])
    hits = within & (p0 >= 0)
    np.testing.assert_allclose(t2n(d_own)[hits], d0[hits], rtol=1e-4)


def _soup_segments(s):
    """The soup's shadow segments, as test_occlusion_compact_matches_reference
    makes them: a seventh zero-length (the masked lanes)."""
    rng = np.random.default_rng(4)
    x = s["o"]
    y = (x + s["d"] * rng.uniform(1.0, 14.0, (x.shape[0], 1))).astype(np.float32)
    y[::7] = x[::7]
    return x, y


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS, indirect=True)
def test_lane_segment_flags_are_conservative(soup, variant):
    """(c) for the shadow kernel: every blocking (segment, triangle) pair
    lies in a unit the lane flags itself, at an entry distance no later
    than its range tm widened by SKIP_MARGIN, and in a unit its row group
    lists with an item tn no later than that (so the kernel's finish test
    drops no blocker); a segment of negative range flags nothing; and the
    any-hit restricted to each lane's own units, each cut at its range,
    gives the bits of the row group's flags on every lane, bit for bit, and
    the reference's compact function's on every lane (those
    test_occlusion_compact_matches_reference compares)."""
    from radish_pt_tpu.accel.pallas_kernels import occlusion_plucker_compact
    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel.plucker import (blocks, plucker_features,
                                                   segment_rays, sweep_any)

    s = soup
    x, y = _soup_segments(s)
    coeffs, center, cb, xt, yt = _t(s["coeffs"], s["center"], s["cb"], x, y)
    o, d, tm = segment_rays(xt, yt)
    flags, tn, g = cpt.prepass(center, cb, o, d, tm)
    feats = plucker_features(o, d, center)
    spheres = cpt.unit_spheres(cb, center)
    own, entry = cpt.lane_unit_flags_plain(spheres, feats, tm, with_entry=True)
    assert not bool(own[tm < 0].any())
    reach = tm * cpt.SKIP_MARGIN
    lane, tri = torch.nonzero(blocks(coeffs, feats, tm), as_tuple=True)
    unit, row = tri // (cpt.CLUSTER_SUB * g), lane // cpt.LANES
    assert lane.unique().numel() > 0.1 * o.shape[0]
    assert bool(own[lane, unit].all())
    assert bool((entry[lane, unit] <= reach[lane]).all())
    assert bool(flags[row, unit].all()) and bool((tn[row, unit] <= reach[lane]).all())
    if g == 1:  # fewer units per lane than per row group: the test bites
        assert float(own.float().sum(1).mean()) < 0.5 * float(flags.float().sum(1).mean())

    mine = (own & (entry <= reach[:, None])
            & flags.repeat_interleave(cpt.LANES, 0)[:own.shape[0]])
    occ_own = sweep_any(coeffs, feats, mine, 1, cpt.CLUSTER_SUB * g,
                        lambda c, f, lo, hi: blocks(c, f, tm[lo:hi]))
    np.testing.assert_array_equal(t2n(occ_own),
                                  t2n(cpt.occlusion_plain(coeffs, feats, tm, flags, g)))
    want = np.asarray(occlusion_plucker_compact(
        jnp.asarray(s["tri_packed"]), jnp.asarray(x), jnp.asarray(y),
        cluster_bounds=jnp.asarray(s["cb"]), interpret=True, bf16x3=False))
    np.testing.assert_array_equal(t2n(occ_own), want)


def test_lane_flags_on_teapot_keep_every_winner(teapot_compact):
    """(c) on teapot's 86 clusters: camera rays and rays leaving surface
    points; every lane's plain winner over the row group's flags lies in a
    unit the lane flags itself."""
    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel.plucker import plucker_features
    from radish_pt_tpu_torch.scene.camera import sample_rays

    _, _, tds, tcam = teapot_compact
    rng = np.random.default_rng(21)
    n = 512
    cam = tcam.replace(width=800, height=800)
    x = torch.from_numpy(rng.integers(0, 800, n // 2).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 800, n // 2).astype(np.int32))
    o1, d1 = sample_rays(cam, x, y, torch.from_numpy(
        rng.uniform(size=(n // 2, 4)).astype(np.float32)))
    tri = t2n(tds.tri_v)
    real = np.flatnonzero(np.abs(tri).sum(axis=(1, 2)) > 0)
    w = rng.dirichlet([1, 1, 1], n // 2).astype(np.float32)
    surf = np.einsum("nk,nkc->nc", w, tri[rng.choice(real, n // 2)])
    d2 = rng.normal(size=(n // 2, 3))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    o = torch.cat([o1, torch.from_numpy((surf + d2 * 1e-3).astype(np.float32))])
    d = torch.cat([d1, torch.from_numpy(d2.astype(np.float32))])
    tmax = torch.full((n,), FLT_MAX)
    tmax[::5] = -FLT_MAX
    flags, _, g = cpt.prepass(tds.sweep_center, tds.cluster_bounds, o, d, tmax)
    feats = plucker_features(o, d, tds.sweep_center)
    assert tds.unit_spheres.shape == (tds.cluster_bounds.shape[0], 4) and g == 1
    own = cpt.lane_unit_flags_plain(tds.unit_spheres, feats, tmax)
    prim, _ = cpt.closest_hit_plain(tds.sweep_coeffs, feats, tmax, flags, g)
    hit = torch.nonzero(prim >= 0).flatten()
    assert hit.numel() > 0.4 * n
    assert bool(own[hit, (prim[hit] // cpt.CLUSTER_SUB).long()].all())
    assert not bool(own[::5].any())


@pytest.mark.parametrize("kind", ["rays", "segments"])
@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS, indirect=True)
def test_pair_counts_are_ordered(soup, variant, kind):
    """(d) Culling finer never adds work: lane <= warp <= row group, with
    and without the cut at each lane's reach (a ray's final t, a segment's
    range); the cut never adds either; the row-group count is the work
    list's."""
    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel.plucker import plucker_features, segment_rays

    coeffs, feats, tmax, flags, g, spheres, _, _ = _lane_culling(soup)
    if kind == "rays":
        _, dist = cpt.closest_hit_plain(coeffs, feats, tmax, flags, g)
    else:
        center, cb, x, y = _t(soup["center"], soup["cb"], *_soup_segments(soup))
        o, d, tmax = segment_rays(x, y)
        flags, _, g = cpt.prepass(center, cb, o, d, tmax)
        feats, dist = plucker_features(o, d, center), tmax
    n_tris = coeffs.shape[0]
    c = cpt.pair_counts(spheres, feats, tmax, flags, dist, g, n_tris, chunk_rows=2)
    assert 0 < c["lane"] <= c["warp"] <= c["row"]
    assert 0 < c["lane_cut"] <= c["warp_cut"] <= c["row_cut"]
    for k in ("row", "warp", "lane"):
        assert c[k + "_cut"] <= c[k]
    if g == 1:
        assert c["lane"] < 0.5 * c["row"]
    unit_tris = cpt.CLUSTER_SUB * g
    tris = np.minimum(unit_tris, n_tris - np.arange(flags.shape[1]) * unit_tris)
    lanes = np.minimum(cpt.LANES, feats.shape[0] - np.arange(flags.shape[0]) * cpt.LANES)
    assert c["row"] == float((t2n(flags) * tris).sum(1) @ lanes)
    assert c == cpt.pair_counts(spheres, feats, tmax, flags, dist, g, n_tris)
