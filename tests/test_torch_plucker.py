"""Port parity: the Plücker closest-hit and shadow sweeps and their culling
against the reference's Pallas kernels (run in interpret mode on the CPU,
f32 planes) and against the port's brute-force oracle.

The reference culls per 128-lane row and the port's engine per 32-lane warp
(``plk.GROUP``): the plain versions take the group size, so they are held
against the reference at ``lanes=128`` and against themselves, the per-lane
slab test and the oracle at ``lanes=32``, which is what the kernels compute.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
builds them from csrc/ and holds them against the plain versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
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


@pytest.fixture(scope="module")
def cluster_soup():
    """300 random triangles sorted along x into 5 clusters of 64 (the last
    ragged: 44) with their boxes, and 250 rays (a ragged last warp and
    row): every 7th lane dead, every 5th bounded by a finite tmax, lanes
    32-63 all dead."""
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import traverse as trv

    rng = np.random.default_rng(33)
    centers = rng.uniform(-4, 4, size=(300, 1, 3))
    tri = (centers + rng.normal(scale=0.4, size=(300, 3, 3))).astype(np.float32)
    tri = tri[np.argsort(tri[:, :, 0].mean(axis=1), kind="stable")]
    tp = trv.pack_tris(tri)
    sub = 64
    cb = np.stack([np.concatenate([tri[c:c + sub].reshape(-1, 3).min(0),
                                   tri[c:c + sub].reshape(-1, 3).max(0)])
                   for c in range(0, 300, sub)]).astype(np.float32)
    n = 250
    o = rng.uniform(-7, 7, size=(n, 3)).astype(np.float32)
    d = tri.mean(axis=1)[rng.integers(0, 300, n)] - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.full(n, FLT_MAX, np.float32)
    tmax[::5] = rng.uniform(3.0, 9.0, tmax[::5].shape)
    tmax[::7] = -FLT_MAX
    tmax[32:64] = -FLT_MAX
    coeffs, center = plk.numpy_coeffs(tp)
    return dict(tp=torch.from_numpy(tp), cb=torch.from_numpy(cb), sub=sub,
                coeffs=torch.from_numpy(coeffs), center=torch.from_numpy(center),
                packed=torch.from_numpy(plk.numpy_packed_coeffs(coeffs)),
                o=torch.from_numpy(o), d=torch.from_numpy(d),
                tmax=torch.from_numpy(tmax))


def _teapot_case(teapot):
    _, ds, o, d, tmax = teapot
    return dict(tp=ds.tri_packed, cb=ds.cluster_bounds, sub=ds.cluster_sub,
                coeffs=ds.sweep_coeffs, center=ds.sweep_center,
                packed=ds.sweep_packed, o=torch.from_numpy(o),
                d=torch.from_numpy(d), tmax=torch.from_numpy(tmax))


@pytest.fixture(params=["teapot", "soup"])
def case(request):
    """The teapot (43 clusters of 128) or the clustered soup, as one dict."""
    if request.param == "teapot":
        return _teapot_case(request.getfixturevalue("teapot"))
    return request.getfixturevalue("cluster_soup")


def _closest(c, lanes, tmax="own", table="coeffs"):
    """Plain closest hit of case ``c`` culled per ``lanes`` lanes."""
    from radish_pt_tpu_torch.accel import plucker as plk

    tmax = c["tmax"] if isinstance(tmax, str) else tmax
    feats = plk.plucker_features(c["o"], c["d"], c["center"])
    mask = plk.cluster_mask_words(c["cb"], c["o"], c["d"], tmax, lanes)
    return plk.closest_hit_plain(c[table], feats, mask, c["sub"], lanes)


def _segments(c):
    """Segments along case ``c``'s rays (dead lanes: zero length)."""
    tmax = c["tmax"]
    seg = torch.where(tmax > 0, torch.clamp(tmax, max=8.0), 0.0)
    return c["o"], c["o"] + c["d"] * seg[:, None]


def _blocked(c, lanes, table="coeffs"):
    """Plain any-hit of case ``c``'s segments culled per ``lanes`` lanes."""
    from radish_pt_tpu_torch.accel import plucker as plk

    so, sd, tm = plk.segment_rays(*_segments(c))
    feats = plk.plucker_features(so, sd, c["center"])
    mask = plk.cluster_mask_words(c["cb"], so, sd, tm, lanes)
    return plk.occlusion_plain(c[table], feats, tm, mask, c["sub"], lanes)


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
    """Clusters, dead lanes and tmax, culled per 128-lane row as the
    reference culls: prim ids exact on every lane (dead lanes included:
    both sweep their row's flagged clusters)."""
    from radish_pt_tpu_torch.accel import plucker as plk

    jds, ds, o, d, tmax = teapot
    prim, dist = _closest(_teapot_case(teapot), plk.ROW)
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
    x, y = (t2n(a) for a in _segments(_teapot_case(teapot)))  # dead lanes: y == x
    got = _blocked(_teapot_case(teapot), plk.ROW)
    want = np.asarray(occlusion_plucker_pallas(
        jnp.asarray(jds.tri_packed), jnp.asarray(x), jnp.asarray(y),
        cluster_bounds=jds.cluster_bounds, coeffs_pre=jds.sweep_coeffs,
        center_pre=jds.sweep_center, cluster_sub=jds.cluster_sub,
        interpret=True, bf16x3=False))
    np.testing.assert_array_equal(t2n(got), want)
    assert 0.05 < want.mean() < 0.95


@pytest.mark.parametrize("segments", [False, True])
def test_mask_prepass_matches_cluster_mask_bits(teapot, segments):
    """The packed per-row words (128 lanes a row) hold exactly the
    reference prepass bits."""
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
    tally = Tally()
    plk.intersect_plucker(coeffs, center, None, 64, torch.from_numpy(o),
                          torch.from_numpy(d))
    plk.occlusion_plucker(coeffs, center, None, 64, torch.from_numpy(o),
                          torch.from_numpy(o + d))
    assert tally("plain.plucker") == {"closest_hit": 1, "occlusion": 1}
    assert tally("launch.plucker") == {}
    feats = plk.plucker_features(torch.from_numpy(o), torch.from_numpy(d), center)
    packed = torch.from_numpy(plk.numpy_packed_coeffs(t2n(coeffs)))
    with pytest.raises(ValueError):  # the kernel refuses CPU tensors
        plk.closest_hit_cuda(packed, feats, None, torch.from_numpy(o),
                             torch.from_numpy(d), None, 64)
    with pytest.raises(ValueError):
        plk.occlusion_cuda(packed, feats, None, torch.from_numpy(o),
                           torch.from_numpy(d), torch.ones(o.shape[0]), 64)


@pytest.mark.parametrize("with_tmax", [True, False])
def test_row_words_are_the_or_of_their_warps(case, with_tmax):
    """cluster_mask_words at 128 lanes is the OR of its four 32-lane
    groups' words, and each group's words are the OR of its lanes' own
    slab tests, on a ragged last group (whose padding lanes vote: o = 0,
    d = 1, tmax = 0, or FLT_MAX without tmax)."""
    from radish_pt_tpu_torch.accel import plucker as plk

    n = case["o"].shape[0] - 3
    assert n % plk.GROUP and n % plk.ROW
    o, d = case["o"][:n], case["d"][:n]
    tmax = case["tmax"][:n] if with_tmax else None
    n_c = case["cb"].shape[0]
    rows = plk.unpack_mask(plk.cluster_mask_words(case["cb"], o, d, tmax), n_c)
    warps = plk.unpack_mask(
        plk.cluster_mask_words(case["cb"], o, d, tmax, plk.GROUP), n_c)
    assert rows.shape[0] == -(-n // plk.ROW) and warps.shape[0] == -(-n // plk.GROUP)
    per_row = plk.ROW // plk.GROUP
    pad = rows.shape[0] * per_row - warps.shape[0]
    grouped = torch.nn.functional.pad(warps, (0, 0, 0, pad)).view(-1, per_row, n_c)
    # a 128-lane row's padding reaches past the last warp's: those lanes
    # vote in the row and in no warp
    n_pad = rows.shape[0] * plk.ROW
    po, pd, ptm = plk._pad_rays(o, d, tmax, n_pad)
    own = plk.lane_cluster_flags_plain(case["cb"], po, pd, ptm)
    assert own.shape == (n_pad, n_c)
    np.testing.assert_array_equal(
        t2n(own.view(-1, plk.GROUP, n_c).any(1))[: warps.shape[0]], t2n(warps))
    tail = own[warps.shape[0] * plk.GROUP:].any(0)
    expect = grouped.any(1)
    expect[-1] |= tail
    np.testing.assert_array_equal(t2n(rows), t2n(expect))
    assert 0 < float(own.float().mean()) < float(warps.float().mean())
    assert float(warps.float().mean()) <= float(rows.float().mean())


def test_warp_culling_keeps_every_winner(case):
    """Culling per 32-lane warp instead of per 128-lane row moves no
    winner within a lane's range and no shadow bit (0 lanes differ; a dead
    lane, or a hit beyond a finite tmax, is whatever the neighbours'
    clusters give in both), and on the live unbounded lanes the winner is
    the brute-force oracle's: the slab test is conservative for these
    rays."""
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import traverse as trv

    p32, d32 = _closest(case, plk.GROUP)
    p128, d128 = _closest(case, plk.ROW)
    within = torch.minimum(d32, d128) < case["tmax"]
    assert 0.3 < float(within.float().mean())
    assert int(((p32 != p128) & within).sum()) == 0
    np.testing.assert_array_equal(t2n(d32[within]), t2n(d128[within]))
    live = case["tmax"] == FLT_MAX
    p0, d0, _ = trv.intersect_brute(case["tp"], case["o"][live], case["d"][live])
    np.testing.assert_array_equal(t2n(p32[live]), t2n(p0))
    assert 0.3 < float((p0 >= 0).float().mean())
    b32, b128 = _blocked(case, plk.GROUP), _blocked(case, plk.ROW)
    assert int((b32 != b128).sum()) == 0
    np.testing.assert_array_equal(
        t2n(b32), t2n(trv.occlusion_brute(case["tp"], *_segments(case))))
    assert 0.02 < float(b32.float().mean()) < 0.95


def test_dead_lanes_miss(cluster_soup):
    """The dead-lane rule of the engine's path: a lane with a negative tmax
    flags nothing, so a warp of dead lanes sweeps nothing, and with
    ``dead`` every dead lane is a miss, (-1, FLT_MAX), while the live
    lanes keep the nearest hit over the clusters their warp flags; without
    ``dead`` (the reference's rule) a dead lane beside live ones gets what
    their clusters give.  The dispatcher applies the rule; ``intersect``
    masks the lanes besides."""
    from radish_pt_tpu_torch.accel import plucker as plk

    c = cluster_soup
    dead = plk.dead_lanes(c["tmax"])
    assert bool(dead[32:64].all()) and 0.1 < float(dead.float().mean()) < 0.5
    prim, dist = _closest(c, plk.GROUP)
    assert bool((prim[32:64] == -1).all()) and bool((dist[32:64] == FLT_MAX).all())
    n, n_c = c["o"].shape[0], c["cb"].shape[0]
    own = plk.lane_cluster_flags_plain(c["cb"], c["o"], c["d"], c["tmax"])
    assert not bool(own[dead].any())
    pad = -n % plk.GROUP
    warp = torch.nn.functional.pad(own, (0, 0, 0, pad)).view(-1, plk.GROUP, n_c).any(1)
    warp = warp.repeat_interleave(plk.GROUP, 0)[:n]  # padding lanes flag nothing here
    feats = plk.plucker_features(c["o"], c["d"], c["center"])
    t = plk.hit_t(c["coeffs"], feats)
    t = torch.where(warp.repeat_interleave(c["sub"], 1)[:, :t.shape[1]], t, FLT_MAX)
    best, idx = t.min(1)
    want = torch.where(best < FLT_MAX, idx.to(torch.int32), -1)
    np.testing.assert_array_equal(t2n(prim), t2n(want))
    np.testing.assert_array_equal(t2n(dist), t2n(best))
    assert bool((prim[dead] >= 0).any())  # without ``dead`` some do ride along
    mask = plk.cluster_mask_words(c["cb"], c["o"], c["d"], c["tmax"], plk.GROUP)
    for got in (plk.closest_hit_plain(c["coeffs"], feats, mask, c["sub"], dead=dead),
                plk.closest_hit(c["coeffs"], feats, c["cb"], c["o"], c["d"], c["tmax"],
                                c["sub"])):
        np.testing.assert_array_equal(t2n(got[0]), t2n(torch.where(dead, -1, want)))
        np.testing.assert_array_equal(t2n(got[1]), t2n(torch.where(dead, FLT_MAX, best)))
    assert plk.dead_lanes(None) is None


def _surface_rays(c, seed):
    """Rays that leave the surfaces case ``c``'s rays hit, in directions
    from ``seed``: they start on a triangle, beside its neighbours."""
    from radish_pt_tpu_torch.accel import plucker as plk

    feats = plk.plucker_features(c["o"], c["d"], c["center"])
    _, dist = plk.closest_hit_plain(c["coeffs"], feats, None, c["sub"])
    hit = dist < FLT_MAX
    o = (c["o"] + c["d"] * dist[:, None])[hit]
    d = np.random.default_rng(seed).normal(size=tuple(o.shape)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return o.contiguous(), d


def test_lane_skip_is_conservative(case, request):
    """A ray of the kernels passes over a cluster only where that moves no
    result: every (ray, triangle) pair that passes the f32 planes at t lies
    in a cluster that ``lane_skip_flags_plain`` flags for the ray at reach
    t (so at any best t not below it), and every blocking pair in one it
    flags at the segment's range; 0 pairs outside, on the case's rays and
    on rays that start on its surfaces, where the slab test without the
    slack does lose pairs (107 on the teapot: hits at t = 0 on a box's
    face; none in the soup, whose triangles share no edges)."""
    from radish_pt_tpu_torch.accel import plucker as plk

    cl = torch.arange(case["coeffs"].shape[0]) // case["sub"]
    lost_without_slack = 0
    for o, d in ((case["o"], case["d"]), _surface_rays(case, 5)):
        feats = plk.plucker_features(o, d, case["center"])
        t = plk.hit_t(case["coeffs"], feats)  # [N, T]
        passing = t < FLT_MAX
        assert int(passing.sum()) > o.shape[0] // 4
        # a pair's own reach is its t: per cluster, the nearest passing t
        n_c = case["cb"].shape[0]
        pad = n_c * case["sub"] - t.shape[1]
        near = torch.nn.functional.pad(t, (0, pad), value=FLT_MAX).view(
            -1, n_c, case["sub"]).amin(-1)  # [N, C]
        for c_id in range(n_c):
            flagged = plk.lane_skip_flags_plain(case["cb"], o, d, near[:, c_id])[:, c_id]
            assert not bool(((near[:, c_id] < FLT_MAX) & ~flagged).any())
        own = plk.lane_cluster_flags_plain(case["cb"], o, d, None)
        lost_without_slack += int((passing & ~own[:, cl]).sum())
        tm = torch.full((o.shape[0],), 6.0)
        blocking = plk.blocks(case["coeffs"], feats, tm)
        reach = plk.lane_skip_flags_plain(case["cb"], o, d, tm)
        assert int(blocking.sum()) > 0 and not bool((blocking & ~reach[:, cl]).any())
        # the test does cull: most (ray, cluster) pairs are passed over
        assert float(reach.float().mean()) < 0.6
    assert (lost_without_slack > 0) == (request.node.callspec.params["case"] == "teapot")


def test_intersect_masks_dead_lanes(teapot):
    from radish_pt_tpu_torch.scene import device_scene as dsc

    _, ds, o, d, tmax = teapot
    active = torch.from_numpy(tmax >= 0)
    it = dsc.intersect(ds.replace(intersector="plucker"), torch.from_numpy(o),
                       torch.from_numpy(d), active)
    assert bool((it.prim_id[~active] == -1).all())
    assert float((it.prim_id[active] >= 0).float().mean()) > 0.3


def test_packed_table_gives_the_same_t(case):
    """The packed table [T, 20] (what the kernels read) holds the planes'
    19 live coefficients: the plain sweeps on it return the same winners,
    the same t by value and the same shadow bits as on ``coeffs``."""
    from radish_pt_tpu_torch.accel import plucker as plk

    assert case["packed"].shape == (case["coeffs"].shape[0], plk.PACKED_WIDTH)
    pc, dc = _closest(case, plk.GROUP)
    pp, dp = _closest(case, plk.GROUP, table="packed")
    np.testing.assert_array_equal(t2n(pp), t2n(pc))
    np.testing.assert_array_equal(t2n(dp), t2n(dc))
    np.testing.assert_array_equal(t2n(_blocked(case, plk.GROUP, table="packed")),
                                  t2n(_blocked(case, plk.GROUP)))
    np.testing.assert_array_equal(t2n(plk.unpack_coeffs(case["packed"])),
                                  t2n(case["coeffs"]))


@pytest.mark.parametrize("with_tmax", [True, False])
def test_pair_counts_are_ordered(case, with_tmax):
    """(lane, triangle) pairs per 128-lane row >= per 32-lane warp >= per
    lane; the row count is the row words' clusters times their lanes."""
    from radish_pt_tpu_torch.accel import plucker as plk

    tmax = case["tmax"] if with_tmax else None
    n, t, sub = case["o"].shape[0], case["coeffs"].shape[0], case["sub"]
    pairs = plk.pair_counts(case["cb"], case["o"], case["d"], tmax, sub, t,
                            chunk_rows=1)
    assert 0 < pairs["lane"] <= pairs["warp"] <= pairs["row"] <= n * t
    assert pairs["lane"] < pairs["row"]
    n_c = case["cb"].shape[0]
    rows = plk.unpack_mask(
        plk.cluster_mask_words(case["cb"], case["o"], case["d"], tmax), n_c)
    tris = torch.clamp(t - torch.arange(n_c) * sub, 0, sub).double()
    lanes = torch.clamp(n - torch.arange(rows.shape[0]) * plk.ROW, 0, plk.ROW).double()
    assert pairs["row"] == float((rows.double() @ tris) @ lanes)
    assert plk.pair_counts(None, case["o"], case["d"], tmax, sub, t) == {
        "row": n * t, "warp": n * t, "lane": n * t}


def test_path_trace_plucker_teapot_matches_reference(teapot):
    """The whole slice on a clustered scene: teapot 32x32, depth 3, looper
    0, through the port's Plücker engine (its plain versions on CPU
    tensors, culled per 32-lane warp) against the reference's frame on the
    same scene bytes (its brute-force engine: interpret-mode Pallas inside
    a jitted frame is out of reach on the CPU); edge-exact ties may resolve
    differently, so the bound is on the mean (2e-2, as the other engines'
    teapot frames)."""
    import jax

    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt
    from torch_port_util import camera_from_jax

    jds, ds, *_ = teapot
    mp = pytest.MonkeyPatch()
    try:
        _, jcam, _ = load_jax_scene(mp, "teapot.txt")
    finally:
        mp.undo()
    res, depth = 32, 3
    jcam = jcam.replace(width=res, height=res)
    jd, ji = (np.asarray(a) for a in jax.jit(jpt.path_trace, static_argnames=(
        "max_depth",))(jds.replace(intersector="brute"), jcam, 0, depth))
    tally = Tally()
    d, i = pt.path_trace(ds.replace(intersector="plucker"),
                         camera_from_jax(jcam, res, res), 0, depth)
    assert tally("plain.plucker") == {"closest_hit": depth + 1, "occlusion": depth}
    assert tally("launch.plucker") == {}
    assert tally("prepass.plucker") == {"cluster_mask_words": 2 * depth + 1}
    assert (jd + ji).mean() > 1e-2
    assert np.abs(t2n(d + i) - (jd + ji)).mean() < 2e-2


def _round_f32(x):
    """The f32 nearest the rational ``x`` (ties to even), exactly."""
    from fractions import Fraction

    r = np.float32(float(x))
    near = (np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf)))
    return min(near, key=lambda y: (abs(Fraction(float(y)) - x),
                                    int(np.array(y, np.float32).view(np.int32)) & 1))


def test_addcmul_rounds_once():
    """``torch.addcmul``, the plain sweeps' fused multiply-add on the card
    (``plk.kernel_planes``), rounds a * b + c once, as ``fmaf``: equal to
    the exact rational sum rounded to f32 on 20,000 random triples (many of
    them cancelling, a quarter below f32's normal range) and where an
    unfused product or an f64 sum rounds twice (a * b an f32 midpoint, c
    below half an f64 ulp of it).  Here on the CPU's tensors; the card's
    by ``addcmul_rounds_once`` and by the Plücker kernels' parity."""
    from fractions import Fraction

    from radish_pt_tpu_torch.utils.math import addcmul_rounds_once

    assert addcmul_rounds_once("cpu")
    a = np.float32(1 + 2**-12)  # a * a = 1 + 2^-11 + 2^-24: an f32 midpoint
    for c, want in ((2.0**-80, 1 + 2**-11 + 2**-23), (-(2.0**-80), 1 + 2**-11),
                    (0.0, 1 + 2**-11)):  # the exact midpoint: ties to even
        got = torch.addcmul(*(torch.tensor([np.float32(v)]) for v in (c, a, a)))
        assert got.item() == want
    assert np.float32(np.float64(a) * np.float64(a) + 2.0**-80) == np.float32(1 + 2**-11)
    rng = np.random.default_rng(35)
    n = 20_000
    # exponents around 2^0 and, for the last quarter, around 2^-66: products
    # and sums below f32's normal range (2^-126)
    e = np.where(np.arange(n) < 3 * n // 4, 0, -66)
    x = (rng.normal(size=n) * 2.0 ** (e + rng.integers(-20, 20, n))).astype(np.float32)
    y = (rng.normal(size=n) * 2.0 ** (e + rng.integers(-20, 20, n))).astype(np.float32)
    z = (-(x.astype(np.float64) * y)
         * (1 + rng.normal(size=n) * 2.0 ** -rng.integers(1, 40, n))).astype(np.float32)
    want = np.array([_round_f32(Fraction(float(p)) * Fraction(float(q)) + Fraction(float(r)))
                     for p, q, r in zip(x, y, z)], np.float32)
    assert (np.abs(want[want != 0]) < 2.0**-126).sum() > 100
    got = t2n(torch.addcmul(*(torch.from_numpy(v) for v in (z, x, y))))
    np.testing.assert_array_equal(got, want)


def test_kernel_planes_follow_the_kernels_order(case):
    """``kernel_planes`` (the planes of the plain sweeps on the card) sums
    each plane as the kernels do: a product, then fused multiply-adds in
    slot order; the winners it gives equal those of the matrix product
    (the CPU's planes), their t within 1e-5 relative."""
    from radish_pt_tpu_torch.accel import plucker as plk

    feats = plk.plucker_features(case["o"], case["d"], case["center"])
    coeffs = case["coeffs"]
    det, bx, by, td = plk.kernel_planes(coeffs, feats)
    want = coeffs[None, :, 3, 6] * feats[:, 6, None]
    for j in (7, 8, 9):
        want = torch.addcmul(want, coeffs[None, :, 3, j], feats[:, j, None])
    assert torch.equal(td, want)
    q = plk._planes(coeffs, feats)  # a matrix product on CPU tensors
    for a, b in zip((det, bx, by, td), q):
        np.testing.assert_allclose(t2n(a), t2n(b), rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))

    def t_of(planes):
        det, bx, by, td = planes
        sd, bxd, byd, tdd = det * det, bx * det, by * det, td * det
        v = torch.minimum(torch.minimum(torch.minimum(bxd, byd), sd - bxd - byd),
                          sd - plk.PLUCKER_EPS2)
        return torch.where(torch.minimum(v, tdd) >= 0, tdd / sd, plk.FLT_MAX)

    tk, tq = t_of((det, bx, by, td)), t_of(q)
    bk, ik = tk.min(1)
    bq, iq = tq.min(1)
    np.testing.assert_array_equal(t2n(ik[bk < plk.FLT_MAX]), t2n(iq[bk < plk.FLT_MAX]))
    np.testing.assert_allclose(t2n(bk), t2n(bq), rtol=1e-5)
    assert float((bk < plk.FLT_MAX).float().mean()) > 0.3
