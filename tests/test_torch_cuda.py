"""The port's CUDA kernels on the card: build csrc/plucker.cu,
csrc/compact.cu, csrc/quad.cu, csrc/band.cu, csrc/dense.cu, csrc/bvh.cu,
csrc/sort_key.cu, csrc/ris.cu, csrc/vertex.cu and csrc/surface.cu and hold the Plücker
closest-hit and shadow kernels, the sphere prepass, the compact, quad, band
and dense closest-hit and shadow kernels, the three BVH walks and the
sort-key kernel against their plain torch versions on teapot geometry,
ReSTIR's candidate RIS kernel against its plain loop on the shipped scenes,
the path tracer's vertex kernel and the closest hit's surface kernel
against their plain versions on their wavefronts, then small renders through the kernels (teapot, and the other
shipped scenes on the Plücker engine) against the same renders through the
plain versions.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no jax, so it runs
on a machine without it:  python -m pytest --noconftest tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radish_pt_tpu_torch.utils.timing import Tally, under  # noqa: E402

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
FLT_MAX = 3.402823466e38


@pytest.fixture(scope="module")
def teapot_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain sweeps in full f32
    from radish_pt_tpu_torch.scene.build import load_scene
    from radish_pt_tpu_torch.scene.camera import sample_rays

    ds, cam, _ = load_scene(os.path.join(SCENES, "teapot.txt"), device="cuda")
    rng = np.random.default_rng(8)
    n = 8192
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.integers(0, 800, n // 2).astype(np.int32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 800, n // 2).astype(np.int32)).to(dev)
    r = torch.from_numpy(rng.uniform(size=(n // 2, 4)).astype(np.float32)).to(dev)
    o1, d1 = sample_rays(cam, x, y, r)
    tri = ds.tri_v.cpu().numpy()
    real = np.flatnonzero(np.abs(tri).sum(axis=(1, 2)) > 0)
    pick = rng.choice(real, n // 2)
    w = rng.dirichlet([1, 1, 1], n // 2).astype(np.float32)
    surf = np.einsum("nk,nkc->nc", w, tri[pick]).astype(np.float32)
    d2 = rng.normal(size=(n // 2, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    o = torch.cat([o1, torch.from_numpy(surf + d2 * 1e-3).to(dev)])
    d = torch.cat([d1, torch.from_numpy(d2).to(dev)])
    tmax = torch.full((n,), FLT_MAX, device=dev)
    tmax[::5] = -FLT_MAX
    return ds, cam, o.contiguous(), d.contiguous(), tmax


def _plucker_pair(ds, o, d, tmax, bounds="scene", num_tris=None):
    """(kernel, plain) closest hits of the Plücker engine on the scene's
    first ``num_tris`` stored triangles: the kernel culls per warp from the
    cluster boxes, the plain version sweeps the prepass words of the same
    32-lane groups; a lane with a negative ``tmax`` is dead and misses in
    both."""
    from radish_pt_tpu_torch.accel import plucker as plk

    t = ds.num_triangles if num_tris is None else num_tris
    cb = ds.cluster_bounds[: -(-t // ds.cluster_sub)] if bounds == "scene" else None
    feats = plk.plucker_features(o, d, ds.sweep_center)
    words = None if cb is None else plk.cluster_mask_words(cb, o, d, tmax, plk.GROUP)
    got = plk.closest_hit_cuda(ds.sweep_packed[:t], feats, cb, o, d, tmax, ds.cluster_sub)
    want = plk.closest_hit_plain(ds.sweep_coeffs[:t], feats, words, ds.cluster_sub,
                                 dead=plk.dead_lanes(tmax))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
def test_kernels_match_plain(teapot_cuda, masked):
    """The kernels cull per warp from the cluster boxes (``masked``) or
    sweep every triangle: prim ids, distances by value and occlusion bits
    equal the plain versions' on the same 32-lane groups, on every lane
    (a dead lane misses in both, whatever its warp sweeps)."""
    from radish_pt_tpu_torch.accel import plucker as plk

    ds, _, o, d, tmax = teapot_cuda
    tally = Tally()
    (pk, dk), (pp, dp) = _plucker_pair(ds, o, d, tmax, "scene" if masked else None)
    assert tally("launch.plucker")["closest_hit"] == 1
    assert torch.equal(pk, pp) and torch.equal(dk, dp)
    live = tmax >= 0
    assert float((pp[live] >= 0).float().mean()) > 0.3
    assert bool((~live).any()) and bool((pk[~live] == -1).all())
    assert bool((dk[~live] == FLT_MAX).all())
    if masked:  # a whole warp of dead lanes flags nothing and misses
        dead = tmax.clone()
        dead[64:96] = -FLT_MAX
        (pk, dk), (pp, dp) = _plucker_pair(ds, o, d, dead)
        assert torch.equal(pk, pp) and torch.equal(dk, dp)
        assert bool((pk[64:96] == -1).all()) and bool((dk[64:96] == FLT_MAX).all())

    feats = plk.plucker_features(o, d, ds.sweep_center)
    cb = ds.cluster_bounds if masked else None
    tm = torch.full_like(o[:, 0], 3.0)
    tm[::7] = -1e-4  # masked NEE lanes: a negative range
    words = plk.cluster_mask_words(cb, o, d, tm, plk.GROUP) if masked else None
    occ_k = plk.occlusion_cuda(ds.sweep_packed, feats, cb, o, d, tm, ds.cluster_sub)
    occ_p = plk.occlusion_plain(ds.sweep_coeffs, feats, tm, words, ds.cluster_sub)
    torch.cuda.synchronize()
    assert tally("launch.plucker")["occlusion"] == 1 and torch.equal(occ_k, occ_p)
    assert 0.05 < occ_p.float().mean().item() < 0.95
    assert not bool(occ_k[::7].any())
    assert tally("plain.plucker") == {"closest_hit": 2 if masked else 1, "occlusion": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", ["scene", None])
def test_plucker_mixed_ragged_wavefront(teapot_cuda, bounds):
    """Dead, missing and hitting lanes mixed in every warp, and a last
    warp (and 128-lane block) that is ragged: the padding lanes vote with
    the reference's padding values; with the cluster boxes and without
    (every triangle swept, no culling set-up), with a range per lane and
    with none (the padding then flags every box it points at)."""
    from radish_pt_tpu_torch.accel import plucker as plk

    ds, _, o, d, tmax = teapot_cuda
    mo, md, mtm = _mixed_wavefront(o, d, tmax, ds.sweep_center)
    assert mo.shape[0] % plk.ROW % plk.GROUP != 0
    for tm in (mtm, None):
        (pk, dk), (pp, dp) = _plucker_pair(ds, mo, md, tm, bounds)
        assert torch.equal(pk, pp) and torch.equal(dk, dp)
        # every lane is held to the plain version; with a range per lane
        # the dead lanes miss, without one no lane is dead
        _check_mixed(pk, dk, pp, dp, mtm, dead_miss=tm is not None)


@pytest.mark.cuda
def test_plucker_ragged_last_cluster(teapot_cuda):
    """A table whose last cluster is ragged (not a whole ``sub``
    triangles), and a wavefront shorter than a warp."""
    from radish_pt_tpu_torch.accel import plucker as plk

    ds, _, o, d, tmax = teapot_cuda
    t = ds.num_triangles - ds.cluster_sub - 37
    assert t % ds.cluster_sub
    (pk, dk), (pp, dp) = _plucker_pair(ds, o, d, tmax, num_tris=t)
    assert torch.equal(pk, pp) and torch.equal(dk, dp)
    assert int(pk.max()) < t and float((pp >= 0).float().mean()) > 0.3
    (pk, dk), (pp, dp) = _plucker_pair(ds, o[:19], d[:19], tmax[:19], num_tris=t)
    assert torch.equal(pk, pp) and torch.equal(dk, dp)


@pytest.mark.cuda
def test_plucker_wrappers_refuse(teapot_cuda):
    """CUDA tensors launch or raise: no packed table, a misaligned or
    mis-shaped table, boxes that do not match the clusters, CPU rays."""
    from radish_pt_tpu_torch.accel import plucker as plk

    ds, _, o, d, tmax = teapot_cuda
    feats = plk.plucker_features(o, d, ds.sweep_center)
    cb, sub, pk = ds.cluster_bounds, ds.cluster_sub, ds.sweep_packed
    with pytest.raises(ValueError):  # the dispatcher without the packed table
        plk.closest_hit(ds.sweep_coeffs, feats, cb, o, d, tmax, sub)
    with pytest.raises(ValueError):
        plk.occlusion(ds.sweep_coeffs, feats, cb, o, d, tmax, sub)
    with pytest.raises(ValueError):  # the plane table is not the packed one
        plk.closest_hit_cuda(ds.sweep_coeffs, feats, cb, o, d, tmax, sub)
    with pytest.raises(ValueError):  # 4 bytes off a 16-byte boundary
        plk.closest_hit_cuda(pk.flatten()[1:-19].view(-1, 20), feats, None, o, d, tmax, sub)
    with pytest.raises(ValueError):  # one box too few
        plk.closest_hit_cuda(pk, feats, cb[:-1], o, d, tmax, sub)
    with pytest.raises(ValueError):
        plk.closest_hit_cuda(pk, feats, cb, o.cpu(), d, tmax, sub)
    with pytest.raises(ValueError):
        plk.occlusion_cuda(pk, feats, cb, o, d, None, sub)


@pytest.mark.cuda
def test_render_through_kernels_matches_plain(teapot_cuda):
    from radish_pt_tpu_torch.render import pathtrace as pt

    ds, cam, *_ = teapot_cuda
    cam = cam.replace(width=64, height=64)
    tally = Tally()
    d, i = pt.path_trace(ds, cam, 3, 5)
    assert tally("launch.plucker") == {"closest_hit": 6, "occlusion": 5}
    assert tally("plain.plucker") == {}
    assert tally("prepass.plucker") == {}  # the kernels cull
    dp, ip = pt.path_trace(ds.replace(intersector="plucker_plain"), cam, 3, 5)
    img, ref = (d + i).cpu().numpy(), (dp + ip).cpu().numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    assert np.abs(img - ref).mean() < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("fname,depth", [("glass.txt", 8), ("env_teapot.txt", 5),
                                         ("many_light.txt", 5), ("textured.txt", 5)])
def test_render_shipped_scenes_through_kernels_matches_plain(fname, depth):
    """The other shipped scenes on the Plücker engine their size picks: glass
    (a masked thin lens, rays refracted through a glass sphere, depth 8),
    env_teapot (NEE segments 1e6 long to its env map), many_light and
    textured (no clusters): depth + 1 closest-hit and depth shadow launches
    a frame, no plain call, no prepass, and the frame within 2e-3 mean
    absolute difference of the frame through the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain sweeps in full f32
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, _ = load_scene(os.path.join(SCENES, fname), device="cuda")
    assert ds.intersector == "plucker"
    cam = cam.replace(width=64, height=64)
    tally = Tally()
    d, i = pt.path_trace(ds, cam, 3, depth)
    assert tally("launch.plucker") == {"closest_hit": depth + 1, "occlusion": depth}
    assert tally("plain.plucker") == {}
    assert tally("prepass.plucker") == {}
    dp, ip = pt.path_trace(ds.replace(intersector="plucker_plain"), cam, 3, depth)
    img, ref = (d + i).cpu().numpy(), (dp + ip).cpu().numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    assert np.abs(img - ref).mean() < 2e-3


@pytest.mark.cuda
def test_plain_closest_hit_does_not_depend_on_its_chunks():
    """On the card the plain sweep sums each plane in the kernels' order
    (``plk.kernel_planes``), not through a matrix product whose rounding
    follows the shape of each chunk: on env_teapot's primaries (warps that
    flag one cluster, chunks of one cluster) the plain closest hit on the
    prepass words, on every triangle and in small chunks gives the kernel's
    winners and distances bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.sampling import rng
    from radish_pt_tpu_torch.scene.build import load_scene
    from radish_pt_tpu_torch.utils.math import addcmul_rounds_once

    assert addcmul_rounds_once("cuda")  # the plain planes' fused multiply-add
    ds, cam, _ = load_scene(os.path.join(SCENES, "env_teapot.txt"), device="cuda")
    cam = cam.replace(width=256, height=256)
    idx, _ = pt._lanes(ds, cam)
    o, d, _ = pt._gen_primary(ds, cam, rng.make_sampler(0, idx), idx)
    feats = plk.plucker_features(o, d, ds.sweep_center)
    cb, sub = ds.cluster_bounds, ds.cluster_sub
    pk, dk = plk.closest_hit_cuda(ds.sweep_packed, feats, cb, o, d, None, sub)
    words = plk.cluster_mask_words(cb, o, d, None, plk.GROUP)
    flags = plk.unpack_mask(words, cb.shape[0])
    assert bool((flags.sum(1) == 1).any())  # warps that flag one cluster
    for mask, budget in ((words, 1 << 24), (None, 1 << 24), (words, 1 << 16)):
        pp, dp = plk.sweep_closest(ds.sweep_coeffs, feats, plk.mask_flags(
            mask, sub, ds.num_triangles), plk.GROUP, sub, plk.hit_t, budget)
        assert torch.equal(pp, pk) and torch.equal(dp, dk), budget
    assert float((pk >= 0).float().mean()) > 0.3


def _mixed_wavefront(o, d, tmax, center):
    """A wavefront that interleaves the fixture's rays (camera rays, rays
    leaving surfaces, dead lanes) with rays that start far outside the
    scene and point away from its centre (they miss everything), lane by
    lane, and ends in a ragged row: 2N - 19 lanes."""
    out = torch.nn.functional.normalize(o - center + 1e-3, dim=1)
    mo = torch.stack([o, center + 100.0 * out], 1).reshape(-1, 3)[:-19].contiguous()
    md = torch.stack([d, out], 1).reshape(-1, 3)[:-19].contiguous()
    mtm = torch.stack([tmax, torch.full_like(tmax, FLT_MAX)], 1).reshape(-1)
    return mo, md, mtm[:-19].contiguous()


def _check_mixed(pk, dk, pp, dp, tmax, dead_miss=True):
    """Kernel against plain on a mixed wavefront: prim ids equal but for
    near-ties (<= 1e-4 of lanes), distances equal to 1e-5, some lanes hit
    and some miss; with ``dead_miss`` every dead lane is (-1, FLT_MAX)."""
    pk, pp, dk, dp, tmax = (t.cpu().numpy() for t in (pk, pp, dk, dp, tmax))
    live = tmax >= 0
    diff = (pk != pp) & live
    assert diff.mean() <= 1e-4
    assert np.all(np.abs(dk[diff] - dp[diff]) <= 1e-5 * np.abs(dp[diff]))
    hit = (pp >= 0) & live & ~diff
    assert 0.1 < hit.mean() < 0.9 and (live & (pp < 0)).mean() > 0.3
    np.testing.assert_allclose(dk[hit], dp[hit], rtol=1e-5)
    assert np.all(dk[live & (pp < 0)] == FLT_MAX)
    if dead_miss:
        assert (~live).any()
        assert np.all(pk[~live] == -1) and np.all(dk[~live] == FLT_MAX)


# ---------------------------------------------------------------------------
# the compact work-list engine (csrc/compact.cu)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def teapot_compact_cuda(teapot_cuda):
    """Teapot in the compact engine's 64-triangle clusters, with the same
    rays (tmax FLT_MAX or -FLT_MAX: the main path's two kinds of lane)."""
    from radish_pt_tpu_torch.scene.build import load_scene

    _, _, o, d, tmax = teapot_cuda
    ds, cam, _ = load_scene(os.path.join(SCENES, "teapot.txt"), device="cuda",
                            intersector="compact")
    return ds, cam, o, d, tmax


@pytest.fixture(params=["slab", "sphere"])
def prepass_branch(request, monkeypatch):
    """Teapot's 78 clusters take the slab prepass; "sphere" lowers the
    threshold so the sphere kernel runs."""
    from radish_pt_tpu_torch.accel import compact as cpt

    if request.param == "sphere":
        monkeypatch.setattr(cpt, "PER_RAY_PREPASS_MAX", 0)
    return request.param


@pytest.mark.cuda
def test_sphere_flags_kernel_matches_plain(teapot_compact_cuda):
    """The sphere kernel sums each plane term by term, unfused, in the
    plain version's order: flags and tn agree bit for bit."""
    from radish_pt_tpu_torch.accel import compact as cpt

    ds, _, o, d, tmax = teapot_compact_cuda
    rows = -(-o.shape[0] // cpt.LANES)
    po, pd, ptm = cpt._pad_rays(o, d, tmax, rows * cpt.LANES)
    feats = cpt._sphere_feats(po - ds.sweep_center, pd, ptm)
    planes = cpt._sphere_plane_coeffs(ds.cluster_bounds, ds.sweep_center)
    tally = Tally()
    fk, tk = cpt.sphere_flags(feats, planes)
    fp, tp = cpt.sphere_flags_plain(feats, planes)
    assert tally("launch.compact")["sphere_flags"] == 1
    assert torch.equal(fk, fp) and torch.equal(tk, tp)
    assert bool(fk.any()) and not bool(fk.all())


@pytest.mark.cuda
def test_compact_kernels_match_plain(teapot_compact_cuda, prepass_branch):
    """On the same flags, the compact closest-hit kernel and its plain
    version agree on >= 99.99% of prim ids, a mismatch being a near-tie;
    the shadow kernel (on the packed table and the unit spheres) gives the
    plain version's bits on every segment."""
    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel import plucker as plk

    ds, _, o, d, tmax = teapot_compact_cuda
    flags, tn, g = cpt.prepass(ds.sweep_center, ds.cluster_bounds, o, d, tmax)
    feats = plk.plucker_features(o, d, ds.sweep_center)
    tally = Tally()
    pk, dk = cpt.closest_hit(ds.sweep_coeffs, feats, tmax, flags, tn, g,
                             ds.sweep_packed, ds.unit_spheres)
    pp, dp = cpt.closest_hit_plain(ds.sweep_coeffs, feats, tmax, flags, g)
    assert tally("launch.compact")["closest_hit"] == 1
    with pytest.raises(ValueError):  # no packed table: no launch, no fallback
        cpt.closest_hit(ds.sweep_coeffs, feats, tmax, flags, tn, g)
    pk, pp, dk, dp = (t.cpu().numpy() for t in (pk, pp, dk, dp))
    diff = pk != pp
    assert diff.mean() <= 1e-4
    assert np.all(np.abs(dk[diff] - dp[diff]) <= 1e-4 * np.abs(dp[diff]))
    hit = (pp >= 0) & ~diff
    assert hit.mean() > 0.3
    np.testing.assert_allclose(dk[hit], dp[hit], rtol=1e-5)
    assert np.all(pk[tmax.cpu().numpy() < 0] == -1)

    # a wavefront whose row groups and warps mix dead lanes, lanes that miss
    # the scene and lanes that hit it, with a ragged last row group and
    # warp: the per-warp vote, the per-lane finish and the block exit
    mo, md, mtm = _mixed_wavefront(o, d, tmax, ds.sweep_center)
    flags, tn, g = cpt.prepass(ds.sweep_center, ds.cluster_bounds, mo, md, mtm)
    feats = plk.plucker_features(mo, md, ds.sweep_center)
    pk, dk = cpt.closest_hit(ds.sweep_coeffs, feats, mtm, flags, tn, g,
                             ds.sweep_packed, ds.unit_spheres)
    pp, dp = cpt.closest_hit_plain(ds.sweep_coeffs, feats, mtm, flags, g)
    assert mo.shape[0] % cpt.LANES % cpt.WARP != 0
    _check_mixed(pk, dk, pp, dp, mtm)

    x = o
    y = o + d * 3.0
    y[::7] = x[::7]  # zero-length segments, as masked NEE lanes
    so, sd, stm = plk.segment_rays(x, y)
    flags, tn, g = cpt.prepass(ds.sweep_center, ds.cluster_bounds, so, sd, stm)
    feats = plk.plucker_features(so, sd, ds.sweep_center)
    occ_k = cpt.occlusion(ds.sweep_coeffs, feats, stm.contiguous(), flags, tn, g,
                          ds.sweep_packed, ds.unit_spheres)
    occ_p = cpt.occlusion_plain(ds.sweep_coeffs, feats, stm, flags, g)
    assert tally("launch.compact")["occlusion"] == 1
    assert torch.equal(occ_k, occ_p)
    assert 0.05 < occ_p.float().mean().item() < 0.95
    assert not bool(occ_k[::7].any())
    with pytest.raises(ValueError):  # no packed table: no launch, no fallback
        cpt.occlusion(ds.sweep_coeffs, feats, stm.contiguous(), flags, tn, g)


@pytest.mark.cuda
def test_compact_closest_hit_walks_merged_units(teapot_compact_cuda, monkeypatch):
    """Units of three clusters, the last one ragged, as scenes above 4,096
    clusters have them: the kernel stages a unit as several 64-triangle
    tiles, on the mixed wavefront with its ragged last row group."""
    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel import plucker as plk

    ds, _, o, d, tmax = teapot_compact_cuda
    monkeypatch.setattr(cpt, "SPHERE_UNIT_MAX", 30)
    mo, md, mtm = _mixed_wavefront(o, d, tmax, ds.sweep_center)
    flags, tn, g = cpt.prepass(ds.sweep_center, ds.cluster_bounds, mo, md, mtm)
    spheres = cpt.unit_spheres(ds.cluster_bounds, ds.sweep_center)
    assert g == 3 and ds.cluster_bounds.shape[0] % g != 0
    assert spheres.shape == (flags.shape[1], 4)
    feats = plk.plucker_features(mo, md, ds.sweep_center)
    pk, dk = cpt.closest_hit(ds.sweep_coeffs, feats, mtm, flags, tn, g,
                             ds.sweep_packed, spheres)
    pp, dp = cpt.closest_hit_plain(ds.sweep_coeffs, feats, mtm, flags, g)
    _check_mixed(pk, dk, pp, dp, mtm)


@pytest.mark.cuda
def test_compact_occlusion_walks_merged_units(teapot_compact_cuda, monkeypatch):
    """The shadow kernel on units of three clusters, the last one ragged:
    segments of the mixed wavefront (dead lanes zero-length, a ragged last
    row group and warp) give the plain version's bits."""
    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel import plucker as plk

    ds, _, o, d, tmax = teapot_compact_cuda
    monkeypatch.setattr(cpt, "SPHERE_UNIT_MAX", 30)
    mo, md, mtm = _mixed_wavefront(o, d, tmax, ds.sweep_center)
    y = torch.where((mtm >= 0)[:, None], mo + md * 3.0, mo)
    so, sd, stm = plk.segment_rays(mo, y)
    flags, tn, g = cpt.prepass(ds.sweep_center, ds.cluster_bounds, so, sd, stm)
    spheres = cpt.unit_spheres(ds.cluster_bounds, ds.sweep_center)
    assert g == 3 and spheres.shape == (flags.shape[1], 4)
    feats = plk.plucker_features(so, sd, ds.sweep_center)
    occ_k = cpt.occlusion(ds.sweep_coeffs, feats, stm.contiguous(), flags, tn, g,
                          ds.sweep_packed, spheres)
    occ_p = cpt.occlusion_plain(ds.sweep_coeffs, feats, stm, flags, g)
    assert torch.equal(occ_k, occ_p)
    assert 0.02 < occ_p.float().mean().item() < 0.95 and not bool(occ_k[mtm < 0].any())


@pytest.mark.cuda
def test_render_through_compact_kernels_matches_plain(teapot_compact_cuda,
                                                      prepass_branch):
    from radish_pt_tpu_torch.render import pathtrace as pt

    ds, cam, *_ = teapot_compact_cuda
    cam = cam.replace(width=64, height=64)
    tally = Tally()
    d, i = pt.path_trace(ds, cam, 3, 5)
    launched = tally("launch.compact")
    assert launched["closest_hit"] == 6 and launched["occlusion"] == 5
    assert tally("launch.compact").get("sphere_flags", 0) == (
        11 if prepass_branch == "sphere" else 0)
    assert tally("plain.compact") == {}
    dp, ip = pt.path_trace(ds.replace(intersector="compact_plain"), cam, 3, 5)
    img, ref = (d + i).cpu().numpy(), (dp + ip).cpu().numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    assert np.abs(img - ref).mean() < 2e-3


# ---------------------------------------------------------------------------
# the quad engine (csrc/quad.cu) and the band engine (csrc/band.cu)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def teapot_engines_cuda(teapot_cuda):
    """Teapot built for the quad engine (the Plücker layout: 43 clusters
    of 128) and for the band engine (64-triangle clusters), with the same
    rays."""
    from radish_pt_tpu_torch.scene.build import load_scene

    _, _, o, d, tmax = teapot_cuda
    path = os.path.join(SCENES, "teapot.txt")
    return {name: load_scene(path, device="cuda", intersector=name)[:2]
            for name in ("quad", "band")}, o, d, tmax


def _check_closest(pk, dk, pp, dp):
    """>= 99.99% of prim ids equal, a mismatch a near-tie; distances equal
    to 1e-5 where the prims agree."""
    pk, pp, dk, dp = (t.cpu().numpy() for t in (pk, pp, dk, dp))
    diff = pk != pp
    assert diff.mean() <= 1e-4
    assert np.all(np.abs(dk[diff] - dp[diff]) <= 1e-5 * np.abs(dp[diff]))
    hit = (pp >= 0) & ~diff
    assert hit.mean() > 0.3
    np.testing.assert_allclose(dk[hit], dp[hit], rtol=1e-5)


@pytest.mark.cuda
def test_quad_kernels_match_plain(teapot_engines_cuda):
    """The quad kernels sum every form in the plain version's order with
    one rounding a term: winners and shadow bits agree.  The shadow kernel
    votes its rows' words itself and passes each segment over the clusters
    it cannot reach; zero-length segments read as blocked exactly where
    their row sweeps a triangle (the reference's behaviour)."""
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import quad as qd

    scenes, o, d, tmax = teapot_engines_cuda
    ds, _ = scenes["quad"]
    feats = qd.quad_features(o, d, ds.sweep_center)
    mask = plk.cluster_mask_words(ds.cluster_bounds, o, d, tmax)
    tally = Tally()
    pk, dk = qd.closest_hit(ds.quad_coeffs, feats, mask, ds.cluster_sub,
                            ds.quad_packed)
    pp, dp = qd.closest_hit_plain(ds.quad_coeffs, feats, mask, ds.cluster_sub)
    assert tally("launch.quad")["closest_hit"] == 1
    with pytest.raises(ValueError):  # no packed table: no launch, no fallback
        qd.closest_hit(ds.quad_coeffs, feats, mask, ds.cluster_sub)
    _check_closest(pk, dk, pp, dp)

    # dead, missing and hitting lanes mixed in every row, and a ragged last
    # row that leaves some threads with fewer rays than others; with the
    # row masks and without (every triangle)
    mo, md, mtm = _mixed_wavefront(o, d, tmax, ds.sweep_center)
    feats = qd.quad_features(mo, md, ds.sweep_center)
    for mask in (plk.cluster_mask_words(ds.cluster_bounds, mo, md, mtm), None):
        pk, dk = qd.closest_hit(ds.quad_coeffs, feats, mask, ds.cluster_sub,
                                ds.quad_packed)
        pp, dp = qd.closest_hit_plain(ds.quad_coeffs, feats, mask, ds.cluster_sub)
        assert mo.shape[0] % plk.ROW % 32 != 0
        # the quad sweep reads no tmax: every lane sweeps its row's clusters
        _check_mixed(pk, dk, pp, dp, torch.ones_like(mtm), dead_miss=False)

    # the shadow kernel votes its rows' words itself: against the plain
    # version on the prepass's row words, with the boxes and without (every
    # triangle), on the fixture's segments and on the mixed wavefront's
    # (ragged last row; its dead lanes and every 7th lane zero-length)
    cb, sub = ds.cluster_bounds, ds.cluster_sub
    for x, ty, dead in ((o, o + d * 3.0, tmax < 0), (mo, mo + md * 3.0, mtm < 0)):
        ty[::7] = x[::7]  # zero-length segments, as masked NEE lanes
        ty[dead] = x[dead]
        so, seg = qd.quad_segments(x, ty)
        sf = qd.quad_features(so, seg, ds.sweep_center)
        zero = qd.zero_segments(sf)
        assert bool(zero[::7].all()) and bool(zero[dead].all())
        ones = torch.ones_like(so[:, 0])
        for bounds in (cb, None):
            smask = None if bounds is None else plk.cluster_mask_words(cb, so, seg, ones)
            launched = tally("launch.quad").get("occlusion", 0)
            occ_k = qd.occlusion(ds.quad_coeffs, sf, bounds, so, seg, sub, ds.quad_occl_packed)
            occ_p = qd.occlusion_plain(ds.quad_coeffs, sf, smask, sub)
            assert tally("launch.quad")["occlusion"] == launched + 1
            assert (occ_k != occ_p).float().mean().item() <= 1e-4
            assert 0.05 < occ_p[~zero].float().mean().item() < 0.95
            # a zero-length segment is blocked exactly where its row sweeps a
            # triangle: a flagged cluster, or without boxes any triangle
            rows = (torch.ones(-(-so.shape[0] // plk.ROW), dtype=torch.bool, device=so.device)
                    if bounds is None else plk.unpack_mask(smask, cb.shape[0]).any(1))
            swept = rows.repeat_interleave(plk.ROW)[:so.shape[0]]
            assert torch.equal(occ_k[zero], swept[zero]) and bool(occ_k[zero].any())
            if bounds is not None:  # the kernel's vote, in plain torch
                assert torch.equal(qd.occl_words_plain(cb, so, seg), smask)
    with pytest.raises(ValueError):  # no packed shadow table: no launch, no fallback
        qd.occlusion(ds.quad_coeffs, sf, cb, so, seg, sub)
    assert tally("launch.quad")["occlusion"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32, 64, 128])
def test_band_kernels_match_plain(teapot_engines_cuda, g):
    """The band kernels at every width.  The closest hit, which votes its
    bands' words itself from the boxes and the rays, against the plain
    version on band_mask_words' words, on the fixture's rays, on the mixed
    wavefront with its ragged last row and without a range: >= 99.99% of
    winners equal, a mismatch a near-tie, distances within 1e-5 where the
    winners agree, every dead lane a miss.  (The plain version's plane
    products go through cuBLAS, whose summation order changes with the
    shapes its chunks take at each width and can move the last bit; the
    kernel's arithmetic does not depend on the width: where its winner is
    the one it finds at g = 8, its distance is bit-equal to that one.)
    The shadow kernel, which votes its bands' words itself too, against
    the plain version on band_mask_words' words of the segments: <= 1e-4
    of bits differ (the plain planes' cuBLAS rounding); zero-length and
    dead lanes are never blocked."""
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import plucker as plk

    scenes, o, d, tmax = teapot_engines_cuda
    ds, _ = scenes["band"]
    cb, wb = ds.cluster_bounds, ds.word_bounds
    mo, md, mtm = _mixed_wavefront(o, d, tmax, ds.sweep_center)
    tally = Tally()
    for ro, rd, rt in ((o, d, tmax), (mo, md, mtm), (o, d, None)):
        feats = plk.plucker_features(ro, rd, ds.sweep_center)
        pk, dk = bnd.closest_hit(ds.sweep_coeffs, feats, cb, ro, rd, rt, g,
                                 ds.sweep_packed, wb)
        p8, d8 = bnd.closest_hit_cuda(ds.sweep_packed, feats, cb, wb, ro.contiguous(),
                                      rd.contiguous(), rt, 8)
        mask = bnd.band_mask_words(cb, ro, rd, rt, g)
        pp, dp = bnd.closest_hit_plain(ds.sweep_coeffs, feats, mask, g,
                                       dead=plk.dead_lanes(rt))
        torch.cuda.synchronize()
        live = torch.ones_like(pk, dtype=torch.bool) if rt is None else rt >= 0
        pk_, pp_, dk_, dp_, live_ = (t.cpu().numpy() for t in (pk, pp, dk, dp, live))
        diff = (pk_ != pp_) & live_
        assert diff.mean() <= 1e-4
        assert np.all(np.abs(dk_[diff] - dp_[diff]) <= 1e-5 * np.abs(dp_[diff]))
        hit = (pp_ >= 0) & live_ & ~diff
        assert hit.mean() > 0.1
        np.testing.assert_allclose(dk_[hit], dp_[hit], rtol=1e-5)
        assert np.all(dk_[live_ & (pp_ < 0)] == FLT_MAX)
        assert np.all(pk_[~live_] == -1) and np.all(dk_[~live_] == FLT_MAX)
        same = pk == p8
        assert torch.equal(dk[same], d8[same])
    assert tally("launch.band")["closest_hit"] == 6
    with pytest.raises(ValueError):  # no packed table: no launch, no fallback
        bnd.closest_hit(ds.sweep_coeffs, feats, cb, o, d, None, g)

    # the shadow kernel votes its bands' words itself too: against the
    # plain version on band_mask_words' words, on the fixture's segments
    # and on the mixed wavefront's (ragged last row; its dead lanes and
    # every 7th lane zero-length: a negative range, never blocked)
    for x, ty, dead in ((o, o + d * 3.0, tmax < 0), (mo, mo + md * 3.0, mtm < 0)):
        ty[::7] = x[::7]
        ty[dead] = x[dead]
        so, sd, stm = plk.segment_rays(x, ty)
        stm = stm.contiguous()
        assert bool((stm[::7] < 0).all()) and bool((stm[dead] < 0).all())
        sf = plk.plucker_features(so, sd, ds.sweep_center)
        smask = bnd.band_mask_words(cb, so, sd, stm, g)
        occ_k = bnd.occlusion(ds.sweep_coeffs, sf, cb, so, sd, stm, g, ds.sweep_packed, wb)
        occ_p = bnd.occlusion_plain(ds.sweep_coeffs, sf, stm, smask, g)
        assert (occ_k != occ_p).float().mean().item() <= 1e-4
        assert 0.05 < occ_p[stm >= 0].float().mean().item() < 0.95
        assert not bool(occ_k[stm < 0].any())
        # the kernels' vote, in plain torch, on the segments
        assert torch.equal(bnd.band_words_plain(cb, wb, so, sd, stm, g), smask)
    assert tally("launch.band")["occlusion"] == 2
    with pytest.raises(ValueError):  # no packed table: no launch, no fallback
        bnd.occlusion(ds.sweep_coeffs, sf, cb, so, sd, stm, g)
    assert tally("launch.band")["occlusion"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["quad", "band"])
def test_render_through_engine_kernels_matches_plain(teapot_engines_cuda, engine):
    """A 64x64 depth-5 teapot frame through the engine's kernels (6
    closest-hit and 5 shadow launches, no plain call; no band-mask prepass
    call on the band engine, the quad closest hits' 6 row-mask prepass
    calls on the quad engine) equals the same frame through its plain
    versions."""
    from radish_pt_tpu_torch.render import pathtrace as pt

    scenes, *_ = teapot_engines_cuda
    ds, cam = scenes[engine]
    cam = cam.replace(width=64, height=64)
    tally = Tally()
    d, i = pt.path_trace(ds, cam, 3, 5)
    assert tally(f"launch.{engine}") == {"closest_hit": 6, "occlusion": 5}
    assert tally(f"plain.{engine}") == {}
    # the band kernels and the quad shadow kernel vote their words themselves
    assert tally("prepass.band") == {}
    assert tally("prepass.plucker") == ({"cluster_mask_words": 6} if engine == "quad" else {})
    dp, ip = pt.path_trace(ds.replace(intersector=f"{engine}_plain"), cam, 3, 5)
    img, ref = (d + i).cpu().numpy(), (dp + ip).cpu().numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    assert np.abs(img - ref).mean() < 2e-3


# ---------------------------------------------------------------------------
# the dense engine (csrc/dense.cu)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_dense_kernels_match_plain(teapot_cuda):
    """Every operation rounds on its own on both sides: prim ids, distances,
    barycentrics and shadow bits are equal, bit for bit, on the teapot's
    stored triangles (zero padding triangles included)."""
    from radish_pt_tpu_torch.accel import dense as dns
    from radish_pt_tpu_torch.accel import traverse as trv

    ds, _, o, d, _ = teapot_cuda
    pk, dk, bk = dns.closest_hit_cuda(ds.tri_packed, o, d)
    pp, dp, bp = dns.closest_hit_plain(ds.tri_packed, o, d)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(dk, dp) and torch.equal(bk, bp)
    assert float((pp >= 0).float().mean()) > 0.3
    y = o + d * torch.linspace(0.5, 6.0, o.shape[0], device=o.device)[:, None]
    y[::7] = o[::7]  # zero-length segments: never blocked
    so, sd, tm = trv.segment_rays(o, y)
    so, sd, tm = so.contiguous(), sd.contiguous(), tm.contiguous()
    ok = dns.occlusion_cuda(ds.tri_packed, so, sd, tm)
    op = dns.occlusion_plain(ds.tri_packed, so, sd, tm)
    torch.cuda.synchronize()
    assert torch.equal(ok, op) and not bool(ok[::7].any())
    assert 0.05 < float(op.float().mean()) < 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("tracer", ["pt", "restir"])
def test_render_through_dense_kernels_matches_plain(tracer):
    """Cornell at 64x64 on the dense engine against the brute engine (its
    plain path): equal frames, the kernels launched and no plain call."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cuda",
                            intersector="dense")
    cam = cam.replace(width=64, height=64)
    settings = Settings(tracer=Tracer.STREAMED if tracer == "pt" else Tracer.RESTIR_DI)
    imgs = []
    for engine in ("dense", "brute"):
        tally = Tally()
        r = Renderer(ds=ds.replace(intersector=engine), cam=cam, settings=settings,
                     device="cuda")
        imgs.append(r.render(spp=2))
        if engine == "dense":
            launched = tally("launch.dense")
            assert launched["closest_hit"] > 0 and launched["occlusion"] > 0
            assert tally("plain.dense") == {}
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0.05
    assert np.abs(imgs[0] - imgs[1]).mean() < 2e-3



# ---------------------------------------------------------------------------
# the BVH walks (csrc/bvh.cu)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_bvh_kernels_match_plain(teapot_cuda):
    """The three walks against their plain versions on the teapot's BVH
    tables (kept on the Plücker scene too): winners, distances and
    barycentrics, shadow bits and heatmap counts equal bit for bit on
    every lane, the segments' zero-length lanes never blocked."""
    from radish_pt_tpu_torch.accel import traverse as trv

    ds, _, o, d, _ = teapot_cuda
    lt, lm, nodes = ds.leaf_tris, ds.leaf_map, ds.bvh_packed
    got = trv.intersect_bvh_cuda(lt, lm, nodes, o, d)
    want = trv.intersect_bvh_plain(lt, lm, nodes, o, d)
    hk = trv.intersect_bvh_heatmap_cuda(lt, nodes, o, d)
    hp = trv.intersect_bvh_heatmap_plain(lt, nodes, o, d)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(hk, hp) and int(hk.min()) >= 1
    assert float((want[0] >= 0).float().mean()) > 0.3
    pb, tb, bb = trv.intersect_brute(ds.tri_packed, o, d)
    assert torch.equal(got[0], pb) and torch.equal(got[1], tb) and torch.equal(got[2], bb)
    y = o + d * torch.linspace(0.5, 6.0, o.shape[0], device=o.device)[:, None]
    y[::7] = o[::7]
    so, sd, tm = (t.contiguous() for t in trv.segment_rays(o, y))
    ok = trv.occlusion_bvh_cuda(lt, nodes, so, sd, tm)
    op = trv.occlusion_bvh_plain(lt, nodes, so, sd, tm)
    torch.cuda.synchronize()
    assert torch.equal(ok, op) and not bool(ok[::7].any())
    assert 0.05 < float(op.float().mean()) < 0.95


def _bvh_wavefront(ds, o, d, case):
    """A wavefront for the persistent walks from the teapot rays: lanes
    interleaving all six direction classes lane by lane, N = 0, 1 and
    1,000 + 7, all lanes dead, half dead in a checkerboard, or origins on
    node boxes' slab planes with that direction component +-0 (the NaN
    rule).  Returns (o, d, the closest hit's range)."""
    from radish_pt_tpu_torch.accel import traverse as trv

    n = o.shape[0]
    ar = torch.arange(n, device=o.device)
    live = torch.full((n,), FLT_MAX, device=o.device)
    if case == "interleaved":
        cls = trv.get_dir_class(-d)
        by_class = [torch.nonzero(cls == k)[:, 0] for k in range(6)]
        m = min(len(b) for b in by_class)
        assert m > 100
        idx = torch.stack([b[:m] for b in by_class], 1).reshape(-1)
        return o[idx].contiguous(), d[idx].contiguous(), live[idx]
    if case in ("empty", "one", "ragged"):
        k = {"empty": 0, "one": 1, "ragged": 1007}[case]
        return o[:k].contiguous(), d[:k].contiguous(), live[:k]
    if case == "all_dead":
        return o, d, torch.full_like(live, -FLT_MAX)
    if case == "checkerboard":
        return o, d, torch.where(ar % 2 == 0, live, -FLT_MAX)
    rng = np.random.default_rng(11)
    pick = torch.from_numpy(rng.integers(0, ds.bvh_packed.shape[0], n)).to(o.device)
    lo, hi = ds.bvh_packed[pick, 0:3], ds.bvh_packed[pick, 3:6]
    u = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32)).to(o.device)
    o2 = lo + (hi - lo) * u
    axis = ar % 3
    o2[ar, axis] = torch.where(ar % 2 == 0, lo[ar, axis], hi[ar, axis])
    d2 = d.clone()
    d2[ar, axis] = torch.where(ar % 4 < 2, 0.0, -0.0)
    d2 = torch.nn.functional.normalize(d2, dim=-1)
    return o2.contiguous(), d2.contiguous(), live


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["interleaved", "empty", "one", "ragged", "all_dead",
                                  "checkerboard", "slab_planes"])
def test_bvh_persistent_walks_match_plain(teapot_cuda, case):
    """The persistent walks against the plain walk, bit for bit on every
    lane: the closest hit without a range and with the case's range (a
    dead lane's miss, (-1, FLT_MAX, (0, 0)), written by the binning
    kernel), and the shadow walk on segments from the same origins (a
    dead lane's segment zero-length: unblocked), launches counted."""
    from radish_pt_tpu_torch.accel import traverse as trv

    ds, _, o0, d0, _ = teapot_cuda
    o, d, tmax = _bvh_wavefront(ds, o0, d0, case)
    lt, lm, nodes = ds.leaf_tris, ds.leaf_map, ds.bvh_packed
    n = o.shape[0]
    tally = Tally()
    for rng_ in (None, tmax):
        got = trv.intersect_bvh_cuda(lt, lm, nodes, o, d, rng_)
        want = trv.intersect_bvh_plain(lt, lm, nodes, o, d, rng_)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), case
    dead = ~(tmax > 0)
    assert bool((got[0][dead] == -1).all()) and bool((got[1][dead] == FLT_MAX).all())
    lengths = torch.linspace(0.5, 6.0, n, device=o.device)
    y = torch.where(dead[:, None], o, o + d * lengths[:, None])
    so, sd, tm = (t.contiguous() for t in trv.segment_rays(o, y))
    ok = trv.occlusion_bvh_cuda(lt, nodes, so, sd, tm)
    op = trv.occlusion_bvh_plain(lt, nodes, so, sd, tm)
    torch.cuda.synchronize()
    assert torch.equal(ok, op) and not bool(ok[dead].any()), case
    # one binning launch before each of the three walks; none on no lanes
    assert tally("launch.traverse") == ({"closest_hit": 2, "occlusion": 1, "bin": 3} if n
                                        else {})
    if case == "interleaved":
        assert float((want[0] >= 0).float().mean()) > 0.3 and bool(op.any())


@pytest.mark.cuda
def test_bvh_queue_resets_between_launches_and_replays(teapot_cuda):
    """The queue counters start from zero on every launch: two launches in
    a row, and a CUDA graph of the closest hit and the shadow walk
    captured once and replayed twice, each equal to the plain walk."""
    from radish_pt_tpu_torch.accel import traverse as trv

    ds, _, o, d, tmax = teapot_cuda
    lt, lm, nodes = ds.leaf_tris, ds.leaf_map, ds.bvh_packed
    y = o + d * 3.0
    so, sd, tm = (t.contiguous() for t in trv.segment_rays(o, y))
    want = (*trv.intersect_bvh_plain(lt, lm, nodes, o, d, tmax),
            trv.occlusion_bvh_plain(lt, nodes, so, sd, tm))

    def walks():
        return (*trv.intersect_bvh_cuda(lt, lm, nodes, o, d, tmax),
                trv.occlusion_bvh_cuda(lt, nodes, so, sd, tm))

    for _ in range(2):
        got = walks()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        walks()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = walks()
    for _ in range(2):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("ranged", [False, True])
def test_bvh_bin_kernel_matches_plain(teapot_cuda, ranged):
    """The binning kernel's class counts equal ``bin_by_dir_class``'s, its
    queue holds exactly the live lanes, class-major, each class the plain
    version's lanes (the order within a class may differ)."""
    from radish_pt_tpu_torch.accel import traverse as trv

    _, _, _, d, tmax = teapot_cuda
    tmax = tmax if ranged else None
    tally = Tally()
    queue, counts = trv.bin_by_dir_class_cuda(d, tmax)
    assert tally("launch.traverse")["bin"] == 1  # one pass
    _check_bin(queue, counts, d, tmax)


def _check_bin(queue, counts, d, tmax):
    """The kernel's queue and counts against ``bin_by_dir_class``."""
    from radish_pt_tpu_torch.accel import traverse as trv

    order, want_counts = trv.bin_by_dir_class(d, tmax)
    torch.cuda.synchronize()
    assert torch.equal(counts.long(), want_counts)
    assert torch.equal(torch.sort(queue.long()).values, torch.sort(order).values)
    cls = trv.get_dir_class(-d)
    bounds = [0, *torch.cumsum(want_counts, 0).tolist()]
    for k in range(6):
        part = queue[bounds[k]:bounds[k + 1]].long()
        assert bool((cls[part] == k).all())
        assert torch.equal(torch.sort(part).values, order[bounds[k]:bounds[k + 1]])


def _bin_wavefront(d, tmax, case):
    """(d, tmax) of a binning case from the teapot rays: every lane dead,
    every lane of one direction class (-d along +x, each lane's other
    components small), or the six classes interleaved lane by lane."""
    from radish_pt_tpu_torch.accel import traverse as trv

    if case == "all_dead":
        return d, torch.full_like(tmax, -FLT_MAX)
    if case == "one_class":
        one = d.clone()
        one[:, 0] = -1.0
        one[:, 1:] *= 0.5
        one = torch.nn.functional.normalize(one, dim=-1).contiguous()
        assert bool((trv.get_dir_class(-one) == 0).all())
        return one, tmax
    cls = trv.get_dir_class(-d)
    by_class = [torch.nonzero(cls == k)[:, 0] for k in range(6)]
    m = min(len(b) for b in by_class)
    idx = torch.stack([b[:m] for b in by_class], 1).reshape(-1)
    return d[idx].contiguous(), tmax[idx].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_dead", "one_class", "interleaved"])
@pytest.mark.parametrize("ranged", [False, True])
def test_bvh_bin_kernel_cases(teapot_cuda, case, ranged):
    """The one-pass binning kernel against ``bin_by_dir_class`` with every
    lane dead (an empty queue, every lane counted dead), with every lane in
    one class (one region filled, five empty) and with the six classes
    interleaved lane by lane; one launch each."""
    from radish_pt_tpu_torch.accel import traverse as trv

    _, _, _, d0, tmax0 = teapot_cuda
    d, tmax = _bin_wavefront(d0, tmax0, case)
    tmax = tmax if ranged or case == "all_dead" else None
    tally = Tally()
    queue, counts = trv.bin_by_dir_class_cuda(d, tmax)
    assert tally("launch.traverse")["bin"] == 1
    _check_bin(queue, counts, d, tmax)
    if case == "all_dead":
        assert queue.numel() == 0
    elif case == "one_class":
        assert int(counts[0]) == queue.numel() and not bool(counts[1:].any())


@pytest.mark.cuda
def test_bvh_bin_kernel_graph_replay_equals_eager(teapot_cuda):
    """The binning kernel captured in a CUDA graph (its counters' memset
    on the captured stream) and replayed twice: each replay's counts,
    class regions (as sets) and dead lanes' misses equal the eager call's."""
    from radish_pt_tpu_torch.accel import traverse as trv

    _, _, _, d, tmax = teapot_cuda
    n = d.shape[0]
    outs = (torch.empty((n,), dtype=torch.int32, device=d.device),
            torch.empty((n,), device=d.device), torch.empty((n, 2), device=d.device))

    def binned(ws):
        counts = ws[6 * n:6 * n + 7]
        regions = [torch.sort(ws[k * n:k * n + int(counts[k])]).values for k in range(6)]
        return counts.clone(), regions

    want_counts, want_regions = binned(trv.bin_cuda(d, tmax, trv.MISS_OUT, outs))
    torch.cuda.synchronize()
    dead = ~(tmax > 0)
    assert int(want_counts[6]) == int(dead.sum())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trv.bin_cuda(d, tmax, trv.MISS_OUT, outs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ws = trv.bin_cuda(d, tmax, trv.MISS_OUT, outs)
    for _ in range(2):
        for t in outs:
            t.fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        counts, regions = binned(ws)
        assert torch.equal(counts, want_counts)
        assert all(torch.equal(a, b) for a, b in zip(regions, want_regions))
        assert bool((outs[0][dead] == -1).all()) and bool((outs[1][dead] == FLT_MAX).all())
        assert not bool(outs[2][dead].any())


def _heatmap_warps(o, d, case):
    """A heatmap wavefront from the teapot rays (the first 4,096 the
    camera's, the rest from the surface in random directions): 32 warps of
    camera rays, warp p with its lane p made odd, for p = 0..31 — a ray of
    another direction class ("class"), a NaN origin ("nan"), an infinite
    direction component ("inf") or a zero one ("zero"); or the camera rays
    cut to N = 0, 1, 31, 33 or 1,007; or every lane of one direction class."""
    from radish_pt_tpu_torch.accel import traverse as trv

    if case.isdigit():
        k = int(case)
        return o[:k].contiguous(), d[:k].contiguous()
    if case == "one_class":
        one = d.clone()
        one[:, 0] = -1.0
        one[:, 1:] *= 0.5
        one = torch.nn.functional.normalize(one, dim=-1).contiguous()
        assert bool((trv.get_dir_class(-one) == 0).all())
        return o, one
    n = 32 * 32
    oo, dd = o[:n].clone(), d[:n].clone()
    ar = torch.arange(n, device=o.device)
    odd = ar % 32 == ar // 32  # warp p's lane p
    if case == "class":
        cls = trv.get_dir_class(-d)
        main = int(torch.mode(cls[:n]).values)
        other = 4096 + torch.nonzero(cls[4096:] != main)[:32, 0]
        oo[odd], dd[odd] = o[other], d[other]
        assert bool((trv.get_dir_class(-dd[odd]) != main).all())
    elif case == "nan":
        oo[odd] = float("nan")
    elif case == "inf":
        dd[odd, 0] = float("inf")
    else:
        dd[odd, 1] = torch.where(ar[odd] % 2 == 0, 0.0, -0.0)
    return oo.contiguous(), dd.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["class", "nan", "inf", "zero", "0", "1", "31", "33",
                                  "1007", "one_class"])
def test_bvh_heatmap_kernel_warps_match_plain(teapot_cuda, case):
    """The warp-coherent heatmap walk against the plain walk, count for
    count on every lane: warps that mix a ray of another direction class
    into each lane position in turn, or a NaN, infinite or zero-direction
    lane (the warp leaves the finite path for the NaN rule) at each
    position; ragged wavefronts and one class.  One launch a call (none
    for N = 0)."""
    from radish_pt_tpu_torch.accel import traverse as trv

    ds, _, o0, d0, _ = teapot_cuda
    o, d = _heatmap_warps(o0, d0, case)
    tally = Tally()
    got = trv.intersect_bvh_heatmap_cuda(ds.leaf_tris, ds.bvh_packed, o, d)
    want = trv.intersect_bvh_heatmap_plain(ds.leaf_tris, ds.bvh_packed, o, d)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want), (
        case, int((got != want).sum()))
    assert tally("launch.traverse") == ({"heatmap": 1} if o.shape[0] else {})
    if o.shape[0] > 32:
        assert int(want.max()) > 2


@pytest.mark.cuda
def test_bvh_heatmap_kernel_graph_replay(teapot_cuda):
    """The heatmap kernel captured in a CUDA graph and replayed twice, its
    output cleared before each replay: both equal the plain walk."""
    from radish_pt_tpu_torch.accel import traverse as trv

    ds, _, o, d, _ = teapot_cuda
    want = trv.intersect_bvh_heatmap_plain(ds.leaf_tris, ds.bvh_packed, o, d)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trv.intersect_bvh_heatmap_cuda(ds.leaf_tris, ds.bvh_packed, o, d)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = trv.intersect_bvh_heatmap_cuda(ds.leaf_tris, ds.bvh_packed, o, d)
    for _ in range(2):
        out.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tracer", ["pt", "bvh"])
def test_render_through_bvh_kernels_matches_plain(tracer):
    """Teapot at 64x64 on the bvh engine through the kernels against the
    plain walks: equal frames (the path tracer) and equal heatmaps, the
    kernels launched and no plain call."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(os.path.join(SCENES, "teapot.txt"), device="cuda",
                            intersector="bvh")
    cam = cam.replace(width=64, height=64)
    settings = Settings(tracer=Tracer.STREAMED if tracer == "pt" else Tracer.BVH_VISUALIZE,
                        trace_depth=3)
    imgs = []
    for engine in ("bvh", "bvh_plain"):
        tally = Tally()
        r = Renderer(ds=ds.replace(intersector=engine), cam=cam, settings=settings,
                     device="cuda")
        imgs.append(r.render(spp=2))
        if engine == "bvh":
            kinds = ("closest_hit", "occlusion") if tracer == "pt" else ("heatmap",)
            launched = tally("launch.traverse")
            assert all(launched.get(k, 0) > 0 for k in kinds), launched
            if tracer == "pt":
                assert tally("plain.traverse") == {}
    assert np.isfinite(imgs[0]).all() and imgs[0].mean() > 0.05
    assert np.array_equal(imgs[0], imgs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("engine,scene", [("plucker", "teapot.txt"), ("quad", "teapot.txt"),
                                          ("bvh", "teapot.txt"),
                                          ("dense", "cornell_box.txt"),
                                          ("compact", "teapot.txt")])
@pytest.mark.parametrize("tracer", ["pt", "restir"])
def test_batched_blocks_equal_steps(engine, scene, tracer):
    """Two blocks of 3 frames at 64x64 through ``Renderer.run_block``: one
    CUDA graph replay a block on the capturable engines (eager on compact),
    equal to 6 ``step()`` frames bit for bit; a replay adds its launches to
    the kernels' counts."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(os.path.join(SCENES, scene), device="cuda", intersector=engine)
    cam = cam.replace(width=64, height=64)
    settings = Settings(tracer=Tracer.STREAMED if tracer == "pt" else Tracer.RESTIR_DI,
                        trace_depth=3)
    a, b = (Renderer(ds=ds, cam=cam, settings=settings, device="cuda") for _ in range(2))
    for _ in range(6):
        a.step()
    for _ in range(2):
        run = b.run_block(3)
    assert b.batch_mode == ("eager" if engine == "compact" else "graph")
    assert run.replays == (0 if engine == "compact" else 2)
    for name in ("direct", "indirect"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for f in ("li", "wi", "dist", "num", "weight"):
        assert torch.equal(getattr(a.reservoir, f), getattr(b.reservoir, f)), f
    if engine != "compact":
        per = under(run.counts_per_replay, "launch." + ("traverse" if engine == "bvh" else engine))
        want = (3 * 4, 3 * 3) if tracer == "pt" else (3 + 1, 3)
        assert (per["closest_hit"], per["occlusion"]) == want


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["teapot", "empty", "one", "ragged", "all_dead", "nan",
                                  "one_box", "hires", "compact", "band"])
def test_sort_key_kernel_matches_plain(teapot_cuda, case):
    """The key kernel (csrc/sort_key.cu) equals its plain version as an
    integer on every lane (tolerance: none): teapot's 43 boxes on the
    fixture's 8,192 primaries and bounce rays, unranged, ranged (NEE
    segments: ``tmax`` 1 on the unnormalised segment, and per lane) and
    with every fifth lane dead; N = 0, 1 and 1,007; every lane dead; NaN
    and zero directions and NaN origins; C = 1; teapot_hires' 115
    super-clusters; the compact layout's 220 (1,755 paired); 512 boxes
    paired to 256 (the miss bit); the band engine's count-major form."""
    from radish_pt_tpu_torch.accel import sort_key as sk

    ds, _, o, d, tmax = teapot_cuda
    boxes, band = ds.key_bounds, False
    active = tmax > 0
    rng = np.random.default_rng(15)
    dev = o.device
    if case == "empty":
        o, d, active = o[:0], d[:0], active[:0]
    elif case == "one":
        o, d, active = o[:1], d[:1], active[:1]
    elif case == "ragged":
        o, d, active = o[:1007], d[:1007], active[:1007]
    elif case == "all_dead":
        active = torch.zeros_like(active)
    elif case == "nan":
        o, d = o.clone(), d.clone()
        d[0] = 0.0
        d[1] = torch.tensor([-1e-13, 1e-13, -1.0], device=dev)
        o[2, 1] = float("nan")
        d[3::97, 0] = float("nan")
    elif case == "one_box":
        boxes = ds.cluster_bounds[:1].contiguous()
    elif case in ("hires", "compact"):
        from radish_pt_tpu_torch.scene.build import load_scene

        hires, _, _ = load_scene(os.path.join(SCENES, "teapot_hires.txt"), device="cuda",
                                 intersector="plucker" if case == "hires" else "compact")
        boxes = hires.key_bounds
        assert boxes.shape[0] == (115 if case == "hires" else 220)
    elif case == "band":
        band = True
        lo = rng.uniform(-3, 3, (512, 3)).astype(np.float32)
        cb = np.concatenate([lo, lo + rng.uniform(0.05, 1.0, (512, 3)).astype(np.float32)], 1)
        boxes = torch.from_numpy(sk.key_boxes(cb)).to(dev)
        assert boxes.shape[0] == 256
    seg = d * 2.5
    for args in ((o, d, None, None), (o, d, None, active), (o, seg, 1.0, None),
                 (o, seg, 1.0, active), (o, d, torch.where(active, 4.0, -1.0), None)):
        got = sk.signature_key_cuda(boxes, *args, band=band)
        want = sk.signature_key_plain(boxes, *args, band=band)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (o.shape[0],)
        assert torch.equal(got, want), (case, int((got != want).sum()))
    dead = sk.signature_key_cuda(boxes, o, d, None, active, band=band) >= sk.DEAD_KEY_BIT
    assert torch.equal(dead, ~active)
    if case == "band":
        assert bool((sk.signature_key_cuda(boxes, o, d, band=band) >= sk.MISS_KEY_BIT).any())


@pytest.mark.cuda
@pytest.mark.parametrize("odd", ["nan_origin", "inf_origin", "inf_direction"])
def test_sort_key_kernel_mixed_warps(teapot_cuda, odd):
    """Warps that mix finite lanes with one odd lane, at every lane
    position (the 32-ray group g has its odd lane at g % 32, every other
    group none): a NaN or infinite origin component, or an infinite
    direction component (1 / d = 0).  Such a warp takes the NaN rule, its
    neighbours the finite path; the key equals the plain version's on
    every lane, unranged, ranged and with dead lanes."""
    from radish_pt_tpu_torch.accel import sort_key as sk

    ds, _, o, d, tmax = teapot_cuda
    o, d = o.clone(), d.clone()
    groups = o.shape[0] // 32
    g = torch.arange(0, groups, 2, device=o.device)
    lanes = 32 * g + g % 32
    value = {"nan_origin": float("nan"), "inf_origin": float("inf"),
             "inf_direction": float("-inf")}[odd]
    (d if odd == "inf_direction" else o)[lanes, g % 3] = value
    assert int((~sk.finite_path_lanes(o, d)).sum()) == lanes.numel()
    active = tmax > 0
    for args in ((o, d, None, None), (o, d * 2.5, 1.0, active),
                 (o, d, torch.where(active, 4.0, -1.0), active)):
        got = sk.signature_key_cuda(ds.key_bounds, *args)
        want = sk.signature_key_plain(ds.key_bounds, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (odd, int((got != want).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("value", ["inf", "nan"])
def test_sort_key_kernel_one_nonfinite_box(teapot_cuda, value):
    """Finite rays and one non-finite box coordinate (every block takes
    the NaN rule): the key equals the plain version's on every lane."""
    from radish_pt_tpu_torch.accel import sort_key as sk

    ds, _, o, d, tmax = teapot_cuda
    boxes = ds.key_bounds.clone()
    boxes[7, 3] = float(value)
    boxes[20, 1] = -float(value) if value == "inf" else boxes[20, 1]
    assert bool(sk.finite_path_lanes(o, d).all())
    for args in ((o, d, None, None), (o, d, 1.0, tmax > 0)):
        got = sk.signature_key_cuda(boxes, *args)
        want = sk.signature_key_plain(boxes, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (value, int((got != want).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [31, 255, 257, 511, 513, 1023, 1025, 2047, 2049, 4095, 4097,
                               8191])
def test_sort_key_kernel_ragged_wavefronts(teapot_cuda, n):
    """N not a multiple of a block's chunk of rays (threads x rays a
    thread, for 1-4 rays and 64-256 threads): the key equals the plain
    version's on every lane, the last chunk's lanes included."""
    from radish_pt_tpu_torch.accel import sort_key as sk

    ds, _, o, d, tmax = teapot_cuda
    o, d, active = o[:n].contiguous(), d[:n].contiguous(), (tmax > 0)[:n].contiguous()
    for args in ((o, d, None, active), (o, d, tmax[:n].contiguous(), None)):
        got = sk.signature_key_cuda(ds.key_bounds, *args)
        want = sk.signature_key_plain(ds.key_bounds, *args)
        torch.cuda.synchronize()
        assert got.shape == (n,) and torch.equal(got, want), n


@pytest.mark.cuda
def test_captured_block_equals_sliced_steps():
    """teapot 64x64, depth 4: ``step()`` runs the sliced bounce loop (its
    live lanes read on the host) and a replayed block the dense loop with
    the sorted sweeps; two blocks of 2 equal 4 ``step()`` frames bit for
    bit, and each frame launched the key kernel 2d + 1 times."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(os.path.join(SCENES, "teapot.txt"), device="cuda")
    cam = cam.replace(width=64, height=64)
    depth = 4
    stats = {}
    pt.path_trace(ds, cam, 0, depth, stats=stats)
    assert stats["loop"] == "sliced" and stats["slice"] == pt._slice_width(
        64 * 64, pt.DEFAULT_SLICES["cuda"])
    settings = Settings(tracer=Tracer.STREAMED, trace_depth=depth)
    a, b = (Renderer(ds=ds, cam=cam, settings=settings, device="cuda") for _ in range(2))
    tally = Tally()
    for _ in range(4):
        a.step()
    torch.cuda.synchronize()
    assert tally("launch.sort_key")["signature_key"] == 4 * (2 * depth + 1)
    for _ in range(2):
        run = b.run_block(2)
    assert b.batch_mode == "graph" and run.replays == 2
    assert under(run.counts_per_replay, "launch.sort_key") == {
        "signature_key": 2 * (2 * depth + 1)}
    for name in ("direct", "indirect"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.cuda
def test_mesh_frame_on_one_card_equals_single_device():
    """Cornell 64x64 on a mesh of 2 tiles over ``[cuda:0] * 2`` (the
    kernels on each tile's lanes): the gathered frame equals the
    single-device frame bit for bit (cornell has no clusters, so no lane
    shares a culling decision across the tile's edge)."""
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cuda")
    cam = cam.replace(width=64, height=64)
    mesh = sh.make_mesh(2, devices=[torch.device("cuda", 0)] * 2)
    got = sh.render_frame_sharded(mesh, ds, cam, 3, 4)
    d, i = pt.path_trace(ds, cam, 3, 4)
    assert got.is_cuda and torch.equal(got, d + i)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [False, True], ids=["one_graph", "segments"])
def test_mesh_batched_restir_equals_single_device(segments):
    """Cornell ReSTIR (dense) 64x48 on 3 tiles of ``[cuda:0]`` (1,024
    pixels a tile, not whole rows): ``step_batched_restir(3)``, a camera
    move, again; the frames, reservoir and last G-buffer equal the
    single-device renderer's bit for bit, as one CUDA graph over all tiles
    and as one captured graph a (stage, tile) with the exchanges between
    (what tiles on several cards run)."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cuda",
                            intersector="dense")
    cam = cam.replace(width=64, height=48)
    settings = Settings(tracer=Tracer.RESTIR_DI)
    one = Renderer(ds=ds, cam=cam, settings=settings, device="cuda")
    r = Renderer(ds=ds, cam=cam, settings=settings, device="cuda",
                 mesh=sh.make_mesh(3, devices=[torch.device("cuda", 0)] * 3))
    r.mesh_segments = segments
    moved = (cam.position + torch.tensor([0.05, 0.0, 0.0], device="cuda")).tolist()
    for k in range(2):
        for x in (one, r):
            x.step_batched_restir(3)
        assert torch.equal(r._full(r.direct), one.direct)
        for got, want in ((r._full(r.reservoir), one.reservoir),
                          (r._full(r.gbuf_last), one.gbuf_last)):
            for f, v in vars(want).items():
                assert torch.equal(getattr(got, f), v), f
        if k == 0:
            for x in (one, r):
                x.update_camera(position=moved)
    runs = [held[1] for held in r._runners.values()]
    assert r.batch_mode == "graph" and {run.mode for run in runs} == {"graph"}
    assert len(runs) == (9 if segments else 1)


@pytest.mark.cuda
def test_nccl_world_of_one_gather_image():
    """A world of one on NCCL (tcp on 127.0.0.1, a free port): the global
    mesh is this card's one tile, and ``gather_image`` returns it."""
    import socket

    from radish_pt_tpu_torch.parallel import multihost as mh

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mh.initialize(f"127.0.0.1:{port}", 1, 0, "cuda")
    try:
        mesh = mh.make_global_mesh()
        assert mesh.shape == {"tile": 1, "sample": 1} and mesh.tile_offset == 0
        tiles = mh.make_sharded_zeros(mesh, (1000, 3))
        tiles[0] += torch.arange(3000, dtype=torch.float32, device="cuda").view(1000, 3)
        img = mh.gather_image(tiles)
        assert isinstance(img, np.ndarray) and np.array_equal(img, np.arange(3000.0).reshape(1000, 3))
    finally:
        mh.shutdown()


def _traced_renderer(entry):
    """A 64x64 cornell renderer on the card and its call: ``run_block(4)``
    of the path tracer at depth 3, or ``step_batched_restir(1)`` with the
    camera orbiting (the benchmark's two entries)."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the stage marks are kernels)")
    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cuda")
    cam = cam.replace(width=64, height=64)
    if entry == "run_block":
        r = Renderer(ds=ds, cam=cam, settings=Settings(tracer=Tracer.STREAMED, trace_depth=3),
                     device="cuda")
        return r, lambda: r.run_block(4)
    r = Renderer(ds=ds, cam=cam, device="cuda",
                 settings=Settings(tracer=Tracer.RESTIR_DI, animate_camera=True,
                                   animate_radius=2.0))
    return r, lambda: r.step_batched_restir(1)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["run_block", "step_batched_restir"])
def test_host_syncs_match_sync_debug_mode(entry):
    """The tracing's ``host_syncs`` a call equals the synchronizing
    operations ``torch.cuda.set_sync_debug_mode("warn")`` reports for the
    same call (after the first call, which warms up and captures): none a
    path-traced block, one a ReSTIR call (the camera's upload)."""
    from radish_pt_tpu_torch.utils import timing

    _, call = _traced_renderer(entry)
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        counted, syncs = timing.sync_check(call)
        assert counted == len(syncs), syncs
        assert len(syncs) == (0 if entry == "run_block" else 1), syncs


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["run_block", "step_batched_restir"])
def test_stage_marks_replay_in_stream_order(entry):
    """The stage marks are captured into the block's graph: a replay counts
    them (``counts_per_replay``, the capture's own taken back) and runs
    their kernels in the frame's order among its kernels."""
    from torch.profiler import ProfilerActivity, profile

    from radish_pt_tpu_torch.utils import timing

    r, call = _traced_renderer(entry)
    call()
    run = r.last_runner
    assert run.mode == "graph"
    if entry == "run_block":
        frame = ["primary", *["nee", "bsdf", "extend", "hit"] * 3, "accumulate"]
        want = frame * 4 + ["end"]
    else:
        want = ["gbuffer", "primary", "ris", "shadow", "temporal", "spatial", "shade",
                "accumulate", "end"]
    per = {f"marks.{s}": want.count(s) for s in set(want)}
    # besides the marks, a replay counts its launches: a path-traced block's
    # sweeps (4 closest hits and 3 shadow sweeps a frame), vertex kernel
    # (one a bounce) and surface kernel (one a closest hit), a ReSTIR
    # frame's G-buffer and primary closest hits and their two surfaces, its
    # winners' shadow sweep and its one RIS kernel launch
    launches = ({"plucker.closest_hit": 4 * 4, "plucker.occlusion": 4 * 3,
                 "vertex.vertex": 4 * 3, "surface.surface": 4 * 4} if entry == "run_block" else
                {"plucker.closest_hit": 2, "plucker.occlusion": 1, "ris.ris": 1,
                 "surface.surface": 2})
    assert run.counts_per_replay == {**per, **{f"launch.{k}": n for k, n in launches.items()}}
    torch.cuda.synchronize()
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    marks = {k: n for k, n in timing.counters().items() if k.startswith("marks.")}
    assert marks == per
    kernels = sorted((e.time_range.start, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.name.startswith("stage_mark_"))
    assert [n[len("stage_mark_"):] for _, n in kernels] == want


@pytest.mark.cuda
def test_cornell_teapot_replay_equals_eager_frames_and_counts_its_reorders(monkeypatch):
    """The benchmark's ``cornell_teapot`` scene (Newell's teapot at 42
    segments, 112,572 triangles, Plücker with clusters of 512) at 800x800,
    depth 5: one replayed ``run_block(4)`` equals the same four frames run
    eagerly, bit for bit; a replay counts ``isect.sorted_wavefronts`` and
    the reorder marks as often as the eager frames do (2d + 1 sorted
    wavefronts a frame, each marked twice) and runs that many
    ``stage_mark_reorder`` kernels; cornell, without clusters, counts none
    of either."""
    from torch.profiler import ProfilerActivity, profile

    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render import graph as gr
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene
    from radish_pt_tpu_torch.utils import timing

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    path = os.path.join(os.path.dirname(__file__), "..", "benchmark", "configs",
                        "cornell_teapot", "scene.txt")
    ds, cam, _ = load_scene(path, device="cuda")
    assert (ds.intersector, ds.cluster_sub, ds.sort_primaries) == ("plucker", 512, True)
    assert (cam.width, cam.height) == (800, 800)
    depth = 5
    settings = Settings(tracer=Tracer.STREAMED, trace_depth=depth)
    replayed = Renderer(ds=ds, cam=cam, settings=settings, device="cuda")
    replayed.run_block(4)  # warm-up, capture, one replay
    run = replayed.last_runner
    assert run.mode == "graph" and run.replays == 1
    per_block = 4 * (2 * depth + 1)
    want = {"isect.sorted_wavefronts": per_block, "marks.reorder": 2 * per_block,
            "marks.reorder_end": 2 * per_block}
    assert {k: run.counts_per_replay.get(k) for k in want} == want

    with monkeypatch.context() as m:
        m.setattr(gr, "batch_mode", lambda ds: "eager")
        eager = Renderer(ds=ds, cam=cam, settings=settings, device="cuda")
        timing.reset()
        eager.run_block(4)
        torch.cuda.synchronize()
        counted = timing.counters()
    assert eager.last_runner.mode == "eager"
    assert {k: counted.get(k) for k in want} == want
    for name in ("direct", "indirect"):
        assert torch.equal(getattr(replayed, name), getattr(eager, name)), name

    timing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replayed.run_block(4)
        torch.cuda.synchronize()
    assert {k: timing.counters().get(k) for k in want} == want
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names.count("stage_mark_reorder") == names.count("stage_mark_reorder_end") \
        == 2 * per_block

    box, bcam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cuda")
    r = Renderer(ds=box, cam=bcam.replace(width=64, height=64), settings=settings,
                 device="cuda")
    timing.reset()
    r.run_block(4)
    r.run_block(4)
    assert r.last_runner.mode == "graph"
    assert not any(k in r.last_runner.counts_per_replay or k in timing.counters()
                   for k in want)


# ---------------------------------------------------------------------------
# ReSTIR's candidate RIS kernel (csrc/ris.cu) against its plain version
# ---------------------------------------------------------------------------

RIS_RES = 800


def _ordered(t):
    """f32 bits as integers ordered like the values (ulp distances)."""
    bits = t.contiguous().view(torch.int32).long()
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def _ris_args(monkeypatch, scene, reservoir_size=32, hash_mode=False, looper=5):
    """What ``restir_candidates`` hands the candidate RIS on an 800x800
    frame of ``scene`` on the card (the lanes after the primary hit, the
    demodulated material, the sampler after the primaries' draws)."""
    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(os.path.join(SCENES, scene), device="cuda")
    if hash_mode:
        ds = ds.replace(sobol=None)
    cam = cam.replace(width=RIS_RES, height=RIS_RES)
    seen = {}
    orig = rs.candidate_ris

    def spy(*args):
        seen["args"] = args
        return orig(*args)

    monkeypatch.setattr(rs, "candidate_ris", spy)
    idx = torch.arange(RIS_RES * RIS_RES, dtype=torch.int32, device="cuda")
    rs.restir_candidates(ds, cam, torch.tensor(looper, device="cuda"), idx, reservoir_size)
    monkeypatch.undo()
    return seen["args"]


def _check_ris(got, want):
    """The kernel's (reservoir, sampler) against the plain version's: the
    count M, the scramble and the pointer exactly; the winner (li, wi,
    dist) and the weight bit for bit.  Both run the same operations in the
    same order, each rounded once (csrc/ris.cu), with torch.sum's order
    over a vec3 (test_vec3_sum_order_is_the_kernels), so no tolerance:
    0 lanes with another winner, 0 ulps."""
    (res, smp), (pres, psmp) = got, want
    assert torch.equal(res.num, pres.num)
    assert torch.equal(smp.scramble, psmp.scramble)
    assert int(smp.ptr) == int(psmp.ptr)
    for f in ("li", "wi", "dist", "weight"):
        a, b = getattr(res, f), getattr(pres, f)
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b)), f
        ulps = (_ordered(a) - _ordered(b)).abs()[~nan]
        assert ulps.numel() == 0 or int(ulps.max()) == 0, (f, int((ulps > 0).sum()),
                                                           int(ulps.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("scene,size,hash_mode", [
    ("cornell_box.txt", 32, False),  # Lambertian, area lights
    ("cornell_box.txt", 16, False),
    ("cornell_box.txt", 32, True),  # the hash sampler (no Sobol table)
    ("teapot.txt", 32, False),  # MetallicWorkflow
    ("env_teapot.txt", 32, False),  # the env map its only light, metallic
    ("many_light.txt", 32, False),  # 72 emitters
    ("glass.txt", 16, False),  # a dielectric's zero lobe
], ids=["cornell", "cornell_r16", "cornell_hash", "teapot", "env_teapot", "many_light",
        "glass"])
def test_ris_kernel_matches_plain(monkeypatch, scene, size, hash_mode):
    """One launch of the candidate RIS kernel at 800x800 against the plain
    loop (``ris_plain``, eager on the card) on the same lanes."""
    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.render import ris

    args = _ris_args(monkeypatch, scene, size, hash_mode)
    tally = Tally()
    got = rs.candidate_ris(*args)
    want = rs.ris_plain(*args)
    torch.cuda.synchronize()
    assert tally("launch.ris") == {"ris": 1} and tally("plain.ris") == {"ris": 1}
    assert float(want[0].weight.sum()) > 0
    _check_ris(got, want)


@pytest.mark.cuda
def test_ris_kernel_lights_past_shared_memory(monkeypatch):
    """many_light's 72 emitters read through the read-only cache (a build
    that stages at most 16 lights a block) equal the shared-memory build's
    and the plain loop's bit for bit."""
    from radish_pt_tpu_torch.accel import _build
    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.render import ris

    args = _ris_args(monkeypatch, "many_light.txt")
    ds = args[0]
    shared = rs.candidate_ris(*args)
    assert _build.load_library("ris").ris_smem_lights() >= ds.n_area_lights
    small = _build.load_library("ris", defines=("-DRIS_SMEM_LIGHTS=16",))
    assert small.ris_smem_lights() == 16 < ds.n_area_lights == 72
    monkeypatch.setitem(_build._libs, "ris", small)  # the variant stands in for the build
    tally = Tally()
    got = rs.candidate_ris(*args)
    assert tally("launch.ris") == {"ris": 1}
    _check_ris(got, shared)
    _check_ris(got, rs.ris_plain(*args))


@pytest.mark.cuda
def test_ris_kernel_graph_replay_equals_eager(monkeypatch):
    """The kernel captured in a CUDA graph reads the sampler's pointer on
    the card: replays with new loopers (one at the Sobol table's clamped
    end) equal eager calls bit for bit, one launch a replay."""
    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.render import ris
    from radish_pt_tpu_torch.sampling import rng
    from radish_pt_tpu_torch.sampling.sobol import SOBOL_SAMPLE_DIM

    ds, pos, mat, norm, wo, sampler, size = _ris_args(monkeypatch, "cornell_box.txt")
    static = rng.SamplerState(scramble=sampler.scramble.clone(), ptr=sampler.ptr.clone())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rs.candidate_ris(ds, pos, mat, norm, wo, static, size)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rs.candidate_ris(ds, pos, mat, norm, wo, static, size)
    for looper in (7, 4321, 9999):
        static.ptr.fill_(looper * SOBOL_SAMPLE_DIM + 3)
        tally = Tally()
        graph.replay()
        assert tally("launch.ris") == {}  # a replay runs the launch the capture recorded
        want = rs.candidate_ris(ds, pos, mat, norm, wo,
                                rng.SamplerState(scramble=static.scramble,
                                                 ptr=static.ptr.clone()), size)
        torch.cuda.synchronize()
        _check_ris(out, want)


@pytest.mark.cuda
def test_replayed_restir_hands_svgf_the_frame_before():
    """``step_batched_restir(1)`` replayed as a CUDA graph, with SVGF and the
    orbiting camera, equals the eager ``step()`` call for call over five
    calls, bit for bit: the accumulation, the display, the denoised image
    and the SVGF history.  A replay writes its G-buffer frame into the
    tensors that held the frame before, so SVGF must read a copy of it.
    SVGF runs as a CUDA graph of its own, captured on the first call (the
    first-frame flag a device fill) and replayed on each later one."""
    from radish_pt_tpu_torch.config import Denoiser, Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a replayed block needs CUDA graphs)")
    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cuda")
    cam = cam.replace(width=64, height=64)

    def make():
        return Renderer(ds=ds, cam=cam, device="cuda", settings=Settings(
            tracer=Tracer.RESTIR_DI, denoiser=Denoiser.SVGF, animate_camera=True,
            animate_radius=2.0))

    a, b = make(), make()
    for k in range(5):
        disp_a, disp_b = a.step(), b.step_batched_restir(1)
        assert b.last_runner.mode == "graph"
        assert torch.equal(a.direct, b.direct), k
        assert torch.equal(disp_a, disp_b), k
        assert torch.equal(a._last_image, b._last_image), k
        for f in ("accum_color", "accum_moment"):
            assert torch.equal(getattr(a.svgf_direct, f), getattr(b.svgf_direct, f)), (k, f)
        (svgf,) = [run for key, (_, run) in b._runners.items() if key[0] == "svgf"]
        assert svgf.mode == "graph" and svgf.replays == k + 1


@pytest.mark.cuda
def test_ris_kernel_one_launch_a_frame():
    """``step_batched_restir`` blocks of 3 frames at 64x64: the replay adds
    one RIS launch a frame (``launch.ris.ris``), and no plain call."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cuda")
    r = Renderer(ds=ds, cam=cam.replace(width=64, height=64), device="cuda",
                 settings=Settings(tracer=Tracer.RESTIR_DI))
    r.step_batched_restir(3)
    run = r.last_runner
    assert run.mode == "graph" and under(run.counts_per_replay, "launch.ris") == {"ris": 3}
    tally = Tally()
    r.step_batched_restir(3)
    torch.cuda.synchronize()
    assert tally("launch.ris") == {"ris": 3} and tally("plain.ris") == {}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 31, 1024, 640_000])
def test_vec3_sum_order_is_the_kernels(n):
    """torch.sum over the last axis of a contiguous [n, 3] f32 tensor on
    the card adds (x + z) + y, and never gives -0: the order csrc/ris.cu's
    sum3 takes.  Values of mixed signs and magnitudes, so the orders
    differ in their last bits on many rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cpu").manual_seed(n)
    x = (torch.randn(n, 3, generator=g) * torch.exp(3 * torch.randn(n, 3, generator=g)))
    x[0] = torch.tensor([-0.0, -0.0, -0.0])
    x = x.cuda()
    got = torch.sum(x, dim=-1)
    want = (x[:, 0] + x[:, 2]) + x[:, 1] + 0.0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# The path tracer's vertex kernel (csrc/vertex.cu) against its plain version
# ---------------------------------------------------------------------------

VERTEX_RES = 800
CORNELL_TEAPOT = os.path.join(os.path.dirname(__file__), "..", "benchmark", "configs",
                              "cornell_teapot", "scene.txt")


def _scene_file(scene):
    return CORNELL_TEAPOT if scene == "cornell_teapot" else os.path.join(SCENES, scene)


def _vertex_waves(monkeypatch, scene, bounces, hash_mode=False, looper=5):
    """What the dense bounce loop hands the vertex at the given bounces of
    an 800x800 frame of ``scene`` on the card: {bounce: (scene, sampler,
    active, material, normal, ray direction, position, throughput)}."""
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import vertex as vx
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(_scene_file(scene), device="cuda")
    if hash_mode:
        ds = ds.replace(sobol=None)
    cam = cam.replace(width=VERTEX_RES, height=VERTEX_RES)
    seen = []
    orig = vx.vertex

    def spy(*args):
        seen.append(args)
        return orig(*args)

    monkeypatch.setattr(vx, "vertex", spy)
    pt.path_trace(ds, cam, torch.tensor(looper, device="cuda"), max(bounces), n_slices=0)
    monkeypatch.undo()
    return {b: seen[b - 1] for b in bounces}


def _same_bits(a, b) -> torch.Tensor:
    """Per element: equal bit for bit, or both NaN (the card's NaN is one
    pattern, but a NaN is a NaN)."""
    if a.dtype != torch.float32:
        return a == b
    same = a.view(torch.int32) == b.view(torch.int32)
    return same | (torch.isnan(a) & torch.isnan(b))


def _check_vertex(got, want, mtype):
    """The kernel's :class:`Vertex` against the plain version's, every
    field on every lane bit for bit: both round the same operations in the
    same order (csrc/shading.cuh), so no tolerance.  A failure names the
    field, how many lanes differ and their material types."""
    fields = {f: (getattr(got, f), getattr(want, f)) for f in (
        "seg_end", "ok", "contrib", "active", "throughput", "new_dir", "pdf", "delta")}
    fields["scramble"] = (got.sampler.scramble, want.sampler.scramble)
    assert int(got.sampler.ptr) == int(want.sampler.ptr)
    bad = {}
    for f, (a, b) in fields.items():
        assert a.shape == b.shape and a.dtype == b.dtype, f
        same = _same_bits(a, b)
        lanes = ~(same if same.dim() == 1 else same.all(-1))
        if lanes.any():
            types = torch.unique(mtype[lanes]).tolist()
            first = int(torch.nonzero(lanes)[0])
            bad[f] = (int(lanes.sum()), types, a[first].tolist(), b[first].tolist())
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("scene,hash_mode", [
    ("cornell_box.txt", False),  # Lambertian, two area lights
    ("cornell_box.txt", True),  # the hash sampler (no Sobol table)
    ("cornell_teapot", False),  # MetallicWorkflow (GGX), clusters, sorted shadows
    ("glass.txt", False),  # Dielectric, reflection and refraction
    ("env_teapot.txt", False),  # the env map its only light
    ("many_light.txt", False),  # 72 emitter triangles
    ("textured.txt", False),  # textured base colours
], ids=["cornell", "cornell_hash", "cornell_teapot", "glass", "env_teapot", "many_light",
        "textured"])
def test_vertex_kernel_matches_plain(monkeypatch, scene, hash_mode):
    """One launch of the vertex kernel on the bounce-1 and bounce-3
    wavefronts of an 800x800 frame against the plain vertex
    (``vertex_plain``, eager on the card) on the same lanes: the sampler
    state, the shadow segment, ``ok``, the contribution, ``active``, the
    throughput and the BSDF sample, bit for bit on every lane."""
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import vertex as vx

    waves = _vertex_waves(monkeypatch, scene, (1, 3), hash_mode)
    for bounce, args in waves.items():
        tally = Tally()
        got = vx.vertex(*args)
        want = pt.vertex_plain(*args)
        torch.cuda.synchronize()
        assert tally("launch.vertex") == {"vertex": 1} and tally("plain.vertex") == {"vertex": 1}
        assert bool(want.ok.any()) and bool(want.active.any()), bounce
        _check_vertex(got, want, args[3].mtype)


@pytest.mark.cuda
def test_vertex_kernel_empty_and_malformed():
    """No lane: no launch, the sampler's pointer 7 draws on; an input off
    the card or of another type raises (nothing falls back to the plain
    version)."""
    from radish_pt_tpu_torch.render import vertex as vx
    from radish_pt_tpu_torch.sampling import rng
    from radish_pt_tpu_torch.scene import device_scene as dsc
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, _, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cuda")

    def lanes(n, dev="cuda"):
        f3 = torch.zeros((n, 3), device="cuda")
        mat = dsc.SurfaceMaterial(mtype=torch.zeros(n, dtype=torch.int32, device="cuda"),
                                  base_color=f3, metallic=f3[:, 0], roughness=f3[:, 0],
                                  ior=f3[:, 0])
        smp = rng.SamplerState(scramble=torch.zeros(n, dtype=torch.int64, device="cuda"),
                               ptr=torch.tensor(35, device="cuda"))
        return (ds, smp, torch.ones(n, dtype=torch.bool, device="cuda"), mat, f3, f3, f3,
                torch.ones((n, 3), device=dev))

    tally = Tally()
    out = vx.vertex(*lanes(0))
    assert tally("launch.vertex") == {} and int(out.sampler.ptr) == 42
    assert out.contrib.shape == (0, 3) and out.ok.shape == (0,)
    with pytest.raises(ValueError, match="throughput"):
        vx.vertex(*lanes(4, dev="cpu"))
    args = list(lanes(4))
    args[2] = args[2].to(torch.int32)
    with pytest.raises(ValueError, match="active"):
        vx.vertex(*args)
    assert tally("launch.vertex") == {} and tally("plain.vertex") == {}


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell_box.txt", "cornell_teapot"],
                         ids=["cornell", "cornell_teapot"])
def test_vertex_kernel_block_equals_plain_frames(monkeypatch, scene):
    """The benchmark's two path-traced scenes at 800x800, depth 5: a
    replayed ``run_block(4)`` (the vertex kernel, captured) equals four
    eager frames whose vertices run the plain version, bit for bit; a
    replay counts one vertex launch a bounce (``launch.vertex.vertex``, 20 a
    block) and no plain call."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render import graph as gr
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import vertex as vx
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(_scene_file(scene), device="cuda")
    cam = cam.replace(width=VERTEX_RES, height=VERTEX_RES)
    depth = 5
    settings = Settings(tracer=Tracer.STREAMED, trace_depth=depth)
    replayed = Renderer(ds=ds, cam=cam, settings=settings, device="cuda")
    replayed.run_block(4)  # warm-up, capture, one replay
    run = replayed.last_runner
    assert run.mode == "graph"
    assert under(run.counts_per_replay, "launch.vertex") == {"vertex": 4 * depth}
    tally = Tally()
    replayed.run_block(4)
    torch.cuda.synchronize()
    assert tally("launch.vertex") == {"vertex": 4 * depth} and tally("plain.vertex") == {}

    with monkeypatch.context() as m:
        m.setattr(gr, "batch_mode", lambda ds: "eager")
        m.setattr(vx, "vertex", pt.vertex_plain)
        eager = Renderer(ds=ds, cam=cam, settings=settings, device="cuda")
        tally = Tally()
        eager.run_block(4)
        eager.run_block(4)
        torch.cuda.synchronize()
    assert eager.last_runner.mode == "eager"
    assert tally("launch.vertex") == {} and tally("plain.vertex") == {"vertex": 8 * depth}
    for name in ("direct", "indirect"):
        a, b = getattr(replayed, name), getattr(eager, name)
        assert bool(_same_bits(a, b).all()), (name, int((~_same_bits(a, b)).sum()))


# ---------------------------------------------------------------------------
# The closest hit's surface kernel (csrc/surface.cu) against its plain version
# ---------------------------------------------------------------------------

SURFACE_SCENES = ("cornell_box.txt", "cornell_teapot", "teapot.txt", "glass.txt",
                  "env_teapot.txt", "many_light.txt", "textured.txt")


def _surface_waves(monkeypatch, scene, engine):
    """The winners the dense bounce loop hands the surface in an 800x800
    frame of ``scene`` on ``engine`` (None: the scene's own, a sweep engine
    that returns winner ids): {wavefront: (scene, prim, bary, ray origin,
    ray direction, path)} for the primaries and bounces 1 and 3."""
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import surface as sf
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(_scene_file(scene), device="cuda", intersector=engine)
    cam = cam.replace(width=VERTEX_RES, height=VERTEX_RES)
    seen = []
    orig = sf.surface

    def spy(*args):
        seen.append(args)
        return orig(*args)

    monkeypatch.setattr(sf, "surface", spy)
    pt.path_trace(ds, cam, torch.tensor(5, device="cuda"), 3, n_slices=0)
    monkeypatch.undo()
    return {"primary": seen[0], "bounce 1": seen[1], "bounce 3": seen[3]}


def _check_surface(got, want, what):
    """The kernel's :class:`Surface` against the plain version's, every
    output on every lane bit for bit (or both NaN): no tolerance."""
    fields = {"pos": (got.pos, want.pos), "norm": (got.norm, want.norm),
              "mat_id": (got.mat_id, want.mat_id)}
    for f in ("mtype", "base_color", "metallic", "roughness", "ior"):
        fields[f] = (getattr(got.mat, f), getattr(want.mat, f))
    if want.acc is not None:
        fields["acc"], fields["active"] = (got.acc, want.acc), (got.active, want.active)
    else:
        assert got.acc is None and got.active is None
    bad = {}
    for f, (a, b) in fields.items():
        assert a.shape == b.shape and a.dtype == b.dtype, (what, f)
        same = _same_bits(a, b)
        lanes = ~(same if same.dim() == 1 else same.all(-1))
        if lanes.any():
            first = int(torch.nonzero(lanes)[0])
            bad[f] = (int(lanes.sum()), first, a[first].tolist(), b[first].tolist())
    assert not bad, (what, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", [None, "bvh"], ids=["winner_id", "barycentric"])
@pytest.mark.parametrize("scene", SURFACE_SCENES,
                         ids=[s.removesuffix(".txt") for s in SURFACE_SCENES])
def test_surface_kernel_matches_plain(monkeypatch, scene, engine):
    """One launch of the surface kernel on the primaries and the bounce-1
    and bounce-3 extension rays of an 800x800 frame (misses and dead lanes
    included) against the plain version (``surface_plain``, eager on the
    card) on the same lanes, with the wavefront's accounting (the
    primaries' or the bounce's) and without: position, shading normal,
    material, material id, accumulator and ``active``, bit for bit on every
    lane.  Both forms of the surface: from the winner id (the scene's sweep
    engine) and from the barycentrics of the BVH walk."""
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import surface as sf

    waves = _surface_waves(monkeypatch, scene, engine)
    for what, (ds, prim, bary, ray_o, ray_d, path) in waves.items():
        assert (bary is None) == (engine is None), what
        assert (path == sf.PRIMARY) == (what == "primary"), what
        if what == "bounce 3":  # dead lanes and misses have no winner
            assert not bool(path.active.all()) and bool((prim < 0).any()), what
        assert bool((prim >= 0).any()), what
        for mode in (path, None):
            tally = Tally()
            got = sf.surface(ds, prim, bary, ray_o, ray_d, mode)
            want = pt.surface_plain(ds, prim, bary, ray_o, ray_d, mode)
            torch.cuda.synchronize()
            assert tally("launch.surface") == {"surface": 1}
            assert tally("plain.surface") == {"surface": 1}
            _check_surface(got, want, (what, "accounting" if mode is not None else "none"))


@pytest.mark.cuda
def test_surface_kernel_empty_and_malformed():
    """No lane: no launch and empty outputs; an input off the card or of
    another type raises (nothing falls back to the plain version)."""
    from radish_pt_tpu_torch.render import surface as sf
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, _, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cuda")

    def lanes(n):
        f3 = torch.zeros((n, 3), device="cuda")
        return ds, torch.zeros(n, dtype=torch.int32, device="cuda"), None, f3, f3

    tally = Tally()
    out = sf.surface(*lanes(0), sf.PRIMARY)
    assert tally("launch.surface") == {} and out.pos.shape == (0, 3)
    assert out.acc.shape == (0, 3) and out.active.shape == (0,)
    ds_, prim, _, o, d = lanes(4)
    with pytest.raises(ValueError, match="ray_o"):
        sf.surface(ds_, prim, None, o.cpu(), d)
    with pytest.raises(ValueError, match="prim"):
        sf.surface(ds_, prim.long(), None, o, d)
    path = sf.PathState(acc=o, active=torch.ones(4, device="cuda"), throughput=o,
                        pdf=o[:, 0], delta=torch.ones(4, dtype=torch.bool, device="cuda"),
                        prev_pos=o)
    with pytest.raises(ValueError, match="active"):
        sf.surface(ds_, prim, None, o, d, path)
    assert tally("launch.surface") == {} and tally("plain.surface") == {}


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell_box.txt", "cornell_teapot"],
                         ids=["cornell", "cornell_teapot"])
def test_surface_kernel_block_equals_plain_frames(monkeypatch, scene):
    """The benchmark's two path-traced scenes at 800x800, depth 5: a
    replayed ``run_block(4)`` (the surface kernel, captured) equals four
    eager frames whose surfaces run the plain version, bit for bit; a
    replay counts one surface launch for the primaries and one a bounce
    (``launch.surface.surface``, 24 a block) and no plain call."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render import graph as gr
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import surface as sf
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(_scene_file(scene), device="cuda")
    cam = cam.replace(width=VERTEX_RES, height=VERTEX_RES)
    depth = 5
    settings = Settings(tracer=Tracer.STREAMED, trace_depth=depth)
    replayed = Renderer(ds=ds, cam=cam, settings=settings, device="cuda")
    replayed.run_block(4)  # warm-up, capture, one replay
    run = replayed.last_runner
    assert run.mode == "graph"
    assert under(run.counts_per_replay, "launch.surface") == {"surface": 4 * (depth + 1)}
    tally = Tally()
    replayed.run_block(4)
    torch.cuda.synchronize()
    assert tally("launch.surface") == {"surface": 24} and tally("plain.surface") == {}

    with monkeypatch.context() as m:
        m.setattr(gr, "batch_mode", lambda ds: "eager")
        m.setattr(sf, "surface", pt.surface_plain)
        eager = Renderer(ds=ds, cam=cam, settings=settings, device="cuda")
        tally = Tally()
        eager.run_block(4)
        eager.run_block(4)
        torch.cuda.synchronize()
    assert eager.last_runner.mode == "eager"
    assert tally("launch.surface") == {} and tally("plain.surface") == {"surface": 48}
    for name in ("direct", "indirect"):
        a, b = getattr(replayed, name), getattr(eager, name)
        assert bool(_same_bits(a, b).all()), (name, int((~_same_bits(a, b)).sum()))


@pytest.mark.cuda
def test_surface_kernel_two_launches_a_restir_frame(monkeypatch):
    """A replayed ``step_batched_restir(1)`` at 800x800 counts two surface
    launches (the G-buffer's primaries and ReSTIR's) and no plain call, and
    its display equals the same frames run eagerly through the plain
    version, bit for bit."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render import graph as gr
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import surface as sf
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cuda")
    cam = cam.replace(width=VERTEX_RES, height=VERTEX_RES)
    settings = Settings(tracer=Tracer.RESTIR_DI)
    replayed = Renderer(ds=ds, cam=cam, settings=settings, device="cuda")
    replayed.step_batched_restir(1)
    run = replayed.last_runner
    assert run.mode == "graph"
    assert under(run.counts_per_replay, "launch.surface") == {"surface": 2}
    tally = Tally()
    replayed.step_batched_restir(1)
    torch.cuda.synchronize()
    assert tally("launch.surface") == {"surface": 2} and tally("plain.surface") == {}
    with monkeypatch.context() as m:
        m.setattr(gr, "batch_mode", lambda ds: "eager")
        m.setattr(sf, "surface", pt.surface_plain)
        eager = Renderer(ds=ds, cam=cam, settings=settings, device="cuda")
        tally = Tally()
        eager.step_batched_restir(1)
        eager.step_batched_restir(1)
        torch.cuda.synchronize()
    assert tally("launch.surface") == {} and tally("plain.surface") == {"surface": 4}
    a, b = replayed.current_image(), eager.current_image()
    assert bool(_same_bits(a, b).all()), int((~_same_bits(a, b)).sum())
