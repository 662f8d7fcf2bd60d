"""Port parity for the sorted, compacted wavefront: the cluster-signature
sort key against the JAX package's ``_sort_key``, the sorted sweeps
(``intersect_sorted``, ``test_occlusion_sorted``, ``intersect_primary``)
against the unsorted ones, the sliced bounce loop against the dense loop,
and the port's default frame against the JAX package's default (sliced)
frame.  Inputs come from numpy seeds; the port runs its plain versions on
the CPU."""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
from torch_port_util import (SCENES, camera_from_jax, jax_scene_parts,  # noqa: E402
                             load_jax_scene, t2n)

@pytest.fixture(scope="module")
def teapot():
    """The reference's teapot build (Plücker engine, 43 clusters) and the
    port's scene on the same bytes."""
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    mp = pytest.MonkeyPatch()
    try:
        jds, jcam, _ = load_jax_scene(mp, "teapot.txt")
    finally:
        mp.undo()
    return jds, jcam, scene_from_jax(*jax_scene_parts(jds))


def _surface_rays(tri_v, n, rng, spread=1e-3):
    """Rays leaving random points of the scene's (non-padding) triangles in
    random directions, f32 numpy."""
    tri = np.asarray(tri_v)
    real = np.flatnonzero(np.abs(tri).sum(axis=(1, 2)) > 0)
    w = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    surf = np.einsum("nk,nkc->nc", w, tri[rng.choice(real, n)]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (surf + d * spread).astype(np.float32), d


def _odd_lanes(o, d):
    """Lanes the slab test must take as the reference does: a zero
    direction, components of +-1e-13 (below the 1e-12 substitution, which
    turns a tiny negative positive), a NaN origin, a NaN direction."""
    o, d = o.copy(), d.copy()
    d[0] = 0.0
    d[1] = (-1e-13, 1e-13, -1.0)
    o[2, 1] = np.nan
    d[3, 0] = np.nan
    return o, d


def _keys(cb, o, d, tmax=None, band=False):
    """(JAX key, port key) of rays ``o``/``d`` on cluster boxes ``cb``."""
    from radish_pt_tpu.scene import device_scene as jdsc
    from radish_pt_tpu_torch.accel import sort_key as sk

    fake = types.SimpleNamespace(cluster_bounds=jnp.asarray(cb),
                                 intersector="pallas_band" if band else "pallas_mxu")
    want = np.asarray(jdsc._sort_key(fake, jnp.asarray(o), jnp.asarray(d),
                                     None if tmax is None else jnp.asarray(tmax)))
    boxes = torch.from_numpy(sk.key_boxes(cb))
    got = sk.signature_key_plain(boxes, torch.from_numpy(o), torch.from_numpy(d),
                                 None if tmax is None else torch.from_numpy(tmax), band=band)
    return want, t2n(got)


@pytest.mark.parametrize("wave", ["primary", "bounce", "segments"])
@pytest.mark.parametrize("band", [False, True])
def test_sort_key_matches_reference_on_teapot(teapot, wave, band):
    """The port's key equals the JAX package's ``_sort_key`` as an integer
    on every lane (tolerance: none) on teapot's 43 clusters (no pairing):
    its 32x32 primaries, 4,096 random bounce rays leaving its surfaces
    (with a zero direction, tiny +-1e-13 components and NaN lanes), and
    4,096 NEE segments toward its lights bounded at their end (``tmax`` 1
    on the unnormalised segment); both key forms."""
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.sampling import rng as prng

    jds, jcam, ds = teapot
    rng = np.random.default_rng(14)
    tmax = None
    if wave == "primary":
        cam = camera_from_jax(jcam, 32, 32)
        idx, _ = pt._lanes(ds, cam)
        o, d, _ = pt._gen_primary(ds, cam, prng.make_sampler(0, idx), idx)
        o, d = t2n(o), t2n(d)
    else:
        o, d = _odd_lanes(*_surface_rays(t2n(ds.tri_v), 4096, rng))
        if wave == "segments":  # toward random points of the lights
            lights = t2n(ds.tri_v)[t2n(ds.light_prim_ids)]
            w = rng.dirichlet([1, 1, 1], o.shape[0]).astype(np.float32)
            y = np.einsum("nk,nkc->nc", w, lights[rng.integers(0, len(lights), o.shape[0])])
            d = (y - o).astype(np.float32)
            tmax = np.ones(o.shape[0], np.float32)
    want, got = _keys(t2n(ds.cluster_bounds), o, d, tmax, band)
    assert ds.key_bounds.shape[0] == ds.cluster_bounds.shape[0] == 43
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 10  # the key separates the rays


def _soup_boxes(n_c, rng):
    """``n_c`` random boxes in [-1, 1]^3, each up to 0.3 wide."""
    lo = rng.uniform(-1, 1, (n_c, 3)).astype(np.float32)
    return np.concatenate([lo, lo + rng.uniform(0.01, 0.3, (n_c, 3)).astype(np.float32)],
                          axis=1)


@pytest.mark.parametrize("n_c,paired", [(601, 151), (1755, 220), (230, 115), (43, 43),
                                        (65, 33)])
def test_key_boxes_pair_as_the_reference(n_c, paired):
    """The super-cluster boxes: paired while C > 256 and once at the first
    level above 64, an odd count padded with the last box (teapot_hires
    230 -> 115, the compact layout's 1,755 -> 220, teapot's 43 kept); the
    keys of 2,048 random rays on them equal the JAX package's on every
    lane (tolerance: none)."""
    from radish_pt_tpu_torch.accel import sort_key as sk

    rng = np.random.default_rng(n_c)
    cb = _soup_boxes(n_c, rng)
    boxes = sk.key_boxes(cb)
    assert boxes.shape == (paired, 6)
    o = rng.uniform(-1.2, 1.2, (2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for band in (False, True):
        want, got = _keys(cb, o, d, None, band)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("band", [False, True])
def test_sort_key_miss_differs_from_cluster_255_only_at_256(band):
    """With C = 256 super-clusters (512 paired once) the reference's miss
    key is cluster 255's field; the port's misses carry bit 22 instead.
    Those lanes, and only those, differ from the JAX package's key; with C
    = 255 no lane differs."""
    from radish_pt_tpu_torch.accel import sort_key as sk

    rng = np.random.default_rng(256)
    o = rng.uniform(-3, 3, (4096, 3)).astype(np.float32)  # many rays miss
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    for n_c, boxes in ((512, 256), (510, 255)):
        cb = _soup_boxes(n_c, rng)
        want, got = _keys(cb, o, d, None, band)
        assert sk.key_boxes(cb).shape[0] == boxes
        differ = got != want
        if boxes == 255:
            assert not differ.any()
            continue
        miss = want == sk.miss_key(256, band) - sk.MISS_KEY_BIT  # the reference's
        assert miss.sum() > 100 and differ.sum() == miss.sum()
        np.testing.assert_array_equal(got[differ], want[differ] + sk.MISS_KEY_BIT)


@pytest.fixture(scope="module")
def bounce_rays(teapot):
    """2,048 bounce rays leaving teapot's surfaces, every fifth dead, and
    NEE segments from the same points (every seventh masked)."""
    _, _, ds = teapot
    rng = np.random.default_rng(41)
    n = 2048
    o, d = _surface_rays(t2n(ds.tri_v), n, rng)
    active = np.ones(n, bool)
    active[::5] = False
    mask = np.ones(n, bool)
    mask[::7] = False
    y = o + d * rng.uniform(0.05, 3.0, (n, 1)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in
            (("o", o), ("d", d), ("active", active), ("y", y), ("mask", mask))}


def _equal_interactions(a, b):
    for f in ("prim_id", "mat_id", "pos", "norm", "uv"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("engine", ["plucker", "brute"])
def test_sorted_sweeps_equal_unsorted(teapot, bounce_rays, engine):
    """``intersect_sorted`` equals ``intersect`` and
    ``test_occlusion_sorted`` equals ``test_occlusion`` bit for bit
    (tolerance: none) on 2,048 bounce rays and segments with dead and
    masked lanes: the Plücker engine's plain sweeps (culled per 32-lane
    warp, so the sort moves what each warp culls; only a ray that grazes a
    cluster's box could change, and none of these does) and the brute
    engine (barycentrics put back by the scatter); ``intersect_primary``
    equals ``intersect`` on the same rays.  The key runs once a sorted
    call."""
    from radish_pt_tpu_torch.scene import device_scene as dsc

    _, _, ds = teapot
    ds = ds.replace(intersector=engine)
    r = bounce_rays
    tally = Tally()
    _equal_interactions(dsc.intersect_sorted(ds, r["o"], r["d"], r["active"]),
                        dsc.intersect(ds, r["o"], r["d"], r["active"]))
    _equal_interactions(dsc.intersect_sorted(ds, r["o"], r["d"]),
                        dsc.intersect(ds, r["o"], r["d"]))
    assert ds.sort_primaries
    _equal_interactions(dsc.intersect_primary(ds, r["o"], r["d"]),
                        dsc.intersect(ds, r["o"], r["d"]))
    occ = dsc.test_occlusion_sorted(ds, r["o"], r["y"], mask=r["mask"])
    want = dsc.test_occlusion(ds, r["o"], torch.where(r["mask"][:, None], r["y"], r["o"]))
    assert torch.equal(occ, want)
    assert 0 < int(want.sum()) < want.numel()
    assert tally("plain.sort_key") == {"signature_key": 4} and tally("launch.sort_key") == {}


@pytest.mark.parametrize("engine", ["plucker", "band", "quad"])
def test_sorted_shadow_test_follows_lane_ids(teapot, bounce_rays, engine):
    """The sorted shadow test sweeps its segments in (key, lane id) order
    and a masked segment flags no cluster, so the same segments share a
    culling group (warp, band, row) however the wavefront is laid out: the
    segments shuffled, with their lane ids, give the same bits lane by
    lane (tolerance: none); a masked lane is not blocked."""
    from radish_pt_tpu_torch.scene import device_scene as dsc
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    jds, _, ds = teapot
    if engine != "plucker":
        ds = scene_from_jax(*jax_scene_parts(jds), intersector=engine)
    r = bounce_rays
    want = dsc.test_occlusion_sorted(ds, r["o"], r["y"], mask=r["mask"])
    perm = torch.from_numpy(np.random.default_rng(7).permutation(r["o"].shape[0]))
    got = dsc.test_occlusion_sorted(ds, r["o"][perm], r["y"][perm], mask=r["mask"][perm],
                                    lane=perm)
    assert torch.equal(got, want[perm])
    assert not bool(want[~r["mask"]].any()) and 0 < int(want.sum())


@pytest.fixture(scope="module")
def port_scenes():
    """The port's own builds (CPU), by (scene, engine)."""
    from radish_pt_tpu_torch.scene.build import load_scene

    cache = {}

    def get(scene, engine):
        if (scene, engine) not in cache:
            cache[scene, engine] = load_scene(os.path.join(SCENES, scene), device="cpu",
                                              intersector=engine)[:2]
        return cache[scene, engine]
    return get


@pytest.mark.parametrize("scene,engine,res,depth,looper", [
    ("teapot.txt", "plucker", (32, 32), 5, 0),
    ("env_teapot.txt", "plucker", (16, 16), 5, 3),
    ("glass.txt", "plucker", (16, 16), 8, 5),
    ("teapot.txt", "bvh", (16, 16), 5, 1),
    ("teapot.txt", "band", (16, 16), 5, 2),
    ("teapot.txt", "plucker", (29, 37), 3, 4),  # no whole tiles: raster order
])
def test_sliced_loop_equals_dense_loop(port_scenes, scene, engine, res, depth, looper):
    """The sliced bounce loop (4 and 3 slices) gives the dense loop's
    frame (``n_slices=0``) bit for bit (``torch.equal``, tolerance: none):
    teapot 32x32 at depth 5, env_teapot's env-miss term, glass's delta
    BSDFs and aperture (its live lanes run out before depth 8 at 16x16:
    the loop stops there), the bvh and band engines, and a frame that does
    not divide into tiles (raster order).  The live lanes of the extension
    wavefronts shrink bounce by bounce."""
    from radish_pt_tpu_torch.render import pathtrace as pt

    ds, cam = port_scenes(scene, engine)
    cam = cam.replace(width=res[0], height=res[1])
    dense = {}
    want = pt.path_trace(ds, cam, looper, depth, n_slices=0, stats=dense)
    assert dense == {"loop": "dense"}
    for n_slices in (4, 3):
        stats = {}
        got = pt.path_trace(ds, cam, looper, depth, n_slices=n_slices, stats=stats)
        assert stats["loop"] == "sliced" and stats["slice"] % 128 == 0
        live = stats["live"]
        assert 0 <= live[-1] <= live[0] <= res[0] * res[1] and live[0] > 0
        assert all(a >= b for a, b in zip(live, live[1:]))
        for g, w in zip(got, want):
            assert torch.equal(g, w), n_slices
    assert float(want[1].abs().sum()) > 0  # bounces reached light


def test_sliced_gate(port_scenes):
    """The reference's gate: cornell (no clusters) and depth 0 run the
    dense loop whatever ``n_slices`` says; teapot takes the sliced loop by
    default (4 slices on the CPU)."""
    from radish_pt_tpu_torch.render import pathtrace as pt

    for scene, depth, loop in (("cornell_box.txt", 3, "dense"), ("teapot.txt", 0, "dense"),
                               ("teapot.txt", 2, "sliced")):
        ds, cam = port_scenes(scene, "plucker")
        stats = {}
        pt.path_trace(ds, cam.replace(width=16, height=16), 0, depth, stats=stats)
        assert stats["loop"] == loop, scene
        if loop == "sliced":
            assert stats["slice"] == pt._slice_width(256, pt.DEFAULT_SLICES["cpu"])


def _off(got, want):
    """Pixels off the rounding bound (rtol 1e-5, atol 1e-6) in a channel."""
    return (np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)).any(axis=-1)


def test_default_path_trace_matches_reference_sliced(teapot, monkeypatch):
    """The port's default frame (sliced, brute engine, teapot 32x32, depth
    3, looper 0) against the JAX package's default frame, which runs its
    own sliced loop on the brute engine.

    The JAX sliced loop rebuilds the previous vertex as ``o - d * 1e-5``
    where the port carries it: the pixels that moves (its sliced frame
    against its own dense one, bit for bit) are counted, and they stay
    within 1e-4 relative.  The bound: every pixel within 1e-3, as
    ``test_path_trace_brute_matches_reference``; that test's rounding
    bound (rtol 1e-5, atol 1e-6), which holds there for all but one cornell
    pixel, holds on teapot for all but at most 2% of the pixels: the
    packages' per-lane arithmetic differs at ~3e-5 relative on some light
    samples (XLA's fused operations), and one grazing shadow decision goes
    the other way.  Every such pixel is off against the JAX dense frame
    too (the port's loops give the same bits), or moved by the JAX sliced
    loop's rebuilt vertex: the sliced loop adds no difference of its own."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, jcam, ds = teapot
    res, depth = 32, 3
    jcam = jcam.replace(width=res, height=res)
    jb = jds.replace(intersector="brute")

    def jax_frame():  # a fresh function: the loop is chosen when it is traced
        f = jax.jit(lambda s, c: jpt.path_trace(s, c, 0, depth))
        return np.concatenate([np.asarray(a) for a in f(jb, jcam)], axis=1)

    monkeypatch.delenv("RADISH_COMPACT", raising=False)
    want = jax_frame()
    monkeypatch.setenv("RADISH_COMPACT", "0")
    jax_dense = jax_frame()
    moved = (want != jax_dense).any(axis=-1)
    stats = {}
    d, i = pt.path_trace(ds.replace(intersector="brute"), camera_from_jax(jcam, res, res), 0,
                         depth, stats=stats)
    assert stats["loop"] == "sliced"
    got = np.concatenate([t2n(d), t2n(i)], axis=1)
    off, off_dense = _off(got, want), _off(got, jax_dense)
    print(f"teapot 32x32 depth 3: pixels the JAX sliced loop's rebuilt vertex moves "
          f"{int(moved.sum())} of {moved.size}; port pixels off the rounding bound "
          f"{int(off.sum())} (against the JAX dense frame {int(off_dense.sum())})")
    assert 0 < moved.sum() <= 0.1 * moved.size
    np.testing.assert_allclose(jax_dense[moved], want[moved], rtol=1e-4, atol=1e-6)
    assert off.sum() <= 0.02 * off.size
    assert not (off & ~off_dense & ~moved).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert want[:, 3:].mean() > 1e-3
