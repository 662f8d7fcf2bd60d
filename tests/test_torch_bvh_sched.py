"""The BVH walks' dead lanes and ray binning (accel/traverse.py,
csrc/bvh.cu): the plain walk's per-lane range in closest-hit mode, the
frame that hands dead lanes ``-FLT_MAX``, the binning's plain version
``bin_by_dir_class`` and the shadow walk's settled zero-range lanes, on
teapot and on small random triangle soups, held against the JAX package's
``intersect_bvh`` / ``occlusion_bvh`` / ``get_dir_class`` / ``path_trace``
where it has a counterpart; and ``tune bvh``'s variants of the kernels'
compile-time shapes.

Tolerances: the port against itself (ranged against unranged walks,
frames with and without the dead-lane range) bit for bit; against the JAX
walk as tests/test_torch_bvh.py states it (ids equal, dist within 5e-5
relative, barycentrics within 1e-5 but on at most one lane in 1,000, each
nearer the winner's f64 barycentrics than the JAX walk's: XLA contracts
the Möller–Trumbore products into FMAs); against the JAX frame as
``test_path_trace_bvh_matches_jax`` (at most 2 of 2,304 pixels beyond
1e-3, the mean absolute difference below 1e-4)."""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_bvh import RES, _check_closest, _exact_bary, _rays, teapot  # noqa: E402,F401
from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
from torch_port_util import t2n  # noqa: E402

FLT_MAX = np.float32(3.402823466e38)
# ranges that settle a lane before its walk: not above 0, or NaN
DEAD_RANGES = np.array([-FLT_MAX, -1.0, 0.0, -0.0, np.nan], np.float32)


def _soup(seed, n_tris=300, n_rays=1500):
    """A random soup of ``n_tris`` small triangles in [-1, 1]^3, both
    packages' BVH tables of it and ``n_rays`` rays (every third
    axis-aligned, signed zeros included)."""
    from radish_pt_tpu.accel import bvh as jbvh
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel import bvh
    from radish_pt_tpu_torch.accel import traverse as trv

    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.0, 1.0, (n_tris, 1, 3))
    v = (centers + rng.normal(scale=0.15, size=(n_tris, 3, 3))).astype(np.float32)
    b = bvh.build_bvh(v.reshape(-1, 3))
    jb = jbvh.build_bvh(v.reshape(-1, 3))
    tables = (torch.from_numpy(b.leaf_tris), torch.from_numpy(b.leaf_map),
              torch.from_numpy(trv.pack_bvh(b)))
    jtables = (jnp.asarray(jb.leaf_tris), jnp.asarray(jb.leaf_map),
               jnp.asarray(jtrv.pack_bvh(jb)))
    o = rng.uniform(-1.5, 1.5, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    axes = np.array([1.0, -1.0, 0.0, -0.0], np.float32)
    d[::3] = axes[rng.integers(0, 4, (len(d[::3]), 3))]
    d[::3][np.abs(d[::3]).sum(1) == 0] = np.float32([0.0, -0.0, 1.0])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tri_packed = torch.from_numpy(trv.pack_tris(v))
    return tables, jtables, tri_packed, torch.from_numpy(o), torch.from_numpy(d)


@pytest.fixture(scope="module", params=["soup0", "soup1", "teapot"])
def case(request):
    """(port tables, JAX tables, stored triangles, ray_o, ray_d): a soup, or
    teapot's 48x48 bounce-1 extension rays (its dead lanes walked as any
    ray here)."""
    if request.param.startswith("soup"):
        return _soup(int(request.param[-1]))
    jds, _, ds, _, _ = request.getfixturevalue("teapot")
    o, d, _ = _rays(request.getfixturevalue("teapot"), "extension")
    return ((ds.leaf_tris, ds.leaf_map, ds.bvh_packed),
            (jds.leaf_tris, jds.leaf_map, jds.bvh_packed), ds.tri_packed, o, d)


def _dead_mask(n):
    """Every third lane dead, the five dead ranges in turn."""
    dead = np.zeros(n, bool)
    dead[::3] = True
    tmax = np.full(n, FLT_MAX, np.float32)
    tmax[dead] = np.resize(DEAD_RANGES, int(dead.sum()))
    return torch.from_numpy(dead), torch.from_numpy(tmax)


def test_closest_hit_range_settles_dead_lanes(case):
    """(a) The plain walk with a per-lane range: a lane whose range is not
    above 0 (-FLT_MAX, -1, +-0, NaN) is settled before its walk with the
    miss result (-1, FLT_MAX exactly, (0, 0)) and no node visit; every live
    lane (range FLT_MAX) keeps the unranged walk's prim, dist, barycentrics
    and visits bit for bit, and the JAX walk's winners."""
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel import traverse as trv

    (lt, lm, bp), (jlt, jlm, jbp), tri, o, d = case
    dead, tmax = _dead_mask(o.shape[0])
    st0, st1 = {}, {}
    want = trv.intersect_bvh_plain(lt, lm, bp, o, d, stats=st0)
    got = trv.intersect_bvh_plain(lt, lm, bp, o, d, tmax, stats=st1)
    live = ~dead
    for g, w in zip(got, want):
        assert torch.equal(g[live], w[live])
    assert bool((got[0][dead] == -1).all())
    np.testing.assert_array_equal(t2n(got[1][dead]), FLT_MAX)
    assert not bool(got[2][dead].any())
    assert not bool(st1["visits"][dead].any())
    assert torch.equal(st1["visits"][live], st0["visits"][live])
    assert float((want[0][live] >= 0).float().mean()) > 0.2  # the walks meet triangles
    jw = jtrv.intersect_bvh(jlt, jlm, jbp, jnp.asarray(t2n(o)), jnp.asarray(t2n(d)))
    keep = t2n(live)
    exact = _exact_bary(t2n(tri), t2n(got[0]), t2n(o), t2n(d))[keep]
    _check_closest(tuple(t2n(x)[keep] for x in got), tuple(np.asarray(x)[keep] for x in jw),
                   exact, max_off=keep.sum() // 1000)


def test_closest_hit_finite_range(case):
    """A live lane's range bounds its hits: half its unranged hit's t, or
    exactly that t (strict t < range), gives the miss result; one and a
    half times that t (10 for a miss) gives the unranged result bit for
    bit."""
    from radish_pt_tpu_torch.accel import traverse as trv

    (lt, lm, bp), _, _, o, d = case
    prim, dist, bary = trv.intersect_bvh_plain(lt, lm, bp, o, d)
    hit = prim >= 0
    assert bool(hit.any()) and not bool(hit.all())
    far = torch.where(hit, dist * 1.5, 10.0)
    assert all(torch.equal(g, w) for g, w in
               zip(trv.intersect_bvh_plain(lt, lm, bp, o, d, far), (prim, dist, bary)))
    for near in (dist * 0.5, dist):
        p, t, b = trv.intersect_bvh_plain(lt, lm, bp, o[hit], d[hit], near[hit])
        assert bool((p == -1).all()) and bool((t == trv.FLT_MAX).all()) and not bool(b.any())


def test_dead_lane_range_keeps_the_frame(teapot, monkeypatch):
    """(b) Two 48x48 teapot frames (depth 3) through ``Renderer`` on
    ``bvh_plain``, whose bounces hand the walk the dead-lane range: the
    accumulations and the image equal, bit for bit, those of the same
    frames with the walk given no range (dead lanes walked as any ray);
    the first frame against the JAX package's ``path_trace`` within
    ``test_path_trace_bvh_matches_jax``'s tolerance."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.accel import traverse as trv
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render.renderer import Renderer

    jds, jcam, ds, cam, _ = teapot
    ds, depth = ds.replace(intersector="bvh_plain"), 3
    ranges = []
    real = trv.intersect_bvh

    def frames(drop_range):
        def walk(lt, lm, bp, o, d, tmax=None, plain=False):
            ranges.append(tmax is not None)
            return real(lt, lm, bp, o, d, None if drop_range else tmax, plain=plain)

        monkeypatch.setattr(trv, "intersect_bvh", walk)
        r = Renderer(ds=ds, cam=cam, desc=None, device="cpu",
                     settings=Settings(tracer=Tracer.STREAMED, trace_depth=depth))
        for _ in range(2):
            r.step()
        return r.direct, r.indirect, r.current_image()

    ranged, unranged = frames(False), frames(True)
    assert ranges.count(True) == 2 * 2 * depth  # every bounce's walk had a range
    assert all(torch.equal(a, b) for a, b in zip(ranged, unranged))
    monkeypatch.setattr(trv, "intersect_bvh", real)
    f = jax.jit(jpt.path_trace, static_argnames=("max_depth",))
    want = sum(np.asarray(a) for a in f(jds, jcam.replace(width=RES, height=RES), 0, depth))
    d0, i0 = pt.path_trace(ds, cam, 0, depth)
    got = t2n(d0 + i0)
    assert want.mean() > 1e-2 and np.isfinite(got).all()
    assert (np.abs(got - want) > 1e-3).any(axis=-1).sum() <= 2
    assert np.abs(got - want).mean() < 1e-4


def _axis_dirs():
    """Every direction with components from {1, -1, 0.5, +0, -0} (the zero
    vector left out)."""
    vals = np.array([1.0, -1.0, 0.5, 0.0, -0.0], np.float32)
    g = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), -1).reshape(-1, 3)
    return g[np.abs(g).sum(1) > 0]


@pytest.mark.parametrize("what", ["random", "axis", "teapot"])
def test_bin_by_dir_class(what, request):
    """(c) ``bin_by_dir_class``: exactly the live lanes (range above 0),
    once each, class-major and in launch order within a class; its
    classes and counts are the JAX package's ``get_dir_class(-d)`` on
    random and axis-aligned directions (signed zeros included) and on
    teapot's bounce-1 extension rays with their dead lanes."""
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel import traverse as trv

    rng = np.random.default_rng(3)
    if what == "teapot":
        _, d, live = _rays(request.getfixturevalue("teapot"), "extension")
        tmax = torch.where(live, trv.FLT_MAX, -trv.FLT_MAX)
    else:
        d = torch.from_numpy(rng.normal(size=(1000, 3)).astype(np.float32)
                             if what == "random" else np.tile(_axis_dirs(), (8, 1)))
        _, tmax = _dead_mask(d.shape[0])
        live = tmax > 0
    want = np.asarray(jtrv.get_dir_class(-jnp.asarray(t2n(d))))
    np.testing.assert_array_equal(t2n(trv.get_dir_class(-d)), want)
    assert len(np.unique(want[t2n(live)])) == 6
    tally = Tally()
    order, counts = trv.bin_by_dir_class(d, tmax)
    assert tally("plain.traverse")["bin"] == 1
    order = t2n(order)
    np.testing.assert_array_equal(np.sort(order), np.flatnonzero(t2n(live)))
    np.testing.assert_array_equal(t2n(counts), np.bincount(want[t2n(live)], minlength=6))
    key = want[order].astype(np.int64) * len(want) + order  # class, then launch order
    assert (np.diff(key) > 0).all()
    full, full_counts = trv.bin_by_dir_class(d)
    np.testing.assert_array_equal(t2n(full), np.argsort(want, kind="stable"))
    np.testing.assert_array_equal(t2n(full_counts), np.bincount(want, minlength=6))


@pytest.mark.parametrize("scene", ["soup0", "teapot"])
def test_zero_range_shadow_never_blocked(scene, request):
    """(d) A shadow lane whose range is not above 0, or NaN, is never
    blocked: by the plain walk, which settles it with no node visit, and
    by the JAX package's ``occlusion_bvh`` on the same segments (zero
    length, shorter than its 1e-4 end inset, or NaN); segments of the same
    origins through the geometry are blocked in both."""
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel import traverse as trv

    if scene == "teapot":
        jds, _, ds, _, _ = request.getfixturevalue("teapot")
        (lt, bp), (jlt, jlm, jbp) = (ds.leaf_tris, ds.bvh_packed), (
            jds.leaf_tris, jds.leaf_map, jds.bvh_packed)
        x, _, _ = request.getfixturevalue("teapot")[4]["segments"]
        x = x[:600]
        d = torch.nn.functional.normalize(torch.randn(x.shape, generator=torch.Generator()
                                                      .manual_seed(5)), dim=-1)
    else:
        (lt, _, bp), (jlt, jlm, jbp), _, x, d = _soup(0)
    n = x.shape[0]
    length = torch.from_numpy(np.resize(np.float32([0.0, 5e-5, 0.9e-4]), n))
    y = x + d * length[:, None]
    y[::7] = float("nan")
    so, sd, tm = trv.segment_rays(x, y)
    assert not bool((tm > 0).any())
    st = {}
    assert not bool(trv.occlusion_bvh_plain(lt, bp, so, sd, tm, stats=st).any())
    assert not bool(st["visits"].any())
    assert not np.asarray(jtrv.occlusion_bvh(jlt, jlm, jbp, jnp.asarray(t2n(x)),
                                             jnp.asarray(t2n(y)))).any()
    far = x + d * 4.0
    so, sd, tm = trv.segment_rays(x, far)
    blocked = trv.occlusion_bvh_plain(lt, bp, so, sd, tm)
    assert bool(blocked.any())
    jb = np.asarray(jtrv.occlusion_bvh(jlt, jlm, jbp, jnp.asarray(t2n(x)),
                                       jnp.asarray(t2n(far))))
    np.testing.assert_array_equal(t2n(blocked), jb)


def _bvh_macros():
    """csrc/bvh.cu's compile-time shapes: {name: default}."""
    import re
    from pathlib import Path

    import radish_pt_tpu_torch

    src = (Path(radish_pt_tpu_torch.__file__).parent / "csrc" / "bvh.cu").read_text()
    return dict(re.findall(r"#ifndef (BVH_\w+)\n#define \1 (\d+)", src))


def _heat_macros(macros):
    """The heatmap walk's macros among csrc/bvh.cu's: ``BVH_HEAT_*``."""
    return {m for m in macros if m.startswith("BVH_HEAT_")}


@pytest.mark.parametrize("k", range(12))
def test_tune_variants_name_the_walks_macros(k):
    """``tune bvh``'s walk variants set only macros csrc/bvh.cu defines,
    each of the walks' four (the heatmap's apart); the first is the
    source's defaults and every other changes one of them, no two alike."""
    from radish_pt_tpu_torch import tune

    macros = _bvh_macros()
    heat = _heat_macros(macros)
    assert len(heat) >= 3
    assert len(tune.BVH_VARIANTS) == 12
    as_dict = [dict(f[2:].split("=") for f in v) for v in tune.BVH_VARIANTS]
    variant = as_dict[k]
    assert set(variant) == set(macros) - heat
    changed = {m for m in variant if variant[m] != macros[m]}
    assert len(changed) == (0 if k == 0 else 1), (k, changed)
    assert as_dict.count(variant) == 1


def test_tune_heatmap_variants_name_its_macros():
    """``tune heat``'s variants set every macro of the heatmap's
    (``BVH_HEAT_*``) and no other; the first is the source's defaults and
    every other changes one of them, no two alike."""
    from radish_pt_tpu_torch import tune

    macros = _bvh_macros()
    as_dict = [dict(f[2:].split("=") for f in v) for v in tune.BVH_HEATMAP_VARIANTS]
    assert len(as_dict) > 1
    for k, variant in enumerate(as_dict):
        assert set(variant) == _heat_macros(macros)
        changed = {m for m in variant if variant[m] != macros[m]}
        assert len(changed) == (0 if k == 0 else 1), (k, changed)
        assert as_dict.count(variant) == 1
