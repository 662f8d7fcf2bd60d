"""Port parity for a tile of a mesh: ``path_trace`` (the dense and the
sliced bounce loop), ``path_trace_direct`` and ``render_gbuffer`` with
``pixel_idx``, each against the JAX package's call on the same shard of
global pixel indices under ``jax.jit`` (what its ``shard_map`` tile
function computes for one tile) and against the port's own full frame.

Tolerances, each with its reason:
* against the port's full frame: none (``torch.equal``); the sampler is
  seeded by the pixel id and each lane's math is the same;
* against the JAX package: those of the full-frame parity tests on the
  same engine and scene — the path tracer on cornell (brute force) to
  1e-5 relative on all but one pixel a shard, every pixel within 1e-3
  (tests/test_torch_pathtrace.py); teapot's sliced loop every pixel
  within 1e-3 and at most 2% of a shard's pixels off the rounding bound
  (tests/test_torch_sliced.py: the JAX sliced loop rebuilds the previous
  vertex); the direct tracer 1e-5 relative on all but 3 pixels, 1e-2
  (tests/test_torch_restir.py); the G-buffer (the JAX call eager, as in
  that file) ids and motion equal, the rest within 1e-5.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_port_util import (SCENES, camera_from_jax, jax_scene_parts,  # noqa: E402
                             load_jax_scene, t2n)

RES, DEPTH = 16, 3


def _shards(n_tile, res=RES):
    """The global pixel indices of each tile of an ``n_tile`` mesh over a
    res x res frame (the last tile's pad lanes clamped)."""
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.scene.camera import Camera

    mesh = sh.make_mesh(n_tile, devices=[torch.device("cpu")] * n_tile)
    return sh.tile_pixels(mesh, Camera(width=res, height=res))


def _off(got, want):
    """Pixels off the rounding bound (rtol 1e-5, atol 1e-6) in a channel."""
    return (np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)).any(axis=-1)


@pytest.fixture(scope="module")
def cornell():
    """The reference's cornell build (brute-force engine) at RES x RES and
    the port's scene on the same bytes, on the same engine."""
    from radish_pt_tpu.scene.build import load_scene
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    jds, jcam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"))
    assert jds.intersector == "brute"
    jcam = jcam.replace(width=RES, height=RES)
    return jds, jcam, scene_from_jax(*jax_scene_parts(jds)), camera_from_jax(jcam)


@pytest.fixture(scope="module")
def teapot():
    """The reference's teapot (43 clusters) on the brute engine, both
    sides: the sliced loop runs on a scene with clusters."""
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    mp = pytest.MonkeyPatch()
    try:
        jds, jcam, _ = load_jax_scene(mp, "teapot.txt")
    finally:
        mp.undo()
    jcam = jcam.replace(width=RES, height=RES)
    ds = scene_from_jax(*jax_scene_parts(jds)).replace(intersector="brute")
    return jds.replace(intersector="brute"), jcam, ds, camera_from_jax(jcam)


def test_dense_loop_shards_match(cornell):
    """Three tiles (86 lanes each, the last with two pad lanes) of cornell
    (no clusters: the dense loop), loopers 0-1: each tile equals the
    port's full frame at its pixels and the JAX package's
    ``path_trace(pixel_idx=tile)``."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, jcam, ds, cam = cornell
    f = jax.jit(jpt.path_trace, static_argnames=("max_depth",))
    for looper in (0, 1):
        full = torch.cat(pt.path_trace(ds, cam, looper, DEPTH), dim=1)
        for idx in _shards(3):
            stats = {}
            got = torch.cat(pt.path_trace(ds, cam, looper, DEPTH, idx, stats=stats), dim=1)
            assert stats["loop"] == "dense"
            assert torch.equal(got, full[idx.long()])
            want = np.concatenate([np.asarray(a) for a in
                                   f(jds, jcam, looper, DEPTH, jnp.asarray(t2n(idx)))], 1)
            assert _off(t2n(got), want).sum() <= 1
            np.testing.assert_allclose(t2n(got), want, rtol=0, atol=1e-3)
        assert full[:, 3:].mean() > 1e-3


def test_sliced_loop_shards_match(teapot):
    """Two tiles of teapot (the sliced loop at 4 slices, slicing each
    tile's 128 lanes): each tile equals the port's dense loop on it and the
    port's full frame at its pixels bit for bit, and the JAX package's
    sliced ``path_trace(pixel_idx=tile)`` within the sliced parity bound."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, jcam, ds, cam = teapot
    f = jax.jit(jpt.path_trace, static_argnames=("max_depth",))
    full = torch.cat(pt.path_trace(ds, cam, 0, DEPTH), dim=1)
    for idx in _shards(2):
        stats = {}
        got = torch.cat(pt.path_trace(ds, cam, 0, DEPTH, idx, stats=stats), dim=1)
        assert stats["loop"] == "sliced" and stats["slice"] == 128
        dense = torch.cat(pt.path_trace(ds, cam, 0, DEPTH, idx, n_slices=0), dim=1)
        assert torch.equal(got, dense) and torch.equal(got, full[idx.long()])
        want = np.concatenate([np.asarray(a) for a in
                               f(jds, jcam, 0, DEPTH, jnp.asarray(t2n(idx)))], 1)
        off = _off(t2n(got), want)
        print(f"teapot tile of {idx.numel()}: {int(off.sum())} pixels off the rounding bound")
        assert off.sum() <= 0.02 * off.size
        np.testing.assert_allclose(t2n(got), want, rtol=0, atol=1e-3)
    assert full[:, 3:].mean() > 1e-3


def test_direct_tracer_shards_match(cornell):
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, jcam, ds, cam = cornell
    f = jax.jit(jpt.path_trace_direct)
    full = pt.path_trace_direct(ds, cam, 2)
    for idx in _shards(2):
        got = pt.path_trace_direct(ds, cam, 2, idx)
        assert torch.equal(got, full[idx.long()])
        want = np.asarray(f(jds, jcam, 2, jnp.asarray(t2n(idx))))
        assert _off(t2n(got), want).sum() <= 3
        np.testing.assert_allclose(t2n(got), want, rtol=0, atol=1e-2)
    assert full.mean() > 0.05


def test_gbuffer_shards_match(cornell):
    """A tile's G-buffer at 32x32: the full frame's rows (motion a global
    index into the last frame, through a moved camera) and the JAX
    package's ``render_gbuffer(pixel_idx=tile)``, run eagerly as the
    full-frame parity test runs it (under jit, XLA's fusion settles one
    edge pixel of this frame, 961, on the other triangle)."""
    from radish_pt_tpu.render import gbuffer as jgb
    from radish_pt_tpu.scene import camera as jcm
    from radish_pt_tpu_torch.render import gbuffer as gb

    jds, jcam, ds, _ = cornell
    jcam = jcam.replace(width=32, height=32)
    cam = camera_from_jax(jcam)
    jlast = jcm.update_camera(jcam.replace(
        position=jcam.position + jnp.array([0.3, 0.0, 0.0], jnp.float32)))
    last = camera_from_jax(jlast)
    full = gb.render_gbuffer(ds, cam, last)
    for idx in _shards(3, 32):
        got = gb.render_gbuffer(ds, cam, last, pixel_idx=idx)
        rows = idx.long()
        for a, b in ((got.frame.normal, full.frame.normal), (got.frame.prim_id,
                     full.frame.prim_id), (got.frame.depth, full.frame.depth),
                     (got.albedo, full.albedo), (got.motion, full.motion)):
            assert torch.equal(a, b[rows])
        want = jgb.render_gbuffer(jds, jcam, jlast, pixel_idx=jnp.asarray(t2n(idx)))
        np.testing.assert_array_equal(t2n(got.frame.prim_id), np.asarray(want.frame.prim_id))
        np.testing.assert_array_equal(t2n(got.motion), np.asarray(want.motion))
        for a, b in ((got.frame.normal, want.frame.normal),
                     (got.frame.depth, want.frame.depth), (got.albedo, want.albedo)):
            np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert (t2n(full.motion) != np.arange(32 * 32)).mean() > 0.1
