"""Port parity for the dense engine (accel/dense.py, csrc/dense.cu): the
plain versions against the reference's dense Pallas kernel
(``intersect_brute_pallas`` / ``occlusion_brute_pallas``) run in interpret
mode on the CPU, on a triangle soup and on hand-made edge cases; the
engine's routing; and the scene bridge's mapping of ``pallas_brute``.

Tolerances: prim ids and shadow bits equal; dist within 5e-5 relative and
barycentrics within 1e-5 absolute.  Both sides evaluate the same
Möller–Trumbore operations, but the reference's run under jit, where XLA
contracts products and sums into FMAs: measured on four soups, up to
1.6e-5 relative on dist (cancellation in e2·q) and 4.5e-6 on bary.  The
port's plain version and its kernel round every operation on their own
and agree bit for bit (chip_smoke.py checks that on the card)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
from torch_port_util import (SCENES, camera_from_jax, jax_scene_parts,  # noqa: E402
                             load_jax_scene, t2n)

FLT_MAX = 3.402823466e38


def _soup(seed=3, n_tris=40, n_rays=300):
    """A random triangle soup with rays aimed at triangle centroids (and a
    few aimed anywhere), as tests/test_pallas.py builds its own."""
    rng = np.random.default_rng(seed)
    soup = rng.uniform(-4, 4, (n_tris, 3, 3)).astype(np.float32)
    tri_packed = np.concatenate([soup[:, 0], soup[:, 1] - soup[:, 0],
                                 soup[:, 2] - soup[:, 0]], axis=1).astype(np.float32)
    ray_o = rng.uniform(-6, 6, (n_rays, 3)).astype(np.float32)
    target = soup.mean(axis=1)[rng.integers(0, n_tris, n_rays)]
    target[::7] = rng.uniform(-6, 6, (len(target[::7]), 3))
    ray_d = target - ray_o
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    return tri_packed, ray_o, ray_d.astype(np.float32)


def _edge_cases():
    """Hand-made triangles and rays: two triangles sharing the edge x = 0
    (ids 1 and 2) and a vertex, a degenerate sliver whose det is below
    1.19e-7 (id 3), zero padding triangles (ids 0, 4), and a far triangle
    behind the shared pair (id 5)."""
    tris = np.zeros((6, 3, 3), np.float32)
    tris[1] = [[0, -1, 0], [0, 1, 0], [-1, 0, 0]]  # left of x = 0
    tris[2] = [[0, -1, 0], [1, 0, 0], [0, 1, 0]]  # right of x = 0
    tris[3] = [[-2, -2, 1], [2, -2, 1], [2, -2 + 1e-8, 1]]  # det ~ 0
    tris[5] = [[-3, -3, 2], [3, -3, 2], [0, 3, 2]]
    tp = np.concatenate([tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]],
                        axis=1).astype(np.float32)
    o = np.array([[0, 0, -1],  # through the shared edge: both hit, id 1 wins
                  [0, 1, -1],  # through the shared vertex (0, 1, 0)
                  [0, -1, -1],  # through the shared vertex (0, -1, 0)
                  [0.5, 0, -1],  # inside triangle 2 only
                  [1.5, -1.5, -1],  # past the pair: the far triangle
                  [1.9, -2, -1],  # along the sliver: below the det threshold
                  [5, 5, -1]], np.float32)  # misses everything
    d = np.tile(np.array([[0, 0, 1]], np.float32), (len(o), 1))
    return tp, o, d


def _ref_closest(tp, o, d):
    from radish_pt_tpu.accel.pallas_kernels import intersect_brute_pallas

    p, t, b = intersect_brute_pallas(jnp.asarray(tp), jnp.asarray(o), jnp.asarray(d),
                                     interpret=True)
    return np.asarray(p), np.asarray(t), np.asarray(b)


def _check_closest(got, want):
    (pg, tg, bg), (pw, tw, bw) = [tuple(np.asarray(x) for x in r) for r in (got, want)]
    np.testing.assert_array_equal(pg, pw)
    np.testing.assert_allclose(tg, tw, rtol=5e-5, atol=0)
    np.testing.assert_allclose(bg, bw, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["soup", "edges"])
def test_plain_closest_hit_matches_pallas(case):
    from radish_pt_tpu_torch.accel import dense as dns

    tp, o, d = _soup() if case == "soup" else _edge_cases()
    want = _ref_closest(tp, o, d)
    tally = Tally()
    got = dns.closest_hit_plain(*(torch.from_numpy(a) for a in (tp, o, d)))
    assert tally("plain.dense") == {"closest_hit": 1}
    assert tally("launch.dense") == {}
    _check_closest(tuple(t2n(x) for x in got), want)
    if case == "soup":
        assert 0.3 < (want[0] >= 0).mean() < 1.0
    else:
        # edge: ties to the lower id; vertices inclusive; the sliver and the
        # padding never hit (the ray along the sliver reaches the far
        # triangle); a miss is (-1, FLT_MAX, (0, 0))
        np.testing.assert_array_equal(want[0], [1, 1, 1, 2, 5, 5, -1])
        assert want[1][-1] == np.float32(FLT_MAX) and not want[2][-1].any()


@pytest.mark.parametrize("case", ["soup", "edges"])
def test_plain_occlusion_matches_pallas(case):
    from radish_pt_tpu.accel.pallas_kernels import occlusion_brute_pallas
    from radish_pt_tpu_torch.accel import dense as dns

    tp, o, d = _soup(seed=5) if case == "soup" else _edge_cases()
    rng = np.random.default_rng(11)
    # segments from the ray origins to points at random distances along
    # them (some short of the first hit); the last is zero-length
    y = o + d * rng.uniform(0.2, 12, (len(o), 1)).astype(np.float32)
    y[-1] = o[-1]
    want = np.asarray(occlusion_brute_pallas(jnp.asarray(tp), jnp.asarray(o),
                                             jnp.asarray(y), interpret=True))
    got = t2n(dns.occlusion_dense(*(torch.from_numpy(a) for a in (tp, o, y))))
    np.testing.assert_array_equal(got, want)
    assert not got[-1]  # zero-length: zero direction, never blocked
    if case == "soup":
        assert 0.1 < want.mean() < 0.9


def test_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take only CUDA tensors (the CPU goes through the
    plain versions, by the dispatchers)."""
    from radish_pt_tpu_torch.accel import dense as dns

    tp, o, d = (torch.from_numpy(a) for a in _edge_cases())
    with pytest.raises(ValueError, match="CUDA"):
        dns.closest_hit_cuda(tp, o, d)
    with pytest.raises(ValueError, match="CUDA"):
        dns.occlusion_cuda(tp, o, d, torch.ones(len(o)))


@pytest.fixture(scope="module")
def cornell_dense():
    """The reference's cornell built for ``pallas_brute``, carried across
    by the scene bridge with its own engine choice."""
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    mp = pytest.MonkeyPatch()
    try:
        jds, jcam, _ = load_jax_scene(mp, "cornell_box.txt", engine="pallas_brute")
    finally:
        mp.undo()
    return jds, jcam, scene_from_jax(*jax_scene_parts(jds))


def test_scene_bridge_maps_pallas_brute_to_dense(cornell_dense):
    jds, _, ds = cornell_dense
    assert jds.intersector == "pallas_brute"
    assert ds.intersector == "dense"


def test_build_offers_dense_by_name_only():
    from radish_pt_tpu_torch.scene import engines
    from radish_pt_tpu_torch.scene.build import choose_intersector

    assert "dense" in engines.NAMES and engines.get("dense").plain_twin == "brute"
    assert choose_intersector(36) == "plucker"
    assert choose_intersector(36, "dense") == "dense"


def test_engine_routes_through_dense_module(cornell_dense):
    """``intersect`` and ``test_occlusion`` on the dense engine go through
    accel/dense.py (counted) and give the brute engine's interactions."""
    from radish_pt_tpu_torch.scene import device_scene as dsc
    from radish_pt_tpu_torch.scene.camera import pinhole_rays

    _, jcam, ds = cornell_dense
    cam = camera_from_jax(jcam, 16, 16)
    idx = torch.arange(256, dtype=torch.int32)
    o, d = pinhole_rays(cam, idx % 16, idx // 16)
    tally = Tally()
    a = dsc.intersect(ds, o, d)
    b = dsc.intersect(ds.replace(intersector="brute"), o, d)
    for name in ("prim_id", "mat_id", "pos", "norm", "uv"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    y = o + d * 3.0
    assert torch.equal(dsc.test_occlusion(ds, o, y),
                       dsc.test_occlusion(ds.replace(intersector="brute"), o, y))
    assert tally("plain.dense") == {"closest_hit": 1, "occlusion": 1}


def test_path_trace_dense_equals_brute(cornell_dense):
    """The dense engine's frame is the brute engine's, bit for bit (same
    arithmetic, same raster-order lanes)."""
    from radish_pt_tpu_torch.render import pathtrace as pt

    _, jcam, ds = cornell_dense
    cam = camera_from_jax(jcam, 16, 16)
    d1, i1 = pt.path_trace(ds, cam, 1, 3)
    d2, i2 = pt.path_trace(ds.replace(intersector="brute"), cam, 1, 3)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    assert float((d1 + i1).mean()) > 0.05


def test_cli_and_profiler_offer_dense(tmp_path):
    from radish_pt_tpu_torch.cli import build_arg_parser, main

    args = build_arg_parser().parse_args(["x.txt", "--intersector", "dense"])
    assert args.intersector == "dense"
    out = tmp_path / "d.png"
    assert main([os.path.join(SCENES, "cornell_box.txt"), "--spp", "1", "--res", "8",
                 "8", "--depth", "2", "--device", "cpu", "--intersector", "dense",
                 "--out", str(out)]) == 0
    assert out.exists()
