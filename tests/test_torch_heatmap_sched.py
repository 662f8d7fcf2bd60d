"""The heatmap kernel's schedule (csrc/bvh.cu::bvh_heatmap_kernel), on the
CPU through its plain model ``accel/traverse.py::heatmap_warp_model``: a
warp of 32 lanes visits, a step at a time, the least node row any of its
lanes is at, and only the lanes at that row take it.

Held here: every miss link of the threaded tables is larger than its node,
in all six direction classes of teapot and of two random soups (so a ray
visits its rows in increasing order and a warp walks its rows in one pass);
the model's counts equal the plain heatmap walk's and the JAX package's
``intersect_bvh_heatmap`` on every lane, and each lane's node visits equal
the plain walk's (it visits exactly its own sequence), on teapot's 48x48
primaries, its bounce-1 extension rays, those rays with the six classes
interleaved lane by lane (as ``chip_smoke.interleave_classes``), and the
soups' rays (every third axis-aligned, signed zeros included); a warp's steps are at least its
longest lane's visits and at most their sum.  The counts are integers:
equal, no tolerance."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_bvh import REPO, _rays, teapot  # noqa: E402,F401
from test_torch_bvh_sched import _soup  # noqa: E402
from torch_port_util import t2n  # noqa: E402


@pytest.fixture(scope="module", params=["teapot", "soup0", "soup1"])
def tables(request):
    """(port node table, JAX tables, leaf triangles, rays): teapot's with
    its 48x48 wavefronts, or a soup's with its rays."""
    if request.param.startswith("soup"):
        (lt, _, bp), jtables, _, o, d = _soup(int(request.param[-1]), n_rays=640)
        return request.param, bp, jtables, lt, {"soup": (o, d)}
    jds, _, ds, _, waves = request.getfixturevalue("teapot")
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    o, d, _ = _rays(request.getfixturevalue("teapot"), "primary")
    eo, ed, live = _rays(request.getfixturevalue("teapot"), "extension")
    idx = chip_smoke.interleave_classes(ed, live)
    # (o, d[, the wavefront and its lanes whose JAX counts these lanes' are])
    rays = {"primary": (o, d), "extension": (eo, ed),
            "interleaved": (eo[idx].contiguous(), ed[idx].contiguous(), "extension", idx)}
    return "teapot", ds.bvh_packed, (jds.leaf_tris, jds.leaf_map, jds.bvh_packed), \
        ds.leaf_tris, rays


def test_miss_links_pass_their_node(tables):
    """In each of the six classes, every node's miss link is larger than
    the node (B, one past the last node, ends the walk)."""
    _, bp, _, _, _ = tables
    size = bp.shape[0] // 6
    miss = bp.view(torch.int32)[:, 7].view(6, size).long()
    node = torch.arange(size)[None, :]
    assert bool((miss > node).all())
    assert bool((miss <= size).all()) and bool((miss == size).any(1).all())


def test_warp_model_matches_plain_and_jax(tables):
    """The model's counts equal the plain walk's and the JAX walk's on
    every lane of every wavefront, each lane visits the plain walk's nodes,
    and each warp's steps lie between its longest lane's visits and their
    sum (the interleaved wavefront mixes classes in every warp: more steps
    than its longest lane's)."""
    from radish_pt_tpu.accel import traverse as jtrv
    from radish_pt_tpu_torch.accel import traverse as trv

    name, bp, (jlt, jlm, jbp), lt, rays = tables
    jax_counts = {}
    for what, (o, d, *of) in rays.items():
        st, ms = {}, {}
        want = trv.intersect_bvh_heatmap_plain(lt, bp, o, d, stats=st)
        got, warp_steps = trv.heatmap_warp_model(lt, bp, o, d, stats=ms)
        if of:  # lanes of a wavefront the JAX walk has counted
            jw = jax_counts[of[0]][t2n(torch.arange(len(jax_counts[of[0]]))[of[1]])]
        else:
            jw = jax_counts[what] = np.asarray(jtrv.intersect_bvh_heatmap(
                jlt, jlm, jbp, jnp.asarray(t2n(o)), jnp.asarray(t2n(d))))
        assert got.dtype == torch.int32 and torch.equal(got, want), (name, what)
        np.testing.assert_array_equal(t2n(got), jw, err_msg=f"{name} {what}")
        assert torch.equal(ms["visits"], st["visits"]), (name, what)
        n = o.shape[0]
        pad = torch.zeros((-n) % trv.WARP, dtype=torch.int64)
        visits = torch.cat([st["visits"], pad]).view(-1, trv.WARP)
        assert warp_steps.shape == (-(-n // trv.WARP),)
        assert bool((warp_steps >= visits.max(1).values).all()), (name, what)
        assert bool((warp_steps <= visits.sum(1)).all()), (name, what)
        assert bool((ms["leaf_steps"] <= warp_steps).all())
        if what == "interleaved":
            assert bool((warp_steps > visits.max(1).values).all())
        assert int(got.min()) >= 0 and int(got.max()) > 0


def test_warp_model_empty_and_one_lane():
    """No lane: no count and no warp; one lane: its warp's steps are its
    own visits."""
    from radish_pt_tpu_torch.accel import traverse as trv

    (lt, _, bp), _, _, o, d = _soup(0, n_tris=40, n_rays=1)
    got, steps = trv.heatmap_warp_model(lt, bp, o[:0], d[:0])
    assert got.shape == (0,) and steps.shape == (0,)
    st = {}
    want = trv.intersect_bvh_heatmap_plain(lt, bp, o, d, stats=st)
    got, steps = trv.heatmap_warp_model(lt, bp, o, d)
    assert torch.equal(got, want) and steps.tolist() == st["visits"].tolist()


if __name__ == "__main__":
    sys.exit(pytest.main([os.path.abspath(__file__), "-q"]))
