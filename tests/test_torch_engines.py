"""The engine table (``radish_pt_tpu_torch/scene/engines.py``): every name
the front ends and the scenes use resolves in it, its sets are the ones
the renderer and the build choose by, and an eager CPU block counts its
engine's plain calls in the counter registry (utils/timing.py)."""

import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from radish_pt_tpu_torch.scene import engines  # noqa: E402
from torch_port_util import SCENES  # noqa: E402

PLAIN_TWINS = ("plucker_plain", "compact_plain", "quad_plain", "band_plain", "bvh_plain")


def test_every_name_resolves():
    """The command lines' names and every plain twin's name resolve; a
    plain twin is its engine in plain torch, and nothing else does."""
    from radish_pt_tpu_torch.cli import build_arg_parser

    choices = next(a.choices for a in build_arg_parser()._actions if a.dest == "intersector")
    assert tuple(choices) == engines.NAMES
    assert engines.NAMES == ("plucker", "compact", "quad", "band", "dense", "bvh", "brute")
    for name in engines.NAMES + PLAIN_TWINS:
        eng = engines.get(name)
        assert eng.name == name and eng.plain == (name in PLAIN_TWINS)
        assert engines.get(eng.plain_twin).plain_twin == eng.plain_twin
    assert set(engines.ENGINES) == set(engines.NAMES + PLAIN_TWINS)
    assert engines.get("dense").plain_twin == "brute"
    assert engines.of(SimpleNamespace(intersector="band_plain")).group == "band"
    for name in ("pallas_mxu", "dense_plain", "brute_plain"):
        with pytest.raises(ValueError, match="unknown intersector"):
            engines.get(name)


def test_capturable_engines():
    assert {n for n, e in engines.ENGINES.items() if e.capturable} == {
        "plucker", "band", "quad", "dense", "bvh"}


def test_tile_order_engines():
    """The sweep engines and their plain twins take a full frame in tile
    order (render/pathtrace.py::_lanes); the others in raster order."""
    from radish_pt_tpu_torch.render import pathtrace as pt

    sweep = {"plucker", "compact", "quad", "band"}
    assert {n for n, e in engines.ENGINES.items() if e.sweep} == sweep | {
        f"{n}_plain" for n in sweep}
    cam = SimpleNamespace(width=2 * pt.TILE_W, height=2 * pt.TILE_H)
    for name in engines.ENGINES:
        ds = SimpleNamespace(intersector=name, device=torch.device("cpu"))
        _, untile = pt._lanes(ds, cam)
        assert (untile is not None) == (name.removesuffix("_plain") in sweep)


def test_eager_block_counts_plain_calls():
    """An eager CPU ``run_block(2)`` on cornell (36 triangles: the Plücker
    engine without clusters) counts, a frame, depth + 1 closest hits,
    depth shadow tests and depth vertices of the plain versions, no sort
    key and no launch."""
    from radish_pt_tpu_torch.config import Settings
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene
    from radish_pt_tpu_torch.utils.timing import Tally

    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cpu")
    cam = cam.replace(width=16, height=16)
    depth = 3
    r = Renderer(ds=ds, cam=cam, desc=None, settings=Settings(trace_depth=depth),
                 device="cpu")
    tally = Tally()
    run = r.run_block(2)
    assert ds.intersector == "plucker" and run.mode == "eager" and run.counts_per_replay == {}
    assert tally("plain.plucker") == {"closest_hit": 2 * (depth + 1), "occlusion": 2 * depth}
    assert tally("plain.vertex") == {"vertex": 2 * depth}
    assert tally("plain.sort_key") == {} and tally("prepass.plucker") == {}
    assert tally("launch") == {}
