"""Every shipped scene through the port: each of ``scenes/*.txt`` loads on
the CPU, many_light and textured render frames held against the JAX
package's on the same scene bytes, the port's ``Renderer`` holds the JAX
package's goldens of glass, textured and teapot_hires (tests/golden/, in
the JAX tests' configurations and at their 2e-2 mean-abs bound), and the
CLI renders the env-map scene."""

import functools
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
from torch_port_util import (SCENES, camera_from_jax, jax_scene_parts,  # noqa: E402
                             load_jax_scene, t2n)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SHIPPED = sorted(os.path.basename(p) for p in glob.glob(os.path.join(SCENES, "*.txt")))


@functools.lru_cache(maxsize=None)
def _port_scene(fname):
    from radish_pt_tpu_torch.scene.build import load_scene

    return load_scene(os.path.join(SCENES, fname), device="cpu")


def test_seven_scenes_are_shipped():
    assert SHIPPED == ["cornell_box.txt", "env_teapot.txt", "glass.txt", "many_light.txt",
                       "teapot.txt", "teapot_hires.txt", "textured.txt"]


@pytest.mark.parametrize("fname", SHIPPED)
def test_every_shipped_scene_loads(fname):
    """The port's own build of each shipped scene on the CPU: the engine
    its size picks, finite geometry, a light (an area light or the env
    map), and the env map and aperture mask the scene file names."""
    ds, cam, desc = _port_scene(fname)
    assert ds.intersector == "plucker" and ds.has_lights
    assert bool(torch.isfinite(ds.tri_attr).all())
    assert ds.has_env == (fname == "env_teapot.txt")
    assert ds.has_aperture == (fname == "glass.txt")
    assert (ds.cluster_bounds is None) == (ds.num_triangles <= 1024)
    assert (cam.width, cam.height) == (desc.width, desc.height)


@pytest.fixture(scope="module", params=["many_light", "textured"])
def small_scene(request):
    """(name, JAX scene on its numpy host path, JAX camera, the port's
    scene carried across) for the two scenes without clusters."""
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    mp = pytest.MonkeyPatch()
    try:
        jds, jcam, _ = load_jax_scene(mp, f"{request.param}.txt")
    finally:
        mp.undo()
    assert jds.cluster_bounds is None
    return request.param, jds, jcam, scene_from_jax(*jax_scene_parts(jds))


def test_path_trace_matches_reference(small_scene):
    """16x16, depth 3, loopers 0-1, against the JAX package's brute-force
    frames on the same scene bytes: many_light's 72 emitters and its alias
    table, and textured's image, procedural, metallic, roughness and normal
    maps.
    * The port's brute-force engine (the same Möller–Trumbore winners):
      every pixel within 1e-3 and the mean absolute difference below 1e-5
      (a grazing shadow ray may turn on the last ulp: measured at most
      7.0e-4 on a pixel, means 3.2e-7 to 2.4e-6).
    * The port's main-path engine, the Plücker sweep (its plain version on
      CPU tensors, every triangle swept: no clusters below 1,024
      triangles): at most 2 of 256 pixels beyond 1e-3 and the mean below
      5e-3.  Where a ray meets the shared edge of two triangles exactly,
      the Plücker planes and Möller–Trumbore may pick different ones
      (measured: textured's cube, looper 0, one pixel 0.34 off, mean
      1.3e-3)."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt

    name, jds, jcam, ds = small_scene
    res, depth = 16, 3
    jcam = jcam.replace(width=res, height=res)
    cam = camera_from_jax(jcam)
    f = jax.jit(jpt.path_trace, static_argnames=("max_depth",))
    tally = Tally()
    for looper in (0, 1):
        jd, ji = (np.asarray(a) for a in f(jds.replace(intersector="brute"), jcam, looper,
                                           depth))
        want = jd + ji
        assert want.mean() > 1e-2 and ji.mean() > 1e-3
        d, i = pt.path_trace(ds.replace(intersector="brute"), cam, looper, depth)
        got = t2n(d + i)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=name)
        assert np.abs(got - want).mean() < 1e-5, name
        d, i = pt.path_trace(ds, cam, looper, depth)
        got = t2n(d + i)
        assert np.isfinite(got).all()
        assert (np.abs(got - want) > 1e-3).any(axis=-1).sum() <= 2, name
        assert np.abs(got - want).mean() < 5e-3, name
    assert tally("plain.plucker") == {"closest_hit": 2 * (depth + 1), "occlusion": 2 * depth}
    assert tally("prepass.plucker") == {}


@pytest.mark.parametrize("fname,golden,depth,spp,res", [
    ("glass.txt", "glass_32", 6, 3, 32),  # tests/test_golden.py::test_golden_glass
    ("textured.txt", "textured_32", 3, 2, 32),  # tests/test_textures.py
    ("teapot_hires.txt", "teapot_hires_48", 2, 1, 48),  # test_golden_teapot_hires
])
def test_renderer_matches_golden(fname, golden, depth, spp, res):
    """The port's own scene build and Renderer against the JAX package's
    golden image, in the JAX test's configuration (full MIS, its depth,
    spp and resolution) and at its bound: mean absolute error < 2e-2."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer

    ds, cam, _ = _port_scene(fname)
    r = Renderer(ds=ds, cam=cam.replace(width=res, height=res), desc=None,
                 settings=Settings(tracer=Tracer.STREAMED, trace_depth=depth),
                 device="cpu")
    img = r.render(spp=spp)
    want = np.load(os.path.join(GOLDEN, f"{golden}.npy"))
    assert np.isfinite(img).all() and img.shape == want.shape
    assert img.mean() > 0.05
    assert np.abs(img - want).mean() < 2e-2


def test_cli_renders_env_map_scene(tmp_path, capsys):
    """The CLI loads the env-map scene, says so in its summary, as the JAX
    package's CLI does, and writes a PNG."""
    from radish_pt_tpu_torch.cli import main

    out = tmp_path / "e.png"
    assert main([os.path.join(SCENES, "env_teapot.txt"), "--spp", "1", "--res", "16",
                 "16", "--depth", "2", "--device", "cpu", "--out", str(out)]) == 0
    assert "0 area lights, env map, 16x16" in capsys.readouterr().out
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
