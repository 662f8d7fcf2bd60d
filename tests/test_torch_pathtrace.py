"""Port parity for the whole slice: path_trace against the reference's on
the same scene bytes, the Renderer against the reference's golden image,
and the port's independence from jax."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
from torch_port_util import SCENES, jax_scene_parts, t2n  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RES, DEPTH, LOOPERS = 16, 3, (0, 1)


@pytest.fixture(scope="module")
def cornell_frames():
    """The reference's cornell frames (its CPU build: brute-force engine)
    at 16x16, depth 3, loopers 0-1, and its scene carried across."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu.scene.build import load_scene

    jds, jcam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"))
    assert jds.intersector == "brute"
    jcam = jcam.replace(width=RES, height=RES)
    f = jax.jit(jpt.path_trace, static_argnames=("max_depth",))
    frames = [tuple(np.asarray(x) for x in f(jds, jcam, lp, DEPTH))
              for lp in LOOPERS]
    return jds, jcam, frames


def _port(jds, jcam, intersector):
    from radish_pt_tpu_torch.scene.camera import make_camera
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    ds = scene_from_jax(*jax_scene_parts(jds), intersector=intersector)
    cam = make_camera(RES, RES, np.asarray(jcam.position),
                      np.asarray(jcam.rotation), fov_y=float(jcam.fov_y),
                      lens_radius=float(jcam.lens_radius),
                      focal_dist=float(jcam.focal_dist), device="cpu")
    return ds, cam


def test_path_trace_brute_matches_reference(cornell_frames):
    """Same engine (exhaustive MT), same bytes, bit-exact sampler: the
    frames agree to float rounding (rtol 1e-5, atol 1e-6) on every pixel
    but at most one per frame.  That one is a discrete decision the last
    ulp settles: at looper 1, pixel 220 takes a light sample at
    cos = 2.8e-4 to the floor, whose shadow ray grazes the floor it
    leaves; the reference's fused (jit) arithmetic and the port's eager
    ops decide it differently.  Such a pixel carries that cosine as its
    weight, so it is held to 1e-3."""
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, jcam, frames = cornell_frames
    ds, cam = _port(jds, jcam, "brute")
    for lp, (jd, ji) in zip(LOOPERS, frames):
        d, i = pt.path_trace(ds, cam, lp, DEPTH)
        for got, want in ((t2n(d), jd), (t2n(i), ji)):
            off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
            assert off.any(axis=-1).sum() <= 1
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        assert ji.mean() > 1e-3


def test_path_trace_plucker_matches_reference(cornell_frames):
    """The port's main-path engine (the plain Plücker sweeps on CPU
    tensors) against the reference's brute-force frames: edge-exact ties
    may resolve differently, so the bound is on the mean."""
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, jcam, frames = cornell_frames
    ds, cam = _port(jds, jcam, "plucker")
    tally = Tally()
    for lp, (jd, ji) in zip(LOOPERS, frames):
        d, i = pt.path_trace(ds, cam, lp, DEPTH)
        err = np.abs(t2n(d + i) - (jd + ji)).mean()
        assert err < 1e-3, err
    assert tally("plain.plucker")["closest_hit"] == 2 * (DEPTH + 1)
    assert tally("plain.plucker")["occlusion"] == 2 * DEPTH
    # cornell has no clusters: every triangle is swept, no culling prepass
    assert tally("prepass.plucker") == {}


def test_renderer_matches_golden():
    """The port's own scene build and Renderer against the reference's
    golden (tests/test_golden.py: cornell 32x32, depth 4, 3 spp)."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cpu")
    r = Renderer(ds=ds, cam=cam.replace(width=32, height=32), desc=None,
                 settings=Settings(tracer=Tracer.STREAMED, trace_depth=4),
                 device="cpu")
    img = r.render(spp=3)
    golden = np.load(os.path.join(GOLDEN, "cornell_pt_32.npy"))
    assert np.isfinite(img).all() and img.shape == golden.shape
    assert np.abs(img - golden).mean() < 2e-2


def test_renderer_refuses_unported_modes():
    """Nothing is refused any more: every tracer of the reference's enum
    runs a frame through the port's ``Renderer`` (the BVH heatmap, the last
    refused, included), and the aperture-mask scene (glass), refused until
    env maps and aperture masks were ported, loads and renders."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cpu")
    cam = cam.replace(width=16, height=16)
    for tracer in (v for k, v in vars(Tracer).items() if k.isupper()):
        r = Renderer(ds=ds, cam=cam, settings=Settings(tracer=tracer, trace_depth=2),
                     device="cpu")
        disp = r.step()
        img = t2n(r.current_image())
        assert disp.shape == (16, 16, 3) and np.isfinite(img).all(), tracer
        assert img.max() > 0.0, tracer
    ds, cam, _ = load_scene(os.path.join(SCENES, "glass.txt"), device="cpu")
    assert ds.has_aperture and not ds.has_env
    img = Renderer(ds=ds, cam=cam.replace(width=16, height=16),
                   settings=Settings(tracer=Tracer.STREAMED, trace_depth=2),
                   device="cpu").render(spp=1)
    assert np.isfinite(img).all() and img.mean() > 0.05


def test_cli_renders_on_cpu(tmp_path):
    from radish_pt_tpu_torch.cli import main

    out = tmp_path / "c.png"
    assert main([os.path.join(SCENES, "cornell_box.txt"), "--spp", "1",
                 "--res", "16", "16", "--depth", "2", "--device", "cpu",
                 "--out", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, radish_pt_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'radish_pt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'radish_pt_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
