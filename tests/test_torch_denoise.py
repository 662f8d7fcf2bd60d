"""Port parity for the denoisers (render/denoise.py) and the renderer's
denoised and preview paths: each filter and the SVGF state chain against
the JAX package on inputs made with numpy, within 1e-5 (both sides sum
the same taps in the same order; the exps and pows of the two libraries
may differ by an ulp); the port's Renderer against the reference's golden
images (tests/golden/, mean abs < 2e-2 as tests/test_golden.py holds the
reference) and against the JAX Renderer frame by frame."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_port_util import (SCENES, camera_from_jax, gbuffer_frame_arrays,  # noqa: E402
                             gbuffer_frame_pair, gbuffer_out_pair, jax_scene_parts,
                             svgf_state_pair, t2n)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
W, H = 16, 12  # not square: a swapped axis shows
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cams():
    """The reference's cornell camera at 16x12, on both sides."""
    from radish_pt_tpu.scene.build import load_scene

    _, jcam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"))
    jcam = jcam.replace(width=W, height=H)
    return jcam, camera_from_jax(jcam)


def _planar_inputs(seed=0):
    """Planar color, normal, prim id and position [C, H, W] as numpy."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(3, H, W)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    return (rng.uniform(0, 1, (3, H, W)).astype(np.float32), nrm,
            rng.integers(-1, 3, (H, W)).astype(np.int32),
            rng.uniform(-1, 1, (3, H, W)).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


def _frame_state(seed, n=W * H, encode_normal=False):
    """A G-buffer (frame, albedo, motion), its last frame and an SVGF
    history, as (JAX, torch) pairs made from the same numpy arrays."""
    rng = np.random.default_rng(seed)
    motion = rng.integers(-1, n, n).astype(np.int32)
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    gbuf = gbuffer_out_pair(gbuffer_frame_arrays(rng, n, encode_normal=encode_normal),
                            albedo, motion)
    last = gbuffer_frame_pair(gbuffer_frame_arrays(rng, n, encode_normal=encode_normal))
    moment = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    moment[:, 2] = rng.integers(0, 8, n)
    state = svgf_state_pair({"accum_color": rng.uniform(0, 1, (n, 3)).astype(np.float32),
                             "accum_moment": moment})
    color = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    return gbuf, last, state, color


def test_eaw_level_matches():
    from radish_pt_tpu.render import denoise as jdn
    from radish_pt_tpu_torch.render import denoise as dn

    args = _planar_inputs()
    want = jdn.eaw_level(*(jnp.asarray(a) for a in args), 2, 64.0, 0.2, 1.0)
    got = dn.eaw_level(*(torch.from_numpy(a) for a in args), 2, 64.0, 0.2, 1.0)
    _close(got, want)


def test_svgf_wavelet_level_matches():
    from radish_pt_tpu.render import denoise as jdn
    from radish_pt_tpu_torch.render import denoise as dn

    color, nrm, prim, pos = _planar_inputs(1)
    rng = np.random.default_rng(2)
    var = rng.uniform(0, 0.5, (H, W)).astype(np.float32)
    var_f = rng.uniform(0, 0.5, (H, W)).astype(np.float32)
    args = (color, var, var_f, nrm, prim, pos)
    jc, jv = jdn.svgf_wavelet_level(*(jnp.asarray(a) for a in args), 4, 4.0, 128.0, 1.0)
    tc, tv = dn.svgf_wavelet_level(*(torch.from_numpy(a) for a in args), 4, 4.0, 128.0,
                                   1.0)
    _close(tc, jc)
    _close(tv, jv)


@pytest.mark.parametrize("fn", ["gaussian", "variance", "filter_variance"])
def test_image_filters_match(fn):
    from radish_pt_tpu.render import denoise as jdn
    from radish_pt_tpu_torch.render import denoise as dn

    rng = np.random.default_rng(3)
    if fn == "gaussian":
        x = rng.uniform(0, 1, (W * H, 3)).astype(np.float32)
    elif fn == "variance":
        x = rng.uniform(0, 1, (W * H, 3)).astype(np.float32)
        x[:, 2] = rng.integers(0, 8, W * H)  # history lengths on both sides of 3.5
    else:
        x = rng.uniform(0, 1, W * H).astype(np.float32)
    name = {"gaussian": "gaussian_filter", "variance": "estimate_variance",
            "filter_variance": "filter_variance"}[fn]
    _close(getattr(dn, name)(torch.from_numpy(x), W, H),
           getattr(jdn, name)(jnp.asarray(x), W, H))


def test_leveled_eaw_filter_matches(cams):
    from radish_pt_tpu.render import denoise as jdn
    from radish_pt_tpu_torch.render import denoise as dn

    jcam, cam = cams
    (jg, tg), _, _, color = _frame_state(4)
    want = jdn.leveled_eaw_filter(jnp.asarray(color), jg.frame, jcam)
    got = dn.leveled_eaw_filter(torch.from_numpy(color), tg.frame, cam)
    _close(got, want)


@pytest.mark.parametrize("first_time", [False, True])
def test_temporal_accumulate_matches(first_time):
    from radish_pt_tpu.render import denoise as jdn
    from radish_pt_tpu_torch.render import denoise as dn

    (jg, tg), (jl, tl), (js, ts), color = _frame_state(5)
    jc, jm = jdn.temporal_accumulate(jnp.asarray(color), js, jg, jl, first_time)
    tc, tm = dn.temporal_accumulate(torch.from_numpy(color), ts, tg, tl, first_time)
    _close(tc, jc)
    _close(tm, jm)


@pytest.mark.parametrize("encode_normal", [False, True])
def test_svgf_state_chain_matches(cams, encode_normal):
    """Three chained SVGF frames: each frame's output and the history it
    hands on (accum colour, moments) against the JAX package's."""
    from radish_pt_tpu.render import denoise as jdn
    from radish_pt_tpu_torch.render import denoise as dn

    jcam, cam = cams
    _, (jl, tl), (js, ts), _ = _frame_state(6, encode_normal=encode_normal)
    for k in range(3):
        (jg, tg), _, _, color = _frame_state(10 + k, encode_normal=encode_normal)
        jo, js = jdn.svgf_filter(jnp.asarray(color), js, jg, jl, jcam, k == 0)
        to, ts = dn.svgf_filter(torch.from_numpy(color), ts, tg, tl, cam, k == 0)
        _close(to, jo)
        _close(ts.accum_color, js.accum_color)
        _close(ts.accum_moment, js.accum_moment)
        jl, tl = jg.frame, tg.frame
    assert float(ts.accum_moment[:, 2].max()) >= 1.0  # some histories grew


def test_svgf_filter_pair_matches(cams):
    from radish_pt_tpu.render import denoise as jdn
    from radish_pt_tpu_torch.render import denoise as dn

    jcam, cam = cams
    (jg, tg), (jl, tl), (jsd, tsd), color_d = _frame_state(7)
    _, _, (jsi, tsi), color_i = _frame_state(8)
    want = jdn.svgf_filter_pair(jnp.asarray(color_d), jnp.asarray(color_i), jsd, jsi,
                                jg, jl, jcam, False)
    got = dn.svgf_filter_pair(torch.from_numpy(color_d), torch.from_numpy(color_i),
                              tsd, tsi, tg, tl, cam, False)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    for g, w in zip(got[2:], want[2:]):
        _close(g.accum_color, w.accum_color)
        _close(g.accum_moment, w.accum_moment)


def _plain_reference(name: str):
    """A module of the benchmark's plain reference (``benchmark/reference/``,
    which imports nothing of the port), loaded as the package
    ``bench_reference`` without putting the benchmark on the path."""
    import importlib
    import importlib.util
    import sys

    pkg = "bench_reference"
    if pkg not in sys.modules:
        init = os.path.join(os.path.dirname(__file__), "..", "benchmark", "reference",
                            "__init__.py")
        spec = importlib.util.spec_from_file_location(
            pkg, init, submodule_search_locations=[os.path.dirname(init)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[pkg] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{pkg}.{name}")


def test_svgf_chain_matches_the_benchmarks_plain_svgf():
    """Four chained SVGF calls of the port against the benchmark's frozen
    plain SVGF (``benchmark/reference/denoise.py``, written from
    denoiser.cu), each side on its own history, on seeded colours and the
    cornell G-buffers at 32x32: the first call (every pixel reset), a call
    with the camera still (the histories grow), a camera move that
    disoccludes part of the image, and a call after it.  Held to 1e-5: the
    same taps summed in the same order; the libraries' exp and pow may
    differ by an ulp."""
    import dataclasses

    from radish_pt_tpu_torch.render import denoise as dn
    from radish_pt_tpu_torch.render import gbuffer as gb
    from radish_pt_tpu_torch.scene.build import load_scene

    rdn, rcam = _plain_reference("denoise"), _plain_reference("camera")
    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cpu")
    cam0 = cam.replace(width=32, height=32)
    cam1 = cam0.replace(position=cam0.position + torch.tensor([0.8, 0.0, 0.0]))
    n = 32 * 32
    rng = np.random.default_rng(9)
    state = dn.empty_svgf_state(n, device="cpu")
    hist = rdn.empty_history(n, device="cpu")
    last, last_cam = gb.empty_frame(n, device="cpu"), cam0
    for k, c in enumerate((cam0, cam0, cam1, cam1)):
        gbuf = gb.render_gbuffer(ds, c, last_cam)
        color = torch.from_numpy(rng.uniform(0, 2, (n, 3)).astype(np.float32))
        out, state = dn.svgf_filter(color, state, gbuf, last, c, k == 0)
        plain_cam = rcam.Camera(**{f.name: getattr(c, f.name)
                                   for f in dataclasses.fields(rcam.Camera)})
        want, hist = rdn.svgf_filter(color, hist, gbuf, last, plain_cam, k == 0)
        np.testing.assert_allclose(t2n(out), t2n(want), **TOL)
        np.testing.assert_allclose(t2n(state.accum_color), t2n(hist.color), **TOL)
        np.testing.assert_allclose(t2n(state.accum_moment), t2n(hist.moment), **TOL)
        length = t2n(state.accum_moment[:, 2])
        if k == 0:
            assert (length == 0).all()
        if k == 2:  # the move resets some histories and keeps others
            assert (length == 0).mean() > 0.05 and (length == 2).mean() > 0.05
        last, last_cam = gbuf.frame, c


def _port_renderer(settings, res=32):
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cpu")
    return Renderer(ds=ds, cam=cam.replace(width=res, height=res), desc=None,
                    settings=settings, device="cpu")


def test_renderer_matches_restir_golden():
    """ReSTIR DI, temporal + spatial reuse, 3 spp (tests/test_golden.py's
    ``test_golden_cornell_restir``)."""
    from radish_pt_tpu_torch.config import Settings, Tracer

    img = _port_renderer(Settings(tracer=Tracer.RESTIR_DI)).render(spp=3)
    golden = np.load(os.path.join(GOLDEN, "cornell_restir_32.npy"))
    assert np.isfinite(img).all() and img.shape == golden.shape
    assert np.abs(img - golden).mean() < 2e-2


def test_renderer_matches_svgf_golden():
    """The direct tracer + SVGF, 3 frames (``test_golden_cornell_svgf``)."""
    from radish_pt_tpu_torch.config import Denoiser, Settings, Tracer

    r = _port_renderer(Settings(tracer=Tracer.DIRECT_LIGHT, denoiser=Denoiser.SVGF))
    for _ in range(3):
        r.step()
    img = t2n(r.current_image()).reshape(32, 32, 3)
    golden = np.load(os.path.join(GOLDEN, "cornell_svgf_32.npy"))
    assert np.isfinite(img).all() and np.abs(img - golden).mean() < 2e-2


@pytest.mark.parametrize("mode", ["pt_split_svgf", "direct_eaw_modulate",
                                  "direct_gaussian", "gbuffer_normal"])
def test_renderer_modes_match_reference(mode):
    """Two frames of the port's Renderer against the JAX Renderer on the
    same scene bytes (cornell, 16x16, the reference's brute-force engine):
    the path tracer's split-SVGF pair and its AOVs, EAW with albedo
    re-modulation, the Gaussian blur, and the G-buffer preview.

    Held on the mean absolute difference, below 0.5% of the image's mean:
    a shadow ray at a grazing cosine (or a G-buffer ray through an edge)
    that the last ulp decides differently changes one pixel's sample, and
    the wavelet levels spread it over their footprint (measured: 0.22% on
    the split-SVGF frame, 21 of 256 pixels; 0.01% with EAW)."""
    from radish_pt_tpu.config import Denoiser as JDenoiser
    from radish_pt_tpu.config import Settings as JSettings
    from radish_pt_tpu.config import Tracer as JTracer
    from radish_pt_tpu.render.renderer import Renderer as JRenderer
    from radish_pt_tpu.scene.build import load_scene
    from radish_pt_tpu_torch.config import Settings
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    kw = {"pt_split_svgf": dict(tracer="STREAMED", denoiser="SVGF", trace_depth=3),
          "direct_eaw_modulate": dict(tracer="DIRECT_LIGHT", denoiser="EA_WAVELET",
                                      modulate=True),
          "direct_gaussian": dict(tracer="DIRECT_LIGHT", denoiser="GAUSSIAN"),
          "gbuffer_normal": dict(tracer="GBUFFER_PREVIEW", gbuffer_view="normal",
                                 encode_normal=True)}[mode]

    def settings(cls, tracer_cls, denoiser_cls):
        s = dict(kw)
        s["tracer"] = getattr(tracer_cls, s["tracer"])
        s["denoiser"] = getattr(denoiser_cls, s.get("denoiser", "NONE"))
        return cls(**s)

    from radish_pt_tpu_torch.config import Denoiser, Tracer

    jds, jcam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"))
    jcam = jcam.replace(width=16, height=16)
    jr = JRenderer(ds=jds, cam=jcam, settings=settings(JSettings, JTracer, JDenoiser))
    r = Renderer(ds=scene_from_jax(*jax_scene_parts(jds)), cam=camera_from_jax(jcam),
                 settings=settings(Settings, Tracer, Denoiser), device="cpu")
    for _ in range(2):
        jr.step()
        r.step()
    got, want = t2n(r.current_image()), np.asarray(jr.current_image())
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert np.abs(got - want).mean() < 5e-3 * want.mean()
    if mode == "pt_split_svgf":
        for aov in ("output_direct", "indirect_moment", "direct_variance"):
            jr.settings.preview_aov = r.settings.preview_aov = aov
            got, want = t2n(r.current_image()), np.asarray(jr.current_image())
            assert np.abs(got - want).mean() < 5e-3 * np.abs(want).mean(), aov
