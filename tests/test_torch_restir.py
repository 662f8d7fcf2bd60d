"""Port parity for the direct-lighting path: the reservoir algebra, the
temporal and spatial neighbour searches, the G-buffer, the direct tracer,
chained ReSTIR DI frames and the animated renderer, each against the JAX
package on the same inputs (made with numpy) or the same scene bytes
(cornell on the reference's brute-force engine, its CPU build and the
dense Pallas kernel's own plain reference, tests/test_pallas.py:33-41).

Tolerances, each with its reason:
* the reservoir algebra and the neighbour searches are elementwise and
  run eagerly on both sides: equal to 1e-6 relative;
* the G-buffer: ids and motion equal, the rest within 1e-5 (the reference
  runs under jit, where XLA fuses products and sums);
* the direct tracer: 1e-5 relative on all but 3 pixels of a 32x32 frame;
  those are shadow rays from a light sample at a grazing cosine, which
  the last ulp blocks or not (as in the path tracer's parity test,
  tests/test_torch_pathtrace.py).  Such a pixel carries the cosine as its
  weight: measured up to 7e-3 over loopers 0-3, held to 1e-2;
* ReSTIR: a weighted-reservoir take compares ``rand * weight < w``, so a
  1-ulp difference in a candidate weight can swap the winner of a pixel,
  and reuse spreads that pixel's reservoir to its neighbours.  The frames
  are held on the share of pixels that differ (<= 2%) and on the mean
  absolute difference (< 2e-3 of a mean near 0.15).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
from torch_port_util import (SCENES, camera_from_jax, gbuffer_frame_arrays,  # noqa: E402
                             gbuffer_frame_pair, jax_scene_parts, reservoir_arrays,
                             reservoir_pair, t2n)

RES = 32


@pytest.fixture(scope="module")
def cornell():
    """(JAX scene, JAX camera at 32x32, port scene, port camera): the
    reference's cornell build (brute-force engine) carried across."""
    from radish_pt_tpu.scene.build import load_scene
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    jds, jcam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"))
    assert jds.intersector == "brute"
    jcam = jcam.replace(width=RES, height=RES)
    return jds, jcam, scene_from_jax(*jax_scene_parts(jds)), camera_from_jax(jcam)


def _moved(jcam, dx=0.3, yaw=4.0):
    """The JAX camera moved sideways and turned: a last camera whose
    reprojection is neither identity nor empty."""
    from radish_pt_tpu.scene import camera as jcm

    return jcm.update_camera(jcam.replace(
        position=jcam.position + jnp.array([dx, 0.0, 0.0], jnp.float32),
        rotation=jcam.rotation + jnp.array([yaw, 0.0, 0.0], jnp.float32)))


def _smooth_frame(rng, n, encode_normal=False):
    """A G-buffer frame whose neighbours often pass the reuse tests: two
    ids and misses, normals near +z, depths near 5."""
    return gbuffer_frame_arrays(rng, n, n_ids=2, encode_normal=encode_normal,
                                spread=0.3, depth=5.0)


def _assert_reservoirs_equal(jr, tr):
    for f in ("li", "wi", "dist", "num", "weight"):
        np.testing.assert_allclose(t2n(getattr(tr, f)), np.asarray(getattr(jr, f)),
                                   rtol=1e-6, atol=0, err_msg=f)


@pytest.mark.parametrize("op", ["update", "merge", "pre_clamped_merge", "check_validity"])
def test_reservoir_algebra_matches(op):
    from radish_pt_tpu.render import restir as jrs
    from radish_pt_tpu_torch.render import restir as rs

    rng = np.random.default_rng(7)
    n = 2048
    ja, ta = reservoir_pair(reservoir_arrays(rng, n))
    jb, tb = reservoir_pair(reservoir_arrays(rng, n))
    rand = rng.random(n).astype(np.float32)
    enable = rng.random(n) < 0.7
    if op == "update":
        args = (tb.li, tb.wi, tb.dist, tb.weight.abs(), torch.from_numpy(rand))
        jargs = (jb.li, jb.wi, jb.dist, jnp.abs(jb.weight), jnp.asarray(rand))
        jo, to = jrs._update(ja, *jargs), rs._update(ta, *args)
    elif op == "merge":
        jo = jrs._merge(ja, jb, jnp.asarray(rand), jnp.asarray(enable))
        to = rs._merge(ta, tb, torch.from_numpy(rand), torch.from_numpy(enable))
    elif op == "pre_clamped_merge":
        jo = jrs._pre_clamped_merge(ja, jb, jnp.asarray(rand), jnp.asarray(enable), 20)
        to = rs._pre_clamped_merge(ta, tb, torch.from_numpy(rand),
                                   torch.from_numpy(enable), 20)
    else:
        jo, to = jrs._check_validity(ja), rs._check_validity(ta)
        assert float(to.weight[0]) == 0.0 and float(to.num[1]) == 0.0
    _assert_reservoirs_equal(jo, to)


@pytest.mark.parametrize("encode_normal", [False, True])
def test_find_temporal_neighbor_matches(encode_normal):
    from radish_pt_tpu.render import restir as jrs
    from radish_pt_tpu_torch.render import restir as rs

    rng = np.random.default_rng(12)
    n = RES * RES
    jres, tres = reservoir_pair(reservoir_arrays(rng, n))
    jcur, tcur = gbuffer_frame_pair(_smooth_frame(rng, n, encode_normal))
    jlast, tlast = gbuffer_frame_pair(_smooth_frame(rng, n, encode_normal))
    motion = rng.integers(-3, n + 3, n).astype(np.int32)
    jo = jrs.find_temporal_neighbor(jres, jnp.asarray(motion), jcur, jlast)
    to = rs.find_temporal_neighbor(tres, torch.from_numpy(motion), tcur, tlast)
    _assert_reservoirs_equal(jo, to)
    assert 0.1 < float((to.num > 0).float().mean()) < 0.9


@pytest.mark.parametrize("looper", [None, 3], ids=["gather", "rolled"])
def test_merge_spatial_matches(cornell, looper):
    """Both branches: per-pixel disk offsets and gathers (``looper`` None),
    and the renderer's offsets shared by all pixels and rolled."""
    from radish_pt_tpu.render import restir as jrs
    from radish_pt_tpu.sampling import rng as jrng
    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.sampling import rng as trng

    jds, _, ds, _ = cornell
    rng = np.random.default_rng(5)
    n = RES * RES
    jres, tres = reservoir_pair(reservoir_arrays(rng, n))
    jcur, tcur = gbuffer_frame_pair(_smooth_frame(rng, n))
    idx = np.arange(n, dtype=np.int32)
    js = jrng.make_sampler(2, jnp.asarray(idx))
    ts = trng.make_sampler(2, torch.from_numpy(idx))
    jo, js = jrs.merge_spatial(jres, jcur, RES, RES, js, jds.sobol, looper=looper)
    to, ts = rs.merge_spatial(tres, tcur, RES, RES, ts, ds.sobol, looper=looper)
    _assert_reservoirs_equal(jo, to)
    assert int(js.ptr) == ts.ptr
    assert float((to.num > 0).float().mean()) > 0.3


@pytest.mark.parametrize("encode_normal", [False, True])
def test_render_gbuffer_matches(cornell, encode_normal):
    from radish_pt_tpu.render import gbuffer as jgb
    from radish_pt_tpu_torch.render import gbuffer as gb

    jds, jcam, ds, cam = cornell
    jlast, jextra = _moved(jcam), _moved(jcam, dx=-0.2, yaw=-3.0)
    want, want2 = jgb.render_gbuffer(jds, jcam, jlast, encode_normal=encode_normal,
                                     extra_motion_cam=jextra)
    got, got2 = gb.render_gbuffer(ds, cam, camera_from_jax(jlast),
                                  encode_normal=encode_normal,
                                  extra_motion_cam=camera_from_jax(jextra))
    np.testing.assert_array_equal(t2n(got.frame.prim_id), np.asarray(want.frame.prim_id))
    np.testing.assert_array_equal(t2n(got.motion), np.asarray(want.motion))
    np.testing.assert_array_equal(t2n(got2), np.asarray(want2))
    for name, a, b in (("normal", got.frame.normal, want.frame.normal),
                       ("depth", got.frame.depth, want.frame.depth),
                       ("albedo", got.albedo, want.albedo)):
        np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert got.frame.normal.shape[-1] == (2 if encode_normal else 3)
    motion = t2n(got.motion)
    assert (motion == -1).any() and (motion > 0).mean() > 0.5
    assert (t2n(got.frame.prim_id) == gb.LIGHT_ID).any()


def test_path_trace_direct_matches(cornell):
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, jcam, ds, cam = cornell
    f = jax.jit(jpt.path_trace_direct)
    for looper in (0, 1):
        want = np.asarray(f(jds, jcam, looper))
        got = t2n(pt.path_trace_direct(ds, cam, looper))
        off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
        assert off.any(axis=-1).sum() <= 3
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
        assert want.mean() > 0.05


def _restir_chain(jds, jcam, ds, cam, reuse, frames=3):
    """``frames`` chained ReSTIR frames on both sides: each frame's
    G-buffer, last frame and reservoir from the one before."""
    from radish_pt_tpu.render import gbuffer as jgb
    from radish_pt_tpu.render import restir as jrs
    from radish_pt_tpu_torch.render import gbuffer as gb
    from radish_pt_tpu_torch.render import restir as rs

    n = RES * RES
    f = jax.jit(jrs.restir_direct, static_argnames=("reuse", "reservoir_size",
                                                    "temporal_clamp"))
    jlast, jres = jgb.empty_frame(n), jrs.empty_reservoir(n)
    tlast, tres = gb.empty_frame(n, device="cpu"), rs.empty_reservoir(n, device="cpu")
    out = []
    for looper in range(frames):
        jg = jgb.render_gbuffer(jds, jcam, jcam)
        tg = gb.render_gbuffer(ds, cam, cam)
        jd, jres = f(jds, jcam, looper, jg, jlast, jres, jnp.asarray(looper == 0),
                     reuse=reuse)
        td, tres = rs.restir_direct(ds, cam, looper, tg, tlast, tres, looper == 0, reuse)
        jlast, tlast = jg.frame, tg.frame
        out.append((np.asarray(jd), t2n(td), np.asarray(jres.num), t2n(tres.num)))
    return out


@pytest.mark.parametrize("reuse", ["none", "temporal_spatial"])
def test_restir_chain_matches(cornell, reuse):
    """Three chained frames, each pixel's shaded direct light and the
    reservoir counts it carries (tolerance: see the module docstring)."""
    from radish_pt_tpu_torch.config import ReservoirReuse

    jds, jcam, ds, cam = cornell
    mode = getattr(ReservoirReuse, reuse.upper())
    for jd, td, jnum, tnum in _restir_chain(jds, jcam, ds, cam, mode):
        assert np.isfinite(td).all() and td.mean() > 0.05
        off = np.abs(td - jd).max(axis=-1) > 1e-5 + 1e-4 * np.abs(jd).max(axis=-1)
        assert off.mean() <= 0.02, off.mean()
        assert np.abs(td - jd).mean() < 2e-3
        assert (tnum != jnum).mean() <= 0.02
    if mode == ReservoirReuse.TEMPORAL_SPATIAL:
        assert tnum.max() > 32  # the history grew past one frame's candidates


def test_renderer_animated_restir_matches_reference(cornell):
    """The port's Renderer against the JAX package's, ReSTIR (T+S) with
    camera animation: each frame moves the camera, so the G-buffer's
    motion reprojection feeds the temporal reuse."""
    from radish_pt_tpu.config import Settings as JSettings
    from radish_pt_tpu.config import Tracer as JTracer
    from radish_pt_tpu.render.renderer import Renderer as JRenderer
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer

    jds, jcam, ds, cam = cornell
    jr = JRenderer(ds=jds, cam=jcam, settings=JSettings(tracer=JTracer.RESTIR_DI,
                                                        animate_camera=True))
    r = Renderer(ds=ds, cam=cam, settings=Settings(tracer=Tracer.RESTIR_DI,
                                                   animate_camera=True), device="cpu")
    for _ in range(3):
        jr.step()
        r.step()
        np.testing.assert_allclose(t2n(r.cam.position), np.asarray(jr.cam.position),
                                   rtol=1e-6)
        np.testing.assert_array_equal(t2n(r.gbuf.motion), np.asarray(jr.gbuf.motion))
    motion = t2n(r.gbuf.motion)
    assert (motion >= 0).mean() > 0.5
    # the camera moved: many pixels reproject to another pixel
    assert (motion != np.arange(RES * RES)).mean() > 0.1
    got, want = t2n(r.current_image()), np.asarray(jr.current_image())
    assert np.abs(got - want).mean() < 2e-3
    # a user's camera move: a new basis, the accumulation reset
    jr.update_camera(position=[0.0, 5.0, 9.0], rotation=[-90.0, -5.0, 0.0])
    r.update_camera(position=[0.0, 5.0, 9.0], rotation=[-90.0, -5.0, 0.0])
    assert r.state.iteration == 0
    for name in ("position", "view", "up", "right"):
        np.testing.assert_allclose(t2n(getattr(r.cam, name)),
                                   np.asarray(getattr(jr.cam, name)), atol=1e-6)


def _ris_call(ds, cam, monkeypatch, reservoir_size, looper=5):
    """The arguments ``restir_candidates`` hands the candidate RIS on the
    32x32 frame's lanes, and what it returned: (args, (reservoir,
    sampler))."""
    import torch as th

    from radish_pt_tpu_torch.render import restir as rs

    seen = {}
    orig = rs.candidate_ris

    def spy(*args):
        seen["args"], seen["out"] = args, orig(*args)
        return seen["out"]

    monkeypatch.setattr(rs, "candidate_ris", spy)
    idx = th.arange(RES * RES, dtype=th.int32)
    rs.restir_candidates(ds, cam, looper, idx, reservoir_size)
    return seen["args"], seen["out"]


def test_candidate_ris_on_cpu_runs_the_plain_loop(cornell, monkeypatch):
    """On CPU tensors the candidate RIS is ``ris_plain``, the eager loop:
    one plain call a frame and no kernel launch."""
    from radish_pt_tpu_torch.render import ris

    _, _, ds, cam = cornell
    tally = Tally()
    _ris_call(ds, cam, monkeypatch, 32)
    assert tally("launch.ris") == {}
    assert tally("plain.ris") == {"ris": 1}


@pytest.mark.parametrize("reservoir_size", [4, 32])
@pytest.mark.parametrize("table", ["sobol", "hash"])
def test_candidate_ris_is_the_candidate_loop(cornell, monkeypatch, table, reservoir_size):
    """The candidate RIS ``restir_candidates`` runs fills every lane's
    reservoir with ``reservoir_size`` candidates and leaves the sampler 5
    draws a candidate further on: ptr + 5 x ``reservoir_size`` and the
    scramble hashed 5 x ``reservoir_size`` times, in both sampler modes.
    The kernel reproduces this state, so the temporal and spatial stages
    draw the numbers they drew before."""
    from radish_pt_tpu_torch.utils import math as m

    _, _, ds, cam = cornell
    if table == "hash":
        ds = ds.replace(sobol=None)
    (*_, sampler, size), (res, after) = _ris_call(ds, cam, monkeypatch, reservoir_size)
    assert size == reservoir_size
    assert (res.num == reservoir_size).all() and (res.weight > 0).any()
    scramble = sampler.scramble
    for _ in range(5 * reservoir_size):
        scramble = m.utilhash(scramble)
    assert after.scramble.equal(scramble)
    assert int(after.ptr) == int(sampler.ptr) + 5 * reservoir_size
