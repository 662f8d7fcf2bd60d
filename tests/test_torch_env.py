"""Port parity for env maps and aperture masks: the equirect maps, the env
and aperture samplers' alias tables, the env radiance / pdf / sampler,
masked aperture sampling, NEE with the env slot, and frames of the two
scenes that need them (scenes/glass.txt: a masked aperture, dielectric;
scenes/env_teapot.txt: an env map and no area light), each against the
JAX package on the same inputs (made with numpy) or the same scene bytes.

Tolerances, each with its reason:
* ``to_sphere`` / ``to_plane``: rtol 1e-5, atol 1e-6 (torch's and XLA's
  sin, cos and atan2 may differ by an ulp); ``to_plane``'s azimuth is
  compared on the circle, since the seam at u = 0 / 1 may fall on either
  side;
* the alias tables and ``sample_aperture``: bytewise equal (the same
  numpy build; the sampler is integer arithmetic and exact f32 ops);
* ``env_radiance`` and ``env_map_pdf``: rtol 1e-5, atol 1e-6 on every
  lane but at most 1 in 1,000, which is held to 1e-3: an ulp of atan2 may
  move ``to_plane``'s u across a texel edge (or the seam), and the
  bilinear weights move with it by an ulp of the texture coordinate
  (measured: 0 of 8,192 lanes outside rtol 1e-5); ``_sample_env_map``:
  rtol 1e-5, atol 1e-6 on every lane (the texel is an exact integer draw);
* ``sample_direct_light_no_vis``: rtol 1e-5, atol 1e-6 (the env lanes'
  directions go through sin and cos);
* the frames: see each test.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
from torch_port_util import (SCENES, camera_from_jax, jax_scene_parts,  # noqa: E402
                             load_jax_scene, t2n)

ENV_SCENES = {"glass": "glass.txt", "env_teapot": "env_teapot.txt"}
RES = 16


@pytest.fixture(scope="module")
def scenes():
    """Per scene: (JAX scene on its numpy host path, JAX camera, the port's
    own build, the JAX scene carried across by ``scene_from_jax``)."""
    from radish_pt_tpu_torch.scene.build import load_scene
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for key, fname in ENV_SCENES.items():
            jds, jcam, _ = load_jax_scene(mp, fname)
            tds, _, _ = load_scene(os.path.join(SCENES, fname), device="cpu")
            out[key] = (jds, jcam, tds, scene_from_jax(*jax_scene_parts(jds)))
    finally:
        mp.undo()
    return out


def _close_but_few(got, want, what, rtol=1e-5, atol=1e-6):
    """Equal within (rtol, atol) on all but 1 in 1,000 lanes; those within
    1e-3 (module docstring)."""
    got, want = np.asarray(got).reshape(len(got), -1), np.asarray(want).reshape(len(want), -1)
    off = (np.abs(got - want) > atol + rtol * np.abs(want)).any(axis=-1)
    assert off.mean() <= 1e-3, (what, int(off.sum()))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3, err_msg=what)


def test_to_sphere_and_to_plane_match():
    from radish_pt_tpu.utils import math as jm
    from radish_pt_tpu_torch.utils import math as m

    rng = np.random.default_rng(31)
    uv = rng.uniform(size=(8192, 2)).astype(np.float32)
    want = np.asarray(jm.to_sphere(jnp.asarray(uv)))
    got = t2n(m.to_sphere(torch.from_numpy(uv)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    d = rng.normal(size=(8192, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:64, 2] = 0.0  # on the seam: atan2(0, x)
    want = np.asarray(jm.to_plane(jnp.asarray(d)))
    got = t2n(m.to_plane(torch.from_numpy(d)))
    assert ((got >= 0) & (got <= 1)).all()
    du = np.abs(got[:, 0] - want[:, 0])
    np.testing.assert_allclose(np.minimum(du, 1.0 - du), 0.0, atol=1e-6)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5, atol=1e-6)
    # the round trip: a texel centre's direction maps back to it
    back = t2n(m.to_plane(m.to_sphere(torch.from_numpy(uv))))
    du = np.abs(back[:, 0] - uv[:, 0])
    assert np.minimum(du, 1.0 - du).max() < 1e-4
    np.testing.assert_allclose(back[:, 1], uv[:, 1], atol=1e-4)


@pytest.mark.parametrize("name", list(ENV_SCENES))
def test_env_and_aperture_tables_bytewise_equal(scenes, name):
    """The port's own build of the scene gives the JAX build's samplers,
    byte for byte: the env and aperture alias tables, the light table with
    the env total in its last slot, and 1 / sumPower."""
    jds, _, tds, _ = scenes[name]
    for k in ("has_env", "has_aperture", "env_tex", "aperture_tex", "n_area_lights"):
        assert getattr(tds, k) == getattr(jds, k), k
    for k in ("env_alias_prob", "env_alias_idx", "aperture_alias_prob",
              "aperture_alias_idx", "light_alias_prob", "light_alias_idx",
              "sum_light_power_inv", "tex_data", "tex_offset", "tex_width",
              "tex_height"):
        assert t2n(getattr(tds, k)).tobytes() == np.asarray(getattr(jds, k)).tobytes(), k
    if name == "env_teapot":  # the env map is the only light: one slot
        assert tds.n_area_lights == 0 and tds.light_alias_prob.shape == (1,)
        assert tds.env_alias_prob.shape[0] == int(tds.tex_width[tds.env_tex]
                                                  * tds.tex_height[tds.env_tex])
    else:
        assert tds.aperture_alias_prob.shape[0] == int(
            tds.tex_width[tds.aperture_tex] * tds.tex_height[tds.aperture_tex])


def test_env_functions_match(scenes):
    """env_radiance, env_map_pdf and _sample_env_map on env_teapot's bytes
    (tolerance: module docstring)."""
    from radish_pt_tpu.scene import device_scene as jdsc
    from radish_pt_tpu_torch.scene import device_scene as dsc

    jds, _, _, ds = scenes["env_teapot"]
    rng = np.random.default_rng(32)
    d = rng.normal(size=(8192, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rad = t2n(dsc.env_radiance(ds, torch.from_numpy(d)))
    _close_but_few(rad, jdsc.env_radiance(jds, jnp.asarray(d)), "env_radiance")
    assert rad.min() >= 0 and rad.mean() > 0.05
    _close_but_few(t2n(dsc.env_map_pdf(ds, torch.from_numpy(d))),
                   jdsc.env_map_pdf(jds, jnp.asarray(d)), "env_map_pdf")
    r2 = rng.uniform(size=(8192, 2)).astype(np.float32)
    got = dsc._sample_env_map(ds, torch.from_numpy(r2))
    want = jdsc._sample_env_map(jds, jnp.asarray(r2))
    for a, b, k in zip(got, want, ("radiance", "wi", "pdf")):
        np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=k)
    # a sampled direction's pdf is the pdf of looking up that direction
    _close_but_few(t2n(dsc.env_map_pdf(ds, got[1])), t2n(got[2]), "pdf round trip",
                   rtol=1e-3, atol=1e-6)
    # the table follows luminance x sin(theta): the bright sky is sampled
    assert t2n(got[1])[:, 1].mean() > 0.0


def test_sample_aperture_mask_matches(scenes):
    """glass's star-shaped aperture: lens points bytewise equal to the JAX
    package's, at texel centres in [-1, 1]^2, only where the mask is lit."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, _, tds, _ = scenes["glass"]
    r2 = np.random.default_rng(33).uniform(size=(8192, 2)).astype(np.float32)
    got = t2n(pt.sample_aperture(tds, torch.from_numpy(r2)))
    assert got.tobytes() == np.asarray(jpt.sample_aperture(jds, jnp.asarray(r2))).tobytes()
    assert np.abs(got).max() < 1.0
    w, h = int(tds.tex_width[tds.aperture_tex]), int(tds.tex_height[tds.aperture_tex])
    px = np.floor((got + 1.0) * 0.5 * [w, h]).astype(int)
    mask = t2n(tds.tex_data)[int(tds.tex_offset[tds.aperture_tex]):][:w * h]
    assert (mask.reshape(h, w, 3)[px[:, 1], px[:, 0]].max(axis=-1) > 0).all()
    # the disk without a mask: the uniform concentric sample
    plain = pt.sample_aperture(tds.replace(has_aperture=False), torch.from_numpy(r2))
    assert float((plain ** 2).sum(-1).max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("name", list(ENV_SCENES))
def test_sample_direct_light_no_vis_matches(scenes, name):
    """NEE without visibility: env_teapot's env map is its only light (the
    env slot is light id 0, every sample 1e6 away); glass has area lights
    only.  Both give valid, non-zero samples."""
    from radish_pt_tpu.scene import device_scene as jdsc
    from radish_pt_tpu_torch.scene import device_scene as dsc

    jds, _, tds, _ = scenes[name]
    rng = np.random.default_rng(34)
    pos = rng.uniform(-3, 3, (4096, 3)).astype(np.float32)
    r4 = rng.uniform(size=(4096, 4)).astype(np.float32)
    want = jdsc.sample_direct_light_no_vis(jds, jnp.asarray(pos), jnp.asarray(r4))
    got = dsc.sample_direct_light_no_vis(tds, torch.from_numpy(pos), torch.from_numpy(r4))
    for a, b, k in zip(got, want, ("radiance", "wi", "dist", "pdf")):
        np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=k)
    radiance, _, dist, pdf = (t2n(a) for a in got)
    valid = pdf > 0
    assert valid.mean() > (0.99 if name == "env_teapot" else 0.2)
    assert radiance[valid].max(axis=-1).min() > 0
    if name == "env_teapot":
        assert (dist == np.float32(1e6)).all()
    else:
        assert dist.max() < 100


def _jax_frames(fn, *args, **kw):
    return tuple(np.asarray(a) for a in jax.jit(fn, static_argnames=tuple(kw))(*args, **kw))


@pytest.mark.parametrize("name,depth", [("glass", 4), ("env_teapot", 3)])
def test_path_trace_matches_reference(scenes, name, depth):
    """The whole slice: 16x16, looper 0, through the port's Plücker engine
    (its plain versions on CPU tensors) against the JAX package's frame on
    the same scene bytes (its brute-force engine): refraction through the
    glass sphere and the masked thin lens, the env map seen on primary
    misses and by escaped bounce rays with its MIS weight, NEE to the env
    slot.  Every pixel within 1e-3 and the mean absolute difference below
    1e-5, on the frame and on its indirect part (the env-miss term on
    env_teapot): a refracted path's or a grazing shadow ray's last ulp may
    turn differently on the two sides (measured: at most 3.0e-5 on a pixel,
    mean 1.6e-7 on env_teapot and 8.5e-7 on glass)."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, jcam, _, ds = scenes[name]
    jcam = jcam.replace(width=RES, height=RES)
    jd, ji = _jax_frames(jpt.path_trace, jds.replace(intersector="brute"), jcam, 0,
                         max_depth=depth)
    tally = Tally()
    d, i = pt.path_trace(ds, camera_from_jax(jcam), 0, depth)
    assert tally("plain.plucker") == {"closest_hit": depth + 1, "occlusion": depth}
    assert np.isfinite(t2n(d + i)).all() and (jd + ji).mean() > 1e-2 and ji.mean() > 1e-2
    for got, want in ((t2n(d + i), jd + ji), (t2n(i), ji)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3, err_msg=name)
        assert np.abs(got - want).mean() < 1e-5, name


@pytest.fixture(scope="module")
def env_brute(scenes):
    """env_teapot on the brute-force engine on both sides (the same
    Möller–Trumbore winners), 16x16: for the direct-lighting paths."""
    jds, jcam, _, ds = scenes["env_teapot"]
    jcam = jcam.replace(width=RES, height=RES)
    return (jds.replace(intersector="brute"), jcam, ds.replace(intersector="brute"),
            camera_from_jax(jcam))


def test_path_trace_direct_matches_on_env_map(env_brute):
    """One NEE sample per pixel to the env map: rtol 1e-5 on all but 2 of
    256 pixels (a shadow ray that the last ulp blocks or not, as in
    tests/test_torch_restir.py), all within 1e-2; the sky's pixels show
    the env map."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, jcam, ds, cam = env_brute
    want = np.asarray(jax.jit(jpt.path_trace_direct)(jds, jcam, 0))
    got = t2n(pt.path_trace_direct(ds, cam, 0))
    off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
    assert off.any(axis=-1).sum() <= 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert want.mean() > 0.05


def test_gbuffer_albedo_and_restir_match_on_env_map(env_brute):
    """The G-buffer's albedo (the env map's radiance on a miss) within
    1e-5, and two chained ReSTIR frames (T+S reuse) whose candidates come
    from the env slot: at most 2% of pixels differ and the mean absolute
    difference is below 2e-3 (a 1-ulp candidate weight can swap a
    reservoir's winner, tests/test_torch_restir.py)."""
    from radish_pt_tpu.render import gbuffer as jgb
    from radish_pt_tpu.render import restir as jrs
    from radish_pt_tpu_torch.config import ReservoirReuse
    from radish_pt_tpu_torch.render import gbuffer as gb
    from radish_pt_tpu_torch.render import restir as rs

    jds, jcam, ds, cam = env_brute
    n = RES * RES
    f = jax.jit(jrs.restir_direct, static_argnames=("reuse", "reservoir_size",
                                                    "temporal_clamp"))
    jlast, jres = jgb.empty_frame(n), jrs.empty_reservoir(n)
    tlast, tres = gb.empty_frame(n, device="cpu"), rs.empty_reservoir(n, device="cpu")
    reuse = ReservoirReuse.TEMPORAL_SPATIAL
    for looper in range(2):
        jg, tg = jgb.render_gbuffer(jds, jcam, jcam), gb.render_gbuffer(ds, cam, cam)
        np.testing.assert_array_equal(t2n(tg.frame.prim_id), np.asarray(jg.frame.prim_id))
        np.testing.assert_allclose(t2n(tg.albedo), np.asarray(jg.albedo), rtol=1e-5,
                                   atol=1e-5)
        miss = t2n(tg.frame.prim_id) < 0
        assert miss.any() and t2n(tg.albedo)[miss].max() > 0  # the sky's colour
        jd, jres = f(jds, jcam, looper, jg, jlast, jres, jnp.asarray(looper == 0),
                     reuse=reuse)
        td, tres = rs.restir_direct(ds, cam, looper, tg, tlast, tres, looper == 0, reuse)
        jlast, tlast = jg.frame, tg.frame
        jd, td = np.asarray(jd), t2n(td)
        assert np.isfinite(td).all() and td.mean() > 0.05
        off = np.abs(td - jd).max(axis=-1) > 1e-5 + 1e-4 * np.abs(jd).max(axis=-1)
        assert off.mean() <= 0.02, off.mean()
        assert np.abs(td - jd).mean() < 2e-3
