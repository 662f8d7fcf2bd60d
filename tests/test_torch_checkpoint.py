"""Port parity for the render-state checkpoint, the per-pass timer, the
debug-NaN stop and the CLI's flags: a checkpoint of either package loads
into the other's ``Renderer``, a resumed render gives the uninterrupted
one, the refusals of tests/test_checkpoint.py hold, and the CLI drives
``--batch-spp``, ``--checkpoint`` / ``--resume``, ``--timing``,
``--preview-every``, ``--profile`` and ``.hdr`` output on the CPU.

Tolerances, each with its reason:
* the port resumed from its own checkpoint: the same operations on the
  same state, equal bit for bit (``torch.equal``);
* across packages (cornell, both on the brute-force engine): the frames'
  tolerance of tests/test_torch_pathtrace.py and test_torch_restir.py: at
  most one pixel a frame beyond rtol 1e-5, atol 1e-6 (a shadow ray at a
  grazing cosine, which the last ulp of the reference's fused arithmetic
  blocks or not), each such pixel within 1e-2 (it carries the cosine as
  its weight), the mean absolute difference below 1e-5;
* a checkpoint's arrays are copied, not computed: equal bit for bit;
* ``.hdr`` output: Radiance RGBE shares one exponent across a pixel's
  channels: rtol 2e-2, atol 1e-3, as tests/test_checkpoint.py holds it.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from torch_port_util import SCENES, camera_from_jax, jax_scene_parts, t2n  # noqa: E402

RES, DEPTH = 32, 3
ARRAYS = ("direct", "indirect", "res_li", "res_wi", "res_dist", "res_num", "res_weight",
          "gbuf_normal", "gbuf_prim", "gbuf_depth", "svgf_color", "svgf_moment",
          "svgf_i_color", "svgf_i_moment", "cam_position", "cam_rotation")


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


def _port(cornell, **settings):
    from radish_pt_tpu_torch.config import Settings
    from radish_pt_tpu_torch.render.renderer import Renderer

    _, _, ds, cam = cornell
    return Renderer(ds=ds, cam=cam, desc=None,
                    settings=Settings(**{"trace_depth": DEPTH, **settings}), device="cpu")


def _jax(cornell, mesh=None, **settings):
    from radish_pt_tpu.config import Settings
    from radish_pt_tpu.render.renderer import Renderer

    jds, jcam, _, _ = cornell
    return Renderer(ds=jds, cam=jcam, desc=None,
                    settings=Settings(**{"trace_depth": DEPTH, **settings}), mesh=mesh)


def _assert_frames_close(got, want):
    off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
    assert off.any(axis=-1).sum() <= 6  # at most one pixel a frame
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert np.abs(got - want).mean() < 1e-5


def test_port_resume_is_bit_exact(cornell, tmp_path):
    """6 frames = 3 frames + checkpoint + resume + 3 frames, bit for bit,
    on the path tracer and on ReSTIR (whose reservoir and G-buffer the
    file carries)."""
    from radish_pt_tpu_torch.config import Tracer

    for tracer in (Tracer.STREAMED, Tracer.RESTIR_DI):
        a = _port(cornell, tracer=tracer)
        for _ in range(6):
            a.step()
        b = _port(cornell, tracer=tracer)
        for _ in range(3):
            b.step()
        path = str(tmp_path / f"ck{tracer}.npz")
        assert b.save_checkpoint(path) == os.path.abspath(path)
        c = _port(cornell, tracer=tracer)
        c.load_checkpoint(path)
        assert (c.state.iteration, c.state.looper, c.first_frame) == (3, 3, False)
        for _ in range(3):
            c.step()
        for name in ("direct", "indirect"):
            assert torch.equal(getattr(a, name), getattr(c, name)), (tracer, name)
        for f in ("li", "wi", "dist", "num", "weight"):
            assert torch.equal(getattr(a.reservoir, f), getattr(c.reservoir, f)), f


def test_port_checkpoint_resumes_in_jax(cornell, tmp_path):
    """The port's file (3 frames; no G-buffer rendered on the path
    tracer's frames, so it writes its last camera's) loads into the JAX
    ``Renderer``, array for array, and 3 more JAX frames come within the
    frames' tolerance of the JAX package's uninterrupted 6."""
    a = _port(cornell)
    for _ in range(3):
        a.step()
    assert a.gbuf_last is None
    path = str(tmp_path / "port.npz")
    a.save_checkpoint(path)
    data = np.load(path)
    assert sorted(k for k in data.files if k != "__meta__") == sorted(ARRAYS)

    j = _jax(cornell)
    j.load_checkpoint(path)
    assert (j.state.iteration, j.state.looper, j.first_frame) == (3, 3, False)
    for key, got in (("direct", j.direct), ("res_weight", j.reservoir.weight),
                     ("gbuf_prim", j.gbuf_last.prim_id), ("gbuf_depth", j.gbuf_last.depth)):
        np.testing.assert_array_equal(np.asarray(got), data[key], err_msg=key)
    # the written G-buffer is the port's for the last camera, the one the
    # JAX renderer keeps for it but for a pixel whose edge hit the last ulp
    # of the reference's fused (jit) arithmetic may turn
    from radish_pt_tpu.render import gbuffer as jgb
    from radish_pt_tpu_torch.render import gbuffer as gb

    g = gb.render_gbuffer(cornell[2], cornell[3], cornell[3]).frame
    for key, want in (("gbuf_normal", g.normal), ("gbuf_prim", g.prim_id),
                      ("gbuf_depth", g.depth)):
        np.testing.assert_array_equal(data[key], t2n(want), err_msg=key)
    jg = jax.jit(jgb.render_gbuffer)(cornell[0], cornell[1], cornell[1])
    assert (data["gbuf_prim"] != np.asarray(jg.frame.prim_id)).sum() <= 1
    for _ in range(3):
        j.step()
    ref = _jax(cornell)
    for _ in range(6):
        ref.step()
    for name in ("direct", "indirect"):
        _assert_frames_close(np.asarray(getattr(j, name)), np.asarray(getattr(ref, name)))


def test_jax_checkpoint_resumes_in_port(cornell, tmp_path):
    """The JAX package's file (3 frames) loads into the port's
    ``Renderer``, array for array; 3 more port frames come within the
    frames' tolerance of the JAX package's uninterrupted 6."""
    j = _jax(cornell)
    for _ in range(3):
        j.step()
    path = str(tmp_path / "jax.npz")
    j.save_checkpoint(path)
    data = np.load(path)
    r = _port(cornell)
    r.load_checkpoint(path)
    assert (r.state.iteration, r.state.looper, r.first_frame) == (3, 3, False)
    for key, got in (("direct", r.direct), ("indirect", r.indirect),
                     ("res_num", r.reservoir.num), ("gbuf_normal", r.gbuf_last.normal),
                     ("svgf_i_moment", r.svgf_indirect.accum_moment),
                     ("cam_position", r.cam.position)):
        np.testing.assert_array_equal(t2n(got), data[key], err_msg=key)
    for _ in range(3):
        r.step()
        j.step()
    for name in ("direct", "indirect"):
        _assert_frames_close(t2n(getattr(r, name)), np.asarray(getattr(j, name)))


def test_checkpoint_rejects_mismatched_layout(cornell, tmp_path):
    """The refusals tests/test_checkpoint.py pins, across packages: a JAX
    file saved under a 7-tile mesh (256 pixels padded to 259 rows), the
    other normal encoding, another resolution, another format version."""
    from radish_pt_tpu.parallel import sharding as sh

    mesh = sh.make_mesh(n_tile=7, n_sample=1, devices=jax.devices("cpu")[:7])
    cam16 = cornell[1].replace(width=16, height=16)
    j = _jax((cornell[0], cam16, None, None), mesh=mesh)
    path = str(tmp_path / "mesh.npz")
    j.save_checkpoint(path)
    small = (None, None, cornell[2], camera_from_jax(cam16))
    with pytest.raises(ValueError, match="mesh"):
        _port(small).load_checkpoint(path)

    p2 = str(tmp_path / "plain.npz")
    _port(cornell).save_checkpoint(p2)
    with pytest.raises(ValueError, match="normal"):
        _port(cornell, encode_normal=True).load_checkpoint(p2)
    with pytest.raises(ValueError, match="normal"):
        _jax(cornell, encode_normal=True).load_checkpoint(p2)
    with pytest.raises(ValueError, match="resolution"):
        _port(small).load_checkpoint(p2)

    data = dict(np.load(p2))
    meta = data.pop("__meta__")
    p3 = str(tmp_path / "v2.npz")
    np.savez(p3, __meta__=str(meta).replace('"version": 1', '"version": 2'), **data)
    with pytest.raises(ValueError, match="version"):
        _port(cornell).load_checkpoint(p3)


def test_pass_timer_tables_the_step_passes(cornell):
    """``timing=True``: ``step`` times its passes (host clock on the CPU)
    and a batched block times the block; off, nothing is recorded."""
    from radish_pt_tpu_torch.config import Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer

    r = Renderer(ds=cornell[2], cam=cornell[3], desc=None, device="cpu", timing=True)
    r.settings.tracer = Tracer.RESTIR_DI
    r.step()
    r.run_block(2)
    table = r.timer.table()
    for name in ("gbuffer", "restir", "display", "block of 2"):
        assert name in table and r.timer.mean_ms(name) > 0, name
    quiet = _port(cornell)
    quiet.step()
    assert quiet.timer.table() == "" and np.isnan(quiet.timer.mean_ms("pathtrace"))


def test_debug_nans_stops_at_a_non_finite_frame(cornell, monkeypatch):
    """With ``debug_nans`` a NaN in the tracer's output raises; without,
    the scrub zeroes it and the frame goes on."""
    from radish_pt_tpu_torch.render import pathtrace as pt

    real = pt.path_trace

    def poisoned(*args, **kwargs):
        d, i = real(*args, **kwargs)
        d[5, 1] = float("nan")
        return d, i

    monkeypatch.setattr(pt, "path_trace", poisoned)
    r = _port(cornell)
    r.step()
    assert bool(torch.isfinite(r.direct).all()) and float(r.direct[5, 1]) == 0.0
    r.debug_nans = True
    with pytest.raises(FloatingPointError, match="non-finite"):
        r.step()


def test_cli_batch_checkpoint_resume_timing_hdr(tmp_path, capsys, monkeypatch):
    """The CLI on the CPU at 16x16: ``--batch-spp 2 --checkpoint`` (4
    samples in blocks of 2), then ``--resume`` with ``--timing``, a
    preview every frame and a profiler trace; the saved image, the file,
    the table; and an ``--out x.hdr`` that ``read_hdr`` reads back as the
    renderer's accumulation."""
    from radish_pt_tpu_torch import cli
    from radish_pt_tpu_torch.config import Settings
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene
    from radish_pt_tpu_torch.scene.image_io import load_image, read_hdr

    monkeypatch.chdir(tmp_path)
    scene = os.path.join(SCENES, "cornell_box.txt")
    base = [scene, "--res", "16", "16", "--depth", "2", "--device", "cpu"]
    ck, png = str(tmp_path / "ck.npz"), str(tmp_path / "a.png")
    assert cli.main(base + ["--spp", "4", "--batch-spp", "2", "--checkpoint", ck,
                            "--out", png]) == 0
    out = capsys.readouterr().out
    assert "blocks of 2, batch mode eager" in out and "[checkpoint ->" in out
    assert load_image(png, flip_vertical=False).shape == (16, 16, 3)
    meta = np.load(ck)["__meta__"]
    assert '"iteration": 4' in str(meta) and '"looper": 4' in str(meta)

    hdr, prof = str(tmp_path / "b.hdr"), str(tmp_path / "prof")
    assert cli.main(base + ["--spp", "2", "--resume", ck, "--timing", "--out", hdr,
                            "--preview-every", "1", "--profile", prof]) == 0
    out = capsys.readouterr().out
    assert "[resumed from" in out and "4 spp accumulated" in out
    assert "pathtrace" in out and "display" in out and " ms  (last" in out
    assert os.path.exists("cornell_preview_2.png") and os.path.exists(f"{prof}/trace.json")

    ds, cam, _ = load_scene(scene, device="cpu")
    r = Renderer(ds=ds, cam=cam.replace(width=16, height=16), desc=None, device="cpu",
                 settings=Settings(trace_depth=2))
    r.render(spp=6)
    ref = t2n(r.current_image()).reshape(16, 16, 3)
    img = read_hdr(hdr)[:, ::-1]  # undo the save's X mirror
    assert img.shape == ref.shape and ref.mean() > 0.05
    np.testing.assert_allclose(img, ref, rtol=0.02, atol=1e-3)
