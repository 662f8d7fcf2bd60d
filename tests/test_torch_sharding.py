"""The port's multi-device path on the CPU (parallel/sharding.py, the
mesh mode of ``Renderer``, ``--mesh``, the dry run): meshes of several
tiles on the one CPU device, the port's counterpart of the JAX package's
virtual host devices.

Tolerances, each with its reason:
* tile sharding and the sample mean against the port's own single-device
  frames: none (``torch.equal``) on cornell, which has no clusters; on
  teapot the JAX package's rule (``dryrun.frames_match``: at most 2
  pixels off by 1e-4, the mean under 5e-5), since a tile regroups the
  lanes that share a culling decision — the count measured here is 0;
* ReSTIR: rows more than 5 from a seam equal to the single-device frame
  (rtol 1e-5, atol 1e-6, the JAX package's test), and at least one pixel
  of the band at the seam differs; a tile against the JAX package's
  ``restir_direct(pixel_idx=tile)`` as the full-frame chain test holds
  frames (tests/test_torch_restir.py: <= 2% of the pixels off, mean
  difference < 2e-3);
* the denoiser in mesh mode: none (``torch.equal``) against SVGF on the
  single-device inputs;
* batched ReSTIR on a mesh, and ``merge_spatial`` on a tile with its halo,
  against the single-device renderer and the full frame: none
  (``torch.equal``), seam rows included (cornell, the plain sweeps).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_port_util import SCENES, camera_from_jax, jax_scene_parts, t2n  # noqa: E402

CPU = torch.device("cpu")


def _mesh(n_tile, n_sample=1):
    from radish_pt_tpu_torch.parallel import sharding as sh

    return sh.make_mesh(n_tile, n_sample, devices=[CPU] * (n_tile * n_sample))


@pytest.fixture(scope="module")
def scenes():
    """The port's own builds on the CPU, by name (cameras at their files'
    resolution)."""
    from radish_pt_tpu_torch.scene.build import load_scene

    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = load_scene(os.path.join(SCENES, name), device="cpu")[:2]
        return cache[name]
    return get


def test_make_mesh_shapes(monkeypatch):
    from radish_pt_tpu_torch.parallel import sharding as sh

    mesh = sh.make_mesh(n_tile=4, n_sample=2, devices=[CPU] * 8)
    assert mesh.shape == {"tile": 4, "sample": 2} and len(mesh.devices[3]) == 2
    assert sh.make_mesh(devices=[CPU] * 8).shape == {"tile": 8, "sample": 1}
    assert sh.parse_mesh("4x2") == (4, 2) and sh.parse_mesh("3") == (3, 1)
    with pytest.raises(ValueError):
        sh.parse_mesh("4y2")
    with pytest.raises(ValueError):
        sh.make_mesh(n_tile=3, n_sample=2, devices=[CPU] * 5)
    # no devices named: the visible CUDA devices, and too few raise
    monkeypatch.setattr(sh, "visible_devices", lambda: [torch.device("cuda", 0)])
    with pytest.raises(RuntimeError, match=r"needs 2 devices, and 1 CUDA device"):
        sh.make_mesh(n_tile=2)
    assert sh.make_mesh(n_tile=1).devices == [[torch.device("cuda", 0)]]


@pytest.mark.parametrize("n_tile", [1, 2, 3, 5])
def test_tile_sharded_cornell_is_bit_equal(scenes, n_tile):
    """Cornell 16x16 (3 and 5 tiles pad the 256 pixels), depth 3: the
    gathered tiles equal the single-device frame, and so do the tiles'
    G-buffers."""
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.render import gbuffer as gb
    from radish_pt_tpu_torch.render import pathtrace as pt

    ds, cam = scenes("cornell_box.txt")
    cam = cam.replace(width=16, height=16)
    mesh = _mesh(n_tile)
    d, i = pt.path_trace(ds, cam, 5, 3)
    assert torch.equal(sh.render_frame_sharded(mesh, ds, cam, 5, 3), d + i)
    full = gb.render_gbuffer(ds, cam, cam)
    tiles = sh.gather(sh.gbuffer_sharded(mesh, ds, cam, cam), CPU, 256)
    for a, b in ((tiles.frame.normal, full.frame.normal), (tiles.motion, full.motion),
                 (tiles.frame.depth, full.frame.depth), (tiles.albedo, full.albedo)):
        assert torch.equal(a, b)


def test_sample_axis_averages(scenes):
    """(tile 2, sample 2): the mean of the looper and looper + 37 frames."""
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.render import pathtrace as pt

    ds, cam = scenes("cornell_box.txt")
    cam = cam.replace(width=16, height=16)
    got = sh.render_frame_sharded(_mesh(2, 2), ds, cam, 3, 2)
    a, b = (sum(pt.path_trace(ds, cam, lp, 2)) for lp in (3, 3 + sh.SAMPLE_STRIDE))
    assert torch.equal(got, (a + b) / 2.0)
    assert not torch.equal(a, b)


def test_pt_step_and_accumulate_sharded(scenes):
    """``pt_step_sharded`` on padded tiles (3 tiles, 258 rows) and
    ``render_accumulate_sharded``, two frames: the single-device scrubbed
    running mean."""
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.render import pathtrace as pt

    ds, cam = scenes("cornell_box.txt")
    cam = cam.replace(width=16, height=16)
    mesh = _mesh(3)
    n_pad = sh._padded_pixel_count(cam, 3)
    assert n_pad == 258
    tiles = sh.shard_image(mesh, torch.zeros((n_pad, 3)))
    accum = torch.zeros((256, 3))
    want = torch.zeros((256, 3))
    for i in range(2):
        tiles = sh.pt_step_sharded(mesh, ds, cam, tiles, i, i, max_depth=2)
        accum = sh.render_accumulate_sharded(mesh, ds, cam, accum, i, i, 2)
        want = pt.accumulate(want, pt.scrub_and_compress(sum(pt.path_trace(ds, cam, i, 2))), i)
    got = sh.gather(tiles)
    assert got.shape == (258, 3) and torch.equal(got[:256], want)
    assert torch.equal(got[256:], want[255].expand(2, 3))  # pad lanes re-trace the last
    assert torch.equal(accum, want) and float(want.mean()) > 0.01


def test_teapot_four_tiles_match_one(scenes):
    """Teapot 16x16 (clusters: the sliced loop on each tile), depth 3:
    4 tiles against 1 under the JAX package's frames rule."""
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.parallel.dryrun import frames_match
    from radish_pt_tpu_torch.render import pathtrace as pt

    ds, cam = scenes("teapot.txt")
    cam = cam.replace(width=16, height=16)
    stats = {}
    pt.path_trace(ds, cam, 0, 3, sh.tile_pixels(_mesh(4), cam)[1], stats=stats)
    assert stats["loop"] == "sliced"
    one = sh.render_frame_sharded(_mesh(1), ds, cam, 0, 3)
    four = sh.render_frame_sharded(_mesh(4), ds, cam, 0, 3)
    flips = frames_match(t2n(four), t2n(one))
    print(f"teapot 16x16 depth 3, 4 tiles against 1: {flips} flipped pixels")
    assert float(one.mean()) > 0.1


def test_restir_seam_rule(scenes):
    """Two frames of temporal + spatial reuse on 2 tiles of cornell 16x32
    (16 rows each) against one device: the interior equal, the seam band
    showing rejected cross-tile candidates."""
    from radish_pt_tpu_torch.parallel.dryrun import seam_check, seam_rule

    ds, cam = scenes("cornell_box.txt")
    tiled, single, seams = seam_check(_mesh(2), ds, cam.replace(width=16, height=32))
    assert seams == [16]
    assert seam_rule(tiled, single, seams) > 0
    assert np.isfinite(tiled).all() and (tiled >= 0).all()


def test_restir_odd_height_runs(scenes, monkeypatch):
    """16x30 on 4 tiles: 120-pixel tiles are not whole rows, so the
    spatial reuse takes the per-pixel gather path."""
    from radish_pt_tpu_torch.config import ReservoirReuse
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.render import gbuffer as gb
    from radish_pt_tpu_torch.render import restir as rs

    ds, cam = scenes("cornell_box.txt")
    cam = cam.replace(width=16, height=30)
    mesh = _mesh(4)
    n_pad = sh._padded_pixel_count(cam, 4)
    calls = []
    real = rs._spatial_neighbor
    monkeypatch.setattr(rs, "_spatial_neighbor", lambda *a, **k: calls.append(1) or real(*a, **k))
    d, _, _ = sh.restir_step_sharded(
        mesh, ds, cam, cam, 0, sh.shard_image(mesh, gb.empty_frame(n_pad, device="cpu")),
        sh.shard_image(mesh, rs.empty_reservoir(n_pad, device="cpu")), True,
        sh.shard_image(mesh, torch.zeros((n_pad, 3))), 0,
        reuse=ReservoirReuse.TEMPORAL_SPATIAL)
    out = t2n(sh.gather(d))[:480]
    assert np.isfinite(out).all() and (out >= 0).all() and out.mean() > 0.01
    assert len(calls) == 4 * 5  # 5 gathered neighbours a tile


def test_restir_tile_matches_reference():
    """The second tile of cornell 16x32 (rows 16-31), two chained frames
    of temporal + spatial reuse, against the JAX package's
    ``restir_direct(pixel_idx=tile)`` under jit on the same state."""
    from radish_pt_tpu.render import gbuffer as jgb
    from radish_pt_tpu.render import restir as jrs
    from radish_pt_tpu.scene.build import load_scene
    from radish_pt_tpu_torch.config import ReservoirReuse
    from radish_pt_tpu_torch.render import gbuffer as gb
    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    jds, jcam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"))
    jcam = jcam.replace(width=16, height=32)
    ds, cam = scene_from_jax(*jax_scene_parts(jds)), camera_from_jax(jcam)
    reuse = ReservoirReuse.TEMPORAL_SPATIAL
    n = 256
    idx = torch.arange(256, 512, dtype=torch.int32)
    jidx = jnp.asarray(t2n(idx))
    f = jax.jit(jrs.restir_direct, static_argnames=("reuse", "reservoir_size",
                                                    "temporal_clamp"))
    jlast, jres = jgb.empty_frame(n), jrs.empty_reservoir(n)
    tlast, tres = gb.empty_frame(n, device="cpu"), rs.empty_reservoir(n, device="cpu")
    for looper in range(2):
        jg = jgb.render_gbuffer(jds, jcam, jcam, pixel_idx=jidx)
        tg = gb.render_gbuffer(ds, cam, cam, pixel_idx=idx)
        jd, jres = f(jds, jcam, looper, jg, jlast, jres, jnp.asarray(looper == 0),
                     reuse=reuse, pixel_idx=jidx)
        td, tres = rs.restir_direct(ds, cam, looper, tg, tlast, tres, looper == 0, reuse,
                                    pixel_idx=idx)
        jlast, tlast = jg.frame, tg.frame
        jd, td = np.asarray(jd), t2n(td)
        assert np.isfinite(td).all() and td.mean() > 0.05
        off = np.abs(td - jd).max(axis=-1) > 1e-5 + 1e-4 * np.abs(jd).max(axis=-1)
        assert off.mean() <= 0.02, off.mean()
        assert np.abs(td - jd).mean() < 2e-3
        assert (t2n(tres.num) != np.asarray(jres.num)).mean() <= 0.02
    assert t2n(tres.num).max() > 32  # the temporal history grew


def _svgf_replay(ds, cam, frames):
    """The mesh renderer's pt + SVGF frames replayed on one device: the
    scrubbed direct + indirect accumulation, the full-frame G-buffer, and
    ``svgf_filter`` on them."""
    from radish_pt_tpu_torch.render import denoise as dn
    from radish_pt_tpu_torch.render import gbuffer as gb
    from radish_pt_tpu_torch.render import pathtrace as pt

    n = cam.width * cam.height
    acc, state, last = torch.zeros((n, 3)), dn.empty_svgf_state(n, device="cpu"), None
    for i in range(frames):
        acc = pt.accumulate(acc, pt.scrub_and_compress(sum(pt.path_trace(ds, cam, i, 2))), i)
        g = gb.render_gbuffer(ds, cam, cam)
        last = gb.render_gbuffer(ds, cam, cam).frame if last is None else last
        out, state = dn.svgf_filter(acc, state, g, last, cam, i == 0)
        last = g.frame
    return out


def test_mesh_svgf_equals_single_device(scenes):
    """``Renderer(mesh=3 tiles)``, the path tracer + SVGF, two frames: the
    denoised image equals SVGF on the single-device inputs; and SVGF on
    the tiles' gathered G-buffer equals SVGF on the full-frame one."""
    from radish_pt_tpu_torch.config import Denoiser, Settings, Tracer
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.render import denoise as dn
    from radish_pt_tpu_torch.render import gbuffer as gb
    from radish_pt_tpu_torch.render.renderer import Renderer

    ds, cam = scenes("cornell_box.txt")
    cam = cam.replace(width=16, height=16)
    r = Renderer(ds=ds, cam=cam, settings=Settings(tracer=Tracer.STREAMED, trace_depth=2,
                                                   denoiser=Denoiser.SVGF),
                 device="cpu", mesh=_mesh(3))
    for _ in range(2):
        r.step()
    assert torch.equal(r.current_image(), _svgf_replay(ds, cam, 2))
    rng = np.random.default_rng(3)
    color = torch.from_numpy(rng.uniform(0, 2, (256, 3)).astype(np.float32))
    g_full = gb.render_gbuffer(ds, cam, cam)
    g_mesh = sh.gather(sh.gbuffer_sharded(_mesh(8), ds, cam, cam), CPU, 256)
    st = dn.empty_svgf_state(256, device="cpu")
    want, _ = dn.svgf_filter(color, st, g_full, g_full.frame, cam, False)
    got, _ = dn.svgf_filter(color, st, g_mesh, g_mesh.frame, cam, False)
    assert torch.equal(got, want)


def test_renderer_mesh_steps(scenes):
    """``Renderer(mesh=...)``: the path tracer on 3 tiles (padded) equals
    the single-device accumulation of direct + indirect; ReSTIR on 2
    tiles runs, its state tile-sharded; the direct tracer is refused."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render.renderer import Renderer

    ds, cam = scenes("cornell_box.txt")
    cam = cam.replace(width=16, height=16)
    r = Renderer(ds=ds, cam=cam, settings=Settings(tracer=Tracer.STREAMED, trace_depth=2),
                 device="cpu", mesh=_mesh(3))
    assert r.n_alloc == 258 and [t.shape[0] for t in r.direct] == [86] * 3
    for _ in range(2):
        disp = r.step()
    want = torch.zeros((256, 3))
    for i in range(2):
        want = pt.accumulate(want, pt.scrub_and_compress(sum(pt.path_trace(ds, cam, i, 2))), i)
    assert disp.shape == (16, 16, 3) and disp.dtype == torch.uint8
    assert torch.equal(r.current_image(), want)
    rr = Renderer(ds=ds, cam=cam, settings=Settings(tracer=Tracer.RESTIR_DI), device="cpu",
                  mesh=_mesh(2))
    for _ in range(2):
        rr.step()
    img = t2n(rr.current_image())
    assert len(rr.reservoir) == 2 and len(rr.gbuf_last) == 2
    assert np.isfinite(img).all() and img.mean() > 0.05 and rr.state.iteration == 2
    rd = Renderer(ds=ds, cam=cam, settings=Settings(tracer=Tracer.DIRECT_LIGHT),
                  device="cpu", mesh=_mesh(2))
    with pytest.raises(NotImplementedError):
        rd.step()


def test_renderer_mesh_batched_equals_step(scenes):
    """The path tracer's ``render_batched`` on 2 tiles (one block runner a
    tile), blocks of 2, equals four ``step()`` frames bit for bit;
    ReSTIR's batched frames on a mesh (``step_batched_restir``,
    ``render_batched``) equal the single-device renderer's."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer

    ds, cam = scenes("cornell_box.txt")
    cam = cam.replace(width=16, height=16)

    def make(tracer=Tracer.STREAMED):
        return Renderer(ds=ds, cam=cam, settings=Settings(tracer=tracer, trace_depth=2),
                        device="cpu", mesh=_mesh(2))
    a, b = make(), make()
    got = a.render_batched(4, block=2)
    assert len(a._runners) == 2 and a.state.iteration == 4
    assert np.array_equal(got, b.render(4))
    r = make(Tracer.RESTIR_DI)
    one = Renderer(ds=ds, cam=cam, settings=Settings(tracer=Tracer.RESTIR_DI, trace_depth=2),
                   device="cpu")
    assert torch.equal(r.step_batched_restir(2), one.step_batched_restir(2))
    assert np.array_equal(r.render_batched(2, block=2), one.render_batched(2, block=2))


def _assert_restir_state_equal(mesh_r, one):
    """The mesh renderer's accumulation, reservoir and last G-buffer,
    gathered, equal the single-device renderer's bit for bit."""
    assert torch.equal(mesh_r._full(mesh_r.direct), one.direct)
    for got, want in ((mesh_r._full(mesh_r.reservoir), one.reservoir),
                      (mesh_r._full(mesh_r.gbuf_last), one.gbuf_last)):
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name


@pytest.mark.parametrize("segments", [False, True], ids=["one_runner", "segments"])
@pytest.mark.parametrize("w,h,n_tile", [(16, 16, 2), (24, 16, 3)])
def test_renderer_mesh_batched_restir_equals_one_device(scenes, w, h, n_tile, segments):
    """Batched ReSTIR (T+S reuse) on a mesh equals the single-device
    renderer running the same sequence bit for bit, seam rows included:
    ``step_batched_restir(2)``, a camera move, ``step_batched_restir(2)``,
    then ``render_batched(4, block=2)``.  16x16 on 2 tiles; 24x16 on 3
    tiles of 128 pixels, not whole rows, so a halo spans a tile boundary
    mid-row.  The tiles share the CPU: the whole block as one runner, and
    (``mesh_segments``) as the runner a (stage, tile) that tiles on several
    devices take.  The eager mesh ``step()`` keeps its seam rule and
    differs."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer

    ds, cam = scenes("cornell_box.txt")
    cam = cam.replace(width=w, height=h)

    def make(mesh=None):
        return Renderer(ds=ds, cam=cam, settings=Settings(tracer=Tracer.RESTIR_DI),
                        device="cpu", mesh=mesh)
    one, r = make(), make(_mesh(n_tile))
    r.mesh_segments = segments
    for k in range(2):
        assert torch.equal(r.step_batched_restir(2), one.step_batched_restir(2))
        _assert_restir_state_equal(r, one)
        if k == 0:
            for x in (r, one):
                x.update_camera(position=t2n(x.cam.position) + np.float32([0.4, 0.2, 0.0]))
    assert np.array_equal(r.render_batched(4, block=2), one.render_batched(4, block=2))
    _assert_restir_state_equal(r, one)
    assert r.state.iteration == one.state.iteration == 6 and r.batch_mode == "eager"
    assert len(r._runners) == (3 * n_tile if segments else 1)
    eager = make(_mesh(n_tile))
    for x in (eager, one):
        x.step()
    assert not torch.equal(eager._full(eager.direct), one.direct)


def test_webviewer_batched_restir_on_a_mesh(scenes):
    """The webviewer's batched mode on a mesh renderer (ReSTIR, no
    denoiser, 2 frames a display): one block through the mesh's runner,
    the display equal to the single-device renderer's."""
    from radish_pt_tpu_torch import webviewer as wv
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer

    ds, cam = scenes("cornell_box.txt")
    cam = cam.replace(width=16, height=16)
    r, one = (Renderer(ds=ds, cam=cam, settings=Settings(tracer=Tracer.RESTIR_DI),
                       device="cpu", mesh=m) for m in (_mesh(2), None))
    disp, n = wv.compute_frame(r, 2)
    assert n == 2 and r.state.iteration == 2 and len(r._runners) == 1
    assert torch.equal(disp, wv.compute_frame(one, 2)[0])


@pytest.mark.parametrize("looper", [0, 3, 9998])
def test_merge_spatial_halo_equals_full_frame(scenes, looper):
    """``merge_spatial`` on each of 3 tiles of a 24x16 frame (128 pixels,
    not whole rows), given its halo from ``halo_rows``, equals the full
    frame's rows for the tile bit for bit, the sampler included; the tile
    on its own rows alone (the eager step's seam rule) does not."""
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.sampling import rng as trng
    from torch_port_util import gbuffer_frame_arrays, gbuffer_frame_pair, reservoir_arrays
    from torch_port_util import reservoir_pair

    w, h = 24, 16
    n = w * h
    gen = np.random.default_rng(11)
    temp = reservoir_pair(reservoir_arrays(gen, n))[1]
    cur = gbuffer_frame_pair(gbuffer_frame_arrays(gen, n, n_ids=2, spread=0.3,
                                                  depth=5.0))[1]
    table = scenes("cornell_box.txt")[0].sobol
    idx = torch.arange(n, dtype=torch.int32)
    full, fs = rs.merge_spatial(temp, cur, w, h, trng.make_sampler(2, idx), table,
                                looper=looper)
    mesh = _mesh(3)
    bounds = sh.tile_bounds(mesh, n)
    part = [slice(lo, hi) for lo, hi in bounds]

    def tile(x, sl):
        return dataclasses.replace(x, **{f.name: getattr(x, f.name)[sl]
                                         for f in dataclasses.fields(x)})
    rows = [rs.spatial_rows(tile(temp, sl), tile(cur, sl), idx[sl]) for sl in part]
    alone = 0
    for t, sl in enumerate(part):
        args = (tile(temp, sl), tile(cur, sl), w, h, trng.make_sampler(2, idx[sl]), table)
        got, gs = rs.merge_spatial(*args, looper=looper, pixel_idx=idx[sl],
                                   halo=sh.halo_rows(rows, bounds, t, w, CPU))
        for f in dataclasses.fields(got):
            assert torch.equal(getattr(got, f.name), getattr(full, f.name)[sl]), (t, f.name)
        assert int(gs.ptr) == int(fs.ptr)
        own, _ = rs.merge_spatial(*args, looper=looper, pixel_idx=idx[sl])
        alone += int((own.num != full.num[sl]).sum())
    assert alone > 0 and float((full.num > 0).float().mean()) > 0.3


def test_renderer_mesh_checkpoint_roundtrip(scenes, tmp_path):
    """A checkpoint written in mesh mode (3 tiles) holds the JAX package's
    mesh layout (``n_alloc`` = 258 rows in every pixel buffer); read back
    into a new mesh renderer, the next frame equals the original's."""
    from radish_pt_tpu_torch.config import Denoiser, Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer

    ds, cam = scenes("cornell_box.txt")
    cam = cam.replace(width=16, height=16)
    settings = Settings(tracer=Tracer.RESTIR_DI, denoiser=Denoiser.SVGF)
    a = Renderer(ds=ds, cam=cam, settings=settings, device="cpu", mesh=_mesh(3))
    for _ in range(2):
        a.step()
    path = a.save_checkpoint(str(tmp_path / "mesh.npz"))
    data = np.load(path)
    for key in ("direct", "res_li", "gbuf_prim", "svgf_color"):
        assert data[key].shape[0] == 258, key
    b = Renderer(ds=ds, cam=cam, settings=Settings(tracer=Tracer.RESTIR_DI,
                                                   denoiser=Denoiser.SVGF),
                 device="cpu", mesh=_mesh(3))
    b.load_checkpoint(path)
    assert b.state.iteration == 2 and not b.first_frame
    a.step()
    b.step()
    assert torch.equal(a.current_image(), b.current_image())


def test_cli_mesh(tmp_path, monkeypatch):
    """``--mesh`` builds its mesh over the visible CUDA devices: too few
    raise with the count; two visible devices (here the CPU, twice) render,
    the path tracer frame by frame and ReSTIR in batched blocks
    (``--tracer restir --batch-spp 2``)."""
    from radish_pt_tpu_torch.cli import main
    from radish_pt_tpu_torch.parallel import sharding as sh

    args = [os.path.join(SCENES, "cornell_box.txt"), "--res", "16", "16", "--spp", "2",
            "--depth", "2", "--device", "cpu", "--out", str(tmp_path / "m.png")]
    monkeypatch.setattr(sh, "visible_devices", lambda: [])
    with pytest.raises(RuntimeError, match="0 CUDA device"):
        main(args + ["--mesh", "2"])
    monkeypatch.setattr(sh, "visible_devices", lambda: [CPU, CPU])
    assert main(args + ["--mesh", "2"]) == 0
    assert (tmp_path / "m.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    (tmp_path / "m.png").unlink()
    assert main(args + ["--mesh", "2", "--tracer", "restir", "--batch-spp", "2"]) == 0
    assert (tmp_path / "m.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        main(args + ["--mesh", "2x2"])


def test_dryrun_multichip():
    """The dry run's four checks on 4 tiles of the CPU."""
    from radish_pt_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, devices=[CPU] * 4, log=lambda s: None)
    assert out["teapot_flips"] <= 2 and out["seam_rejections"] > 0
    assert out["pt_mean"] > 0.01
