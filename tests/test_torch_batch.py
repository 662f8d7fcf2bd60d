"""Port parity for batched frames: the sampler's device pointer, the ReSTIR
spatial offsets computed on the device, ``Renderer.render_batched`` and
``step_batched_restir`` against the port's own ``step()`` sequence (bit for
bit) and against the JAX package's ``render_batched`` on the same scene
bytes, and the capturable block's freedom from host syncs.

Tolerances, each with its reason:
* the sampler and the offsets are integer and f32 elementwise chains:
  equal bit for bit;
* a batch of the port against the port's own ``step()`` frames: the same
  operations on the same inputs, equal bit for bit (``torch.equal``);
* the port's batched path tracer against the JAX package's: the frames'
  tolerances of tests/test_torch_pathtrace.py and test_torch_restir.py.
  On cornell (both on the brute-force engine) at most one pixel a frame
  beyond rtol 1e-5, atol 1e-6: a shadow ray at a grazing cosine, which
  the last ulp of the reference's fused arithmetic blocks or not.  Such a
  pixel carries the cosine as its weight (measured up to 7e-3 on a frame,
  tests/test_torch_restir.py): held to 1e-2, and the mean absolute
  difference below 1e-5;
  on teapot (the port's Plücker sweep, its plain version on the CPU,
  against the reference's brute force) edge-exact ties may resolve
  differently, so the bound is on the mean (2e-2);
* the port's batched ReSTIR against the JAX package's: a weighted
  reservoir's take compares ``rand * weight < w``, so a 1-ulp difference
  can swap a pixel's winner and reuse spreads it: the share of pixels
  that differ (<= 2%) and the mean absolute difference (< 2e-3), as
  tests/test_torch_restir.py holds chained frames.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
from torch_port_util import SCENES, camera_from_jax, jax_scene_parts, t2n  # noqa: E402

RES, DEPTH = 32, 3


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


# ---------------------------------------------------------------------------
# the sampler's pointer on the device
# ---------------------------------------------------------------------------


POINTERS = np.concatenate([[-7, -1, 0, 1, 199, 200], np.arange(54) * 37_041 + 3,
                           [10_000 * 200 - 2, 10_000 * 200 - 1, 10_000 * 200,
                            10_000 * 200 + 5]]).astype(np.int64)


@pytest.mark.parametrize("mode", ["sobol", "hash"])
def test_sampler_tensor_ptr_matches_int_ptr(mode):
    """One draw at each of 64 pointers (the clamp at both ends of the
    table included) on 1000 lanes: the port's 0-d tensor ``ptr`` gives
    the JAX package's int32 pointer's bits, and in Sobol mode the bits of
    ``table[clip(ptr)] ^ scramble`` computed in numpy."""
    from radish_pt_tpu.sampling import rng as jrng
    from radish_pt_tpu.sampling.sobol import load_sobol_table as jax_table
    from radish_pt_tpu_torch.sampling import rng

    table = jax_table() if mode == "sobol" else None
    ttable = None if table is None else torch.from_numpy(table.astype(np.int64))
    idx = np.arange(1000, dtype=np.int32) * 13 + 5
    scramble = rng.make_sampler(0, torch.from_numpy(idx)).scramble
    assert len(POINTERS) == 64
    for ptr in POINTERS:
        tr, ts = rng.sample_1d(ttable, rng.SamplerState(
            scramble=scramble, ptr=torch.tensor(int(ptr))))
        js = jrng.SamplerState(scramble=jnp.asarray(t2n(scramble).astype(np.uint32)),
                               ptr=jnp.asarray(ptr, jnp.int32))
        jr, js = jrng.sample_1d(None if table is None else jnp.asarray(table), js)
        np.testing.assert_array_equal(t2n(tr).view(np.int32),
                                      np.asarray(jr).view(np.int32), err_msg=str(ptr))
        assert int(ts.ptr) == ptr + 1 == int(js.ptr)
        if table is not None:
            flat = table.reshape(-1)
            want = (flat[np.clip(ptr, 0, flat.size - 1)].astype(np.int64)
                    ^ t2n(scramble)).astype(np.float32) * np.float32(2.0**-32)
            np.testing.assert_array_equal(t2n(tr).view(np.int32), want.view(np.int32))


def test_make_sampler_takes_a_looper_tensor():
    from radish_pt_tpu_torch.sampling import rng

    idx = torch.arange(64, dtype=torch.int32)
    for looper in (0, 7, 9999):
        a = rng.make_sampler(looper, idx)
        b = rng.make_sampler(torch.tensor(looper), idx)
        assert a.ptr.dtype == b.ptr.dtype == torch.int64 and a.ptr.dim() == 0
        assert int(a.ptr) == int(b.ptr) == looper * 200
        assert torch.equal(a.scramble, b.scramble)


# ---------------------------------------------------------------------------
# the spatial offsets and the gathered fetch
# ---------------------------------------------------------------------------


def _offsets_numpy(loopers, k):
    """The shared offsets on the host in numpy: the uint32 hash chain, the
    disk warp in f32, rounded half to even."""
    def utilhash(a):
        a = a.astype(np.uint32)
        a = (a + np.uint32(0x7ED55D16)) + (a << np.uint32(12))
        a = (a ^ np.uint32(0xC761C23C)) ^ (a >> np.uint32(19))
        a = (a + np.uint32(0x165667B1)) + (a << np.uint32(5))
        a = (a + np.uint32(0xD3A2646C)) ^ (a << np.uint32(9))
        a = (a + np.uint32(0xFD7046C5)) + (a << np.uint32(3))
        return (a ^ np.uint32(0xB55A4F09)) ^ (a >> np.uint32(16))

    with np.errstate(over="ignore"):
        h1 = utilhash(loopers.astype(np.uint32) * np.uint32(31) + np.uint32(2 * k + 1))
        h2 = utilhash(h1 ^ np.uint32(0x9E3779B9))
    u1 = h1.astype(np.float32) * np.float32(2.0**-32)
    u2 = h2.astype(np.float32) * np.float32(2.0**-32)
    r, theta = np.sqrt(u1), np.float32(2.0 * np.pi) * u2
    p = np.stack([r * np.cos(theta), r * np.sin(theta)], -1).astype(np.float32) * np.float32(5)
    return np.round(p).astype(np.int32)


def test_shared_offsets_match_host_and_reference():
    """``_shared_offset`` on a looper tensor, for every looper 0-9,999 and
    neighbour 0-4: equal to the numpy host version and to the JAX
    package's ``utilhash`` / ``concentric_sample_disk`` chain (its
    ``merge_spatial``).  The nearest any offset comes to a rounding edge
    is 4.1e-6, 17 ulps at that magnitude: the libraries' sine and cosine
    cannot turn a rounding."""
    from radish_pt_tpu.utils import math as jm
    from radish_pt_tpu_torch.render import restir as rs

    loopers = np.arange(10_000)
    dx, dy = rs._shared_offset(torch.from_numpy(loopers)[:, None], torch.arange(5))
    got = np.stack([t2n(dx), t2n(dy)], -1)  # [10000, 5, 2]
    for k in range(5):
        np.testing.assert_array_equal(got[:, k], _offsets_numpy(loopers, k))
        h1 = jm.utilhash(jnp.asarray(loopers, jnp.uint32) * 31 + jnp.uint32(2 * k + 1))
        h2 = jm.utilhash(h1 ^ jnp.uint32(0x9E3779B9))
        p = jm.concentric_sample_disk(h1.astype(jnp.float32) * jnp.float32(2.0**-32),
                                      h2.astype(jnp.float32) * jnp.float32(2.0**-32)) * 5.0
        np.testing.assert_array_equal(got[:, k], np.asarray(jnp.round(p).astype(jnp.int32)))
    assert set(np.unique(got[..., 0])) == set(range(-5, 6))
    assert (got == 0).all(-1).any()  # a zero offset: the neighbour is the pixel


@pytest.mark.parametrize("shape", [(8, 16), (5, 7)])
def test_gathered_fetch_equals_roll(shape):
    """The spatial merge's gather at ((y + dy) mod H) * W + (x + dx) mod W
    brings the bytes ``torch.roll`` by (-dy, -dx) brings, for every offset
    in the disk's range."""
    h, w = shape
    n = h * w
    img = torch.from_numpy(np.random.default_rng(3).normal(size=(n, 15)).astype(np.float32))
    idx = torch.arange(n, dtype=torch.int32)
    x, y = idx % w, idx // w
    for dy in range(-5, 6):
        for dx in range(-5, 6):
            src = (torch.remainder(y + torch.tensor(dy, dtype=torch.int32), h) * w
                   + torch.remainder(x + torch.tensor(dx, dtype=torch.int32), w))
            want = torch.roll(img.reshape(h, w, 15), shifts=(-dy, -dx), dims=(0, 1))
            assert torch.equal(img[src.long()], want.reshape(n, 15))


@pytest.mark.parametrize("looper", [3, 9998])
def test_merge_spatial_looper_tensor_matches(cornell, looper):
    """The rolled branch of ``merge_spatial`` with a looper tensor equals
    the int looper's result and the JAX package's roll, bit for bit."""
    from radish_pt_tpu.render import restir as jrs
    from radish_pt_tpu.sampling import rng as jrng
    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.sampling import rng as trng
    from torch_port_util import gbuffer_frame_arrays, gbuffer_frame_pair, reservoir_arrays
    from torch_port_util import reservoir_pair

    jds, _, ds, _ = cornell
    rng = np.random.default_rng(8)
    n = RES * RES
    jres, tres = reservoir_pair(reservoir_arrays(rng, n))
    jcur, tcur = gbuffer_frame_pair(gbuffer_frame_arrays(rng, n, n_ids=2, spread=0.3,
                                                         depth=5.0))
    idx = np.arange(n, dtype=np.int32)
    outs = [rs.merge_spatial(tres, tcur, RES, RES, trng.make_sampler(2, torch.from_numpy(idx)),
                             ds.sobol, looper=lp)[0]
            for lp in (looper, torch.tensor(looper))]
    jo, _ = jrs.merge_spatial(jres, jcur, RES, RES, jrng.make_sampler(2, jnp.asarray(idx)),
                              jds.sobol, looper=looper)
    for f in ("li", "wi", "dist", "num", "weight"):
        a, b = (t2n(getattr(o, f)) for o in outs)
        np.testing.assert_array_equal(a, b, err_msg=f)
        np.testing.assert_array_equal(a, np.asarray(getattr(jo, f)), err_msg=f)
    assert float((outs[0].num > 0).float().mean()) > 0.3


# ---------------------------------------------------------------------------
# batched frames
# ---------------------------------------------------------------------------


def _renderer(ds, cam, **settings):
    from radish_pt_tpu_torch.config import Settings
    from radish_pt_tpu_torch.render.renderer import Renderer

    return Renderer(ds=ds, cam=cam, desc=None, settings=Settings(**settings), device="cpu")


def _jax_renderer(jds, jcam, **settings):
    from radish_pt_tpu.config import Settings
    from radish_pt_tpu.render.renderer import Renderer

    return Renderer(ds=jds, cam=jcam, desc=None, settings=Settings(**settings))


def _assert_same_state(a, b):
    """Two port renderers' progressive state, bit for bit."""
    for name in ("direct", "indirect"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for f in ("li", "wi", "dist", "num", "weight"):
        assert torch.equal(getattr(a.reservoir, f), getattr(b.reservoir, f)), f
    assert a.state.iteration == b.state.iteration
    assert a.state.looper == b.state.looper


@pytest.fixture(scope="module")
def teapot():
    """(JAX teapot on its brute-force engine at 32x32, its camera, the
    port's teapot on the Plücker engine, the port's camera)."""
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax
    from torch_port_util import load_jax_scene

    mp = pytest.MonkeyPatch()
    try:
        jds, jcam, _ = load_jax_scene(mp, "teapot.txt")
    finally:
        mp.undo()
    ds = scene_from_jax(*jax_scene_parts(jds), intersector="plucker")
    jcam = jcam.replace(width=RES, height=RES)
    return jds.replace(intersector="brute"), jcam, ds, camera_from_jax(jcam)


@pytest.mark.parametrize("scene", ["cornell", "teapot"])
def test_render_batched_pt_matches_steps_and_reference(scene, request):
    """``render_batched(4, block=2)`` of the path tracer: equal to four
    ``step()`` calls bit for bit, with the same bookkeeping, and to the
    JAX package's ``render_batched(4, block=2)`` within the frames'
    tolerance (module docstring)."""

    jds, jcam, ds, cam = request.getfixturevalue(scene)
    a = _renderer(ds, cam, trace_depth=DEPTH)
    for _ in range(4):
        a.step()
    b = _renderer(ds, cam, trace_depth=DEPTH)
    tally = Tally()
    img = b.render_batched(4, block=2)
    assert b.batch_mode == "eager"  # CPU tensors: no graph
    _assert_same_state(a, b)
    assert b.state.iteration == 4 and b.last_runner.replays == 0
    if scene == "teapot":  # the sweep engine's plain version ran
        assert tally("plain.plucker") == {"closest_hit": 4 * (DEPTH + 1), "occlusion": 4 * DEPTH}
        assert tally("launch.plucker") == {}

    jr = _jax_renderer(jds, jcam, trace_depth=DEPTH)
    want = jr.render_batched(4, block=2)
    assert img.shape == want.shape == (RES, RES, 3)
    assert want.mean() > 1e-2
    if scene == "cornell":
        for got, ref in ((t2n(b.direct), np.asarray(jr.direct)),
                         (t2n(b.indirect), np.asarray(jr.indirect))):
            off = np.abs(got - ref) > 1e-6 + 1e-5 * np.abs(ref)
            assert off.any(axis=-1).sum() <= 4  # at most one pixel a frame
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)
            assert np.abs(got - ref).mean() < 1e-5
    else:
        assert np.abs(img - want).mean() < 2e-2


def test_render_batched_restir_matches_steps_and_reference(cornell):
    """ReSTIR DI (T+S reuse, 32 candidates) as tests/test_restir.py holds
    the JAX package's batch, across packages: ``render_batched(4,
    block=2)`` equals four ``step()`` calls, then a camera move at the
    batch boundary (frame 0 of the next batch reprojects through the old
    camera) and one more batch equals two more steps, bit for bit; the
    G-buffer the batch hands on equals the steps'.  Against the JAX
    package's same sequence: the ReSTIR bounds (module docstring)."""
    from radish_pt_tpu_torch.config import Tracer

    jds, jcam, ds, cam = cornell
    a = _renderer(ds, cam, tracer=Tracer.RESTIR_DI)
    b = _renderer(ds, cam, tracer=Tracer.RESTIR_DI)
    jr = _jax_renderer(jds, jcam, tracer=Tracer.RESTIR_DI)
    for _ in range(4):
        a.step()
    b.render_batched(4, block=2)
    jr.render_batched(4, block=2)
    _assert_same_state(a, b)
    new_pos = t2n(a.cam.position) + np.array([0.05, 0.0, 0.0], np.float32)
    for r in (a, b, jr):
        r.update_camera(position=new_pos)
    for _ in range(2):
        a.step()
    b.render_batched(2, block=2)
    jr.render_batched(2, block=2)
    _assert_same_state(a, b)
    for f in ("normal", "prim_id", "depth"):
        assert torch.equal(getattr(a.gbuf_last, f), getattr(b.gbuf_last, f)), f
    assert torch.equal(a.gbuf.motion, b.gbuf.motion)  # motion of the steady frames

    got, want = t2n(b.direct), np.asarray(jr.direct)
    assert np.isfinite(got).all() and want.mean() > 0.05
    off = np.abs(got - want).max(axis=-1) > 1e-5 + 1e-4 * np.abs(want).max(axis=-1)
    assert off.mean() <= 0.02, off.mean()
    assert np.abs(got - want).mean() < 2e-3


def test_step_batched_restir_matches_steps(cornell):
    """``step_batched_restir(3)``: the same three frames as ``step()``,
    the display image of the last, and the lazily rendered G-buffer of the
    last camera when the frame before rendered none."""
    from radish_pt_tpu_torch.config import Tracer

    _, _, ds, cam = cornell
    a = _renderer(ds, cam, tracer=Tracer.RESTIR_DI)
    b = _renderer(ds, cam, tracer=Tracer.RESTIR_DI)
    for r in (a, b):  # a path-traced frame first: it leaves no G-buffer
        r.settings.tracer = Tracer.STREAMED
        r.step()
        assert r.gbuf_last is None
        r.settings.tracer = Tracer.RESTIR_DI
    for _ in range(3):
        disp_a = a.step()
    disp_b = b.step_batched_restir(3)
    _assert_same_state(a, b)
    assert torch.equal(disp_a, disp_b) and disp_b.dtype == torch.uint8


@pytest.mark.parametrize("start", ["first_call", "after_a_path_traced_frame"])
def test_step_batched_restir_hands_svgf_the_frame_before(cornell, start):
    """``step_batched_restir(1)`` with SVGF and the orbiting camera equals
    ``step()`` call for call over four calls, bit for bit: the display,
    the denoised image and the SVGF history.  The denoiser after a block
    reads the G-buffer frame from before the block (the one its motion
    reprojects into) and a first-frame flag that is True on the first
    call, as ``step()`` gives them.  The second case starts after a
    path-traced frame that left no G-buffer, so the frame before is the
    one rendered for the last camera."""
    from radish_pt_tpu_torch.config import Denoiser, Tracer

    _, _, ds, cam = cornell
    kw = dict(tracer=Tracer.RESTIR_DI, denoiser=Denoiser.SVGF, animate_camera=True,
              animate_radius=2.0, animate_speed=1.0, trace_depth=DEPTH)
    a, b = _renderer(ds, cam, **kw), _renderer(ds, cam, **kw)
    if start == "after_a_path_traced_frame":
        for r in (a, b):
            r.settings.tracer, r.settings.denoiser = Tracer.STREAMED, Denoiser.NONE
            r.step()
            assert r.gbuf_last is None and not r.first_frame
            r.settings.tracer, r.settings.denoiser = Tracer.RESTIR_DI, Denoiser.SVGF
    tally = Tally()
    for k in range(4):
        disp_a, disp_b = a.step(), b.step_batched_restir(1)
        _assert_same_state(a, b)
        assert torch.equal(disp_a, disp_b), k
        assert torch.equal(a._last_image, b._last_image), k
        for f in ("accum_color", "accum_moment"):
            assert torch.equal(getattr(a.svgf_direct, f), getattr(b.svgf_direct, f)), (k, f)
    assert float(b.svgf_direct.accum_moment[:, 2].max()) >= 3.0  # histories grew
    assert tally("denoise") == {"svgf": 8, "svgf_level": 40,
                                "svgf_pixels": 8 * cam.width * cam.height}
    marks = tally("marks")
    assert [marks.get(s) for s in ("denoise", "svgf_levels", "denoise_end")] == [8, 8, 8]


def test_render_batched_refuses_other_tracers(cornell):
    from radish_pt_tpu_torch.config import Tracer

    _, _, ds, cam = cornell
    with pytest.raises(ValueError, match="path tracer and ReSTIR"):
        _renderer(ds, cam, tracer=Tracer.DIRECT_LIGHT).render_batched(2, block=2)


def test_batch_mode_is_decided_by_engine_and_device(cornell):
    """The graph needs the card and a capturable engine (scene/engines.py);
    the compact engine, the plain engines and every CPU scene run eagerly."""
    from types import SimpleNamespace

    from radish_pt_tpu_torch.render import graph as gr
    from radish_pt_tpu_torch.scene import engines

    _, _, ds, _ = cornell
    capturable = {n for n, e in engines.ENGINES.items() if e.capturable}
    assert capturable == {"plucker", "band", "quad", "dense", "bvh"}
    for engine in ("plucker", "band", "quad", "dense", "bvh", "compact", "plucker_plain",
                   "bvh_plain", "brute"):
        on_card = SimpleNamespace(intersector=engine, device=torch.device("cuda"))
        want = "graph" if engine in capturable else "eager"
        assert gr.batch_mode(on_card) == want
        assert gr.batch_mode(ds.replace(intersector=engine)) == "eager"


# ---------------------------------------------------------------------------
# the capturable block makes no host sync
# ---------------------------------------------------------------------------


# what copies from or to the host, or reads a device value on it: none may
# run inside a captured block (the kernels' plain versions, which stand in
# for the kernels on the CPU, are exempt)
HOST_SYNCS = {"item", "tolist", "__bool__", "__int__", "__float__", "__index__",
              "nonzero", "tensor", "as_tensor", "numpy", "cpu", "unique", "masked_select",
              "argwhere"}


class _HostSyncGuard(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.exempt = 0
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        if not self.exempt:
            bad = name in HOST_SYNCS or (name == "where" and len(args) + len(kwargs) == 1)
            if name in ("__getitem__", "__setitem__") and len(args) > 1:
                index = args[1] if isinstance(args[1], tuple) else (args[1],)
                bad |= any(isinstance(i, (list, np.ndarray)) or (
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool) for i in index)
            if bad:
                self.seen.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("engine,scene", [("plucker", "cornell_box.txt"),
                                          ("quad", "teapot.txt"),
                                          ("dense", "cornell_box.txt"),
                                          ("plucker", "env_teapot.txt"),
                                          ("plucker", "glass.txt"),
                                          ("bvh", "teapot.txt")])
def test_capturable_block_makes_no_host_sync(engine, scene, monkeypatch):
    """A block of path-traced and of ReSTIR frames on each capturable
    engine (16x16, depth 2), run once to build the cached constants, then
    again under a guard that records every call that would copy from the
    host or read a device value on it: none, so the block can be captured
    as a CUDA graph."""
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import dense as dns
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import quad as qd
    from radish_pt_tpu_torch.accel import traverse as trv
    from radish_pt_tpu_torch.config import Tracer
    from radish_pt_tpu_torch.scene.build import load_scene

    guard = _HostSyncGuard()

    def exempt(fn):
        def run(*args, **kwargs):
            guard.exempt += 1
            try:
                return fn(*args, **kwargs)
            finally:
                guard.exempt -= 1
        return run

    for mod in (plk, bnd, qd, dns, trv):
        for name in dir(mod):
            if name.endswith("_plain") and callable(getattr(mod, name)):
                monkeypatch.setattr(mod, name, exempt(getattr(mod, name)))
    ds, cam, _ = load_scene(os.path.join(SCENES, scene), device="cpu", intersector=engine)
    cam = cam.replace(width=16, height=16)
    for tracer in (Tracer.STREAMED, Tracer.RESTIR_DI):
        r = _renderer(ds, cam, tracer=tracer, trace_depth=2, reservoir_size=4)
        r.run_block(2)
        with guard:
            r.run_block(2)
        assert guard.seen == [], (tracer, guard.seen)


def test_capturable_mesh_restir_block_makes_no_host_sync():
    """The mesh's batched ReSTIR block over 3 tiles on one device (24x16,
    tiles of 128 pixels, the dense engine): the whole block, exchanges
    included, is what the card captures as one graph, and it makes no host
    sync once its constants are built."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cpu",
                            intersector="dense")
    cam = cam.replace(width=24, height=16)
    mesh = sh.make_mesh(3, devices=[torch.device("cpu")] * 3)
    r = Renderer(ds=ds, cam=cam, desc=None, device="cpu", mesh=mesh,
                 settings=Settings(tracer=Tracer.RESTIR_DI, reservoir_size=4))
    r.run_block(2)
    guard = _HostSyncGuard()
    with guard:
        r.run_block(2)
    assert guard.seen == [] and len(r._runners) == 1
