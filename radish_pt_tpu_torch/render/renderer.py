"""Frame-loop driver: the port of ``radish_pt_tpu/render/renderer.py``.

Per frame (reference main.cpp:163-202): optional camera animation, the
G-buffer, the tracer — full-MIS path tracing (``STREAMED`` and its alias
``SINGLE_KERNEL``), one-bounce direct lighting (``DIRECT_LIGHT``), ReSTIR
DI (``RESTIR_DI`` or ``use_reservoir``), the G-buffer preview or the BVH
heatmap (``BVH_VISUALIZE``) — then
scrub, range-compress and fold into the running mean, an optional
denoiser (Gaussian, EAW, SVGF; the path tracer's direct and indirect
halves through the split-SVGF pair), and tonemap for display.  All buffers
live on the renderer's ``device``.

The G-buffer is rendered only on frames whose tracer or denoiser reads it
(the JAX renderer renders it every frame, and nothing else reads it).  It
depends only on the scene and the camera, so a frame that needs last
frame's G-buffer after a frame without one renders it for ``last_cam``:
the same bytes the JAX renderer would have kept.

Batched frames (:meth:`Renderer.render_batched`,
:meth:`Renderer.step_batched_restir`) run ``block`` frames of the path
tracer or of ReSTIR DI as one block (:func:`_pt_batch`,
:func:`_restir_batch`, the JAX renderer's ``fori_loop`` programs): on the
card with a capturable engine the block is one CUDA graph, captured once
and replayed (render/graph.py); ``Renderer.batch_mode`` says which.
``step_batched_restir``'s SVGF runs after the block as a block of its own
(one more graph).  A replayed block equals the same frames run by
:meth:`Renderer.step`, bit for bit.

Mesh mode (``Renderer(mesh=...)``, parallel/sharding.py): the pixel
buffers are padded to the tile count and held one tensor a tile on the
tiles' devices, the scene is replicated, and :meth:`Renderer.step` runs
the path tracer or ReSTIR DI tile by tile; the denoiser, the display and
the saved image gather the tiles on the renderer's ``device`` (the
denoiser's result is the single-device filter's, exactly).  Batched path
tracer blocks run one block a tile, each its own block runner (one CUDA
graph a tile on the card).  Batched ReSTIR blocks exchange the reservoirs
across the seams and equal one device's frames bit for bit
(``sharding.restir_batch_sharded``): one runner over all tiles when they
share a device, a runner a (stage, tile) when they span devices.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch

from ..config import Denoiser, RenderState, Settings, Tracer
from ..sampling.sobol import SOBOL_SAMPLE_NUM
from ..scene import camera as cam_mod
from ..scene import engines
from ..scene.build import load_scene
from ..scene.image_io import save_image, write_hdr
from ..utils import math as m
from ..utils import timing as tracing
from ..utils.timing import PassTimer
from . import denoise as dn
from . import gbuffer as gb
from . import graph as gr
from . import pathtrace as pt
from . import post
from . import restir as rs

def _pt_batch(ds, cam, looper0, direct, indirect, iteration, pixel_idx=None, *,
              max_depth: int, block: int):
    """``block`` full-PT samples accumulated: frame k at looper ``looper0 +
    k`` (no wrap inside a block, as the JAX batch) and iteration
    ``iteration + k``; ``looper0`` int64 and ``iteration`` f32 0-d tensors.
    Returns (direct, indirect).  On one tile of a mesh (``pixel_idx``) the
    frame's direct + indirect, scrubbed, go into ``direct``, as the mesh's
    :meth:`Renderer.step` accumulates them, and ``indirect`` is None.  On
    an engine whose blocks are captured as a CUDA graph (``capturable``,
    scene/engines.py, on any device, so that the CPU runs the body the card
    captures) the frames run the dense bounce loop with the sorted sweeps
    (``n_slices=0``): the sliced loop reads its live count on the host.
    The compact engine's eager blocks run the sliced loop where
    ``path_trace`` gates it; both loops give the same bits."""
    n_slices = 0 if engines.of(ds).capturable else None
    for k in range(block):
        d, ind = pt.path_trace(ds, cam, looper0 + k, max_depth, pixel_idx, n_slices=n_slices)
        if pixel_idx is not None:
            d, ind = d + ind, None
        direct = pt.accumulate(direct, pt.scrub_and_compress(d), iteration + k)
        if ind is not None:
            indirect = pt.accumulate(indirect, pt.scrub_and_compress(ind), iteration + k)
    tracing.mark("end", ds.device)
    return direct, indirect


def _restir_batch(ds, cam, last_cam, looper0, gbuf_last, reservoir, first_frame, direct,
                  iteration, *, reuse: int, reservoir_size: int, clamp: int,
                  encode_normal: bool, block: int):
    """``block`` ReSTIR frames with a static camera, the reservoir carried
    from frame to frame.  The G-buffer is rendered once: frame 0 uses its
    motion through the pre-batch ``last_cam`` and the caller's
    ``gbuf_last`` and ``first_frame`` (a bool 0-d tensor), frames k > 0
    the motion through ``cam`` itself and the batch's own G-buffer, so a
    batch boundary behaves as the unbatched frames, a camera move before
    it included.  Returns (direct, reservoir, gbuf): ``gbuf`` is the
    caller's next ``gbuf_last``."""
    gbuf, motion_ss = gb.render_gbuffer(ds, cam, last_cam, encode_normal=encode_normal,
                                        extra_motion_cam=cam)
    steady = dataclasses.replace(gbuf, motion=motion_ss)
    for k in range(block):
        d, reservoir = rs.restir_direct(
            ds, cam, looper0 + k, gbuf if k == 0 else steady,
            gbuf_last if k == 0 else gbuf.frame, reservoir,
            first_frame if k == 0 else False, reuse, reservoir_size, clamp)
        direct = pt.accumulate(direct, pt.scrub_and_compress(d), iteration + k)
    tracing.mark("end", ds.device)
    return direct, reservoir, gbuf


def _frame_copy(frame):
    """A copy of a G-buffer frame, or of a mesh's list of tile frames."""
    if isinstance(frame, list):
        return [_frame_copy(f) for f in frame]
    return gb.GBufferFrame(normal=frame.normal.clone(), prim_id=frame.prim_id.clone(),
                           depth=frame.depth.clone())


class Renderer:
    """Stateful frame driver around the render passes."""

    # AOV names of the reference's denoiser Preview combo
    # (preview.cpp:254-276); "composed" is the normal display path
    PREVIEW_AOVS = (
        "composed", "input_direct", "input_indirect", "output_direct",
        "output_indirect", "direct_moment", "indirect_moment",
        "direct_variance", "indirect_variance",
    )

    def __init__(self, scene_path: str | None = None, ds=None, cam=None,
                 desc=None, settings: Settings | None = None, device="cuda",
                 timing: bool = False, mesh=None):
        """``mesh`` (a ``parallel.sharding.Mesh``): render tile-sharded over
        its devices; ``device`` is where the tiles are gathered for the
        denoiser and the display."""
        self.device = torch.device(device)
        if scene_path is not None:
            ds, cam, desc = load_scene(scene_path, device=self.device)
        self.ds = ds.to(self.device)
        self.cam = cam.to(self.device)
        self.last_cam = self.cam
        self.settings = settings or (desc.settings if desc else Settings())
        self.state = desc.state if desc else RenderState()
        self.timer = PassTimer(enabled=timing, device=self.device)
        # raise on the first frame whose tracer output holds a non-finite
        # value before the scrub (the CLI's --debug-nans)
        self.debug_nans = False
        n = self.n_pixels = cam.width * cam.height
        self.mesh = mesh
        if mesh is not None:
            from ..parallel import sharding as sh

            n = sh._padded_pixel_count(cam, mesh.shape["tile"])
            self._scenes = sh.replicate_scene(mesh, self.ds)
            self._tile_idx = sh.tile_pixels(mesh, cam)
        self.n_alloc = n  # pixel rows of the buffers (checkpoint layout)
        self.direct = torch.zeros((n, 3), dtype=torch.float32, device=self.device)
        self.indirect = torch.zeros_like(self.direct)
        self.gbuf = None
        self.gbuf_last = gb.empty_frame(n, encode_normal=self.settings.encode_normal,
                                        device=self.device)
        self.reservoir = rs.empty_reservoir(n, device=self.device)
        # the denoisers' histories stay whole on ``device`` in mesh mode
        self.svgf_direct = dn.empty_svgf_state(self.n_pixels, device=self.device)
        self.svgf_indirect = dn.empty_svgf_state(self.n_pixels, device=self.device)
        # the mesh's batched ReSTIR: one captured segment a (stage, tile),
        # the exchanges' copies between them (parallel/sharding.py), when the
        # tiles span devices; else the whole block is one runner
        self.mesh_segments = False
        if mesh is not None:  # one tensor a tile, on the tiles' devices
            self.direct, self.indirect, self.gbuf_last, self.reservoir = (
                sh.shard_image(mesh, x) for x in (self.direct, self.indirect,
                                                  self.gbuf_last, self.reservoir))
            self.mesh_segments = len(set(mesh.tile_devices)) > 1
        self.first_frame = True
        tracing.host_sync()
        self._orig_cam_pos = self.cam.position.cpu().numpy()
        self._time = 0.0
        self._last_image = None
        self._split_out = None
        self._svgf_indirect_live = False
        self._runners = {}  # batch key -> (scene, gr.BlockRunner)
        self.last_runner = None  # the BlockRunner of the last batched block

    @property
    def batch_mode(self) -> str:
        """How a block of batched frames runs here: "graph" (one CUDA graph,
        replayed) or "eager" (render/graph.py)."""
        return gr.batch_mode(self.ds)

    def _uses_restir(self) -> bool:
        s = self.settings
        return s.tracer == Tracer.RESTIR_DI or s.use_reservoir

    def _needs_gbuffer(self) -> bool:
        """Whether this frame's tracer or denoiser reads the G-buffer."""
        s = self.settings
        return (self._uses_restir() or s.tracer == Tracer.GBUFFER_PREVIEW
                or s.denoiser in (Denoiser.EA_WAVELET, Denoiser.SVGF))

    # ------------------------------------------------------------------
    # camera
    # ------------------------------------------------------------------

    def reset_accumulation(self):
        self.state.iteration = 0

    def update_camera(self, **kwargs):
        """Set camera parameters (position, rotation, ...) and reset the
        accumulation — the State::camChanged path (main.cpp:177-182)."""
        with tracing.span("frame.camera"):
            cam = self.cam
            with tracing.span("frame.camera_upload"):
                for k, v in kwargs.items():  # copies from pageable memory: the host waits
                    tracing.host_sync()
                    cam = cam.replace(**{k: torch.as_tensor(np.asarray(v, np.float32),
                                                            device=self.device)})
            self.cam = cam_mod.update_camera(cam)
            tracing.host_sync()
            self._orig_cam_pos = self.cam.position.cpu().numpy()
        self.reset_accumulation()

    def _animate_camera(self, dt: float = 1.0 / 60.0):
        """Circle the camera about its start (Settings::animateCamera).
        The new eye is copied from pageable host memory, which waits for
        the card: one host sync a call (span ``frame.camera_upload``)."""
        s = self.settings
        with tracing.span("frame.camera"):
            self._time += dt * s.animate_speed
            offset = np.array([np.cos(self._time), 0.0, np.sin(self._time)],
                              np.float32) * s.animate_radius
            with tracing.span("frame.camera_upload"):
                tracing.host_sync()
                pos = torch.from_numpy(self._orig_cam_pos + offset).to(self.device)
            self.cam = cam_mod.update_camera(self.cam.replace(position=pos))
        self.reset_accumulation()

    # ------------------------------------------------------------------
    # frame loop
    # ------------------------------------------------------------------

    def _check_finite(self, what, *images):
        """With ``debug_nans``: raise if a tracer output holds a non-finite
        value (before the scrub zeroes it)."""
        if self.debug_nans:
            for img in images:
                tracing.host_sync()
                if not bool(torch.isfinite(img).all()):
                    raise FloatingPointError(
                        f"non-finite {what} output at iteration {self.state.iteration}, "
                        f"looper {self.state.looper}")

    def _ensure_gbuf_last(self):
        """The G-buffer of ``last_cam`` when the last frame rendered none."""
        if self.gbuf_last is not None:
            return
        enc = self.settings.encode_normal
        if self.mesh is None:
            self.gbuf_last = gb.render_gbuffer(self.ds, self.last_cam, self.last_cam,
                                               encode_normal=enc).frame
        else:
            from ..parallel import sharding as sh

            self.gbuf_last = [g.frame for g in sh.gbuffer_sharded(
                self.mesh, self._scenes, self.last_cam, self.last_cam, enc)]

    def _full(self, x):
        """A mesh renderer's tile-sharded state (a list of tiles) gathered
        on ``device``, the padding dropped; anything else as it is."""
        if not isinstance(x, list):
            return x
        from ..parallel import sharding as sh

        return sh.gather(x, self.device, self.n_pixels)

    def step(self):
        """Render one frame; returns the uint8 display image [H, W, 3] as a
        tensor on the renderer's device."""
        with tracing.call("call.step"):
            if self.mesh is not None:
                return self._step_sharded()
            return self._step()

    def _display(self, image):
        """The uint8 display image of the HDR ``image`` [N, 3]."""
        with tracing.span("frame.display"):
            return post.to_display(image.reshape(self.cam.height, self.cam.width, 3),
                                   tone_mapping=self.settings.tone_mapping)

    def _step(self):
        s, st, timer = self.settings, self.state, self.timer
        if s.animate_camera:
            self._animate_camera()
        if not s.accumulate:
            self.reset_accumulation()

        self.gbuf = None
        if self._needs_gbuffer():
            with timer.time("gbuffer"):
                self._ensure_gbuf_last()
                self.gbuf = gb.render_gbuffer(self.ds, self.cam, self.last_cam,
                                              encode_normal=s.encode_normal)

        denoised = False
        if self._uses_restir():
            with timer.time("restir"):
                d, self.reservoir = rs.restir_direct(
                    self.ds, self.cam, st.looper, self.gbuf, self.gbuf_last,
                    self.reservoir, self.first_frame, s.reservoir_reuse,
                    s.reservoir_size, s.temporal_clamp)
                self._check_finite("ReSTIR", d)
                self.direct = pt.accumulate(self.direct, pt.scrub_and_compress(d),
                                            st.iteration)
            image = self.direct
        elif s.tracer == Tracer.BVH_VISUALIZE:
            with timer.time("bvh_heatmap"):
                image = self._bvh_heatmap()
        elif s.tracer == Tracer.GBUFFER_PREVIEW:
            image = self._gbuffer_view()
        elif s.tracer in (Tracer.STREAMED, Tracer.SINGLE_KERNEL):
            with timer.time("pathtrace"):
                d, ind = pt.path_trace(self.ds, self.cam, st.looper, s.trace_depth)
                self._check_finite("path tracer", d, ind)
                self.direct = pt.accumulate(self.direct, pt.scrub_and_compress(d),
                                            st.iteration)
                self.indirect = pt.accumulate(self.indirect, pt.scrub_and_compress(ind),
                                              st.iteration)
            # direct and indirect go through the denoiser apart: the
            # reference filters each with its own SpatioTemporalFilter
            # (main.cpp:95-97, DENOISER_SPLIT_DIRECT_INDIRECT common.h:10)
            tracing.mark("end", self.device)
            with timer.time("denoise"):
                image = self._apply_denoiser(self.direct, (self.gbuf_last, self.first_frame),
                                             self.indirect)
            denoised = True
        else:  # the direct-light tracer (the reference demo loop's default)
            with timer.time("pt_direct"):
                d = pt.path_trace_direct(self.ds, self.cam, st.looper)
                self._check_finite("direct tracer", d)
                self.direct = pt.accumulate(self.direct, pt.scrub_and_compress(d),
                                            st.iteration)
            image = self.direct
        if not denoised:
            tracing.mark("end", self.device)
            with timer.time("denoise"):
                image = self._apply_denoiser(image, (self.gbuf_last, self.first_frame))
        self._last_image = image
        with timer.time("display"):
            disp = self._display(image)

        # frame bookkeeping (main.cpp:199-200, pathtrace.cu:380-384)
        st.iteration += 1
        st.looper = (st.looper + 1) % SOBOL_SAMPLE_NUM
        self.last_cam = self.cam
        self.gbuf_last = None if self.gbuf is None else self.gbuf.frame
        self.first_frame = False
        return disp

    def _step_sharded(self):
        """One frame over ``self.mesh``: the path tracer
        (``pt_step_sharded``: direct + indirect accumulated into ``direct``,
        as the JAX renderer's mesh mode does) or ReSTIR DI
        (``restir_step_sharded``) tile by tile, the state staying on the
        tiles; the G-buffer the denoiser reads, the denoiser and the
        display on ``device``, gathered."""
        from ..parallel import sharding as sh

        s, st, timer, mesh = self.settings, self.state, self.timer, self.mesh
        if not (self._uses_restir() or s.tracer in (Tracer.STREAMED, Tracer.SINGLE_KERNEL)):
            raise NotImplementedError("mesh mode runs the pt and restir tracers")
        if s.animate_camera:
            self._animate_camera()
        if not s.accumulate:
            self.reset_accumulation()
        tiles = None  # this frame's G-buffer tiles
        if self._uses_restir():
            with timer.time("restir_sharded"):
                self._ensure_gbuf_last()
                self.direct, self.reservoir, tiles = sh.restir_step_sharded(
                    mesh, self._scenes, self.cam, self.last_cam, st.looper, self.gbuf_last,
                    self.reservoir, self.first_frame, self.direct, st.iteration,
                    reuse=s.reservoir_reuse, reservoir_size=s.reservoir_size,
                    temporal_clamp=s.temporal_clamp, encode_normal=s.encode_normal)
        else:
            if self._needs_gbuffer():
                with timer.time("gbuffer"):
                    self._ensure_gbuf_last()
                    tiles = sh.gbuffer_sharded(mesh, self._scenes, self.cam,
                                               self.last_cam, s.encode_normal)
            with timer.time("pathtrace_sharded"):
                self.direct = sh.pt_step_sharded(mesh, self._scenes, self.cam, self.direct,
                                                 st.looper, st.iteration,
                                                 max_depth=s.trace_depth)
        self.gbuf = None
        if tiles is not None and s.denoiser in (Denoiser.EA_WAVELET, Denoiser.SVGF):
            self.gbuf = self._full(tiles)
        tracing.mark("end", self.device)
        with timer.time("denoise"):
            image = self._apply_denoiser(self._full(self.direct),
                                         (self.gbuf_last, self.first_frame))
        self._last_image = image
        with timer.time("display"):
            disp = self._display(image)
        st.iteration += 1
        st.looper = (st.looper + 1) % SOBOL_SAMPLE_NUM
        self.last_cam = self.cam
        self.gbuf_last = None if tiles is None else [g.frame for g in tiles]
        self.first_frame = False
        return disp

    def step_device(self):
        """:meth:`step`: the display image stays on the device, so a caller
        can overlap its fetch with the next frame (the JAX renderer's
        ``step_device``; the port's ``step`` already returns a device
        tensor)."""
        return self.step()

    # ------------------------------------------------------------------
    # batched frames (render/graph.py)
    # ------------------------------------------------------------------

    def _runner(self, key, fn, carry=(), ds=None):
        """The block runner of ``key``, made on first use (and again for a
        new scene): a CUDA graph per (tracer settings, depth, block,
        engine) on the card.  ``ds``: the scene the block runs on, on its
        device (None: the renderer's)."""
        ds = self.ds if ds is None else ds
        key = (*key, ds.intersector)
        held = self._runners.get(key)
        if held is None or held[0] is not ds:
            held = (ds, gr.BlockRunner(fn, gr.batch_mode(ds), ds.device, carry))
            self._runners[key] = held
        self.last_runner = held[1]
        return held[1]

    def _scalars(self, device):
        """The block's looper, iteration and first-frame flag as 0-d device
        fills."""
        st = self.state
        return (gr.block_input(st.looper, device), gr.block_input(float(st.iteration), device),
                gr.block_input(bool(self.first_frame), device))

    def _pt_block(self, block: int):
        """One block of ``block`` full-PT frames, and its bookkeeping."""
        s, st = self.settings, self.state

        def batch(cam, looper0, iteration, direct, indirect):
            return _pt_batch(self.ds, cam, looper0, direct, indirect, iteration,
                             max_depth=s.trace_depth, block=block)

        run = self._runner(("pt", s.trace_depth, block), batch, (("0", "3"), ("1", "4")))
        looper0, iteration, _ = self._scalars(self.device)
        self.direct, self.indirect = run(self.cam, looper0, iteration, self.direct,
                                         self.indirect)
        st.iteration += block
        st.looper = (st.looper + block) % SOBOL_SAMPLE_NUM
        return run

    def _pt_tile_blocks(self, block: int):
        """One block of ``block`` full-PT frames on each tile of the mesh
        (:func:`_pt_batch` on its pixels), each tile its own block runner; returns
        the last tile's runner.  The sample axis is not used: every tile's
        block runs on its sample-0 device, as the JAX renderer's batched
        program runs on the tile-sharded buffers."""
        s, st = self.settings, self.state
        self._check_mesh_batch()
        direct = []
        for t, dev in enumerate(self.mesh.tile_devices):
            ds, idx = self._scenes[dev], self._tile_idx[t]

            def batch(cam, looper0, iteration, direct, ds=ds, idx=idx):
                return _pt_batch(ds, cam, looper0, direct, None, iteration, idx,
                                 max_depth=s.trace_depth, block=block)[0]

            run = self._runner(("pt_tile", t, s.trace_depth, block), batch, (("", "3"),),
                               ds=ds)
            looper0, iteration, _ = self._scalars(dev)
            direct.append(run(self.cam.to(dev), looper0, iteration, self.direct[t]))
        self.direct = direct
        st.iteration += block
        st.looper = (st.looper + block) % SOBOL_SAMPLE_NUM
        return run

    def _restir_block(self, block: int):
        """One block of ``block`` ReSTIR frames (:func:`_restir_batch`; on a
        mesh ``sharding.restir_batch_sharded``, the same frames bit for
        bit), and its bookkeeping; the batch's G-buffer becomes
        ``self.gbuf`` (on a mesh gathered when the denoiser reads it, as
        :meth:`_step_sharded` gathers it).  On a mesh whose tiles share a
        device the whole block over all tiles is one runner (one CUDA graph
        on the card), the exchanges device copies inside it; tiles on
        several devices (``mesh_segments``) run a runner a (stage, tile),
        the exchanges' copies between them."""
        s, st, cam, mesh = self.settings, self.state, self.cam, self.mesh
        self._ensure_gbuf_last()
        key = ("restir", s.reservoir_reuse, s.reservoir_size, s.temporal_clamp,
               s.encode_normal)
        kw = dict(reuse=s.reservoir_reuse, reservoir_size=s.reservoir_size,
                  clamp=s.temporal_clamp, encode_normal=s.encode_normal, block=block)
        dev = self.device if mesh is None else mesh.tile_devices[0]
        looper0, iteration, first = self._scalars(dev)
        args = (cam, self.last_cam, looper0, self.gbuf_last, self.reservoir, first,
                self.direct, iteration)
        if mesh is None:
            run = self._runner((*key, block), lambda *a: _restir_batch(self.ds, *a, **kw),
                               (("0", "6"), ("1", "4"), ("2.frame", "3")))
            self.direct, self.reservoir, self.gbuf = run(*args)
            self.gbuf_last = self.gbuf.frame
        else:
            from ..parallel import sharding as sh

            self._check_mesh_batch()

            def batch(*a, segment=None):
                return sh.restir_batch_sharded(mesh, self._scenes, self._tile_idx, *a,
                                               segment=segment, **kw)

            if self.mesh_segments:
                def segment(name, fn, *a):
                    ds = self._scenes[mesh.tile_devices[name[1]]]
                    return self._runner((*key, *name), fn, ds=ds)(*a)

                direct, res, tiles = batch(*args, segment=segment)
            else:
                carry = (("0", "6"), ("1", "4"),
                         *((f"2.{t}.frame", f"3.{t}") for t in range(len(mesh.tile_devices))))
                direct, res, tiles = self._runner((*key, block), batch, carry,
                                                  ds=self._scenes[dev])(*args)
            self.direct, self.reservoir = list(direct), list(res)
            self.gbuf = None
            if s.denoiser in (Denoiser.EA_WAVELET, Denoiser.SVGF):
                self.gbuf = self._full(list(tiles))
            self.gbuf_last = [g.frame for g in tiles]
        st.iteration += block
        st.looper = (st.looper + block) % SOBOL_SAMPLE_NUM
        self.last_cam = cam
        self.first_frame = False
        return self.last_runner

    def _check_batchable(self):
        s = self.settings
        if not (self._uses_restir() or s.tracer in (Tracer.STREAMED, Tracer.SINGLE_KERNEL)):
            raise ValueError("batched frames run the path tracer and ReSTIR DI")

    def _check_mesh_batch(self):
        """A mesh's batched blocks need W*H divisible by the tile count (no
        pad lanes), as the JAX renderer's."""
        if self.n_alloc != self.n_pixels:
            raise NotImplementedError("mesh-mode batching needs W*H divisible by the "
                                      "tile count")

    def run_block(self, block: int):
        """Accumulate one block of ``block`` frames of the path tracer or
        ReSTIR DI, the camera static across it, with nothing read back;
        returns the :class:`~.graph.BlockRunner` that ran it (a CUDA graph
        when ``batch_mode`` is "graph")."""
        self._check_batchable()
        with tracing.call("call.run_block"), self.timer.time(f"block of {block}"):
            if self._uses_restir():
                return self._restir_block(block)
            if self.mesh is not None:
                return self._pt_tile_blocks(block)
            return self._pt_block(block)

    def render_batched(self, spp: int, block: int = 8):
        """Accumulate ``spp`` samples, ``block`` frames a block (whole
        blocks: ``spp`` rounds up to a multiple of ``block``), with the
        path tracer or ReSTIR DI; the camera is static across a block.
        Renders without the denoiser (the JAX renderer's batched paths do
        too).  Returns the current image [H, W, 3] as numpy."""
        done = 0
        while done < spp:
            self.run_block(block)
            done += block
        # batched paths render WITHOUT the denoiser: drop any stale denoised
        # frame so current_image() returns the fresh accumulation
        self._last_image = None
        img = self.current_image()
        tracing.host_sync()
        return img.cpu().numpy().reshape(self.cam.height, self.cam.width, 3)

    def step_batched_restir(self, block: int):
        """``block`` ReSTIR frames as one block, then the denoiser once (SVGF
        as a block of its own: one CUDA graph on the card, as the ReSTIR
        block); returns the display image on the device (the JAX renderer's
        high-throughput interactive mode).

        The denoiser gets the G-buffer frame and the first-frame flag from
        before the block, as :meth:`step` gives them: the frame that the
        block's motion reprojects into and True on the first call
        (temporalAccumulate, denoiser.cu:208-262).  This departs from the
        JAX package's ``step_batched_restir``, whose denoiser reads the
        block's own frame and a first-frame flag already cleared.  SVGF,
        which reads that frame, gets a copy: a replayed block writes its
        own frame into the tensors that hold ``gbuf_last`` (the runner's
        carry, render/graph.py)."""
        s = self.settings
        with tracing.call("call.step_batched_restir"):
            if s.animate_camera:
                self._animate_camera()
            if not s.accumulate:
                self.reset_accumulation()
            # the frame before must exist before it is copied (on the
            # first call, last_cam's)
            self._ensure_gbuf_last()
            last_frame, first = self.gbuf_last, self.first_frame
            if s.denoiser == Denoiser.SVGF:
                last_frame = _frame_copy(last_frame)
            with self.timer.time(f"block of {block}"):
                self._restir_block(block)
            image = self._apply_denoiser(self._full(self.direct), (last_frame, first),
                                         block=self.mesh is None)
            self._last_image = image
            return self._display(image)

    def _apply_denoiser(self, image, history, indirect=None, block=False):
        """Denoise ``image``, or the (direct, indirect) pair when
        ``indirect`` is given: split SVGF filters the two with independent
        histories and adds them after (main.cpp:95-97, denoiser.cu:436-448),
        the other denoisers filter their sum.  ``history``: the last
        G-buffer frame and the first-frame flag SVGF reads; ``block``: SVGF
        on ``image`` runs as a block (:meth:`_svgf`)."""
        s = self.settings
        # the Output Direct/Indirect AOVs are live only while the split
        # path runs
        self._split_out = None
        if s.denoiser == Denoiser.NONE:
            return image if indirect is None else post.add_image(image, indirect)
        with tracing.span("frame.denoise"):
            tracing.mark("denoise", self.device)
            out = self._denoise(image, indirect, history, block)
            tracing.mark("denoise_end", self.device)
            return out

    def _denoise(self, image, indirect, history, block):
        s = self.settings
        sig_d, sig_n, sig_l = self._svgf_sigmas()
        last_frame, first = history
        if indirect is not None and s.denoiser == Denoiser.SVGF and s.denoiser_split:
            out_d, out_i, self.svgf_direct, self.svgf_indirect = dn.svgf_filter_pair(
                image, indirect, self.svgf_direct, self.svgf_indirect, self.gbuf,
                self._full(last_frame), self.cam, first, levels=s.svgf_levels,
                sig_depth=sig_d, sig_normal=sig_n, sig_luminance=sig_l)
            self._split_out = (out_d, out_i)
            self._svgf_indirect_live = True
            out = post.add_image(out_d, out_i)
            return post.modulate_albedo(out, self.gbuf.albedo) if s.modulate else out
        if indirect is not None:
            image = post.add_image(image, indirect)
        if s.denoiser == Denoiser.GAUSSIAN:
            return dn.gaussian_filter(image, self.cam.width, self.cam.height)
        if s.denoiser == Denoiser.EA_WAVELET:
            out = dn.leveled_eaw_filter(image, self.gbuf.frame, self.cam,
                                        sig_depth=s.eaw_sig_depth,
                                        sig_normal=s.eaw_sig_normal,
                                        sig_luminance=s.eaw_sig_luminance)
        elif s.denoiser == Denoiser.SVGF:
            out, self.svgf_direct = self._svgf(image, self._full(last_frame), first, block,
                                               levels=s.svgf_levels, sig_depth=sig_d,
                                               sig_normal=sig_n, sig_luminance=sig_l)
        else:
            return image
        return post.modulate_albedo(out, self.gbuf.albedo) if s.modulate else out

    def _svgf(self, image, last_frame, first, block: bool, **kw):
        """SVGF on ``image``: (the filtered image, the new history).  With
        ``block`` it runs as a block runner of its own, the first-frame flag
        a device fill: on the card one CUDA graph, captured on the first
        call and replayed, the history carried in its static tensors; the
        same kernels as the eager filter, so the same bits."""
        args = (image, self.svgf_direct, self.gbuf, last_frame, self.cam)
        if not block:
            return dn.svgf_filter(*args, first, **kw)
        held = self.last_runner  # the ReSTIR block's, which callers read
        run = self._runner(("svgf", *kw.values()), lambda *a: dn.svgf_filter(*a, **kw),
                           (("1", "1"),))
        self.last_runner = held
        return run(*args, gr.block_input(bool(first), self.device))

    def _svgf_sigmas(self):
        """SVGF's (depth, normal, luminance) sigmas, live-tunable like the
        reference GUI's sliders (preview.cpp:261-267)."""
        s = self.settings
        return s.svgf_sig_depth, s.svgf_sig_normal, s.svgf_sig_luminance

    def _gbuffer_view(self):
        """G-buffer debug views — the reference GUI's Albedo / Normal /
        Depth / Motion previews (preview.cpp:254-276)."""
        view = self.settings.gbuffer_view
        g = self.gbuf
        if view == "normal":
            return gb.decoded_normal(g.frame) * 0.5 + 0.5
        if view == "depth":
            d = g.frame.depth
            d = d / torch.clamp(torch.max(d), min=1e-6)
            return d[:, None].expand(-1, 3).contiguous()
        if view == "motion":
            return gb.motion_debug_image(g.motion, self.cam.width, self.cam.height)
        return g.albedo

    def _bvh_heatmap(self):
        """The BVH traversal heatmap (the reference's ``--tracer bvh``): the
        pinhole rays in raster order go through the MTBVH walk (the kernel
        on the card whatever the engine, the plain walk on a plain twin),
        and each pixel shows t = its descended nodes over the frame's most
        as [t, 1 - t, 0]."""
        from ..accel import traverse as trv

        ds, cam = self.ds, self.cam
        idx = torch.arange(cam.width * cam.height, dtype=torch.int32, device=self.device)
        ray_o, ray_d = cam_mod.pinhole_rays(cam, idx % cam.width, idx // cam.width)
        steps = trv.intersect_bvh_heatmap(ds.leaf_tris, ds.bvh_packed, ray_o, ray_d,
                                          plain=engines.of(ds).plain)
        t = steps.to(torch.float32) / torch.clamp(steps.max().to(torch.float32), min=1.0)
        return torch.stack([t, 1.0 - t, torch.zeros_like(t)], dim=-1)

    # ------------------------------------------------------------------
    # offline rendering, previews and saving
    # ------------------------------------------------------------------

    def render(self, spp: int | None = None):
        """Accumulate ``spp`` frames; returns the current image [H, W, 3]
        as numpy."""
        for _ in range(spp or self.state.iterations):
            self.step()
        img = self.current_image()
        tracing.host_sync()
        return img.cpu().numpy().reshape(self.cam.height, self.cam.width, 3)

    def preview_aov_image(self):
        """The buffer ``settings.preview_aov`` selects (HDR [N, 3]), or None
        for "composed" and for a buffer not filled yet (the split outputs
        before a split-SVGF frame, the indirect history without one)."""
        view = self.settings.preview_aov
        if view == "composed":
            return None
        if view == "input_direct":
            return self._full(self.direct)
        if view == "input_indirect":
            return self._full(self.indirect)
        if view in ("output_direct", "output_indirect"):
            if self._split_out is None:
                return None
            return self._split_out[0 if view == "output_direct" else 1]
        if view.startswith("indirect") and not self._svgf_indirect_live:
            return None
        state = self.svgf_direct if view.startswith("direct") else self.svgf_indirect
        mo = state.accum_moment  # (mean lum, mean lum², history)
        if view.endswith("_moment"):
            hist = mo[:, 2] / torch.clamp(torch.max(mo[:, 2]), min=1e-6)
            return torch.stack([mo[:, 0], mo[:, 1], hist], dim=-1)
        var = torch.clamp(mo[:, 1] - mo[:, 0] ** 2, min=0.0)
        var = var / torch.clamp(torch.max(var), min=1e-12)
        return var[:, None].expand(-1, 3).contiguous()

    def current_image(self):
        """The image on display, HDR [N, 3]: a preview AOV when one is
        selected; the last frame's for the G-buffer preview, the BVH
        heatmap and behind a denoiser; else the accumulation (direct +
        indirect for the path tracer)."""
        s = self.settings
        aov = self.preview_aov_image()
        if aov is not None:
            return aov
        if ((s.tracer in (Tracer.GBUFFER_PREVIEW, Tracer.BVH_VISUALIZE)
             or s.denoiser != Denoiser.NONE)
                and self._last_image is not None):
            return self._last_image
        if s.tracer in (Tracer.STREAMED, Tracer.SINGLE_KERNEL) and not s.use_reservoir:
            return post.add_image(self._full(self.direct), self._full(self.indirect))
        return self._full(self.direct)

    def save(self, path: str | None = None, jpg: bool = False) -> str:
        """Tonemap + gamma + save, X-mirrored like the reference
        (``saveImage``, main.cpp:122-161); the default name embeds time +
        spp (``.jpg`` with ``jpg``).  A ``.hdr`` path gets the raw Radiance
        RGBE image: no tonemap, no gamma, the same mirror."""
        img = self.current_image().reshape(self.cam.height, self.cam.width, 3)
        tracing.host_sync()
        if path is not None and path.lower().endswith(".hdr"):
            write_hdr(path, np.ascontiguousarray(img.cpu().numpy()[:, ::-1]))
            return os.path.abspath(path)
        disp = m.gamma_correction(post.tonemap(img, self.settings.tone_mapping))
        out = np.ascontiguousarray(
            torch.clamp(disp, 0.0, 1.0).cpu().numpy()[:, ::-1])  # mirror X
        if path is None:
            stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
            ext = "jpg" if jpg else "png"
            path = f"{self.state.image_name}.{stamp}.{self.state.iteration}samp.{ext}"
        save_image(path, out)
        return os.path.abspath(path)

    def save_checkpoint(self, path: str) -> str:
        """Write the progressive render state to ``path`` (.npz, the JAX
        package's format): resume with :meth:`load_checkpoint`."""
        from .checkpoint import save_checkpoint

        return save_checkpoint(self, path)

    def load_checkpoint(self, path: str) -> None:
        from .checkpoint import load_checkpoint

        load_checkpoint(self, path)
