"""Frame-loop driver: the port of ``radish_pt_tpu/render/renderer.py``.

Per frame (reference main.cpp:163-202): optional camera animation, the
G-buffer, the tracer — full-MIS path tracing (``STREAMED`` and its alias
``SINGLE_KERNEL``), one-bounce direct lighting (``DIRECT_LIGHT``), ReSTIR
DI (``RESTIR_DI`` or ``use_reservoir``) or the G-buffer preview — then
scrub, range-compress and fold into the running mean, an optional
denoiser (Gaussian, EAW, SVGF; the path tracer's direct and indirect
halves through the split-SVGF pair), and tonemap for display.  All buffers
live on the renderer's ``device``.

The G-buffer is rendered only on frames whose tracer or denoiser reads it
(the JAX renderer renders it every frame, and nothing else reads it).  It
depends only on the scene and the camera, so a frame that needs last
frame's G-buffer after a frame without one renders it for ``last_cam``:
the same bytes the JAX renderer would have kept.

The BVH heatmap raises ``NotImplementedError`` naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from ..config import Denoiser, RenderState, Settings, Tracer
from ..sampling.sobol import SOBOL_SAMPLE_NUM
from ..scene import camera as cam_mod
from ..scene.build import load_scene
from ..scene.image_io import save_image
from ..utils import math as m
from . import denoise as dn
from . import gbuffer as gb
from . import pathtrace as pt
from . import post
from . import restir as rs

_NOT_PORTED = {
    Tracer.BVH_VISUALIZE: "the BVH heatmap (ROADMAP queue 1, item 5)",
}


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
                 desc=None, settings: Settings | None = None, device="cuda"):
        self.device = torch.device(device)
        if scene_path is not None:
            ds, cam, desc = load_scene(scene_path, device=self.device)
        self.ds = ds.to(self.device)
        self.cam = cam.to(self.device)
        self.last_cam = self.cam
        self.settings = settings or (desc.settings if desc else Settings())
        self.state = desc.state if desc else RenderState()
        n = cam.width * cam.height
        self.direct = torch.zeros((n, 3), dtype=torch.float32, device=self.device)
        self.indirect = torch.zeros_like(self.direct)
        self.gbuf = None
        self.gbuf_last = gb.empty_frame(n, encode_normal=self.settings.encode_normal,
                                        device=self.device)
        self.reservoir = rs.empty_reservoir(n, device=self.device)
        self.svgf_direct = dn.empty_svgf_state(n, device=self.device)
        self.svgf_indirect = dn.empty_svgf_state(n, device=self.device)
        self.first_frame = True
        self._orig_cam_pos = self.cam.position.cpu().numpy()
        self._time = 0.0
        self._last_image = None
        self._split_out = None
        self._svgf_indirect_live = False

    def _check_supported(self):
        what = _NOT_PORTED.get(self.settings.tracer)
        if what is not None:
            raise NotImplementedError(f"not ported yet: {what}")

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
        cam = self.cam
        for k, v in kwargs.items():
            cam = cam.replace(**{k: torch.as_tensor(np.asarray(v, np.float32),
                                                    device=self.device)})
        self.cam = cam_mod.update_camera(cam)
        self._orig_cam_pos = self.cam.position.cpu().numpy()
        self.reset_accumulation()

    def _animate_camera(self, dt: float = 1.0 / 60.0):
        """Circle the camera about its start (Settings::animateCamera)."""
        s = self.settings
        self._time += dt * s.animate_speed
        offset = np.array([np.cos(self._time), 0.0, np.sin(self._time)],
                          np.float32) * s.animate_radius
        pos = torch.from_numpy(self._orig_cam_pos + offset).to(self.device)
        self.cam = cam_mod.update_camera(self.cam.replace(position=pos))
        self.reset_accumulation()

    # ------------------------------------------------------------------
    # frame loop
    # ------------------------------------------------------------------

    def step(self):
        """Render one frame; returns the uint8 display image [H, W, 3] as a
        tensor on the renderer's device."""
        self._check_supported()
        s, st = self.settings, self.state
        if s.animate_camera:
            self._animate_camera()
        if not s.accumulate:
            self.reset_accumulation()

        self.gbuf = None
        if self._needs_gbuffer():
            if self.gbuf_last is None:
                self.gbuf_last = gb.render_gbuffer(
                    self.ds, self.last_cam, self.last_cam,
                    encode_normal=s.encode_normal).frame
            self.gbuf = gb.render_gbuffer(self.ds, self.cam, self.last_cam,
                                          encode_normal=s.encode_normal)

        denoised = False
        if self._uses_restir():
            d, self.reservoir = rs.restir_direct(
                self.ds, self.cam, st.looper, self.gbuf, self.gbuf_last,
                self.reservoir, self.first_frame, s.reservoir_reuse,
                s.reservoir_size, s.temporal_clamp)
            self.direct = pt.accumulate(self.direct, pt.scrub_and_compress(d),
                                        st.iteration)
            image = self.direct
        elif s.tracer == Tracer.GBUFFER_PREVIEW:
            image = self._gbuffer_view()
        elif s.tracer in (Tracer.STREAMED, Tracer.SINGLE_KERNEL):
            d, ind = pt.path_trace(self.ds, self.cam, st.looper, s.trace_depth)
            self.direct = pt.accumulate(self.direct, pt.scrub_and_compress(d),
                                        st.iteration)
            self.indirect = pt.accumulate(self.indirect, pt.scrub_and_compress(ind),
                                          st.iteration)
            # direct and indirect go through the denoiser apart: the
            # reference filters each with its own SpatioTemporalFilter
            # (main.cpp:95-97, DENOISER_SPLIT_DIRECT_INDIRECT common.h:10)
            image = self._apply_denoiser(self.direct, self.indirect)
            denoised = True
        else:  # the direct-light tracer (the reference demo loop's default)
            d = pt.path_trace_direct(self.ds, self.cam, st.looper)
            self.direct = pt.accumulate(self.direct, pt.scrub_and_compress(d),
                                        st.iteration)
            image = self.direct
        if not denoised:
            image = self._apply_denoiser(image)
        self._last_image = image
        disp = post.to_display(image.reshape(self.cam.height, self.cam.width, 3),
                               tone_mapping=s.tone_mapping)

        # frame bookkeeping (main.cpp:199-200, pathtrace.cu:380-384)
        st.iteration += 1
        st.looper = (st.looper + 1) % SOBOL_SAMPLE_NUM
        self.last_cam = self.cam
        self.gbuf_last = None if self.gbuf is None else self.gbuf.frame
        self.first_frame = False
        return disp

    def _apply_denoiser(self, image, indirect=None):
        """Denoise ``image``, or the (direct, indirect) pair when
        ``indirect`` is given: split SVGF filters the two with independent
        histories and adds them after (main.cpp:95-97, denoiser.cu:436-448),
        the other denoisers filter their sum."""
        s = self.settings
        # the Output Direct/Indirect AOVs are live only while the split
        # path runs
        self._split_out = None
        if s.denoiser == Denoiser.NONE:
            return image if indirect is None else post.add_image(image, indirect)
        sig_d, sig_n, sig_l = self._svgf_sigmas()
        if indirect is not None and s.denoiser == Denoiser.SVGF and s.denoiser_split:
            out_d, out_i, self.svgf_direct, self.svgf_indirect = dn.svgf_filter_pair(
                image, indirect, self.svgf_direct, self.svgf_indirect, self.gbuf,
                self.gbuf_last, self.cam, self.first_frame, levels=s.svgf_levels,
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
            out, self.svgf_direct = dn.svgf_filter(
                image, self.svgf_direct, self.gbuf, self.gbuf_last, self.cam,
                self.first_frame, levels=s.svgf_levels, sig_depth=sig_d,
                sig_normal=sig_n, sig_luminance=sig_l)
        else:
            return image
        return post.modulate_albedo(out, self.gbuf.albedo) if s.modulate else out

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

    # ------------------------------------------------------------------
    # offline rendering, previews and saving
    # ------------------------------------------------------------------

    def render(self, spp: int | None = None):
        """Accumulate ``spp`` frames; returns the current image [H, W, 3]
        as numpy."""
        for _ in range(spp or self.state.iterations):
            self.step()
        img = self.current_image()
        return img.cpu().numpy().reshape(self.cam.height, self.cam.width, 3)

    def preview_aov_image(self):
        """The buffer ``settings.preview_aov`` selects (HDR [N, 3]), or None
        for "composed" and for a buffer not filled yet (the split outputs
        before a split-SVGF frame, the indirect history without one)."""
        view = self.settings.preview_aov
        if view == "composed":
            return None
        if view == "input_direct":
            return self.direct
        if view == "input_indirect":
            return self.indirect
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
        selected; the last frame's for the G-buffer preview and behind a
        denoiser; else the accumulation (direct + indirect for the path
        tracer)."""
        s = self.settings
        aov = self.preview_aov_image()
        if aov is not None:
            return aov
        if ((s.tracer == Tracer.GBUFFER_PREVIEW or s.denoiser != Denoiser.NONE)
                and self._last_image is not None):
            return self._last_image
        if s.tracer in (Tracer.STREAMED, Tracer.SINGLE_KERNEL) and not s.use_reservoir:
            return post.add_image(self.direct, self.indirect)
        return self.direct

    def save(self, path: str | None = None) -> str:
        """Tonemap + gamma + save, X-mirrored like the reference
        (``saveImage``, main.cpp:122-161); the default PNG name embeds time
        + spp."""
        img = self.current_image().reshape(self.cam.height, self.cam.width, 3)
        disp = m.gamma_correction(post.tonemap(img, self.settings.tone_mapping))
        out = np.ascontiguousarray(
            torch.clamp(disp, 0.0, 1.0).cpu().numpy()[:, ::-1])  # mirror X
        if path is None:
            stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
            path = f"{self.state.image_name}.{stamp}.{self.state.iteration}samp.png"
        save_image(path, out)
        return os.path.abspath(path)
