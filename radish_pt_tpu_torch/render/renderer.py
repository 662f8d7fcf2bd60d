"""Frame-loop driver: the port of ``radish_pt_tpu/render/renderer.py``.

Per frame (reference main.cpp:163-202): trace one full-MIS sample per
pixel, scrub and range-compress it, fold it into the running mean, and
tonemap for display.  All buffers live on the renderer's ``device``.

Only the path tracer (``Tracer.STREAMED`` and its alias ``SINGLE_KERNEL``)
is ported; the other tracers, the denoisers and camera animation raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from ..config import Denoiser, RenderState, Settings, Tracer
from ..sampling.sobol import SOBOL_SAMPLE_NUM
from ..scene.build import load_scene
from ..scene.image_io import save_image
from ..utils import math as m
from . import pathtrace as pt
from . import post

_NOT_PORTED = {
    Tracer.DIRECT_LIGHT: "the direct-light tracer (ROADMAP queue 1, item 4)",
    Tracer.RESTIR_DI: "ReSTIR DI (ROADMAP queue 1, item 4)",
    Tracer.GBUFFER_PREVIEW: "the G-buffer preview (ROADMAP queue 1, item 4)",
    Tracer.BVH_VISUALIZE: "the BVH heatmap (ROADMAP queue 1, item 5)",
}


class Renderer:
    """Stateful frame driver around :func:`pathtrace.path_trace`."""

    def __init__(self, scene_path: str | None = None, ds=None, cam=None,
                 desc=None, settings: Settings | None = None, device="cuda"):
        self.device = torch.device(device)
        if scene_path is not None:
            ds, cam, desc = load_scene(scene_path, device=self.device)
        self.ds = ds.to(self.device)
        self.cam = cam.to(self.device)
        self.settings = settings or (desc.settings if desc else Settings())
        self.state = desc.state if desc else RenderState()
        n = cam.width * cam.height
        self.direct = torch.zeros((n, 3), dtype=torch.float32, device=self.device)
        self.indirect = torch.zeros_like(self.direct)

    def _check_supported(self):
        s = self.settings
        if s.tracer in _NOT_PORTED or s.use_reservoir:
            what = _NOT_PORTED.get(s.tracer, _NOT_PORTED[Tracer.RESTIR_DI])
            raise NotImplementedError(f"not ported yet: {what}")
        if s.denoiser != Denoiser.NONE:
            raise NotImplementedError(
                "not ported yet: the denoisers (ROADMAP queue 1, item 4)")
        if s.animate_camera:
            raise NotImplementedError(
                "not ported yet: camera animation (ROADMAP queue 1, item 12)")

    def reset_accumulation(self):
        self.state.iteration = 0

    def step(self):
        """Render and accumulate one frame; returns the uint8 display image
        [H, W, 3] as a tensor on the renderer's device."""
        self._check_supported()
        s, st = self.settings, self.state
        if not s.accumulate:
            self.reset_accumulation()
        d, ind = pt.path_trace(self.ds, self.cam, st.looper, s.trace_depth)
        self.direct = pt.accumulate(self.direct, pt.scrub_and_compress(d),
                                    st.iteration)
        self.indirect = pt.accumulate(self.indirect, pt.scrub_and_compress(ind),
                                      st.iteration)
        disp = post.to_display(
            self.current_image().reshape(self.cam.height, self.cam.width, 3),
            tone_mapping=s.tone_mapping)
        # frame bookkeeping (main.cpp:199-200, pathtrace.cu:380-384)
        st.iteration += 1
        st.looper = (st.looper + 1) % SOBOL_SAMPLE_NUM
        return disp

    def render(self, spp: int | None = None):
        """Accumulate ``spp`` frames; returns the HDR accumulation [H, W, 3]
        as numpy."""
        for _ in range(spp or self.state.iterations):
            self.step()
        img = self.current_image()
        return img.cpu().numpy().reshape(self.cam.height, self.cam.width, 3)

    def current_image(self):
        """The accumulated HDR image, direct + indirect, [N, 3]."""
        return self.direct + self.indirect

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
