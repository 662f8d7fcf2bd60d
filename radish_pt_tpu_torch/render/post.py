"""Post-processing: tone mapping, gamma, albedo modulation, display.

Port of ``radish_pt_tpu/render/post.py`` (reference ``sendImageToPBO``,
pathtrace.cu:32-118, and the modulate/add helpers, denoiser.cu:175-206).
"""

from __future__ import annotations

import torch

from ..config import ToneMapping
from ..utils import math as m


def tonemap(color, mode: int):
    """Tonemap dispatch (pathtrace.cu:44-53)."""
    if mode == ToneMapping.FILMIC:
        return m.filmic(color)
    if mode == ToneMapping.ACES:
        return m.aces(color)
    return color


def to_display(color, tone_mapping: int = ToneMapping.NONE, scale: float = 1.0):
    """HDR image -> uint8 display buffer: scale, tonemap, gamma, quantize
    (sendImageToPBO, pathtrace.cu:32-59)."""
    c = tonemap(color * scale, tone_mapping)
    c = m.gamma_correction(c)
    return torch.clamp(c * 255.0, 0.0, 255.0).to(torch.uint8)


def modulate_albedo(img, albedo):
    """Re-apply albedo after demodulated denoising (denoiser.cu:175-185),
    through the true inverse of the accumulation's range compression."""
    return m.ldr_to_hdr(img) * torch.clamp(albedo, min=0.0)


def add_image(a, b):
    return a + b
