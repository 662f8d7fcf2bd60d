"""Post-processing: tone mapping, gamma, display.

A frozen copy of the port's ``render/post.py``, a port of
``radish_pt_tpu/render/post.py`` (reference ``sendImageToPBO``,
pathtrace.cu:32-118).
"""

from __future__ import annotations

import torch

from . import vmath as m


class ToneMapping:
    NONE = 0
    FILMIC = 1
    ACES = 2


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
