"""SVGF, the spatio-temporal variance-guided filter.

A plain version of the upstream renderer's ``SpatioTemporalFilter``
(denoiser.cu:436-558), written from its kernels and importing nothing of
the port: the temporal blend with its disocclusion reset
(``temporalAccumulate``, :208-262), the variance estimate
(``estimateVariance``, :264-299), the 3x3 Gaussian variance prefilter
(``filterVariance``, :301-328) and the variance-guided à-trous levels
(``waveletFilter``'s SVGF overload, :92-173) with sigmas 4 / 128 / 1
(:443).  The level-0 output becomes the next call's colour history, the
temporal moments its moments (the swap at :533).

Images are planar [C, H, W] (or [H, W]); a tap at offset (dy, dx) reads a
copy of the image padded with zeros, and a tap outside the image is
weighed 0.  Every float tensor is made in ``precision.FT``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import camera as cam_mod
from . import gbuffer as gb
from . import precision as prec
from . import vmath as m

GAUSSIAN_3X3 = ((0.075, 0.124, 0.075), (0.124, 0.204, 0.124), (0.075, 0.124, 0.075))
GAUSSIAN_5X5 = ((0.0030, 0.0133, 0.0219, 0.0133, 0.0030),
                (0.0133, 0.0596, 0.0983, 0.0596, 0.0133),
                (0.0219, 0.0983, 0.1621, 0.0983, 0.0219),
                (0.0133, 0.0596, 0.0983, 0.0596, 0.0133),
                (0.0030, 0.0133, 0.0219, 0.0133, 0.0030))
FLT_EPS = 1.1920929e-07
ALPHA = 0.2  # the history's blend factor (denoiser.cu:243)


@dataclass
class History:
    """What one call hands the next: the colour history and the moments
    (mean luminance, mean squared luminance, history length), flat."""

    color: torch.Tensor  # [N, 3]
    moment: torch.Tensor  # [N, 3]


def empty_history(n: int, device="cuda") -> History:
    z = torch.zeros((n, 3), dtype=prec.FT, device=device)
    return History(color=z, moment=z)


def _tap(img, dy: int, dx: int):
    """img[..., y + dy, x + dx] at every (y, x), 0 where that lies outside."""
    h, w = img.shape[-2:]
    p = max(abs(dy), abs(dx))
    padded = F.pad(img[None] if img.dim() == 2 else img, (p, p, p, p))
    out = padded[..., p + dy:p + dy + h, p + dx:p + dx + w]
    return out[0] if img.dim() == 2 else out


def _inside(h: int, w: int, dy: int, dx: int, device):
    """Whether (y + dy, x + dx) lies in the image, at every (y, x)."""
    y = torch.arange(h, device=device)[:, None] + dy
    x = torch.arange(w, device=device)[None, :] + dx
    return (y >= 0) & (y < h) & (x >= 0) & (x < w)


def _planar(flat, h: int, w: int):
    return flat.t().reshape(flat.shape[1], h, w)


def _flat(img):
    return img.reshape(img.shape[0], -1).t().contiguous()


def _lum(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def temporal_accumulate(color, hist: History, gbuf: gb.GBufferOut, last: gb.GBufferFrame,
                        first: bool):
    """(colour, moments) [N, 3] after the blend with the history at each
    pixel's motion, reset where the pixel is new: the first call, motion off
    the last image, a miss, another id or a normal turned by more than
    acos(0.1) there (denoiser.cu:208-262)."""
    cur = gbuf.frame
    at = gbuf.motion.clamp(min=0).long()
    last_color, last_moment = hist.color[at], hist.moment[at]
    last_normal, last_id = gb.decoded_normal(last)[at], last.prim_id[at]
    reset = (gbuf.motion < 0) | (cur.prim_id <= gb.NULL_PRIMITIVE) | (last_id != cur.prim_id)
    reset = reset | (m.abs_dot(gb.decoded_normal(cur), last_normal) < 0.1)
    if first:
        reset = torch.ones_like(reset)
    lum = m.luminance(color)
    blended = last_color + (color - last_color) * ALPHA
    m1 = last_moment[:, 0] * (1 - ALPHA) + lum * ALPHA
    m2 = last_moment[:, 1] * (1 - ALPHA) + lum * lum * ALPHA
    fresh = torch.stack([lum, lum * lum, torch.zeros_like(lum)], dim=-1)
    kept = torch.stack([m1, m2, last_moment[:, 2] + 1.0], dim=-1)
    return (torch.where(reset[:, None], color, blended),
            torch.where(reset[:, None], fresh, kept))


def estimate_variance(moment, h: int, w: int):
    """[H, W] luminance variance: the temporal moments' where the history
    is longer than 3.5 calls, else the 3x3 neighbourhood's moments'
    (denoiser.cu:264-299)."""
    mo = _planar(moment, h, w)
    s1 = torch.zeros((h, w), dtype=prec.FT, device=mo.device)
    s2, n = torch.zeros_like(s1), torch.zeros_like(s1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            inside = _inside(h, w, dy, dx, mo.device)
            s1 = s1 + torch.where(inside, _tap(mo[0], dy, dx), 0.0)
            s2 = s2 + torch.where(inside, _tap(mo[1], dy, dx), 0.0)
            n = n + inside.to(prec.FT)
    s1, s2 = s1 / n, s2 / n
    return torch.where(mo[2] > 3.5, mo[1] - mo[0] ** 2, s2 - s1 ** 2)


def filter_variance(var):
    """The variance under a 3x3 Gaussian, renormalised over the taps inside
    the image (denoiser.cu:301-328)."""
    h, w = var.shape
    acc, wsum = torch.zeros_like(var), torch.zeros_like(var)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            g = torch.where(_inside(h, w, dy, dx, var.device),
                            GAUSSIAN_3X3[dy + 1][dx + 1], 0.0).to(var.dtype)
            acc = acc + _tap(var, dy, dx) * g
            wsum = wsum + g
    return acc / wsum.clamp(min=1e-12)


def guided_level(color, var, var_f, pos, normal, prim_id, step: int, sig_depth: float,
                 sig_normal: float, sig_luminance: float):
    """One variance-guided à-trous level of ``color`` [3, H, W] and ``var``
    [H, W] at tap spacing ``step`` (denoiser.cu:92-173): a tap's weight is
    the 5x5 kernel's times the depth, normal and luminance terms; the colour
    is the weighted mean, the variance the mean under the squared weights;
    a background pixel keeps its input."""
    h, w = var.shape
    lum = _lum(color)
    denom = sig_luminance * torch.sqrt(var_f.clamp(min=0.0)) + 1e-4
    c_acc = torch.zeros_like(color)
    v_acc, wsum, w2sum = torch.zeros_like(var), torch.zeros_like(var), torch.zeros_like(var)
    for i in range(-2, 3):
        for j in range(-2, 3):
            dy, dx = i * step, j * step
            c_q = _tap(color, dy, dx)
            w_depth = torch.exp(-((pos - _tap(pos, dy, dx)) ** 2).sum(0) / (sig_depth + 1e-4))
            w_normal = (normal * _tap(normal, dy, dx)).sum(0).clamp(min=0.0) ** sig_normal + 1e-4
            w_geo = torch.where(_inside(h, w, dy, dx, var.device),
                                w_normal * w_depth * GAUSSIAN_5X5[i + 2][j + 2], 0.0)
            w_lum = torch.exp(-(lum - _lum(c_q)).abs() / denom) + 1e-4
            wt = w_lum * w_geo
            c_acc = c_acc + c_q * wt
            v_acc = v_acc + _tap(var, dy, dx) * wt * wt
            wsum = wsum + wt
            w2sum = w2sum + wt * wt
    out_c = torch.where(wsum >= FLT_EPS, c_acc / wsum.clamp(min=1e-12), color)
    out_v = torch.where(w2sum >= FLT_EPS, v_acc / w2sum.clamp(min=1e-12), var)
    background = prim_id <= gb.NULL_PRIMITIVE
    return torch.where(background, color, out_c), torch.where(background, var, out_v)


def svgf_filter(color, hist: History, gbuf: gb.GBufferOut, last: gb.GBufferFrame,
                cam: cam_mod.Camera, first: bool, levels: int = 5, sig_depth: float = 4.0,
                sig_normal: float = 128.0, sig_luminance: float = 1.0):
    """One call of the filter (SpatioTemporalFilter::filter,
    denoiser.cu:525-558) on ``color`` [N, 3], the G-buffer of this call
    (its motion into ``last``'s raster) and the last call's frame.  Returns
    (filtered colour [N, 3], the next call's :class:`History`)."""
    h, w = cam.height, cam.width
    color_acc, moment = temporal_accumulate(color, hist, gbuf, last, first)
    frame = gbuf.frame
    idx = torch.arange(h * w, dtype=torch.int32, device=color.device)
    ray_o, ray_d = cam_mod.pinhole_rays(cam, idx % w, idx // w)
    pos = _planar(ray_o + ray_d * frame.depth[:, None], h, w)
    normal = _planar(gb.decoded_normal(frame), h, w)
    prim_id = frame.prim_id.reshape(h, w)
    c = _planar(color_acc, h, w)
    var = estimate_variance(moment, h, w)
    history = None
    for level in range(levels):
        c, var = guided_level(c, var, filter_variance(var), pos, normal, prim_id, 1 << level,
                              sig_depth, sig_normal, sig_luminance)
        if level == 0:
            history = c
    return _flat(c), History(color=_flat(history), moment=moment)
