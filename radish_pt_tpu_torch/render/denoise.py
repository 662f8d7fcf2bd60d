"""Denoisers: Gaussian blur, edge-avoiding à-trous wavelet (EAW) and SVGF.

Port of ``radish_pt_tpu/render/denoise.py`` (reference denoiser.cu):
* ``waveletFilter`` (EAW, :17-85) and its variance-guided SVGF form (:92-173);
* ``temporalAccumulate`` (:208-262), ``estimateVariance`` (:264-299),
  ``filterVariance`` (:301-328);
* the level drivers ``LeveledEAWFilter::filter`` (:419-434) and
  ``SpatioTemporalFilter::filter`` (:525-558).

Every stencil is a sum over statically shifted views of planar [C, H, W]
images (a roll plus a boundary mask), as in the JAX package; the public
functions take and return flat [N, C] tensors.  Plain torch: the JAX
package has no Pallas kernel here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..scene import camera as cam_mod
from ..utils import math as m
from ..utils import timing as tracing
from .gbuffer import (NULL_PRIMITIVE, GBufferFrame, GBufferOut, camera_get_position,
                      decoded_normal)

GAUSSIAN_3X3 = np.array(
    [[0.075, 0.124, 0.075], [0.124, 0.204, 0.124], [0.075, 0.124, 0.075]],
    dtype=np.float32)

GAUSSIAN_5X5 = np.array(
    [[0.0030, 0.0133, 0.0219, 0.0133, 0.0030],
     [0.0133, 0.0596, 0.0983, 0.0596, 0.0133],
     [0.0219, 0.0983, 0.1621, 0.0983, 0.0219],
     [0.0133, 0.0596, 0.0983, 0.0596, 0.0133],
     [0.0030, 0.0133, 0.0219, 0.0133, 0.0030]],
    dtype=np.float32)

FLT_EPS = 1.1920929e-07


def _planar(flat, h: int, w: int):
    """[N, C] -> [C, H, W] (or [N] -> [H, W])."""
    if flat.dim() == 1:
        return flat.reshape(h, w)
    return flat.t().reshape(flat.shape[1], h, w)


def _flat(img):
    """[C, H, W] -> [N, C] (or [H, W] -> [N])."""
    if img.dim() == 2:
        return img.reshape(-1)
    return img.reshape(img.shape[0], -1).t().contiguous()


def _shift(img, dy: int, dx: int):
    """out[..., y, x] = img[..., y + dy, x + dx] over the last two axes;
    wrapped values must be masked with :func:`_shift_mask`."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _shift_mask(h: int, w: int, dy: int, dx: int, device):
    yy = torch.arange(h, device=device)[:, None] + dy
    xx = torch.arange(w, device=device)[None, :] + dx
    return (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)


def _lum(color):
    """Luminance of a planar [3, H, W] stack -> [H, W]."""
    return 0.2126 * color[0] + 0.7152 * color[1] + 0.0722 * color[2]


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


def _geometry(frame: GBufferFrame, cam: cam_mod.Camera):
    """Planar world positions [3, H, W], normals [3, H, W] and ids [H, W]
    of a G-buffer frame."""
    h, w = cam.height, cam.width
    idx = torch.arange(h * w, dtype=torch.int32, device=frame.depth.device)
    pos = _planar(camera_get_position(cam, idx % w, idx // w, frame.depth), h, w)
    return pos, _planar(decoded_normal(frame), h, w), frame.prim_id.reshape(h, w)


# ---------------------------------------------------------------------------
# EAW à-trous wavelet (denoiser.cu:17-85)
# ---------------------------------------------------------------------------


def eaw_level(color, normal, prim_id, pos, step: int, sig_depth: float,
              sig_normal: float, sig_luminance: float):
    """One à-trous level over planar ``color`` [3, H, W] guided by
    ``normal`` [3, H, W], ``prim_id`` [H, W] and ``pos`` [3, H, W]."""
    h, w = color.shape[-2:]
    acc = torch.zeros_like(color)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=color.device)
    for i in range(-2, 3):
        for j in range(-2, 3):
            dy, dx = i * step, j * step
            valid = _shift_mask(h, w, dy, dx, color.device)
            cq = _shift(color, dy, dx)
            nq = _shift(normal, dy, dx)
            pq = _shift(pos, dy, dx)
            iq = _shift(prim_id, dy, dx)
            valid = valid & (iq == prim_id)
            dc2 = torch.sum((color - cq) ** 2, dim=0)
            dn2 = torch.sum((normal - nq) ** 2, dim=0)
            dp2 = torch.sum((pos - pq) ** 2, dim=0)
            # one exp for the three edge-stopping terms (each distance is
            # >= 0, so min(1, exp(-x)) is exp(-x))
            wt = torch.exp(-(dc2 / sig_luminance + dn2 / sig_normal + dp2 / sig_depth)
                           ) * float(GAUSSIAN_5X5[i + 2, j + 2])
            wt = _where0(valid, wt)
            acc = acc + cq * wt[None]
            wsum = wsum + wt
    out = torch.where(wsum[None] > 0.0, acc / torch.clamp(wsum, min=1e-12)[None], color)
    # background pixels pass through (denoiser.cu:31-34)
    return torch.where(prim_id[None] <= NULL_PRIMITIVE, color, out)


def leveled_eaw_filter(color_flat, frame: GBufferFrame, cam: cam_mod.Camera,
                       levels: int = 5, sig_depth: float = 64.0,
                       sig_normal: float = 0.2, sig_luminance: float = 1.0):
    """The 5-level EAW chain — LeveledEAWFilter (denoiser.cu:411-434,
    sigmas from :413)."""
    pos, normal, prim = _geometry(frame, cam)
    color = _planar(color_flat, cam.height, cam.width)
    for level in range(levels):
        color = eaw_level(color, normal, prim, pos, 1 << level, sig_depth,
                          sig_normal, sig_luminance)
    return _flat(color)


def gaussian_filter(color_flat, width: int, height: int):
    """Plain 5x5 Gaussian blur (the reference GUI's ``Denoiser::Gaussian``,
    common.h:38)."""
    color = _planar(color_flat, height, width)
    acc = torch.zeros_like(color)
    wsum = torch.zeros((height, width), dtype=torch.float32, device=color.device)
    for i in range(-2, 3):
        for j in range(-2, 3):
            valid = _shift_mask(height, width, i, j, color.device)
            wt = _where0(valid, torch.full_like(wsum, float(GAUSSIAN_5X5[i + 2, j + 2])))
            acc = acc + _shift(color, i, j) * wt[None]
            wsum = wsum + wt
    return _flat(acc / wsum[None])


# ---------------------------------------------------------------------------
# SVGF (denoiser.cu:92-173, 208-328, 436-558)
# ---------------------------------------------------------------------------


@dataclass
class SVGFState:
    """Temporal history: the accumColor / accumMoment double buffer."""

    accum_color: torch.Tensor  # f32 [N, 3]
    accum_moment: torch.Tensor  # f32 [N, 3] (mean, mean², history length)


def empty_svgf_state(n: int, device="cuda") -> SVGFState:
    z = torch.zeros((n, 3), dtype=torch.float32, device=device)
    return SVGFState(accum_color=z, accum_moment=z)


def _disoccluded(gbuf: GBufferOut, last_prim, last_normal, first_time):
    """True where a pixel's history is unusable (temporalAccumulate's
    geometry tests, denoiser.cu:222-240).  ``first_time``: a bool, or a
    bool 0-d tensor (a captured filter's flag)."""
    cur = gbuf.frame
    diff = (gbuf.motion < 0) | (cur.prim_id <= NULL_PRIMITIVE)
    if isinstance(first_time, torch.Tensor):
        diff = diff | first_time
    elif first_time:
        diff = torch.ones_like(diff)
    diff |= last_prim.to(torch.int32) != cur.prim_id
    diff |= m.abs_dot(decoded_normal(cur), last_normal) < 0.1
    return diff


def _blend(color_in, last_color, last_moment, diff, alpha: float = 0.2):
    """The exponential history blend, reset where ``diff``."""
    lum = m.luminance(color_in)
    blend_color = last_color + (color_in - last_color) * alpha
    blend_m1 = last_moment[..., 0] * (1 - alpha) + lum * alpha
    blend_m2 = last_moment[..., 1] * (1 - alpha) + lum * lum * alpha
    hist = last_moment[..., 2] + 1.0
    color_accum = torch.where(diff[..., None], color_in, blend_color)
    moment_accum = torch.where(
        diff[..., None],
        torch.stack([lum, lum * lum, torch.zeros_like(lum)], dim=-1),
        torch.stack([blend_m1, blend_m2, hist], dim=-1))
    return color_accum, moment_accum


def temporal_accumulate(color_in, state: SVGFState, gbuf: GBufferOut,
                        last_frame: GBufferFrame, first_time: bool):
    """Exponential history blend with disocclusion reset, alpha = 0.2
    (temporalAccumulate, denoiser.cu:208-262).  One packed [N, 10] row per
    motion gather."""
    last_idx = torch.clamp(gbuf.motion, min=0).long()
    packed = torch.cat([state.accum_color, state.accum_moment,
                        decoded_normal(last_frame),
                        last_frame.prim_id.to(torch.float32)[:, None]], dim=1)[last_idx]
    diff = _disoccluded(gbuf, packed[:, 9], packed[:, 6:9], first_time)
    return _blend(color_in, packed[:, 0:3], packed[:, 3:6], diff)


def estimate_variance(moment_flat, width: int, height: int):
    """Temporal variance where the history is longer than 3.5 frames, else
    the 3x3 spatial moments' (estimateVariance, denoiser.cu:264-299)."""
    moment = _planar(moment_flat, height, width)  # [3, H, W]
    temporal_var = moment[1] - moment[0] ** 2
    msum = torch.zeros((2, height, width), dtype=torch.float32, device=moment.device)
    count = torch.zeros((height, width), dtype=torch.float32, device=moment.device)
    for i in range(-1, 2):
        for j in range(-1, 2):
            valid = _shift_mask(height, width, i, j, moment.device)
            msum = msum + _where0(valid[None], _shift(moment[:2], i, j))
            count = count + valid.to(torch.float32)
    msum = msum / count[None]
    spatial_var = msum[1] - msum[0] ** 2
    return torch.where(moment[2] > 3.5, temporal_var, spatial_var).reshape(-1)


def filter_variance(var_flat, width: int, height: int):
    """3x3 Gaussian prefilter of the variance (filterVariance,
    denoiser.cu:301-328)."""
    var = var_flat.reshape(height, width)
    acc = torch.zeros_like(var)
    wsum = torch.zeros_like(var)
    for i in range(-1, 2):
        for j in range(-1, 2):
            valid = _shift_mask(height, width, i, j, var.device)
            wt = _where0(valid, torch.full_like(var, float(GAUSSIAN_3X3[i + 1, j + 1])))
            acc = acc + _shift(var, i, j) * wt
            wsum = wsum + wt
    return (acc / torch.clamp(wsum, min=1e-12)).reshape(-1)


def _guided_level(colors, variances, var_filtered, normal, prim_id, pos, step: int,
                  sig_depth: float, sig_normal: float, sig_luminance: float):
    """One variance-guided à-trous level over images that share one
    G-buffer: each tap's depth x normal x kernel weight is computed once
    (it depends only on the geometry, denoiser.cu:123-141) and each image
    adds its own luminance weight.  Returns (colors, variances)."""
    h, w = normal.shape[-2:]
    lum_p = [_lum(c) for c in colors]
    denom = [sig_luminance * torch.sqrt(torch.clamp(v, min=0.0)) + 1e-4
             for v in var_filtered]
    c_acc = [torch.zeros_like(c) for c in colors]
    v_acc = [torch.zeros_like(v) for v in variances]
    wsum = [torch.zeros((h, w), dtype=torch.float32, device=normal.device)
            for _ in colors]
    w2sum = [torch.zeros_like(ws) for ws in wsum]
    for i in range(-2, 3):
        for j in range(-2, 3):
            dy, dx = i * step, j * step
            dp2 = torch.sum((pos - _shift(pos, dy, dx)) ** 2, dim=0)
            w_p = torch.exp(-dp2 / (sig_depth + 1e-4))
            w_n = torch.pow(torch.clamp(torch.sum(normal * _shift(normal, dy, dx), dim=0),
                                        min=0.0), sig_normal) + 1e-4
            w_geo = _where0(_shift_mask(h, w, dy, dx, normal.device),
                            w_n * w_p * float(GAUSSIAN_5X5[i + 2, j + 2]))
            for k, (color, var) in enumerate(zip(colors, variances)):
                cq = _shift(color, dy, dx)
                w_c = torch.exp(-torch.abs(lum_p[k] - _lum(cq)) / denom[k]) + 1e-4
                wt = w_c * w_geo
                c_acc[k] = c_acc[k] + cq * wt[None]
                v_acc[k] = v_acc[k] + _shift(var, dy, dx) * wt * wt
                wsum[k] = wsum[k] + wt
                w2sum[k] = w2sum[k] + wt * wt
    keep = prim_id <= NULL_PRIMITIVE
    out_c, out_v = [], []
    for k, (color, var) in enumerate(zip(colors, variances)):
        c = torch.where(wsum[k][None] >= FLT_EPS,
                        c_acc[k] / torch.clamp(wsum[k], min=1e-12)[None], color)
        v = torch.where(w2sum[k] >= FLT_EPS, v_acc[k] / torch.clamp(w2sum[k], min=1e-12),
                        var)
        out_c.append(torch.where(keep[None], color, c))
        out_v.append(torch.where(keep, var, v))
    return out_c, out_v


def svgf_wavelet_level(color, variance, var_filtered, normal, prim_id, pos, step: int,
                       sig_depth: float, sig_normal: float, sig_luminance: float):
    """One variance-guided à-trous level with Falcor-style weights
    (waveletFilter's SVGF overload, denoiser.cu:92-173).  Planar ``color``
    [3, H, W], ``variance`` / ``var_filtered`` [H, W]; returns (color,
    variance)."""
    (c,), (v,) = _guided_level([color], [variance], [var_filtered], normal, prim_id,
                               pos, step, sig_depth, sig_normal, sig_luminance)
    return c, v


def _svgf_levels(accum, gbuf: GBufferOut, cam: cam_mod.Camera, levels: int,
                 sig_depth: float, sig_normal: float, sig_luminance: float):
    """The spatial half of SVGF for images that share one G-buffer:
    variance from each image's moments, then ``levels`` guided wavelet
    levels.  ``accum``: [(color_accum, moment_accum)], flat.  Returns
    [(filtered color, new SVGFState)]; as in the reference, the level-0
    output becomes next frame's history (the swap at denoiser.cu:533).
    Counts ``denoise.svgf`` an image, ``denoise.svgf_pixels`` its pixels
    and ``denoise.svgf_level`` a guided level; marks ``svgf_levels`` before
    the first variance prefilter."""
    h, w = cam.height, cam.width
    pos, normal, prim = _geometry(gbuf.frame, cam)
    colors = [_planar(c, h, w) for c, _ in accum]
    variances = [estimate_variance(mo, w, h).reshape(h, w) for _, mo in accum]
    tracing.count("denoise.svgf", len(accum))
    tracing.count("denoise.svgf_pixels", len(accum) * h * w)
    tracing.mark("svgf_levels", normal.device)
    history = None
    for level in range(levels):
        tracing.count("denoise.svgf_level")
        var_f = [filter_variance(v.reshape(-1), w, h).reshape(h, w) for v in variances]
        colors, variances = _guided_level(colors, variances, var_f, normal, prim, pos,
                                          1 << level, sig_depth, sig_normal,
                                          sig_luminance)
        if level == 0:
            history = colors  # denoiser.cu:533 swap
    return [(_flat(c), SVGFState(accum_color=_flat(hc), accum_moment=mo))
            for c, hc, (_, mo) in zip(colors, history, accum)]


def svgf_filter(color_in, state: SVGFState, gbuf: GBufferOut, last_frame: GBufferFrame,
                cam: cam_mod.Camera, first_time: bool, levels: int = 5,
                sig_depth: float = 4.0, sig_normal: float = 128.0,
                sig_luminance: float = 1.0):
    """Full SVGF: temporal accumulation -> variance -> 5 guided wavelet
    levels (SpatioTemporalFilter::filter, denoiser.cu:525-558; sigmas from
    :443).  Returns (filtered color [N, 3], new SVGFState)."""
    accum = temporal_accumulate(color_in, state, gbuf, last_frame, first_time)
    ((out, new_state),) = _svgf_levels([accum], gbuf, cam, levels, sig_depth,
                                       sig_normal, sig_luminance)
    return out, new_state


def svgf_filter_pair(color_d, color_i, state_d: SVGFState, state_i: SVGFState,
                     gbuf: GBufferOut, last_frame: GBufferFrame, cam: cam_mod.Camera,
                     first_time: bool, levels: int = 5, sig_depth: float = 4.0,
                     sig_normal: float = 128.0, sig_luminance: float = 1.0):
    """Two SVGF instances, direct and indirect
    (``DENOISER_SPLIT_DIRECT_INDIRECT``), in one pass: the numbers of two
    :func:`svgf_filter` calls, with the shared work done once — one packed
    [N, 16] motion gather for both histories, the disocclusion tests, and
    each tap's geometry weights.  Returns (out_d, out_i, new_state_d,
    new_state_i)."""
    last_idx = torch.clamp(gbuf.motion, min=0).long()
    packed = torch.cat([state_d.accum_color, state_d.accum_moment,
                        state_i.accum_color, state_i.accum_moment,
                        decoded_normal(last_frame),
                        last_frame.prim_id.to(torch.float32)[:, None]], dim=1)[last_idx]
    diff = _disoccluded(gbuf, packed[:, 15], packed[:, 12:15], first_time)
    accum = [_blend(color_d, packed[:, 0:3], packed[:, 3:6], diff),
             _blend(color_i, packed[:, 6:9], packed[:, 9:12], diff)]
    (out_d, new_d), (out_i, new_i) = _svgf_levels(accum, gbuf, cam, levels, sig_depth,
                                                  sig_normal, sig_luminance)
    return out_d, out_i, new_d, new_i
