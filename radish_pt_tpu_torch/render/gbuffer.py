"""G-buffer pass: albedo / normal / material id / depth / motion.

Port of ``radish_pt_tpu/render/gbuffer.py`` (reference ``renderGBuffer``,
gBuffer.cu:3-103, and the double-buffered ``GBuffer``, gBuffer.h).  One
wavefront of pinhole primary rays, in raster order, writes image-shaped
[N] tensors; the renderer keeps (current, last) :class:`GBufferFrame`\\ s
and swaps the references instead of flipping ``frameIdx``.

As in the reference the id channel holds the *material* id, with lights
remapped to ``NULL_PRIMITIVE - 1`` (gBuffer.cu:35-42): the temporal and
spatial ReSTIR and SVGF neighbour tests compare these ids.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..scene import camera as cam_mod
from ..scene import device_scene as dsc
from ..utils import math as m
from ..utils import timing
from . import surface as sf

NULL_PRIMITIVE = -1
LIGHT_ID = NULL_PRIMITIVE - 1  # lights in the id channel (gBuffer.cu:36)


@dataclass
class GBufferFrame:
    """One frame's geometry attributes (the double-buffered half).

    ``normal`` is raw f32 [N, 3] or hemi-octahedral f32 [N, 2]
    (``DENOISER_ENCODE_NORMAL``, gBuffer.h:7-13); consumers read it through
    :func:`decoded_normal`."""

    normal: torch.Tensor  # f32 [N, 3] raw or [N, 2] hemi-oct encoded
    prim_id: torch.Tensor  # i32 [N] material id, lights remapped
    depth: torch.Tensor  # f32 [N] distance along the pinhole ray


@dataclass
class GBufferOut:
    frame: GBufferFrame
    albedo: torch.Tensor  # f32 [N, 3]
    motion: torch.Tensor  # i32 [N] flat pixel index into the last frame, -1 invalid


def empty_frame(n: int, encode_normal: bool = False, device="cuda") -> GBufferFrame:
    return GBufferFrame(
        normal=torch.zeros((n, 2 if encode_normal else 3), dtype=torch.float32,
                           device=device),
        prim_id=torch.full((n,), NULL_PRIMITIVE, dtype=torch.int32, device=device),
        depth=torch.ones((n,), dtype=torch.float32, device=device),
    )


def decoded_normal(frame: GBufferFrame):
    """[N, 3] world normals whatever the frame's storage encoding."""
    if frame.normal.shape[-1] == 2:
        return m.decode_normal_hemioct(frame.normal)
    return frame.normal


def camera_get_position(cam: cam_mod.Camera, x, y, dist):
    """The world position seen at pixel (x, y) at ray distance ``dist`` —
    reference ``Camera::getPosition`` (sceneStructs.h:50-67)."""
    ray_o, ray_d = cam_mod.pinhole_rays(cam, x, y)
    return ray_o + ray_d * dist[..., None]


def render_gbuffer(ds: dsc.DeviceScene, cam: cam_mod.Camera,
                   last_cam: cam_mod.Camera, encode_normal: bool = False,
                   pixel_idx=None, extra_motion_cam=None):
    """The G-buffer of ``cam``'s frame, motion reprojected through
    ``last_cam``.  ``pixel_idx`` (i32 [n] global flat pixel indices, on the
    scene's device): only those pixels, a tile of a mesh; motion stays a
    global index into the last frame.  With ``extra_motion_cam`` returns
    ``(GBufferOut, motion2)``: a second motion field through that camera
    (same hits).  Device stage ``gbuffer`` (utils/timing.py)."""
    timing.mark("gbuffer", ds.device)
    idx = pixel_idx
    if idx is None:
        idx = torch.arange(cam.width * cam.height, dtype=torch.int32, device=ds.device)
    x = idx % cam.width
    y = idx // cam.width

    ray_o, ray_d = cam_mod.pinhole_rays(cam, x, y)
    prim, bary = dsc.intersect_primary_ids(ds, ray_o, ray_d)
    hit = prim != NULL_PRIMITIVE

    surf = sf.surface(ds, prim, bary, ray_o, ray_d)
    mat, norm = surf.mat, surf.norm
    is_light = hit & (mat.mtype == dsc.MAT_LIGHT)
    if ds.single_sided:
        # a light's back face counts as a miss (gBuffer.cu:37-41)
        hit = hit & ~(is_light & (m.dot(norm, ray_d) >= 0.0))

    mat_id = torch.where(is_light, LIGHT_ID, surf.mat_id)

    env_albedo = dsc.env_radiance(ds, ray_d)
    albedo = torch.where(hit[..., None], mat.base_color, env_albedo)
    if encode_normal:
        # DENOISER_ENCODE_NORMAL (gBuffer.h:7-13): miss lanes encode +z (the
        # encoder divides by the L1 norm, so a zero vector would give NaN)
        up = m.const((0.0, 0.0, 1.0), device=norm.device)
        normal = m.encode_normal_hemioct(torch.where(hit[..., None], norm, up))
    else:
        normal = torch.where(hit[..., None], norm, torch.zeros_like(norm))
    prim_id = torch.where(hit, mat_id, NULL_PRIMITIVE).to(torch.int32)
    depth = torch.where(hit, m.length(surf.pos - ray_o), torch.ones_like(ray_o[:, 0]))

    out = GBufferOut(
        frame=GBufferFrame(normal=normal, prim_id=prim_id, depth=depth),
        albedo=albedo,
        motion=_motion_index(cam, last_cam, surf.pos, hit),
    )
    if extra_motion_cam is not None:
        return out, _motion_index(cam, extra_motion_cam, surf.pos, hit)
    return out


def _motion_index(cam, last_cam, pos, hit):
    """Flat pixel index of ``pos`` in ``last_cam``'s raster (-1 off-screen,
    0 on a miss) — gBuffer.cu:53-59."""
    last_pos = cam_mod.raster_coord(last_cam, pos)
    in_bounds = ((last_pos[..., 0] >= 0) & (last_pos[..., 0] < cam.width)
                 & (last_pos[..., 1] >= 0) & (last_pos[..., 1] < cam.height))
    idx = last_pos[..., 1] * cam.width + last_pos[..., 0]
    return torch.where(hit, torch.where(in_bounds, idx, -1), 0).to(torch.int32)


def motion_debug_image(motion, width: int, height: int):
    """Motion indices as rg colours (sendImageToPBO's int overload,
    pathtrace.cu:99-118)."""
    px = (motion % width).to(torch.float32) / width
    py = torch.div(motion, width, rounding_mode="floor").to(torch.float32) / height
    return torch.stack([px, py, torch.zeros_like(px)], dim=-1)
