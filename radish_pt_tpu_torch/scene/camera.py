"""Thin-lens perspective camera.

Port of ``radish_pt_tpu/scene/camera.py`` (reference sceneStructs.h:21-131):
a dataclass of f32 tensors plus the static resolution; ray generation is a
batched function of pixel coordinates.  The view basis is computed in f32
exactly as the reference computes it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import math as m
from ..utils import timing


@dataclass
class Camera:
    width: int = 800
    height: int = 800
    position: torch.Tensor = None  # f32 [3]
    rotation: torch.Tensor = None  # f32 [3] yaw/pitch/roll degrees
    view: torch.Tensor = None  # f32 [3]
    up: torch.Tensor = None  # f32 [3]
    right: torch.Tensor = None  # f32 [3]
    fov_y: torch.Tensor = None  # f32 scalar, HALF vertical fov in degrees
    tan_fov_y: torch.Tensor = None  # f32 scalar
    lens_radius: torch.Tensor = None  # f32 scalar
    focal_dist: torch.Tensor = None  # f32 scalar

    @property
    def aspect(self):
        return self.width / self.height

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


def make_camera(
    width: int,
    height: int,
    position,
    rotation,
    fov_y: float = 45.0,
    lens_radius: float = 0.0,
    focal_dist: float = 1.0,
    device="cuda",
) -> Camera:
    def f32(v):  # a copy from pageable host memory: the host waits
        timing.host_sync()
        return torch.tensor(v, dtype=torch.float32, device=device)

    cam = Camera(
        width=int(width),
        height=int(height),
        position=f32(np.asarray(position, np.float32)),
        rotation=f32(np.asarray(rotation, np.float32)),
        fov_y=f32(np.float32(fov_y)),
        lens_radius=f32(np.float32(lens_radius)),
        focal_dist=f32(np.float32(focal_dist)),
    )
    return update_camera(cam)


def update_camera(cam: Camera) -> Camera:
    """Recompute the view basis from yaw/pitch/roll — reference
    ``Camera::update`` (sceneStructs.h:93-107)."""
    yaw = torch.deg2rad(cam.rotation[0])
    pitch = torch.deg2rad(cam.rotation[1])
    roll = torch.deg2rad(cam.rotation[2])
    view = torch.stack([
        torch.cos(yaw) * torch.cos(pitch),
        torch.sin(pitch) * torch.cos(roll),
        torch.sin(yaw) * torch.cos(pitch),
    ])
    view = m.normalize(view)
    world_up = m.const((0.0, 1.0, 0.0), device=view.device)
    right = m.normalize(m.cross(view, world_up))
    up = m.normalize(m.cross(right, view))
    return cam.replace(view=view, up=up, right=right,
                       tan_fov_y=torch.tan(torch.deg2rad(cam.fov_y)))


def sample_rays(cam: Camera, x, y, r, p_aperture=None):
    """One primary ray per lane — reference ``Camera::sample``
    (sceneStructs.h:72-91) with the aperture wired up.

    x, y: int tensors [N] of pixel coords; r: [N, 4] uniforms (r.xy = pixel
    jitter; r.zw = aperture sample when ``p_aperture`` is None).
    Returns (origins [N, 3], directions [N, 3]).
    """
    dev = r.device
    aspect = m.const(cam.aspect, device=dev)
    pixel_size = 1.0 / m.const((float(cam.width), float(cam.height)), device=dev)
    scr = torch.stack([x, y], dim=-1).to(torch.float32) * pixel_size
    ruv = scr + pixel_size * r[..., 0:2]
    ruv = 1.0 - ruv * 2.0

    if p_aperture is None:
        p_aperture = m.concentric_sample_disk(r[..., 2], r[..., 3])
    p_lens = p_aperture * cam.lens_radius  # [N, 2]

    p_focus = torch.stack(
        [ruv[..., 0] * aspect * cam.tan_fov_y,
         ruv[..., 1] * cam.tan_fov_y,
         torch.ones_like(ruv[..., 0])],
        dim=-1,
    ) * cam.focal_dist
    d_local = p_focus - torch.cat([p_lens, torch.zeros_like(p_lens[..., :1])],
                                  dim=-1)
    # world = mat3(right, up, view) * local  (columns are the basis vectors)
    d_world = (cam.right * d_local[..., 0:1] + cam.up * d_local[..., 1:2]
               + cam.view * d_local[..., 2:3])
    directions = m.normalize(d_world)
    origins = (cam.position + cam.right * p_lens[..., 0:1]
               + cam.up * p_lens[..., 1:2])
    return origins.expand_as(directions).contiguous(), directions


def pinhole_rays(cam: Camera, x, y):
    """Center-of-pixel pinhole rays (no jitter, no lens) — the G-buffer
    pass's rays (gBuffer.cu:11-26)."""
    r = torch.full(x.shape + (4,), 0.5, dtype=torch.float32, device=x.device)
    zero_ap = torch.zeros(x.shape + (2,), dtype=torch.float32, device=x.device)
    return sample_rays(cam, x, y, r, p_aperture=zero_ap)


def raster_uv(cam: Camera, pos):
    """World position -> this camera's raster uv in [0, 1]^2 — reference
    ``Camera::getRasterUV`` (sceneStructs.h:22-43)."""
    dir = m.normalize(pos - cam.position)
    d = 1.0 / m.dot(dir, cam.view)
    p = dir * d[..., None]
    # rotationMatInv is the transpose of [right|up|view] (orthonormal)
    px = m.dot(p, cam.right)
    py = m.dot(p, cam.up)
    aspect = m.const(cam.aspect, device=pos.device)
    ndc_x = -(px / (aspect * cam.tan_fov_y))
    ndc_y = -(py / cam.tan_fov_y)
    return torch.stack([ndc_x, ndc_y], dim=-1) * 0.5 + 0.5


def raster_coord(cam: Camera, pos):
    """Integer raster coords — reference ``getRasterCoord``
    (sceneStructs.h:45-48).  May be out of bounds: callers range-check."""
    uv = raster_uv(cam, pos)
    res = m.const((float(cam.width), float(cam.height)), device=pos.device)
    return torch.floor(uv * res).to(torch.int32)
