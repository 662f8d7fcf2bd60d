"""The closest hit's surface as one CUDA kernel (``csrc/surface.cu``).

:func:`surface` is what the frames call on the winners of a closest hit,
in lane order (``intersect_ids``, ``intersect_sorted_ids``,
``intersect_primary_ids`` of scene/device_scene.py): the hit's position
and shading normal, recovered from the winner id on the sweep engines
(``bary`` None) or from the engine's barycentrics, the material after its
texture and normal maps, and optionally the hit's accounting, the env map
an escaped ray sees and an emissive hit's radiance, each MIS-weighted into
the path's accumulator.  On CUDA tensors it launches ``surface_kernel``
(:func:`surface_cuda`), which computes what
:func:`.pathtrace.surface_plain` computes with eager torch operations,
operation for operation; on CPU tensors it runs ``surface_plain``.

The accounting, ``path``: None (the G-buffer, ReSTIR's primaries: the
surface and material alone); :data:`PRIMARY` (the path tracer's
primaries: throughput 1 after a delta sample, nothing accumulated yet, so
``acc`` is the primary hit's emission or the env map and ``active`` a hit
that is not a light); or a bounce's :class:`PathState`.

Each launch counts ``launch.surface.surface`` and each plain call
``plain.surface.surface`` (utils/timing.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..scene import device_scene as dsc
from ..utils import timing
from .shading_args import lane_tensor

# the kernel's accounting modes (csrc/surface.cu)
ACCOUNT_NONE, ACCOUNT_PRIMARY, ACCOUNT_BOUNCE = 0, 1, 2
PRIMARY = "primary"  # ``path`` of the path tracer's primaries

# bytes a lane reads and writes (csrc/surface.cu): the winner; the ray
# (origin and direction) or the barycentrics (the direction too with the
# accounting); a bounce's path state (acc, active, throughput, pdf, delta,
# previous vertex); position, normal, the five material fields and the
# material id; with the accounting acc and active.  Each triangle hit is
# read once, its row of 25 floats.
BYTES_ID, BYTES_RAY, BYTES_BARY, BYTES_DIR = 4, 24, 8, 12
BYTES_PATH, BYTES_OUT, BYTES_ACCOUNT_OUT = 42, 56, 13
BYTES_ROW = 100


@dataclass
class PathState:
    """A bounce's path state at its extension ray's hit: the accumulator
    [N, 3], ``active`` [N], the throughput [N, 3], the BSDF sample's pdf
    [N] and delta flag [N] that sampled the ray, and the previous vertex
    (the ray's start) [N, 3]."""

    acc: torch.Tensor
    active: torch.Tensor
    throughput: torch.Tensor
    pdf: torch.Tensor
    delta: torch.Tensor
    prev_pos: torch.Tensor


@dataclass
class Surface:
    """The hit of each lane: position and shading normal [N, 3] (after the
    normal map), the material, the material id [N] (-1 on a miss); with
    the accounting the accumulator [N, 3] and ``active`` [N] after it
    (None without)."""

    pos: torch.Tensor
    norm: torch.Tensor
    mat: dsc.SurfaceMaterial
    mat_id: torch.Tensor
    acc: torch.Tensor | None = None
    active: torch.Tensor | None = None


def account_mode(path) -> int:
    """The kernel's accounting mode for ``path`` (module docstring)."""
    if path is None:
        return ACCOUNT_NONE
    return ACCOUNT_PRIMARY if path == PRIMARY else ACCOUNT_BOUNCE


def bytes_moved(ds: dsc.DeviceScene, prim: torch.Tensor, interpolated: bool,
                account: int) -> int:
    """The bytes the kernel reads and writes over the winners ``prim`` [N]
    in form ``interpolated`` (barycentrics) with accounting mode
    ``account``: csrc/surface.cu's bound."""
    lane = BYTES_ID + BYTES_OUT
    lane += (BYTES_BARY + (BYTES_DIR if account != ACCOUNT_NONE else 0) if interpolated
             else BYTES_RAY)
    if account != ACCOUNT_NONE:
        lane += BYTES_ACCOUNT_OUT
    if account == ACCOUNT_BOUNCE:
        lane += BYTES_PATH
    rows = torch.unique(prim.clamp(0, ds.num_triangles - 1)).numel() if prim.numel() else 0
    return prim.numel() * lane + rows * BYTES_ROW


def surface(ds: dsc.DeviceScene, prim, bary, ray_o, ray_d, path=None) -> Surface:
    """:func:`.pathtrace.surface_plain` on CPU tensors; on CUDA tensors one
    launch of the kernel of csrc/surface.cu, the same :class:`Surface` bit
    for bit.  A CUDA call the kernel cannot take raises."""
    if not prim.is_cuda:
        from .pathtrace import surface_plain

        return surface_plain(ds, prim, bary, ray_o, ray_d, path)
    return surface_cuda(ds, prim, bary, ray_o, ray_d, path)


_P, _I = ctypes.c_void_p, ctypes.c_int


class SurfaceArgs(ctypes.Structure):
    """csrc/surface.cu's ``SurfaceArgs``, field for field."""

    _fields_ = [
        ("prim", _P), ("ray_o", _P), ("ray_d", _P), ("bary", _P), ("n", _I),
        ("account", _I), ("acc", _P), ("active", _P), ("throughput", _P), ("pdf", _P),
        ("delta", _P), ("prev_pos", _P),
        ("tri_attr", _P), ("n_tris", _I),
        ("mat_type", _P), ("mat_base_color", _P), ("mat_metallic", _P), ("mat_roughness", _P),
        ("mat_ior", _P), ("mat_color_map", _P), ("mat_normal_map", _P),
        ("mat_metallic_map", _P), ("mat_roughness_map", _P), ("n_mats", _I), ("textured", _I),
        ("tex_data", _P), ("tex_offset", _P), ("tex_width", _P), ("tex_height", _P),
        ("n_tex", _I),
        ("has_env", _I), ("env_tex", _I), ("single_sided", _I), ("sum_light_power_inv", _P),
        ("pos", _P), ("norm", _P), ("mtype", _P), ("base_color", _P), ("metallic", _P),
        ("roughness", _P), ("ior", _P), ("mat_id", _P), ("acc_out", _P), ("active_out", _P),
    ]


def surface_cuda(ds: dsc.DeviceScene, prim, bary, ray_o, ray_d, path=None) -> Surface:
    """The surface kernel on the winners ``prim`` int32 [N] of the rays
    ``ray_o``, ``ray_d`` f32 [N, 3] with the engine's barycentrics ``bary``
    f32 [N, 2] (None: from the winner id) and the accounting ``path``
    (module docstring): one launch."""
    from ..accel._build import load_library

    n = prim.shape[0]
    account = account_mode(path)
    prim = lane_tensor(prim, "prim", torch.int32, (n,))
    ray_d = lane_tensor(ray_d, "ray_d", torch.float32, (n, 3))
    keep = [prim, ray_d]
    ptrs = {"prim": prim.data_ptr(), "ray_d": ray_d.data_ptr()}
    if bary is None:
        ray_o = lane_tensor(ray_o, "ray_o", torch.float32, (n, 3))
        keep.append(ray_o)
        ptrs["ray_o"] = ray_o.data_ptr()
    else:
        bary = lane_tensor(bary, "bary", torch.float32, (n, 2))
        keep.append(bary)
        ptrs["bary"] = bary.data_ptr()
    if account == ACCOUNT_BOUNCE:
        for name, dtype, shape in (("acc", torch.float32, (n, 3)), ("active", torch.bool, (n,)),
                                   ("throughput", torch.float32, (n, 3)),
                                   ("pdf", torch.float32, (n,)), ("delta", torch.bool, (n,)),
                                   ("prev_pos", torch.float32, (n, 3))):
            t = lane_tensor(getattr(path, name), name, dtype, shape)
            keep.append(t)
            ptrs[name] = t.data_ptr()
    dev = prim.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = Surface(pos=empty(n, 3), norm=empty(n, 3),
                  mat=dsc.SurfaceMaterial(mtype=empty(n, dtype=torch.int32),
                                          base_color=empty(n, 3), metallic=empty(n),
                                          roughness=empty(n), ior=empty(n)),
                  mat_id=empty(n, dtype=torch.int32))
    if account != ACCOUNT_NONE:
        out.acc, out.active = empty(n, 3), empty(n, dtype=torch.bool)
    if n == 0:
        return out
    tables = [t.contiguous() for t in (
        ds.tri_attr, ds.mat_type, ds.mat_base_color, ds.mat_metallic, ds.mat_roughness,
        ds.mat_ior, ds.mat_color_map, ds.mat_normal_map, ds.mat_metallic_map,
        ds.mat_roughness_map, ds.tex_data, ds.tex_offset, ds.tex_width, ds.tex_height,
        ds.sum_light_power_inv)]
    for t in tables:
        if t.device != dev:
            raise ValueError(f"the scene's tables must be on {dev}, got {t.device}")
    (tri_attr, mtype, base, metallic, roughness, ior, cmap, nmap, mmap, rmap, tex, off, tw, th,
     slpi) = tables
    args = SurfaceArgs(
        **ptrs, n=n, account=account,
        tri_attr=tri_attr.data_ptr(), n_tris=tri_attr.shape[0],
        mat_type=mtype.data_ptr(), mat_base_color=base.data_ptr(),
        mat_metallic=metallic.data_ptr(), mat_roughness=roughness.data_ptr(),
        mat_ior=ior.data_ptr(), mat_color_map=cmap.data_ptr(), mat_normal_map=nmap.data_ptr(),
        mat_metallic_map=mmap.data_ptr(), mat_roughness_map=rmap.data_ptr(),
        n_mats=mtype.shape[0], textured=int(ds.textured),
        tex_data=tex.data_ptr(), tex_offset=off.data_ptr(), tex_width=tw.data_ptr(),
        tex_height=th.data_ptr(), n_tex=off.shape[0],
        has_env=int(ds.has_env), env_tex=max(ds.env_tex, 0),
        single_sided=int(ds.single_sided), sum_light_power_inv=slpi.data_ptr(),
        pos=out.pos.data_ptr(), norm=out.norm.data_ptr(), mtype=out.mat.mtype.data_ptr(),
        base_color=out.mat.base_color.data_ptr(), metallic=out.mat.metallic.data_ptr(),
        roughness=out.mat.roughness.data_ptr(), ior=out.mat.ior.data_ptr(),
        mat_id=out.mat_id.data_ptr(),
        acc_out=None if out.acc is None else out.acc.data_ptr(),
        active_out=None if out.active is None else out.active.data_ptr())
    lib = load_library("surface")
    with torch.cuda.device(dev):
        err = lib.surface_shade(ctypes.addressof(args),
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"surface kernel launch failed: CUDA error {err}")
    timing.count("launch.surface.surface")
    return out
