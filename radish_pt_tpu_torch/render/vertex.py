"""The path tracer's vertex as one CUDA kernel (``csrc/vertex.cu``).

:func:`vertex` is what the bounce loops call at each path vertex (the
two-sided shading normal, next-event estimation's light sample, BSDF
evaluation and MIS, the BSDF sample and the throughput update): on CUDA
tensors it launches ``vertex_kernel`` (:func:`vertex_cuda`), which computes
what :func:`.pathtrace.vertex_plain` computes with eager torch operations,
operation for operation; on CPU tensors it runs ``vertex_plain``.  Either
returns a :class:`Vertex` whose contribution is NEE's as if the light
were visible: the caller runs the shadow test on its segment and zeroes it
where blocked (:func:`.pathtrace._vertex`).

Each launch counts ``launch.vertex.vertex`` and each plain call
``plain.vertex.vertex`` (utils/timing.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..sampling import rng
from ..scene import device_scene as dsc
from ..utils import timing
from .shading_args import has_type, lane_tensor, scene_fields


# bytes every lane reads (position, normal, direction, throughput, active,
# the material's type, base colour, the scramble) and writes (segment end,
# ok, contribution, scramble, active, throughput, direction, pdf, delta),
# and what a lane of one material type reads besides: metallic and
# roughness on a MetallicWorkflow lane, ior on a dielectric one
BYTES_PER_LANE = (48 + 1 + 4 + 12 + 8) + (12 + 1 + 12 + 8 + 1 + 12 + 12 + 4 + 1)
BYTES_BY_TYPE = {dsc.MAT_METALLIC_WORKFLOW: 8, dsc.MAT_DIELECTRIC: 4}


@dataclass
class Vertex:
    """One path vertex of a wavefront: NEE's shadow segment (from the lane's
    position to ``seg_end``) and ``ok``, the lanes whose light sample
    counts if the segment is clear; ``contrib`` [N, 3], NEE's MIS-weighted
    contribution as if it were (zero where not ``ok``); then the sampler,
    ``active``, ``throughput`` and the BSDF sample's direction, pdf and
    delta flag after the BSDF sample."""

    seg_end: torch.Tensor
    ok: torch.Tensor
    contrib: torch.Tensor
    sampler: rng.SamplerState
    active: torch.Tensor
    throughput: torch.Tensor
    new_dir: torch.Tensor
    pdf: torch.Tensor
    delta: torch.Tensor


def bytes_moved(mtype: torch.Tensor) -> int:
    """The bytes the kernel reads and writes over lanes of material types
    ``mtype`` [N]: csrc/vertex.cu's bound."""
    extra = sum(b * int((mtype == ty).sum()) for ty, b in BYTES_BY_TYPE.items())
    return mtype.numel() * BYTES_PER_LANE + extra



def vertex(ds: dsc.DeviceScene, sampler, active, mat: dsc.SurfaceMaterial, norm, ray_d, pos,
           throughput) -> Vertex:
    """:func:`.pathtrace.vertex_plain` on CPU tensors; on CUDA tensors one
    launch of the kernel of csrc/vertex.cu, the same :class:`Vertex` bit for
    bit.  A CUDA call the kernel cannot take raises."""
    if not pos.is_cuda:
        from .pathtrace import vertex_plain

        return vertex_plain(ds, sampler, active, mat, norm, ray_d, pos, throughput)
    return vertex_cuda(ds, sampler, active, mat, norm, ray_d, pos, throughput)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class VertexArgs(ctypes.Structure):
    """csrc/vertex.cu's ``VertexArgs``, field for field."""

    _fields_ = [
        ("pos", _P), ("norm", _P), ("ray_d", _P), ("throughput", _P), ("active", _P),
        ("mtype", _P), ("base_color", _P), ("metallic", _P), ("roughness", _P), ("ior", _P),
        ("scramble", _P), ("n", _I),
        ("ptr", _P), ("sobol", _P), ("sobol_len", _L),
        ("tri_v", _P), ("light_prim", _P), ("light_radiance", _P), ("light_prob", _P),
        ("light_alias", _P), ("sum_light_power_inv", _P), ("n_area", _I), ("n_alias", _I),
        ("has_env", _I), ("single_sided", _I),
        ("lambertian", _I), ("metallic_lobe", _I), ("dielectric", _I),
        ("env_prob", _P), ("env_alias", _P), ("tex_data", _P), ("tex_offset", _P),
        ("tex_width", _P), ("tex_height", _P), ("n_env", _I), ("env_tex", _I),
        ("ok", _P), ("seg_end", _P), ("contrib", _P), ("scramble_out", _P), ("ptr_out", _P),
        ("active_out", _P), ("throughput_out", _P), ("new_dir", _P), ("pdf", _P),
        ("delta", _P),
    ]


def vertex_cuda(ds: dsc.DeviceScene, sampler, active, mat: dsc.SurfaceMaterial, norm, ray_d,
                pos, throughput) -> Vertex:
    """The vertex kernel on the lanes ``pos``, ``norm`` (the hit's shading
    normal), ``ray_d`` (the ray that reached it), ``throughput`` f32
    [N, 3], ``active`` bool [N], material ``mat`` and ``sampler``
    (:class:`..sampling.rng.SamplerState` on the card): one launch."""
    from ..accel._build import load_library

    n = pos.shape[0]
    pos = lane_tensor(pos, "pos", torch.float32, (n, 3))
    norm = lane_tensor(norm, "norm", torch.float32, (n, 3))
    ray_d = lane_tensor(ray_d, "ray_d", torch.float32, (n, 3))
    throughput = lane_tensor(throughput, "throughput", torch.float32, (n, 3))
    active = lane_tensor(active, "active", torch.bool, (n,))
    mtype = lane_tensor(mat.mtype, "mtype", torch.int32, (n,))
    base = lane_tensor(mat.base_color, "base_color", torch.float32, (n, 3))
    metallic = lane_tensor(mat.metallic, "metallic", torch.float32, (n,))
    roughness = lane_tensor(mat.roughness, "roughness", torch.float32, (n,))
    ior = lane_tensor(mat.ior, "ior", torch.float32, (n,))
    scramble = lane_tensor(sampler.scramble, "scramble", torch.int64, (n,))
    ptr = lane_tensor(sampler.ptr, "ptr", torch.int64, ())
    dev = pos.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = Vertex(seg_end=empty(n, 3), ok=empty(n, dtype=torch.bool), contrib=empty(n, 3),
                 sampler=rng.SamplerState(scramble=empty(n, dtype=torch.int64),
                                          ptr=empty(dtype=torch.int64)),
                 active=empty(n, dtype=torch.bool), throughput=empty(n, 3),
                 new_dir=empty(n, 3), pdf=empty(n), delta=empty(n, dtype=torch.bool))
    if n == 0:
        out.sampler.ptr = ptr + 7
        return out
    fields, _tables = scene_fields(ds, dev)
    args = VertexArgs(
        pos=pos.data_ptr(), norm=norm.data_ptr(), ray_d=ray_d.data_ptr(),
        throughput=throughput.data_ptr(), active=active.data_ptr(), mtype=mtype.data_ptr(),
        base_color=base.data_ptr(), metallic=metallic.data_ptr(),
        roughness=roughness.data_ptr(), ior=ior.data_ptr(), scramble=scramble.data_ptr(),
        n=n, ptr=ptr.data_ptr(), dielectric=has_type(ds.mat_types, dsc.MAT_DIELECTRIC),
        ok=out.ok.data_ptr(), seg_end=out.seg_end.data_ptr(), contrib=out.contrib.data_ptr(),
        scramble_out=out.sampler.scramble.data_ptr(), ptr_out=out.sampler.ptr.data_ptr(),
        active_out=out.active.data_ptr(), throughput_out=out.throughput.data_ptr(),
        new_dir=out.new_dir.data_ptr(), pdf=out.pdf.data_ptr(), delta=out.delta.data_ptr(),
        **fields)
    lib = load_library("vertex")
    with torch.cuda.device(dev):
        err = lib.vertex_shade(ctypes.addressof(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vertex kernel launch failed: CUDA error {err}")
    timing.count("launch.vertex.vertex")
    return out
