"""ReSTIR's candidate RIS as one CUDA kernel (``csrc/ris.cu``).

:func:`ris_cuda` launches ``ris_candidates_kernel``: every lane draws
``reservoir_size`` light samples without visibility, weighs each by its
target function over its pdf and keeps one in a weighted reservoir, its
reservoir and sampler state kept in registers across the candidates.  It
computes what :func:`.restir.ris_plain` computes with eager torch
operations, operation for operation; ``restir.candidate_ris`` takes the
plain version for CPU tensors and this kernel for CUDA tensors.

Each launch counts ``launch.ris.ris`` and each plain call ``plain.ris.ris``
(utils/timing.py).
"""

from __future__ import annotations

import ctypes

import torch

from ..scene import device_scene as dsc
from ..utils import timing
from .shading_args import lane_tensor, scene_fields


# operations of one candidate of a lane (an area light, a Lambertian lobe),
# counted from csrc/ris.cu: five draws of 22 (the word's load and xor, the
# convert and scale, the 18 of utilhash: 110), the light pick (7), the
# branch tests and the light's clamp (4), its record's 15 loads, the
# triangle sample (5), the point (15), the direction, squared distance,
# distance and wi (3 + 6 + 5 + 3), luminance and the area pdf (7), the
# light's cosine (9), the solid-angle pdf and the facing test (7), the
# lobe's select (2), sat_dot (8), p_hat (6), its length (9), the weight
# and its guard (8), the update (11); a division or a square root is one
OPS_PER_CANDIDATE = 240
# bytes a lane reads (pos, norm, wo, type, metallic, roughness, scramble)
# and writes (li, wi, dist, num, weight, scramble)
BYTES_PER_LANE = 56 + 44

# the most candidates a launch takes: its 5 draws a candidate are staged in
# shared memory (a block's 48 KB without an opt-in, beside the lights)
MAX_RESERVOIR_SIZE = 1024



_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class RisArgs(ctypes.Structure):
    """csrc/ris.cu's ``RisArgs``, field for field."""

    _fields_ = [
        ("pos", _P), ("norm", _P), ("wo", _P), ("mtype", _P), ("metallic", _P),
        ("roughness", _P), ("scramble", _P), ("n", _I), ("reservoir_size", _I),
        ("ptr", _P), ("sobol", _P), ("sobol_len", _L),
        ("tri_v", _P), ("light_prim", _P), ("light_radiance", _P), ("light_prob", _P),
        ("light_alias", _P), ("sum_light_power_inv", _P), ("n_area", _I), ("n_alias", _I),
        ("has_env", _I), ("single_sided", _I), ("lambertian", _I), ("metallic_lobe", _I),
        ("env_prob", _P), ("env_alias", _P), ("tex_data", _P), ("tex_offset", _P),
        ("tex_width", _P), ("tex_height", _P), ("n_env", _I), ("env_tex", _I),
        ("li", _P), ("wi", _P), ("dist", _P), ("num", _P), ("weight", _P),
        ("scramble_out", _P),
    ]


def ris_cuda(ds: dsc.DeviceScene, pos, mat: dsc.SurfaceMaterial, norm, wo, sampler,
             reservoir_size: int):
    """The candidate RIS kernel on the lanes ``pos``, ``norm``, ``wo`` f32
    [N, 3] with material ``mat`` (shaded with a white base colour, the
    demodulated material of ``restir_candidates``) and ``sampler``
    (:class:`..sampling.rng.SamplerState` on the card).  Returns (li, wi,
    dist, num, weight, scramble): the reservoir's tensors and the sampler's
    scramble after the 5 x ``reservoir_size`` draws."""
    from ..accel._build import load_library

    n = pos.shape[0]
    if not 0 < reservoir_size <= MAX_RESERVOIR_SIZE:
        raise ValueError(f"reservoir_size must be in 1..{MAX_RESERVOIR_SIZE}, got "
                         f"{reservoir_size}")
    pos = lane_tensor(pos, "pos", torch.float32, (n, 3))
    norm = lane_tensor(norm, "norm", torch.float32, (n, 3))
    wo = lane_tensor(wo, "wo", torch.float32, (n, 3))
    mtype = lane_tensor(mat.mtype, "mtype", torch.int32, (n,))
    metallic = lane_tensor(mat.metallic, "metallic", torch.float32, (n,))
    roughness = lane_tensor(mat.roughness, "roughness", torch.float32, (n,))
    scramble = lane_tensor(sampler.scramble, "scramble", torch.int64, (n,))
    ptr = lane_tensor(sampler.ptr, "ptr", torch.int64, ())
    dev = pos.device
    li = torch.empty((n, 3), dtype=torch.float32, device=dev)
    wi = torch.empty((n, 3), dtype=torch.float32, device=dev)
    dist, num, weight = (torch.empty((n,), dtype=torch.float32, device=dev)
                         for _ in range(3))
    scramble_out = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return li, wi, dist, num, weight, scramble_out
    fields, _tables = scene_fields(ds, dev)
    args = RisArgs(
        pos=pos.data_ptr(), norm=norm.data_ptr(), wo=wo.data_ptr(), mtype=mtype.data_ptr(),
        metallic=metallic.data_ptr(), roughness=roughness.data_ptr(),
        scramble=scramble.data_ptr(), n=n, reservoir_size=reservoir_size,
        ptr=ptr.data_ptr(), li=li.data_ptr(), wi=wi.data_ptr(), dist=dist.data_ptr(),
        num=num.data_ptr(), weight=weight.data_ptr(), scramble_out=scramble_out.data_ptr(),
        **fields)
    lib = load_library("ris")
    with torch.cuda.device(dev):
        err = lib.ris_candidates(ctypes.addressof(args),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ris_candidates kernel launch failed: CUDA error {err}")
    timing.count("launch.ris.ris")
    return li, wi, dist, num, weight, scramble_out
