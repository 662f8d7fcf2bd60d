"""ReSTIR's candidate RIS as one CUDA kernel (``csrc/ris.cu``).

:func:`ris_cuda` launches ``ris_candidates_kernel``: every lane draws
``reservoir_size`` light samples without visibility, weighs each by its
target function over its pdf and keeps one in a weighted reservoir, its
reservoir and sampler state kept in registers across the candidates.  It
computes what :func:`.restir.ris_plain` computes with eager torch
operations, operation for operation; ``restir.candidate_ris`` takes the
plain version for CPU tensors and this kernel for CUDA tensors.

``LAUNCHES`` counts the kernel's launches and ``PLAIN_CALLS`` the plain
version's calls (registered in ``render/graph.py``, so a captured block's
replays count the launches the card ran); every launch also counts
``ris.kernel`` in the tracing registry (utils/timing.py).
"""

from __future__ import annotations

import ctypes

import torch

from ..sampling.sobol import SOBOL_SAMPLE_DIM, SOBOL_SAMPLE_NUM
from ..scene import device_scene as dsc
from ..utils import timing

LAUNCHES = {"ris": 0}
PLAIN_CALLS = {"ris": 0}

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


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


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


def _lane(t: torch.Tensor, name: str, dtype, shape) -> torch.Tensor:
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be a {dtype} CUDA tensor of shape {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _has(types, ty) -> int:
    return int(types is None or ty in types)


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
    pos = _lane(pos, "pos", torch.float32, (n, 3))
    norm = _lane(norm, "norm", torch.float32, (n, 3))
    wo = _lane(wo, "wo", torch.float32, (n, 3))
    mtype = _lane(mat.mtype, "mtype", torch.int32, (n,))
    metallic = _lane(mat.metallic, "metallic", torch.float32, (n,))
    roughness = _lane(mat.roughness, "roughness", torch.float32, (n,))
    scramble = _lane(sampler.scramble, "scramble", torch.int64, (n,))
    ptr = _lane(sampler.ptr, "ptr", torch.int64, ())
    dev = pos.device
    li = torch.empty((n, 3), dtype=torch.float32, device=dev)
    wi = torch.empty((n, 3), dtype=torch.float32, device=dev)
    dist, num, weight = (torch.empty((n,), dtype=torch.float32, device=dev)
                         for _ in range(3))
    scramble_out = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return li, wi, dist, num, weight, scramble_out
    scene = [t.contiguous() for t in (
        ds.tri_v, ds.light_prim_ids, ds.light_radiance, ds.light_alias_prob,
        ds.light_alias_idx, ds.sum_light_power_inv, ds.env_alias_prob, ds.env_alias_idx,
        ds.tex_data, ds.tex_offset, ds.tex_width, ds.tex_height)]
    for t in scene:
        if t.device != dev:
            raise ValueError(f"the scene's tables must be on {dev}, got {t.device}")
    tri_v, prim, rad, prob, alias, slpi, env_prob, env_alias, tex, off, tw, th = scene
    sobol = ds.sobol
    if sobol is not None and (sobol.device != dev or sobol.dtype != torch.int64):
        raise ValueError("the Sobol table must be an int64 tensor on the lanes' device")
    args = RisArgs(
        pos=pos.data_ptr(), norm=norm.data_ptr(), wo=wo.data_ptr(), mtype=mtype.data_ptr(),
        metallic=metallic.data_ptr(), roughness=roughness.data_ptr(),
        scramble=scramble.data_ptr(), n=n, reservoir_size=reservoir_size,
        ptr=ptr.data_ptr(), sobol=None if sobol is None else sobol.data_ptr(),
        sobol_len=SOBOL_SAMPLE_NUM * SOBOL_SAMPLE_DIM,
        tri_v=tri_v.data_ptr(), light_prim=prim.data_ptr(), light_radiance=rad.data_ptr(),
        light_prob=prob.data_ptr(), light_alias=alias.data_ptr(),
        sum_light_power_inv=slpi.data_ptr(), n_area=ds.n_area_lights, n_alias=prob.shape[0],
        has_env=int(ds.has_env), single_sided=int(ds.single_sided),
        lambertian=_has(ds.mat_types, dsc.MAT_LAMBERTIAN),
        metallic_lobe=_has(ds.mat_types, dsc.MAT_METALLIC_WORKFLOW),
        env_prob=env_prob.data_ptr(), env_alias=env_alias.data_ptr(), tex_data=tex.data_ptr(),
        tex_offset=off.data_ptr(), tex_width=tw.data_ptr(), tex_height=th.data_ptr(),
        n_env=env_prob.shape[0], env_tex=max(ds.env_tex, 0),
        li=li.data_ptr(), wi=wi.data_ptr(), dist=dist.data_ptr(), num=num.data_ptr(),
        weight=weight.data_ptr(), scramble_out=scramble_out.data_ptr())
    lib = load_library("ris")
    with torch.cuda.device(dev):
        err = lib.ris_candidates(ctypes.addressof(args),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ris_candidates kernel launch failed: CUDA error {err}")
    LAUNCHES["ris"] += 1
    timing.count("ris.kernel")
    return li, wi, dist, num, weight, scramble_out
