"""The host side of ``csrc/shading.cuh``'s launches, shared by the
wrappers of ``csrc/ris.cu`` (render/ris.py) and ``csrc/vertex.cu``
(render/vertex.py): the checks of a lane tensor and the launch arguments
both kernels read from the scene (the Sobol table, the area lights and
their alias table, the env map, the material lobes the scene has)."""

from __future__ import annotations

import torch

from ..sampling.sobol import SOBOL_SAMPLE_DIM, SOBOL_SAMPLE_NUM
from ..scene import device_scene as dsc


def lane_tensor(t: torch.Tensor, name: str, dtype, shape) -> torch.Tensor:
    """``t`` contiguous, or ValueError unless it is a CUDA tensor of
    ``dtype`` and ``shape``."""
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be a {dtype} CUDA tensor of shape {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def has_type(types, ty) -> int:
    """1 if material type ``ty`` is among the scene's ``types`` (None: all)."""
    return int(types is None or ty in types)


def scene_fields(ds: dsc.DeviceScene, dev) -> tuple:
    """The launch arguments csrc/ris.cu and csrc/vertex.cu read from the
    scene (the Sobol table, the area lights, the light alias table, the env
    map), as ({field: value}, the contiguous tensors they point into, to
    be kept alive until the launch); ValueError if a table is not on
    ``dev``."""
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
    return dict(
        sobol=None if sobol is None else sobol.data_ptr(),
        sobol_len=SOBOL_SAMPLE_NUM * SOBOL_SAMPLE_DIM,
        tri_v=tri_v.data_ptr(), light_prim=prim.data_ptr(), light_radiance=rad.data_ptr(),
        light_prob=prob.data_ptr(), light_alias=alias.data_ptr(),
        sum_light_power_inv=slpi.data_ptr(), n_area=ds.n_area_lights, n_alias=prob.shape[0],
        has_env=int(ds.has_env), single_sided=int(ds.single_sided),
        lambertian=has_type(ds.mat_types, dsc.MAT_LAMBERTIAN),
        metallic_lobe=has_type(ds.mat_types, dsc.MAT_METALLIC_WORKFLOW),
        env_prob=env_prob.data_ptr(), env_alias=env_alias.data_ptr(), tex_data=tex.data_ptr(),
        tex_offset=off.data_ptr(), tex_width=tw.data_ptr(), tex_height=th.data_ptr(),
        n_env=env_prob.shape[0], env_tex=max(ds.env_tex, 0)), scene
