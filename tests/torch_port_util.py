"""Helpers shared by the port's parity tests (tests/test_torch_*.py): carry
a JAX ``DeviceScene`` across to the port as numpy, and compare results."""

from __future__ import annotations

import dataclasses
import os

import numpy as np

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")

META = ("intersector", "n_area_lights", "has_env", "has_aperture",
        "single_sided", "mat_types", "cluster_sub", "env_tex", "aperture_tex",
        "sort_primaries")


def jax_scene_parts(ds):
    """(fields: name -> ndarray, meta: static fields) of a JAX DeviceScene."""
    fields, meta = {}, {}
    for f in dataclasses.fields(ds):
        v = getattr(ds, f.name)
        if f.name in META:
            meta[f.name] = v
        elif v is not None and not isinstance(v, (bool, int, str, tuple)):
            fields[f.name] = np.asarray(v)
    return fields, meta


def load_jax_scene(monkeypatch, name, engine="pallas_mxu"):
    """The reference's own build of ``scenes/<name>`` for one engine, on its
    numpy host path (the port's copies are of that path; the reference's
    native C++ BVH and cluster cuts order teapot-scale scenes differently)."""
    from radish_pt_tpu import native
    from radish_pt_tpu.scene.build import load_scene
    from radish_pt_tpu.scene.parser import Resource

    monkeypatch.setenv("RADISH_INTERSECTOR", engine)
    monkeypatch.setattr(native, "load_library", lambda: None)
    Resource.clear()  # drop meshes memoized by the native loader
    try:
        return load_scene(os.path.join(SCENES, name))
    finally:
        Resource.clear()


def t2n(x):
    return x.detach().cpu().numpy()


def camera_from_jax(jcam, width=None, height=None):
    """The port's camera (on the CPU) with a JAX camera's parameters."""
    from radish_pt_tpu_torch.scene.camera import make_camera

    return make_camera(width or jcam.width, height or jcam.height,
                       np.asarray(jcam.position), np.asarray(jcam.rotation),
                       fov_y=float(jcam.fov_y), lens_radius=float(jcam.lens_radius),
                       focal_dist=float(jcam.focal_dist), device="cpu")


def _both(arrays: dict, jax_cls, torch_cls):
    """One state built twice from the same numpy arrays: (JAX, torch)."""
    import jax.numpy as jnp
    import torch

    return (jax_cls(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            torch_cls(**{k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in arrays.items()}))


def reservoir_arrays(rng, n, empty_share=0.2):
    """A numpy reservoir: random samples, some lanes empty, one NaN weight
    and one negative weight (the lanes ``_check_validity`` resets)."""
    num = rng.integers(1, 40, n).astype(np.float32)
    weight = rng.exponential(2.0, n).astype(np.float32)
    empty = rng.random(n) < empty_share
    num[empty] = 0.0
    weight[empty] = 0.0
    weight[0], weight[1] = np.nan, -1.0
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    return {"li": rng.uniform(0, 5, (n, 3)).astype(np.float32), "wi": wi,
            "dist": rng.uniform(0.1, 10, n).astype(np.float32), "num": num,
            "weight": weight}


def reservoir_pair(arrays):
    from radish_pt_tpu.render import restir as jrs
    from radish_pt_tpu_torch.render import restir as rs

    return _both(arrays, jrs.DirectReservoir, rs.DirectReservoir)


def gbuffer_frame_arrays(rng, n, n_ids=3, encode_normal=False, spread=None,
                         depth=None):
    """A numpy G-buffer frame: ids in [-1, n_ids) (-1: a miss), unit
    normals in the z >= 0 hemisphere (stored as their hemi-oct codes with
    ``encode_normal``) and depths in [1, 10).  ``spread`` draws the normals
    near +z instead (each +z plus ``spread`` times a normal draw) and
    ``depth`` the depths near that value (±4%), so that neighbours pass the
    reuse tests."""
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    if spread is not None:
        nrm = np.array([0, 0, 1], np.float32) + spread * nrm
    nrm[:, 2] = np.abs(nrm[:, 2])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    if encode_normal:
        d = np.abs(nrm[:, 0]) + np.abs(nrm[:, 1]) + nrm[:, 2]
        p = nrm[:, :2] / d[:, None]
        nrm = np.stack([p[:, 0] + p[:, 1], p[:, 0] - p[:, 1]], axis=-1)
    if depth is None:
        d = rng.uniform(1, 10, n)
    else:
        d = depth * (1.0 + 0.04 * rng.normal(size=n))
    return {"normal": nrm.astype(np.float32),
            "prim_id": rng.integers(-1, n_ids, n).astype(np.int32),
            "depth": d.astype(np.float32)}


def gbuffer_frame_pair(arrays):
    from radish_pt_tpu.render import gbuffer as jgb
    from radish_pt_tpu_torch.render import gbuffer as gb

    return _both(arrays, jgb.GBufferFrame, gb.GBufferFrame)


def gbuffer_out_pair(frame_arrays, albedo, motion):
    """(JAX, torch) ``GBufferOut`` from numpy frame arrays, albedo, motion."""
    import jax.numpy as jnp
    import torch

    from radish_pt_tpu.render import gbuffer as jgb
    from radish_pt_tpu_torch.render import gbuffer as gb

    jf, tf = gbuffer_frame_pair(frame_arrays)
    return (jgb.GBufferOut(frame=jf, albedo=jnp.asarray(albedo),
                           motion=jnp.asarray(motion)),
            gb.GBufferOut(frame=tf, albedo=torch.from_numpy(albedo),
                          motion=torch.from_numpy(motion)))


def svgf_state_pair(arrays):
    from radish_pt_tpu.render import denoise as jdn
    from radish_pt_tpu_torch.render import denoise as dn

    return _both(arrays, jdn.SVGFState, dn.SVGFState)
