"""Helpers shared by the port's parity tests (tests/test_torch_*.py): carry
a JAX ``DeviceScene`` across to the port as numpy, and compare results."""

from __future__ import annotations

import dataclasses
import os

import numpy as np

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")

META = ("intersector", "n_area_lights", "has_env", "has_aperture",
        "single_sided", "mat_types", "cluster_sub", "env_tex", "aperture_tex")


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
