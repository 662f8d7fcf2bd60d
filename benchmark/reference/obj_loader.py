"""Minimal OBJ loader producing flat triangle soup: a frozen copy of the
port's ``scene/obj_loader.py`` (its pure-Python parser; the port also has a
native twin).

Replaces the vendored tinyobjloader (reference uses it at
``reference/src/scene.cpp:28-65``): indices are expanded into a
non-indexed triangle soup — one vertex/normal/texcoord per corner — which is
exactly the SoA layout the device scene wants.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MeshData:
    """Flat triangle soup; shapes [3*T, ...] where T = triangle count."""

    vertices: np.ndarray  # float32 [3T, 3]
    normals: np.ndarray  # float32 [3T, 3]
    texcoords: np.ndarray  # float32 [3T, 2]

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0] // 3


def _parse_index(token: str, count: int) -> int:
    i = int(token)
    return i - 1 if i > 0 else count + i


def load_obj(path: str) -> MeshData:
    """Parse an OBJ file; polygons are fan-triangulated.  Missing normals are
    replaced with face normals and missing texcoords with (0,0), matching the
    reference's fallback (scene.cpp:55-58)."""
    positions: list[tuple[float, float, float]] = []
    normals: list[tuple[float, float, float]] = []
    texcoords: list[tuple[float, float]] = []
    # per-corner index triples (vi, ti, ni); -1 = missing
    corners: list[tuple[int, int, int]] = []

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vn":
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vt":
                texcoords.append((float(parts[1]), float(parts[2])))
            elif tag == "f":
                face = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = _parse_index(comps[0], len(positions))
                    ti = (
                        _parse_index(comps[1], len(texcoords))
                        if len(comps) > 1 and comps[1]
                        else -1
                    )
                    ni = (
                        _parse_index(comps[2], len(normals))
                        if len(comps) > 2 and comps[2]
                        else -1
                    )
                    face.append((vi, ti, ni))
                for k in range(1, len(face) - 1):  # fan triangulation
                    corners.extend([face[0], face[k], face[k + 1]])

    if not corners:
        raise ValueError(f"OBJ file {path!r} contains no faces")

    pos_arr = np.asarray(positions, dtype=np.float32)
    nrm_arr = (
        np.asarray(normals, dtype=np.float32)
        if normals
        else np.zeros((0, 3), np.float32)
    )
    uv_arr = (
        np.asarray(texcoords, dtype=np.float32)
        if texcoords
        else np.zeros((0, 2), np.float32)
    )

    vi = np.array([c[0] for c in corners], dtype=np.int64)
    ti = np.array([c[1] for c in corners], dtype=np.int64)
    ni = np.array([c[2] for c in corners], dtype=np.int64)

    out_v = pos_arr[vi]
    out_uv = np.where((ti >= 0)[:, None], uv_arr[np.maximum(ti, 0)] if uv_arr.size else 0.0, 0.0).astype(np.float32)
    if uv_arr.size == 0:
        out_uv = np.zeros((len(corners), 2), np.float32)

    out_n = np.zeros((len(corners), 3), np.float32)
    have_n = (ni >= 0) & (nrm_arr.size > 0)
    if nrm_arr.size:
        out_n[have_n] = nrm_arr[ni[have_n]]
    # fill missing normals with face normals
    missing = ~have_n
    if missing.any():
        v = out_v.reshape(-1, 3, 3)
        fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        fl = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = fn / np.maximum(fl, 1e-12)
        fn_per_corner = np.repeat(fn, 3, axis=0)
        out_n[missing] = fn_per_corner[missing]

    return MeshData(vertices=out_v, normals=out_n, texcoords=out_uv)
