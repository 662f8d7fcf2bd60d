"""Bicubic Bézier patches cut into a triangle mesh the port renders: a patch
table read (:func:`load_patches`, Newell's teapot as the Standard Procedural
Databases give it), each patch tessellated on a uniform grid
(:func:`tessellate`), and the mesh written as an OBJ file a scene names
(:func:`write_obj`).

    python -m radish_pt_tpu_torch.scene.bezier PATCHES OUT.obj --segments 42

writes the mesh turned from the table's z up to the renderer's y up
(:func:`to_y_up`).

A patch is 4 x 4 control points: row ``i`` of the table's 16 indices is
``v = i / 3``'s control row, and the four points of a row run along ``u``.
The surface is ``P(u, v) = sum_ij B_i(v) B_j(u) C_ij`` with the cubic
Bernstein polynomials, evaluated in float64 and cast to float32 once; its
normal is ``dP/du x dP/dv`` (outward on Newell's patches), taken from the
differences of the control points so that it is exactly zero where a
boundary row of the net collapses to a point (the lid's and the bottom's
poles). There ``dP/du`` is taken from the next grid row, which gives the
pole the limit of its neighbours' normals.

Each grid quad is split along the diagonal from ``(u, v)`` to ``(u + du,
v + dv)``, both triangles wound so that their face normal follows the
surface's. A triangle with two coincident corners (one of each quad on a
collapsed row) is dropped and counted in ``PatchMesh.dropped``.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class Patches:
    """A patch table: ``points`` float64 [P, 3], ``index`` int64 [N, 4, 4]
    (0-based; ``index[k, i, j]``: patch ``k``'s control point of row ``i``
    (along v) and column ``j`` (along u))."""

    points: np.ndarray
    index: np.ndarray

    def nets(self) -> np.ndarray:
        """The control nets, float64 [N, 4, 4, 3]."""
        return self.points[self.index]


@dataclass
class PatchMesh:
    """A tessellation: ``vertices``, ``normals`` float32 [V, 3] and
    ``texcoords`` float32 [V, 2] (the patch's (u, v)), patch by patch, each
    a (segments + 1)^2 grid in row-major (v, u) order; ``faces`` int64
    [T, 3], 0-based; ``dropped``: triangles with two coincident corners
    left out."""

    vertices: np.ndarray
    normals: np.ndarray
    texcoords: np.ndarray
    faces: np.ndarray
    dropped: int


def load_patches(path: str) -> Patches:
    """Read a patch table: ``#`` lines and blank lines skipped; the number
    of patches, one line of 16 comma-separated 1-based indices a patch; the
    number of points, one line of x, y, z a point."""
    with open(path, encoding="utf-8") as f:
        rows = [ln.strip() for ln in f if ln.strip() and not ln.lstrip().startswith("#")]
    n = int(rows[0])
    index = np.array([[int(t) for t in r.split(",")] for r in rows[1:1 + n]], np.int64)
    m = int(rows[1 + n])
    points = np.array([[float(t) for t in r.split(",")] for r in rows[2 + n:2 + n + m]],
                      np.float64)
    if index.shape != (n, 16) or points.shape != (m, 3) or len(rows) != 2 + n + m:
        raise ValueError(f"{path}: not a table of {n} patches of 16 indices and {m} points")
    if index.min() < 1 or index.max() > m:
        raise ValueError(f"{path}: a patch index outside 1..{m}")
    return Patches(points=points, index=(index - 1).reshape(n, 4, 4))


def _bernstein(t: np.ndarray, degree: int) -> np.ndarray:
    """[len(t), degree + 1] Bernstein polynomials of ``degree`` at ``t``."""
    k = np.arange(degree + 1)
    binom = np.array([1, 3, 3, 1] if degree == 3 else [1, 2, 1], np.float64)
    return binom * t[:, None] ** k * (1.0 - t[:, None]) ** (degree - k)


def _surface(nets: np.ndarray, n: int):
    """(P, dP/du, dP/dv), float64 [N, n + 1, n + 1, 3] each, on the uniform
    grid of ``n`` steps a side, ``[k, a, b]`` at (u, v) = (b / n, a / n);
    on a boundary row of the net that is one point, where dP/du vanishes,
    dP/du is taken from the next grid row in."""
    t = np.arange(n + 1, dtype=np.float64) / n
    b3, b2 = _bernstein(t, 3), _bernstein(t, 2)
    pos = np.einsum("ai,bj,kijc->kabc", b3, b3, nets)
    du = 3.0 * np.einsum("ai,bj,kijc->kabc", b3, b2, np.diff(nets, axis=2))
    dv = 3.0 * np.einsum("ai,bj,kijc->kabc", b2, b3, np.diff(nets, axis=1))
    for k, net in enumerate(nets):
        for a, row, inner in ((0, 0, 1), (n, 3, n - 1)):  # v = 0 and v = 1
            if (net[row] == net[row, 0]).all():
                du[k, a] = du[k, inner]
    return pos, du, dv


def tessellate(patches: Patches, segments: int) -> PatchMesh:
    """Every patch on a uniform grid of ``segments`` steps in u and in v
    (module docstring): 2 x segments^2 triangles a patch, less those with
    two coincident corners."""
    n = int(segments)
    if n < 1:
        raise ValueError("segments must be at least 1")
    pos, du, dv = _surface(patches.nets(), n)
    nrm = np.cross(du, dv)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    side = n + 1
    count = pos.shape[0]
    verts = pos.reshape(-1, 3).astype(np.float32)
    t = (np.arange(side, dtype=np.float64) / n).astype(np.float32)
    uv = np.stack(np.broadcast_arrays(t[None, :], t[:, None]), -1).reshape(-1, 2)
    grid = np.arange(side * side).reshape(side, side)
    p00, p01 = grid[:-1, :-1].ravel(), grid[:-1, 1:].ravel()
    p10, p11 = grid[1:, :-1].ravel(), grid[1:, 1:].ravel()
    quad = np.stack([np.stack([p00, p01, p11], -1), np.stack([p00, p11, p10], -1)], 1)
    faces = (quad.reshape(-1, 3)[None] + side * side * np.arange(count)[:, None, None])
    faces = faces.reshape(-1, 3)
    c = verts[faces]
    same = ((c[:, 0] == c[:, 1]).all(-1) | (c[:, 1] == c[:, 2]).all(-1)
            | (c[:, 0] == c[:, 2]).all(-1))
    return PatchMesh(vertices=verts, normals=nrm.reshape(-1, 3).astype(np.float32),
                     texcoords=np.tile(uv, (count, 1)), faces=faces[~same],
                     dropped=int(same.sum()))


def to_y_up(mesh: PatchMesh) -> PatchMesh:
    """The mesh turned from z up to y up: (x, y, z) -> (x, z, -y), a
    rotation of -90 degrees about x (exact in float32)."""

    def turn(a):
        return np.stack([a[:, 0], a[:, 2], -a[:, 1]], -1)

    return PatchMesh(vertices=turn(mesh.vertices), normals=turn(mesh.normals),
                     texcoords=mesh.texcoords, faces=mesh.faces, dropped=mesh.dropped)


def float_text(x: np.float32) -> str:
    """The shortest decimal that reads back to ``x`` through a float64
    parse and a cast to float32, as the port's OBJ parsers read numbers; a
    float64's repr where the shortest float32 form would round twice."""
    x = np.float32(x)
    s = np.format_float_positional(x, unique=True, trim="-")
    if np.float32(float(s)).view(np.uint32) != x.view(np.uint32):
        s = repr(float(x))
    return s


def write_obj(mesh: PatchMesh, path: str, header: str = "") -> None:
    """``mesh`` as OBJ: ``v`` and ``vn`` lines a vertex (each number
    :func:`float_text`), ``f a//a b//b c//c`` a triangle (the vertex's own
    normal; the texcoords are not written), ``header`` as ``#`` lines."""
    lines = [f"# {ln}".rstrip() for ln in header.splitlines()]
    for tag, arr in (("v", mesh.vertices), ("vn", mesh.normals)):
        lines += [f"{tag} {float_text(a)} {float_text(b)} {float_text(c)}" for a, b, c in arr]
    lines += [f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in (mesh.faces + 1).tolist()]
    with open(path, "w", encoding="utf-8", newline="\n") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m radish_pt_tpu_torch.scene.bezier",
                                description="Tessellate a Bezier patch table into an "
                                "OBJ mesh, z up turned to y up.")
    p.add_argument("patches", help="patch table (load_patches' layout)")
    p.add_argument("out", help="OBJ file to write")
    p.add_argument("--segments", type=int, default=42, help="grid steps a patch side")
    args = p.parse_args(argv)
    mesh = to_y_up(tessellate(load_patches(args.patches), args.segments))
    n = len(mesh.faces)
    write_obj(mesh, args.out, header=(
        f"{n} triangles from {os.path.basename(args.patches)}, "
        f"{args.segments} segments a patch side, y up; "
        f"{mesh.dropped} with two coincident corners dropped\n"
        f"written by python -m radish_pt_tpu_torch.scene.bezier"))
    print(f"{args.out}: {len(mesh.vertices)} vertices, {n} triangles, "
          f"{mesh.dropped} dropped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
