"""A plain tessellator of bicubic Bézier patches, written apart from the
port's (``radish_pt_tpu_torch/scene/bezier.py``) to check it and the mesh the
``cornell_teapot`` configuration renders: de Casteljau's construction in
float64, one patch at a time, where the port sums Bernstein polynomials.

Same conventions as the port: a patch's 16 indices are four control rows
along v, each row's four points along u; the grid has ``segments + 1``
points a side at u, v = k / segments, row-major in (v, u); the normal is
dP/du x dP/dv, and where dP/du vanishes on a boundary row that is one point
(a pole) the next grid row's dP/du is used; each quad splits along its (u,
v) -> (u + du, v + dv) diagonal into (p00, p01, p11) and (p00, p11, p10),
and a triangle with two coincident corners is dropped.  Imports nothing of
the port."""

from __future__ import annotations

import numpy as np


def load_table(path: str):
    """(points float64 [P, 3], index int64 [N, 4, 4] 0-based) of a patch
    table: ``#`` lines skipped, a count and 16 comma-separated 1-based
    indices a line, a count and x, y, z a line."""
    with open(path, encoding="utf-8") as f:
        rows = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    n = int(rows[0])
    index = [[int(t) - 1 for t in rows[1 + k].split(",")] for k in range(n)]
    m = int(rows[1 + n])
    points = [[float(t) for t in rows[2 + n + k].split(",")] for k in range(m)]
    return np.array(points, np.float64), np.array(index, np.int64).reshape(n, 4, 4)


def _casteljau(ctrl: np.ndarray, t: np.ndarray):
    """A cubic's point and derivative at each ``t``: ``ctrl`` [..., 4, 3]
    -> ([..., T, 3], [..., T, 3])."""
    c = np.broadcast_to(ctrl[..., None, :, :], ctrl.shape[:-2] + (t.shape[0], 4, 3))
    s = t[:, None]
    level = [c[..., k, :] for k in range(4)]
    while len(level) > 2:
        level = [(1.0 - s) * a + s * b for a, b in zip(level, level[1:])]
    point = (1.0 - s) * level[0] + s * level[1]
    return point, 3.0 * (level[1] - level[0])


def tessellate(points: np.ndarray, index: np.ndarray, segments: int):
    """(vertices f32 [V, 3], normals f32 [V, 3], faces int64 [T, 3],
    dropped) of every patch on a ``segments`` grid (module docstring)."""
    n = segments
    t = np.array([k / n for k in range(n + 1)], np.float64)
    verts, norms, faces = [], [], []
    dropped = 0
    side = n + 1
    for k in range(index.shape[0]):
        net = points[index[k]]  # [4 rows (v), 4 columns (u), 3]
        # along u within each control row, then along v: P and dP/du
        rows_u, drows_u = _casteljau(net, t)  # [4, side(u), 3]
        pos, _ = _casteljau(np.swapaxes(rows_u, 0, 1), t)  # [side(u), side(v), 3]
        du, _ = _casteljau(np.swapaxes(drows_u, 0, 1), t)
        # along v within each control column, then along u: dP/dv
        _, dcols_v = _casteljau(np.swapaxes(net, 0, 1), t)  # [4 (u), side(v), 3]
        dv, _ = _casteljau(np.swapaxes(dcols_v, 0, 1), t)  # [side(v), side(u), 3]
        pos, du = np.swapaxes(pos, 0, 1), np.swapaxes(du, 0, 1)  # [v, u, 3]
        for a, ctrl_row, inner in ((0, 0, 1), (n, 3, n - 1)):
            if np.all(net[ctrl_row] == net[ctrl_row][0]):
                du[a] = du[inner]
        nrm = np.cross(du, dv)
        nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
        vf = pos.reshape(-1, 3).astype(np.float32)
        base = k * side * side
        for a in range(n):
            for b in range(n):
                p00, p01 = a * side + b, a * side + b + 1
                p10, p11 = p00 + side, p01 + side
                for tri in ((p00, p01, p11), (p00, p11, p10)):
                    c = vf[list(tri)]
                    if (c[0] == c[1]).all() or (c[1] == c[2]).all() or (c[0] == c[2]).all():
                        dropped += 1
                    else:
                        faces.append([base + i for i in tri])
        verts.append(vf)
        norms.append(nrm.reshape(-1, 3).astype(np.float32))
    return (np.concatenate(verts), np.concatenate(norms), np.array(faces, np.int64),
            dropped)
