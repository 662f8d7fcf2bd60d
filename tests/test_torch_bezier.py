"""The port's Bézier patch tessellator (``scene/bezier.py``) and the patch
table it reads: Newell's teapot as the Standard Procedural Databases give it
(``benchmark/configs/cornell_teapot/newell_teapot.txt``), held to the
table's own symmetries, then a 4-segment tessellation held to the Bernstein
surface, its normals to finite differences, and its OBJ file to the port's
parsers bit for bit.  CPU only, a second or two."""

import os

import numpy as np
import pytest

from radish_pt_tpu_torch.scene import bezier as bz
from radish_pt_tpu_torch.scene import obj_loader

TABLE = os.path.join(os.path.dirname(__file__), "..", "benchmark", "configs",
                     "cornell_teapot", "newell_teapot.txt")
# the table's patches by part (0-based), in its order
RIM, BODY, HANDLE, SPOUT = range(0, 4), range(4, 12), range(12, 16), range(16, 20)
LID, BOTTOM = range(20, 28), range(28, 32)
REVOLVED = (RIM, BODY, LID, BOTTOM)


@pytest.fixture(scope="module")
def table():
    return bz.load_patches(TABLE)


@pytest.fixture(scope="module")
def printed():
    """Decimals of each printed coordinate of the table's points, [306, 3]."""
    with open(TABLE, encoding="utf-8") as f:
        rows = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    pts = rows[2 + int(rows[0]):]
    return np.array([[len(t.split(".")[1]) if "." in t else 0 for t in r.split(",")]
                     for r in pts])


def _quarter(net, sign):
    """``net`` turned a quarter about z: (x, y) -> (y, -x) for sign -1,
    (-y, x) for +1 (exact)."""
    x, y, z = net[..., 0], net[..., 1], net[..., 2]
    return np.stack([-sign * y, sign * x, z], -1)


def test_the_table_is_newells_32_patches_over_306_points(table):
    assert table.points.shape == (306, 3) and table.index.shape == (32, 4, 4)
    used = np.unique(table.index) + 1
    # every point is in a patch but the four 0.002 from the lid's pole
    assert sorted(set(range(1, 307)) - set(used.tolist())) == [205, 206, 216, 223]
    assert table.points[[204, 205, 215, 222]].tolist() == [
        [0.0, -0.002, 3.15], [0.002, 0.0, 3.15], [-0.002, 0.0, 3.15], [0.0, 0.002, 3.15]]


@pytest.mark.parametrize("part", REVOLVED, ids=["rim", "body", "lid", "bottom"])
def test_revolved_quadrants_are_quarter_turns(table, part):
    """Each ring of four patches: the next is the last turned a quarter
    about z, the same way round the whole ring (clockwise from above, the
    bottom anticlockwise so that its normals face down)."""
    nets = table.nets()
    for ring in range(part.start, part.stop, 4):
        sign = -1 if part is not BOTTOM else 1
        for q in range(4):
            k, nxt = ring + q, ring + (q + 1) % 4
            assert np.array_equal(nets[nxt], _quarter(nets[k], sign)), (k, nxt)


@pytest.mark.parametrize("part", REVOLVED, ids=["rim", "body", "lid", "bottom"])
def test_revolved_rows_are_quarter_circles_to_the_printed_digits(table, printed, part):
    """Every control row of a revolved patch is a quarter circle of radius
    r at one height, in its own quadrant's frame (e0 along the first point,
    e1 along the last) the points r e0, r e0 + 0.56 r e1, 0.56 r e0 + r e1,
    r e1 (rim patch 1's first row: (1.4, 0), (1.4, -0.784), (0.784, -1.4),
    (0, -1.4)), each coordinate to the digits the table prints; a row of
    radius 0 is one point on the axis."""
    for k in part:
        for row in table.index[k]:
            p = table.points[row]
            assert np.all(p[:, 2] == p[0, 2])
            r = np.hypot(*p[0, :2])
            if r == 0:
                assert np.all(p[:, :2] == 0), k
                continue
            e0, e1 = p[0, :2] / r, p[3, :2] / r
            assert np.hypot(*p[3, :2]) == r and abs(e0 @ e1) < 1e-12
            want = np.array([r * e0, r * e0 + 0.56 * r * e1, 0.56 * r * e0 + r * e1, r * e1])
            tol = 0.5 * 10.0 ** -printed[row][:, :2] + 1e-12
            assert np.all(np.abs(p[:, :2] - want) <= tol), (k, row + 1)


def test_neighbouring_patches_share_their_boundaries(table):
    """Around each ring a patch's last column is the next patch's first;
    down the pot the rim's last row is the body's first, the upper body's
    the lower body's, the knob's the lid's, the handle's and the spout's
    upper halves' their lower halves'; a handle or spout half's seams are
    its mirror half's; the bottom's outer row holds the body's last row's
    points (the table gives them again under their own indices)."""
    idx = table.index
    for part in REVOLVED:
        for ring in range(part.start, part.stop, 4):
            for q in range(4):
                k, nxt = ring + q, ring + (q + 1) % 4
                assert np.array_equal(idx[k][:, 3], idx[nxt][:, 0]), (k, nxt)
    for upper, lower in ((RIM, BODY[:4]), (BODY[:4], BODY[4:]), (LID[:4], LID[4:]),
                         (HANDLE[:2], HANDLE[2:]), (SPOUT[:2], SPOUT[2:])):
        for a, b in zip(upper, lower):
            assert np.array_equal(idx[a][3], idx[b][0]), (a, b)
    for a in (HANDLE[0], HANDLE[2], SPOUT[0], SPOUT[2]):
        assert np.array_equal(idx[a][:, 0], idx[a + 1][:, 3])
        assert np.array_equal(idx[a][:, 3], idx[a + 1][:, 0])
    body_edge = {tuple(p) for k in BODY[4:] for p in table.points[idx[k][3]]}
    bottom_edge = {tuple(p) for k in BOTTOM for p in table.points[idx[k][3]]}
    assert body_edge == bottom_edge and len(body_edge) == 12


def test_handle_and_spout_are_mirror_symmetric_in_y(table):
    """The second patch of each handle and spout pair is the first
    reflected in y, its columns in reverse."""
    nets = table.nets()
    flip = np.array([1.0, -1.0, 1.0])
    for a in (HANDLE[0], HANDLE[2], SPOUT[0], SPOUT[2]):
        assert np.array_equal(nets[a + 1], (nets[a] * flip)[:, ::-1]), a


@pytest.fixture(scope="module")
def small(table):
    return bz.tessellate(table, 4)


def test_the_poles_collapse_to_single_points(table, small):
    """The lid's top row and the bottom's first row are one point each,
    on the axis; in the tessellation so is that grid row."""
    for part, pole in ((LID[:4], [0.0, 0.0, 3.15]), (BOTTOM, [0.0, 0.0, 0.0])):
        for k in part:
            assert table.points[table.index[k][0]].tolist() == [pole] * 4
            row = small.vertices.reshape(32, 5, 5, 3)[k, 0]
            assert np.all(row == np.float32(pole)), k
    others = [k for k in range(32) if k not in LID[:4] and k not in BOTTOM]
    grid = small.vertices.reshape(32, 5, 5, 3)[others]
    assert np.all(np.abs(np.diff(grid, axis=2)).max(-1) > 0)


def _bernstein_point(net, u, v):
    """The surface at (u, v), float64: the Bernstein sum term by term."""
    bu = [(1 - u) ** 3, 3 * u * (1 - u) ** 2, 3 * u * u * (1 - u), u ** 3]
    bv = [(1 - v) ** 3, 3 * v * (1 - v) ** 2, 3 * v * v * (1 - v), v ** 3]
    return sum(bv[i] * bu[j] * net[i, j] for i in range(4) for j in range(4))


def test_small_tessellation_lies_on_the_surface(table, small):
    """4 segments: each vertex is the Bernstein surface at its (u, v) to
    float32 rounding; each normal is the finite-difference normal away from
    the poles (unit, outward); each face is wound with its vertices'
    normals; 32 x 4 x 4 x 2 triangles less one a quad on the 8 pole rows."""
    nets = table.nets()
    v = small.vertices.reshape(32, 25, 3)
    n = small.normals.reshape(32, 25, 3)
    uv = small.texcoords.reshape(32, 25, 2).astype(np.float64)
    h = 1e-6
    for k in range(32):
        for g in range(25):
            u, w = uv[k, g]
            assert (u, w) == ((g % 5) / 4, (g // 5) / 4)
            exact = _bernstein_point(nets[k], u, w)
            assert np.all(np.abs(v[k, g] - exact) <= 2.0 ** -22 * max(1.0, np.abs(exact).max()))
            assert abs(np.linalg.norm(n[k, g].astype(np.float64)) - 1.0) < 1e-6
            on_pole = g < 5 and (k in LID[:4] or k in BOTTOM)
            if on_pole:
                continue
            du = (_bernstein_point(nets[k], min(u + h, 1), w)
                  - _bernstein_point(nets[k], max(u - h, 0), w))
            dv = (_bernstein_point(nets[k], u, min(w + h, 1))
                  - _bernstein_point(nets[k], u, max(w - h, 0)))
            fd = np.cross(du, dv)
            fd /= np.linalg.norm(fd)
            assert np.abs(n[k, g] - fd).max() < 1e-4, (k, g)
    assert small.dropped == 8 * 4 and len(small.faces) == 32 * 4 * 4 * 2 - 32
    corners = small.vertices[small.faces].astype(np.float64)
    face_n = np.cross(corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0])
    assert np.all(np.linalg.norm(face_n, axis=-1) > 0)
    assert np.all((face_n * small.normals[small.faces].sum(1)).sum(-1) > 0)


def test_the_tessellation_counts_as_stated(table):
    """42 segments: 112,896 triangles less the 336 on the pole rows."""
    mesh = bz.tessellate(table, 42)
    assert (mesh.dropped, len(mesh.faces), len(mesh.vertices)) == (336, 112560, 32 * 43 * 43)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_write_obj_reads_back_bit_for_bit(table, small, tmp_path, monkeypatch, native):
    """The OBJ file of the y-up mesh, read by the port's parser (the native
    one and the Python one), gives each triangle's corners and normals
    bit for bit."""
    monkeypatch.setenv("RADISH_NATIVE", "1" if native else "0")
    mesh = bz.to_y_up(small)
    path = str(tmp_path / "t.obj")
    bz.write_obj(mesh, path, header="a test\nof two lines")
    got = obj_loader.load_obj(path)
    f = mesh.faces.reshape(-1)
    assert got.vertices.view(np.uint32).tolist() == mesh.vertices[f].view(np.uint32).tolist()
    assert got.normals.view(np.uint32).tolist() == mesh.normals[f].view(np.uint32).tolist()
    with open(path, encoding="utf-8") as fh:
        assert fh.readline() == "# a test\n"


def test_float_text_is_the_shortest_that_reads_back():
    rng = np.random.default_rng(3)
    xs = np.concatenate([rng.standard_normal(2000).astype(np.float32),
                         np.float32([0.0, -0.0, 1.5, 2.4, 1e-8, 3.1e5, 0.1])])
    for x in xs:
        s = bz.float_text(x)
        assert np.float32(float(s)).view(np.uint32) == x.view(np.uint32), s
        assert "e" not in s and len(s.replace("-", "").replace(".", "").strip("0")) <= 9
    assert bz.float_text(np.float32(2.4)) == "2.4" and bz.float_text(np.float32(-0.0)) == "-0"
