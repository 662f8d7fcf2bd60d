"""The port's native host build (radish_pt_tpu_torch/native) against its
numpy builders and the JAX package's: the SAH BVH, the cluster cuts and the
OBJ parser, and a whole scene load native against ``RADISH_NATIVE=0``.

Tolerance: none.  Every array is compared with ``np.array_equal`` (the
soups and the scene's tensors bit for bit): the C++ does numpy's arithmetic in
numpy's precision (the SAH cost in f64, the rest in f32, no fused
multiply-adds) and pads the cuts' last chunk as numpy pads it.  The JAX
package's numpy builders run with its own native library disabled.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_util import SCENES  # noqa: E402

MODELS = os.path.join(SCENES, "models")
OBJS = ("cube.obj", "plane.obj", "sphere.obj", "teapot.obj", "teapot_hires.obj")
BVH_FIELDS = ("bounds_min", "bounds_max", "node_leaf", "node_aabb", "node_miss",
              "leaf_tris", "leaf_map", "leaf_size", "depth")


def _soup(name):
    from radish_pt_tpu_torch.scene.obj_loader import load_obj_py

    return load_obj_py(os.path.join(MODELS, name)).vertices


def _random_soup(seed=5):
    """300 triangles: clustered ones, degenerate ones (a point, a segment)
    and 40 whose centroids coincide, so a node meets the zero-extent
    branch."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, size=(200, 1, 3))
    tris = centers + rng.normal(scale=0.4, size=(200, 3, 3))
    point = np.repeat(rng.uniform(-1, 1, size=(30, 1, 3)), 3, axis=1)
    seg = rng.uniform(-1, 1, size=(30, 2, 3))
    seg = np.concatenate([seg, seg[:, :1]], axis=1)
    same = rng.normal(scale=0.3, size=(40, 3, 3))
    same -= same.mean(axis=1, keepdims=True) - 1.5  # every centroid at (1.5,)*3
    soup = np.concatenate([tris, point, seg, same])[rng.permutation(300)]
    return soup.astype(np.float32).reshape(-1, 3)


def _assert_bvh_equal(a, b):
    for f in BVH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert np.array_equal(np.asarray(x), np.asarray(y)), f
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype and x.shape == np.asarray(y).shape, f


@pytest.mark.parametrize("soup,leaf_size", [("teapot.obj", 8), ("teapot.obj", 16),
                                            ("random", 4), ("random", 16)])
def test_bvh_native_equals_numpy(soup, leaf_size):
    """The native BVH equals the port's numpy builder and the JAX package's
    ``build_bvh_numpy`` in all seven arrays and the depth (teapot: 814
    leaves at leaf size 16, where an f32 SAH cost gives 810)."""
    from radish_pt_tpu.accel.bvh import build_bvh_numpy as jax_build
    from radish_pt_tpu_torch import native
    from radish_pt_tpu_torch.accel.bvh import BVH, build_bvh_numpy

    v = _soup(soup) if soup != "random" else _random_soup()
    got = BVH(**native.build_bvh(v, leaf_size))
    _assert_bvh_equal(got, build_bvh_numpy(v, leaf_size))
    _assert_bvh_equal(got, jax_build(v, leaf_size))
    if soup == "teapot.obj" and leaf_size == 16:
        assert (got.num_leaves, got.depth) == (814, 60)


@pytest.mark.parametrize("n,sub,chunk", [(1200, 64, 400), (1234, 64, 400), (1000, 16, 333),
                                         (300, 128, 400), (4344, 64, 4096)])
def test_cluster_cuts_native_equals_numpy(n, sub, chunk, monkeypatch):
    """The native cuts equal the port's numpy DP and the JAX package's, for
    T a multiple of ``chunk`` and not (the last chunk padded as numpy pads
    it), a window larger than the input, and teapot's 4,344 leaf-ordered
    triangles at the scene build's chunk of 4,096."""
    from radish_pt_tpu import native as jax_native
    from radish_pt_tpu.scene import build as jbuild
    from radish_pt_tpu_torch import native
    from radish_pt_tpu_torch.accel.bvh import build_bvh_numpy
    from radish_pt_tpu_torch.scene import build as sbuild

    if n == 4344:
        v = _soup("teapot.obj").reshape(-1, 3, 3)
        lm = build_bvh_numpy(v.reshape(-1, 3)).leaf_map
        tri = v[lm[lm >= 0]]
    else:
        rng = np.random.default_rng(n)
        c = np.sort(rng.uniform(-10, 10, (n, 1, 3)), axis=0)
        tri = c + rng.uniform(-0.4, 0.4, (n, 3, 3))
    pmin = tri.min(axis=1).astype(np.float32)
    pmax = tri.max(axis=1).astype(np.float32)
    got = native.cluster_cuts(pmin, pmax, sub, sbuild._cluster_lambda(pmin, pmax, 0.005), chunk)
    want = sbuild._cluster_cuts_numpy(pmin, pmax, sub, 0.005, chunk)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    monkeypatch.setattr(jax_native, "load_library", lambda: None)
    assert np.array_equal(got, jbuild._cluster_cuts(pmin, pmax, sub, 0.005, chunk))
    assert got[0] == 0 and got[-1] == n and np.all(np.diff(got) <= sub)


def _assert_mesh_equal(v, n, uv, ref):
    for x, y in ((v, ref.vertices), (n, ref.normals), (uv, ref.texcoords)):
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        assert np.array_equal(x.view(np.int32), y.view(np.int32))  # bit for bit


@pytest.mark.parametrize("name", OBJS)
def test_obj_native_equals_python(name):
    """The native OBJ parser equals ``load_obj_py`` of the port and of the
    JAX package bit for bit on every shipped model."""
    from radish_pt_tpu.scene.obj_loader import load_obj_py as jax_load
    from radish_pt_tpu_torch import native
    from radish_pt_tpu_torch.scene.obj_loader import load_obj_py

    path = os.path.join(MODELS, name)
    v, n, uv = native.load_obj(path)
    _assert_mesh_equal(v, n, uv, load_obj_py(path))
    _assert_mesh_equal(v, n, uv, jax_load(path))


def test_obj_quad_negative_indices_and_errors(tmp_path):
    """A quad with negative (relative) indices fan-triangulates as the
    Python parser does (tests/test_native.py's file); a file without faces,
    a malformed number and a missing file raise."""
    from radish_pt_tpu_torch import native
    from radish_pt_tpu_torch.scene.obj_loader import load_obj_py

    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                 "f -4/-4 -3/-3 -2/-2 -1/-1\n")
    v, n, uv = native.load_obj(str(p))
    assert v.shape == (6, 3)
    _assert_mesh_equal(v, n, uv, load_obj_py(str(p)))
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\n")
    with pytest.raises(ValueError, match="no faces"):
        native.load_obj(str(bad))
    bad.write_text("v 0 x 0\nf 1 1 1\n")
    with pytest.raises(ValueError, match="not a number"):
        native.load_obj(str(bad))
    with pytest.raises(FileNotFoundError):
        native.load_obj(str(tmp_path / "missing.obj"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler error raises with the compiler's output: nothing falls
    back to numpy."""
    from radish_pt_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX_FLAGS", [*native.CXX_FLAGS, "-fno-such-option"])
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed(.|\\n)*no-such-option"):
        native.load_library()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


def test_load_scene_native_equals_numpy(monkeypatch):
    """``load_scene("scenes/teapot.txt")`` native and with RADISH_NATIVE=0:
    every tensor of the DeviceScene equal bit for bit, and the camera."""
    from radish_pt_tpu_torch.scene.build import load_scene
    from radish_pt_tpu_torch.scene.parser import Resource

    def load(flag):
        monkeypatch.setenv("RADISH_NATIVE", flag)
        Resource.clear()
        try:
            return load_scene(os.path.join(SCENES, "teapot.txt"), device="cpu")[:2]
        finally:
            Resource.clear()

    (a, cam_a), (b, cam_b) = load("1"), load("0")
    n_tensors = 0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            # bit for bit: packed tables hold integers bit-cast to f32 (NaNs)
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.numpy().tobytes() == y.numpy().tobytes(), f.name
            n_tensors += 1
        else:
            assert type(x) is type(y) and (x == y if not isinstance(x, np.ndarray)
                                           else np.array_equal(x, y)), f.name
    assert n_tensors > 20 and a.cluster_bounds is not None
    for f in dataclasses.fields(cam_a):
        x, y = getattr(cam_a, f.name), getattr(cam_b, f.name)
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, f.name
