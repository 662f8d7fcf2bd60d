"""Port parity: hash, lockstep sampler, alias tables, Sobol table and the
numpy host code the port copies (radish_pt_tpu_torch vs radish_pt_tpu)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_port_util import SCENES  # noqa: E402


def test_utilhash_bit_exact():
    from radish_pt_tpu.utils.math import utilhash as jax_hash
    from radish_pt_tpu_torch.utils.math import utilhash

    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, size=100_000, dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(jax_hash(jnp.asarray(a)))
    got = utilhash(torch.from_numpy(a.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2**32


@pytest.mark.parametrize("looper", [0, 7, 9999])
def test_sampler_chain_bit_exact(looper):
    """make_sampler + the 4-draw / 4-draw / 3-draw chain of one bounce:
    every r and the final scramble bit-equal on 1e5 lanes."""
    from radish_pt_tpu.sampling import rng as jrng
    from radish_pt_tpu.sampling.sobol import load_sobol_table as jax_table
    from radish_pt_tpu_torch.sampling import rng

    table = jax_table()
    idx = np.arange(100_000, dtype=np.int32) * 7 + 3
    js = jrng.make_sampler(looper, jnp.asarray(idx))
    ts = rng.make_sampler(looper, torch.from_numpy(idx))
    jt = jnp.asarray(table)
    tt = torch.from_numpy(table.astype(np.int64))
    for draw in (jrng.sample_4d, jrng.sample_4d, jrng.sample_3d):
        jr, js = draw(jt, js)
        tr, ts = getattr(rng, draw.__name__)(tt, ts)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert ts.ptr == int(js.ptr)
    np.testing.assert_array_equal(ts.scramble.numpy().astype(np.uint32),
                                  np.asarray(js.scramble))


def test_hash_sampler_without_table_bit_exact():
    from radish_pt_tpu.sampling import rng as jrng
    from radish_pt_tpu_torch.sampling import rng

    idx = np.arange(4096, dtype=np.int32)
    jr, _ = jrng.sample_3d(None, jrng.make_sampler(3, jnp.asarray(idx)))
    tr, _ = rng.sample_3d(None, rng.make_sampler(3, torch.from_numpy(idx)))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_alias_table_and_sample_exact():
    from radish_pt_tpu.sampling import alias as jal
    from radish_pt_tpu_torch.sampling import alias as tal

    rng = np.random.default_rng(1)
    w = rng.uniform(0.0, 5.0, 37)
    jt, tt = jal.build_alias_table(w), tal.build_alias_table(w)
    np.testing.assert_array_equal(tt.prob, jt.prob)
    np.testing.assert_array_equal(tt.alias, jt.alias)
    assert tt.total == jt.total
    r = rng.uniform(size=(2, 100_000)).astype(np.float32)
    r[0, :3] = [0.0, 0.99999994, 1.0]
    want = np.asarray(jal.alias_sample(jnp.asarray(jt.prob), jnp.asarray(jt.alias),
                                       jnp.asarray(r[0]), jnp.asarray(r[1])))
    got = tal.alias_sample(torch.from_numpy(tt.prob), torch.from_numpy(tt.alias),
                           torch.from_numpy(r[0]), torch.from_numpy(r[1]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sobol_table_byte_equal(tmp_path, monkeypatch):
    from radish_pt_tpu.sampling.sobol import load_sobol_table as jax_table
    from radish_pt_tpu_torch.sampling import sobol

    monkeypatch.setenv("RADISH_TORCH_CACHE_DIR", str(tmp_path))
    got = sobol.load_sobol_table()
    assert os.path.exists(tmp_path / "sobol_10000_200.npy")  # own cache
    assert got.dtype == np.uint32
    assert got.tobytes() == jax_table().tobytes()


def test_config_copy_equal():
    """The port's config.py is the reference's: same enums and defaults."""
    import dataclasses

    from radish_pt_tpu import config as jc
    from radish_pt_tpu_torch import config as tc

    for name in ("ToneMapping", "Tracer", "Denoiser", "ReservoirReuse"):
        jv, tv = vars(getattr(jc, name)), vars(getattr(tc, name))
        assert {k: v for k, v in tv.items() if k.isupper()} == \
            {k: v for k, v in jv.items() if k.isupper()}, name
    for name in ("Settings", "RenderState"):
        assert dataclasses.asdict(getattr(tc, name)()) == \
            dataclasses.asdict(getattr(jc, name)()), name


@pytest.mark.parametrize("scene", ["cornell_box.txt", "teapot.txt",
                                   "textured.txt", "glass.txt", "many_light.txt"])
def test_parser_copy_equal(scene):
    """The port's scene parser reads every field the reference reads."""
    import dataclasses

    from radish_pt_tpu.scene.parser import parse_scene as jparse
    from radish_pt_tpu_torch.scene.parser import parse_scene

    path = os.path.join(SCENES, scene)
    want, got = jparse(path), parse_scene(path)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "instances":
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                assert (gi.material_id, gi.translation, gi.rotation, gi.scale) == \
                    (wi.material_id, wi.translation, wi.rotation, wi.scale)
                assert gi.transform.tobytes() == wi.transform.tobytes()
                np.testing.assert_array_equal(gi.mesh.vertices, wi.mesh.vertices)
        elif f.name == "textures":
            assert [t.tobytes() for t in g] == [t.tobytes() for t in w]
        elif f.name in ("materials", "state", "settings"):
            assert [dataclasses.asdict(x) for x in np.atleast_1d(g)] == \
                [dataclasses.asdict(x) for x in np.atleast_1d(w)], f.name
        else:
            assert g == w, f.name


@pytest.mark.parametrize("name", ["plane.obj", "cube.obj", "teapot.obj"])
def test_obj_loader_copy_equal(name):
    from radish_pt_tpu.scene.obj_loader import load_obj_py
    from radish_pt_tpu_torch.scene.obj_loader import load_obj

    path = os.path.join(SCENES, "models", name)
    ref, got = load_obj_py(path), load_obj(path)
    for k in ("vertices", "normals", "texcoords"):
        assert getattr(got, k).tobytes() == getattr(ref, k).tobytes()


def test_bvh_copy_equal():
    from radish_pt_tpu.accel.bvh import build_bvh_numpy
    from radish_pt_tpu_torch.accel.bvh import build_bvh

    rng = np.random.default_rng(9)
    centers = rng.uniform(-4, 4, size=(300, 1, 3))
    soup = (centers + rng.normal(scale=0.4, size=(300, 3, 3))).astype(np.float32)
    ref, got = build_bvh_numpy(soup.reshape(-1, 3)), build_bvh(soup.reshape(-1, 3))
    for k in ("bounds_min", "bounds_max", "node_leaf", "node_aabb",
              "node_miss", "leaf_tris", "leaf_map"):
        assert getattr(got, k).tobytes() == getattr(ref, k).tobytes(), k
    assert got.depth == ref.depth


def test_cluster_cuts_copy_equal():
    import unittest.mock as mock

    from radish_pt_tpu import native
    from radish_pt_tpu.scene import build as jbuild
    from radish_pt_tpu_torch.scene import build as tbuild

    rng = np.random.default_rng(4)
    centers = rng.uniform(-10, 10, (2500, 3)).astype(np.float32)
    half = rng.uniform(0.01, 0.4, (2500, 3)).astype(np.float32)
    order = np.argsort(centers[:, 0], kind="stable")
    pmin, pmax = (centers - half)[order], (centers + half)[order]
    with mock.patch.object(native, "load_library", lambda: None):
        want = jbuild._cluster_cuts(pmin, pmax, sub=128, lam_frac=0.005, chunk=1024)
    got = tbuild._cluster_cuts(pmin, pmax, sub=128, lam_frac=0.005, chunk=1024)
    np.testing.assert_array_equal(got, want)
