"""The sort-key kernel's two paths (csrc/sort_key.cu), on the CPU: its
finite path takes the slab test with ``fminf`` / ``fmaxf`` on a warp whose
rays all lie in ``sort_key.finite_path_lanes`` (with every box finite),
its NaN path keeps ``torch.minimum`` / ``torch.maximum``'s NaN rule.  A
plain twin of the finite path (``signature_key_plain`` with ``torch.fmin``
/ ``torch.fmax`` in their place) equals the plain version, and the JAX
package's ``_sort_key``, as an integer on every lane of finite rays:
teapot's bounce-1 rays and NEE segments, signed-zero and infinite direction
components, origins so far out that the slab products overflow to +-inf.
It does not equal it on NaN origins, nor where an infinite direction meets
an overflowed difference (inf * 0), which is why the kernel keeps the NaN
rule for such warps.  Also: ``tune key`` and ``tune bin`` vary only the
macros the kernels define.  Tolerance: none (keys are integers)."""

import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
from test_torch_sliced import _keys, teapot  # noqa: E402,F401
from torch_port_util import t2n  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")


def finite_twin(boxes, ray_o, ray_d, tmax=None, active=None, band=False):
    """``signature_key_plain`` as the kernel's finite path computes it:
    ``torch.fmin`` / ``torch.fmax`` (which drop a NaN) in place of
    ``torch.minimum`` / ``torch.maximum`` and of the clamp at 0."""
    from radish_pt_tpu_torch.accel import sort_key as sk

    n, n_c = ray_o.shape[0], boxes.shape[0]
    inv = 1.0 / torch.where(torch.abs(ray_d) > 1e-12, ray_d, 1e-12)
    tn = torch.full((n, n_c), -3.4e38, dtype=torch.float32)
    tf = torch.full((n, n_c), 3.4e38, dtype=torch.float32)
    for k in range(3):
        a = (boxes[None, :, k] - ray_o[:, k, None]) * inv[:, k, None]
        b = (boxes[None, :, 3 + k] - ray_o[:, k, None]) * inv[:, k, None]
        tn = torch.fmax(tn, torch.fmin(a, b))
        tf = torch.fmin(tf, torch.fmax(a, b))
    hit = tf >= torch.fmax(tn, torch.zeros_like(tn))
    if tmax is not None:
        hit = hit & (tn < (tmax if not isinstance(tmax, torch.Tensor) else tmax[:, None]))
    hit8 = hit.to(torch.int8)
    count = hit8.sum(1, dtype=torch.int32)
    none = n_c + 1
    first = torch.where(count > 0, hit8.argmax(1).to(torch.int32), none)
    ids = torch.arange(n_c, dtype=torch.int32)
    rest = (hit & (ids[None, :] != first[:, None])).to(torch.int8)
    second = torch.where(count > 1, rest.argmax(1).to(torch.int32), none)
    f8, s8 = torch.clamp(first, max=255), torch.clamp(second, max=255)
    cnt = torch.clamp(count, max=63)
    key = (cnt << 16) | (f8 << 8) | s8 if band else (f8 << 14) | (s8 << 6) | cnt
    key = key + torch.where(count == 0, sk.miss_extra(n_c), 0).to(torch.int32)
    if active is not None:
        key = key + torch.where(active, 0, sk.DEAD_KEY_BIT).to(torch.int32)
    return key


@pytest.fixture(scope="module")
def teapot_bounce(teapot):
    """teapot's 24x24 wavefronts as the frame builds them (the port on the
    CPU): the primaries, the bounce-1 extension rays with their dead lanes,
    the bounce-1 NEE segments with their masked lanes."""
    sys.path.insert(0, REPO)
    import chip_smoke

    _, jcam, ds = teapot
    from torch_port_util import camera_from_jax

    return ds, chip_smoke.bounce_one(ds, camera_from_jax(jcam, 24, 24))


@pytest.mark.parametrize("wave", ["primary", "extension", "segments"])
@pytest.mark.parametrize("band", [False, True])
def test_finite_twin_equals_plain_on_teapot(teapot_bounce, wave, band):
    """On teapot's wavefronts every lane is a finite-path lane, and the
    twin's key equals the plain version's, and the JAX package's, on every
    lane (segments bounded at their end; dead lanes marked)."""
    from radish_pt_tpu_torch.accel import sort_key as sk

    ds, waves = teapot_bounce
    if wave == "segments":
        x, y, ok = waves["segments"]
        o, d, tmax, active = x, y - x, 1.0, ok
    else:
        o, d, tm = waves[wave]
        tmax, active = None, tm > 0
    assert bool(sk.finite_path_lanes(o, d).all())
    want = sk.signature_key_plain(ds.key_bounds, o, d, tmax, active, band)
    got = finite_twin(ds.key_bounds, o, d, tmax, active, band)
    assert torch.equal(got, want), int((got != want).sum())
    ref, port = _keys(t2n(ds.cluster_bounds), t2n(o), t2n(d),
                      None if tmax is None else np.ones(o.shape[0], np.float32), band)
    np.testing.assert_array_equal(port, ref)
    dead = torch.where(active, 0, sk.DEAD_KEY_BIT).to(torch.int32)
    np.testing.assert_array_equal(t2n(want - dead), ref)
    assert len(np.unique(ref)) > 5


def _edge_rays(case, rng, n=2048):
    """Rays around random boxes in [-1, 1]^3: signed-zero direction
    components, infinite direction components (+-inf, origins inside the
    scene), or origins at +-1e30 to 3e38 with tiny components (1 / d up to
    1e12: the slab products overflow to +-inf)."""
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ar = np.arange(n)
    axis = ar % 3
    if case == "signed_zeros":
        d[ar, axis] = np.where(ar % 2 == 0, np.float32(0.0), np.float32(-0.0))
        d[ar % 7 == 0, (axis[ar % 7 == 0] + 1) % 3] = -0.0
    elif case == "infinite_directions":
        d[ar, axis] = np.where(ar % 2 == 0, np.inf, -np.inf).astype(np.float32)
        d[ar % 5 == 0] = np.float32([np.inf, -np.inf, np.inf])
    else:  # far origins
        far = o * 10.0 ** rng.uniform(30, 38.5, (n, 1))  # f64: no overflow here
        d[ar % 2 == 0, axis[ar % 2 == 0]] = rng.choice([1e-13, -1e-13, 1e-30], (n + 1) // 2)
        home = ar % 3 == 0  # pointing back at the scene
        d[home] = -far[home] / np.linalg.norm(far[home], axis=-1, keepdims=True)
        o = np.clip(far, -3.0e38, 3.0e38).astype(np.float32)
    return o, d


@pytest.mark.parametrize("case", ["signed_zeros", "infinite_directions", "far_origins"])
@pytest.mark.parametrize("ranged", [False, True])
def test_finite_twin_equals_plain_on_edge_rays(teapot, case, ranged):
    """+-0 direction components (1 / d of +1e12: the 1e-12 substitution),
    infinite ones (1 / d of +-0: products of +-0, never NaN with a finite
    difference) and origins so far out that the products overflow to +-inf:
    the twin's key equals the plain version's, and the JAX package's, on
    every lane, on teapot's 43 boxes and on 256 random ones.  Infinite
    directions leave the finite path (``finite_path_lanes`` false), the
    other cases stay on it."""
    from radish_pt_tpu_torch.accel import sort_key as sk

    rng = np.random.default_rng(15 + ranged)
    lo = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    rand = np.concatenate([lo, lo + rng.uniform(0.01, 0.5, (256, 3)).astype(np.float32)], 1)
    o, d = _edge_rays(case, rng)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    assert bool(sk.finite_path_lanes(ot, dt).all()) == (case != "infinite_directions")
    tmax = torch.from_numpy(rng.uniform(-1.0, 4.0, o.shape[0]).astype(np.float32)) if ranged \
        else None
    for cb in (t2n(teapot[2].cluster_bounds), rand):
        boxes = torch.from_numpy(sk.key_boxes(cb))
        want = sk.signature_key_plain(boxes, ot, dt, tmax)
        got = finite_twin(boxes, ot, dt, tmax)
        assert torch.equal(got, want), (case, int((got != want).sum()))
        ref, port = _keys(cb, o, d, None if tmax is None else t2n(tmax))
        np.testing.assert_array_equal(port, ref)
        assert np.array_equal(t2n(want), port)
    if case == "far_origins":  # the products did overflow
        inv = 1.0 / np.where(np.abs(d) > 1e-12, d, np.float32(1e-12))
        with np.errstate(over="ignore"):
            assert np.isinf((rand[None, :, 0] - o[:, 0, None]) * inv[:, 0, None]).any()


def test_finite_twin_differs_where_the_nan_rule_is_needed():
    """NaN origins, and an infinite direction component where the
    difference box - o overflowed (inf * 0): the plain version's NaN rule
    keeps a NaN slab end (the box is not reached), the twin drops it; the
    keys differ on such lanes, and ``finite_path_lanes`` leaves every one
    of them out, so the kernel takes the NaN rule there."""
    from radish_pt_tpu_torch.accel import sort_key as sk

    rng = np.random.default_rng(23)
    n = 1024
    lo = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.6, (64, 3)).astype(np.float32)], 1)
    boxes[:8, 0], boxes[:8, 3] = np.float32(-2e38), np.float32(-1e38)  # far along -x
    boxes = torch.from_numpy(boxes)
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    nan_lanes = torch.arange(n) % 2 == 0
    o[nan_lanes, torch.arange(n)[nan_lanes] % 3] = float("nan")
    far = torch.arange(n) % 4 == 1  # origin at 2e38 along x, direction +-inf along x
    o[far, 0] = 2e38
    d[far, 0] = torch.where(torch.arange(n)[far] % 8 == 1, float("inf"), float("-inf"))
    want = sk.signature_key_plain(boxes, o, d)
    got = finite_twin(boxes, o, d)
    differ = got != want
    assert bool(differ[nan_lanes].any()) and bool(differ[far].any())
    assert not bool(differ[~(nan_lanes | far)].any())
    assert not bool(sk.finite_path_lanes(o, d)[nan_lanes | far].any())
    assert bool(sk.finite_path_lanes(o, d)[~(nan_lanes | far)].all())


def _macros(source, prefix):
    """A csrc source's compile-time shapes named ``prefix...``: {name: default}."""
    import radish_pt_tpu_torch

    src = (Path(radish_pt_tpu_torch.__file__).parent / "csrc" / source).read_text()
    return dict(re.findall(rf"#ifndef ({prefix}\w+)\n#define \1 (\d+)", src))


@pytest.mark.parametrize("kernel,k", [(kernel, k) for kernel, n in (("key", 5), ("bin", 4))
                                      for k in range(n)])
def test_tune_variants_name_the_key_and_bin_macros(kernel, k):
    """``tune key``'s variants set exactly the macros csrc/sort_key.cu
    defines (KEY_RAYS, KEY_THREADS), ``tune bin``'s the one
    csrc/bvh.cu defines for the binning kernel (BIN_THREADS); the first is
    the source's defaults, every other changes one of them, no two alike."""
    from radish_pt_tpu_torch import tune

    assert (len(tune.KEY_VARIANTS), len(tune.BIN_VARIANTS)) == (5, 4)
    variants, macros = ((tune.KEY_VARIANTS, _macros("sort_key.cu", "KEY_")) if kernel == "key"
                        else (tune.BIN_VARIANTS, _macros("bvh.cu", "BIN_")))
    assert set(macros) == ({"KEY_RAYS", "KEY_THREADS"} if kernel == "key"
                           else {"BIN_THREADS"})
    as_dict = [dict(f[2:].split("=") for f in v) for v in variants]
    variant = as_dict[k]
    assert set(variant) == set(macros)
    changed = {m for m in variant if variant[m] != macros[m]}
    assert len(changed) == (0 if k == 0 else 1), (k, changed)
    assert as_dict.count(variant) == 1
