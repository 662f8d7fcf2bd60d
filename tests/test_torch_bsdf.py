"""Port parity: BSDF eval / pdf / sample per material type, on 4096 seeded
lanes (radish_pt_tpu_torch vs radish_pt_tpu)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_port_util import t2n  # noqa: E402

N = 4096


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(mtype, seed):
    """Materials of one type, shading normals, wo on the normal's side
    (the renderer flips non-delta normals towards wo), wi anywhere, r3."""
    rng = np.random.default_rng(seed)
    n = _unit(rng, N)
    wo = _unit(rng, N)
    flip = np.sum(n * wo, axis=-1) < 0
    if mtype != 2:
        wo[flip] = -wo[flip]
    mat = dict(
        mtype=np.full(N, mtype, np.int32),
        base_color=rng.uniform(0.05, 1.0, (N, 3)).astype(np.float32),
        metallic=rng.uniform(0.0, 1.0, N).astype(np.float32),
        roughness=rng.uniform(0.1, 1.0, N).astype(np.float32),
        ior=rng.uniform(1.1, 2.0, N).astype(np.float32),
    )
    return mat, n, wo, _unit(rng, N), rng.uniform(size=(N, 3)).astype(np.float32)


def _both(mat):
    from radish_pt_tpu.scene.device_scene import SurfaceMaterial as JMat
    from radish_pt_tpu_torch.scene.device_scene import SurfaceMaterial as TMat

    return (JMat(**{k: jnp.asarray(v) for k, v in mat.items()}),
            TMat(**{k: torch.from_numpy(v) for k, v in mat.items()}))


def _close(got, want, what):
    # 1e-5: the reference's XLA and torch's CPU kernels may round sqrt /
    # division chains and transcendentals an ulp apart
    got = got if isinstance(got, np.ndarray) else t2n(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                               atol=1e-6, err_msg=what)


@pytest.mark.parametrize("mtype", [0, 1, 2], ids=["lambertian", "metallic",
                                                  "dielectric"])
def test_bsdf_eval_pdf_sample_match(mtype):
    from radish_pt_tpu.bsdf import materials as jb
    from radish_pt_tpu_torch.bsdf import materials as tb

    mat, n, wo, wi, r3 = _inputs(mtype, 10 + mtype)
    jm, tm = _both(mat)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = torch.from_numpy
    types = (mtype,)
    _close(tb.bsdf_eval(tm, T(n), T(wo), T(wi), types),
           jb.bsdf_eval(jm, J(n), J(wo), J(wi), types), "eval")
    _close(tb.bsdf_pdf(tm, T(n), T(wo), T(wi), types),
           jb.bsdf_pdf(jm, J(n), J(wo), J(wi), types), "pdf")
    got = tb.bsdf_sample(tm, T(n), T(wo), T(r3), types)
    want = jb.bsdf_sample(jm, J(n), J(wo), J(r3), types)
    np.testing.assert_array_equal(t2n(got.type), np.asarray(want.type))
    # near the edge of the GGX visible-normal disk a sqrt of a near-zero
    # argument turns the last ulp of r3 into ~1e-5 of direction: each
    # direction is held to 1e-5 plus 100x the change one ulp of r3 makes in
    # the port's own output there (an ulp or two on most lanes)
    nudged = tb.bsdf_sample(tm, T(n), T(wo), T(np.nextafter(r3, np.float32(1))),
                            types)
    g, w = t2n(got.dir), np.asarray(want.dir)
    sens = np.abs(t2n(nudged.dir) - g)
    assert (np.abs(g - w) <= 1e-5 * np.abs(w) + 1e-6 + 100 * sens).all()
    # the metallic lobe's sample sits on its GGX peak, where D's
    # 1 - cos²θh term cancels: one ulp of n·h is ~1e-3 of D at roughness
    # 0.1 (eval and pdf away from the peak hold 1e-5 above)
    rtol = 5e-3 if mtype == 1 else 1e-5
    for k in ("bsdf", "pdf"):
        np.testing.assert_allclose(t2n(getattr(got, k)),
                                   np.asarray(getattr(want, k)), rtol=rtol,
                                   atol=1e-6, err_msg=k)
    valid = ~t2n(tb.is_invalid(got.type))
    assert valid.mean() > 0.5
    # all lobes evaluated (types=None) give the same answer
    _close(tb.bsdf_eval(tm, T(n), T(wo), T(wi)),
           jb.bsdf_eval(jm, J(n), J(wo), J(wi), types), "eval/all lobes")
