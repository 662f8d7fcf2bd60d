"""The path tracer's vertex on the CPU: the dispatcher in
``render/vertex.py`` runs the plain version on CPU tensors, the ctypes
mirrors of the kernels' argument structs match the C structs field for
field, and the plain vertex (``render/pathtrace.py::vertex_plain`` with
the shadow test and the resolve of ``_vertex``) equals the JAX package's
``_nee_contrib`` + ``_bsdf_advance`` on the same lanes of a Lambertian, a
MetallicWorkflow, a dielectric and an env-lit scene.

Tolerance of the comparison with the JAX package, with its reason: the
sampler state, ``active`` and the delta flags exactly; the contribution,
throughput, direction and pdf within rtol 1e-5, atol 1e-6, but a
MetallicWorkflow lane's pdf within rtol 5e-3, on all lanes but at most 1 in
500, which are held to rtol 1e-3, atol 1e-3 where finite.  XLA's and
torch's sin, cos and sums may differ by an ulp; the GGX pdf divides by the
square of (n.h)^2 (alpha^2 - 1) + 1, which cancels near a smooth lobe's
peak and makes such an ulp up to 2.3e-3 of it (measured on env_teapot's
24x24 wavefronts, 5.5e-5 on teapot's; every other field within 1e-5 on
every lane); and a lobe choice or a grazing shadow ray that an ulp settles
may go the other way on a lane.  The kernel's own equality with the plain
version, bit for bit, is held on the card (tests/test_torch_cuda.py).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402
from torch_port_util import camera_from_jax, jax_scene_parts, load_jax_scene, t2n  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
CSRC = os.path.join(REPO, "radish_pt_tpu_torch", "csrc")
SCENE_FILES = {"cornell": "cornell_box.txt", "teapot": "teapot.txt", "glass": "glass.txt",
               "env_teapot": "env_teapot.txt"}
RES = 24
MAT_METALLIC_WORKFLOW = 1


def test_vertex_on_cpu_runs_the_plain_version():
    """On CPU tensors every vertex of a frame is ``vertex_plain``: one
    plain call a bounce and no kernel launch; the dispatcher called alone
    counts one more."""
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import vertex as vx
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, _ = load_scene(os.path.join(REPO, "scenes", "cornell_box.txt"), device="cpu")
    cam = cam.replace(width=16, height=16)
    seen = []
    orig = vx.vertex

    def spy(*args):
        seen.append(args)
        return orig(*args)

    tally = Tally()
    vx.vertex = spy
    try:
        pt.path_trace(ds, cam, 2, 3)
    finally:
        vx.vertex = orig
    assert tally("launch.vertex") == {} and tally("plain.vertex") == {"vertex": 3}
    out = vx.vertex(*seen[0])
    assert tally("launch.vertex") == {} and tally("plain.vertex") == {"vertex": 4}
    assert isinstance(out, vx.Vertex) and int(out.sampler.ptr) == int(seen[0][1].ptr) + 7
    with pytest.raises(ValueError, match="CUDA tensor"):
        vx.vertex_cuda(*seen[0])


def test_bytes_moved_counts_each_lanes_material():
    """The kernel's bound reads metallic and roughness only on
    MetallicWorkflow lanes and ior only on dielectric ones: 136 bytes a
    Lambertian lane, 144 a MetallicWorkflow one, 140 a dielectric one."""
    from radish_pt_tpu_torch.render import vertex as vx
    from radish_pt_tpu_torch.scene import device_scene as dsc

    mtype = torch.tensor([dsc.MAT_LAMBERTIAN] * 3 + [dsc.MAT_METALLIC_WORKFLOW] * 2
                         + [dsc.MAT_DIELECTRIC], dtype=torch.int32)
    assert vx.bytes_moved(mtype) == 3 * 136 + 2 * 144 + 140
    assert vx.bytes_moved(mtype[:0]) == 0


def _c_struct_fields(source: str, name: str) -> list:
    """The field names of ``struct <name> { ... };`` in csrc/<source>, in
    order."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            fields += [re.findall(r"\w+", part)[-1] for part in decl.split(",")]
    return fields


@pytest.mark.parametrize("source,struct,module", [
    ("vertex.cu", "VertexArgs", "vertex"), ("ris.cu", "RisArgs", "ris"),
    ("surface.cu", "SurfaceArgs", "surface")])
def test_args_mirror_the_kernels_struct(source, struct, module):
    """The ctypes structure the wrapper fills is the C struct the kernel
    reads: the same fields in the same order (ctypes lays them out with the
    C compiler's alignment)."""
    import importlib

    mod = importlib.import_module(f"radish_pt_tpu_torch.render.{module}")
    ours = [f for f, _ in getattr(mod, struct)._fields_]
    assert ours == _c_struct_fields(source, struct)


@pytest.fixture(scope="module")
def scenes():
    """Per scene: (the JAX scene on its numpy host path, brute force, the
    port's copy of it, the port's 24x24 camera)."""
    from radish_pt_tpu_torch.scene.device_scene import scene_from_jax

    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for key, fname in SCENE_FILES.items():
            jds, jcam, _ = load_jax_scene(mp, fname)
            jds = jds.replace(intersector="brute")
            ds = scene_from_jax(*jax_scene_parts(jds), intersector="brute")
            out[key] = (jds, ds, camera_from_jax(jcam, RES, RES))
    finally:
        mp.undo()
    return out


def _wavefront(ds, cam, bounce, looper=3):
    """The lanes the dense loop hands the vertex at ``bounce`` of a frame,
    through the port's own loop: (sampler, active, material, normal, ray
    direction, position, throughput)."""
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.sampling import rng
    from radish_pt_tpu_torch.scene import device_scene as dsc

    idx, _ = pt._lanes(ds, cam)
    smp = rng.make_sampler(looper, idx)
    ray_o, ray_d, smp = pt._gen_primary(ds, cam, smp, idx)
    it = dsc.intersect_primary(ds, ray_o, ray_d)
    mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
    active = (it.prim_id != pt.NULL_PRIMITIVE) & (mat.mtype != dsc.MAT_LIGHT)
    thr, pos = torch.ones_like(ray_d), it.pos
    for _ in range(bounce - 1):
        _, smp, active, thr, new_dir, pdf, delta = pt._vertex(ds, smp, active, mat, norm,
                                                              ray_d, pos, thr)
        it = dsc.intersect_sorted(ds, pos + new_dir * 1e-5, new_dir, active=active)
        _, active, mat, norm = pt._shade_hit(ds, torch.zeros_like(thr), active, thr,
                                             it.prim_id, it.pos, it.norm, it.uv, it.mat_id,
                                             new_dir, pdf, delta, pos)
        pos, ray_d = it.pos, new_dir
    return smp, active, mat, norm, ray_d, pos, thr


def _reference_vertex(jds, smp, active, mat, norm, ray_d, pos, thr):
    """The JAX package's vertex on the same lanes: its two-sided normal,
    ``_nee_contrib`` and ``_bsdf_advance`` (eager, its brute-force shadow
    test)."""
    from radish_pt_tpu.render import pathtrace as jpt
    from radish_pt_tpu.sampling import rng as jrng
    from radish_pt_tpu.scene import device_scene as jdsc
    from radish_pt_tpu.utils import math as jm

    j = lambda t: jnp.asarray(t2n(t))  # noqa: E731
    jmat = jdsc.SurfaceMaterial(mtype=j(mat.mtype), base_color=j(mat.base_color),
                                metallic=j(mat.metallic), roughness=j(mat.roughness),
                                ior=j(mat.ior))
    jsmp = jrng.SamplerState(scramble=jnp.asarray(t2n(smp.scramble).astype(np.uint32)),
                             ptr=jnp.asarray(int(smp.ptr), dtype=jnp.int32))
    norm, wo = j(norm), -j(ray_d)
    flip = (jmat.mtype != jdsc.MAT_DIELECTRIC) & (jm.dot(norm, wo) < 0.0)
    norm = jnp.where(flip[..., None], -norm, norm)
    contrib, jsmp = jpt._nee_contrib(jds, jsmp, j(active), jmat, norm, wo, j(pos), j(thr))
    return (contrib, *jpt._bsdf_advance(jds, jsmp, j(active), jmat, norm, wo, j(thr)))


def _close_but_few(got, want, what, rtol=1e-5, share=2e-3):
    """Within (``rtol``, a lane's own or one for all; atol 1e-6) on all
    but ``share`` of the lanes; those within (1e-3, 1e-3) where finite
    (module docstring)."""
    got, want = got.reshape(len(got), -1), want.reshape(len(want), -1)
    rtol = np.broadcast_to(np.asarray(rtol, dtype=np.float64).reshape(-1, 1), got.shape)
    same = np.isclose(got, want, rtol=rtol, atol=1e-6, equal_nan=True).all(-1)
    assert (~same).mean() <= share, (what, int((~same).sum()))
    near = np.isclose(got, want, rtol=np.maximum(rtol, 1e-3), atol=1e-3, equal_nan=True)
    assert (near | ~np.isfinite(want)).all(), (what, got[~near], want[~near])


@pytest.mark.parametrize("bounce", [1, 2])
@pytest.mark.parametrize("name", list(SCENE_FILES))
def test_vertex_plain_matches_reference(scenes, name, bounce):
    """``_vertex`` on the CPU (``vertex_plain``, the shadow test, the
    resolve) against the JAX package's vertex on every lane of a 24x24
    wavefront at bounce 1 (primary hits) and bounce 2 (after one vertex
    and extension: mixed throughput, dead lanes): Lambertian (cornell),
    MetallicWorkflow (teapot), Dielectric (glass), the env map as the only
    light (env_teapot).  Tolerances in the module docstring."""
    from radish_pt_tpu_torch.render import pathtrace as pt

    jds, ds, cam = scenes[name]
    lanes = _wavefront(ds, cam, bounce)
    want = _reference_vertex(jds, *lanes)
    tally = Tally()
    got = pt._vertex(ds, *lanes)
    assert tally("plain.vertex") == {"vertex": 1}
    contrib, smp, active, thr, new_dir, pdf, delta = got
    jcontrib, jsmp, jactive, jthr, jdir, jpdf, jdelta = want
    assert np.array_equal(t2n(smp.scramble), np.asarray(jsmp.scramble).astype(np.int64))
    assert int(smp.ptr) == int(jsmp.ptr) == int(lanes[0].ptr) + 7
    assert np.array_equal(t2n(active), np.asarray(jactive)), name
    assert np.array_equal(t2n(delta), np.asarray(jdelta)), name
    for what, a, b in (("contrib", contrib, jcontrib), ("throughput", thr, jthr),
                       ("new_dir", new_dir, jdir), ("pdf", pdf, jpdf)):
        metal = t2n(lanes[2].mtype) == MAT_METALLIC_WORKFLOW
        _close_but_few(t2n(a), np.asarray(b), (name, bounce, what),
                       rtol=np.where(metal, 5e-3, 1e-5) if what == "pdf" else 1e-5)
    live = t2n(lanes[1])
    assert live.any() and np.abs(t2n(contrib)).sum() > 0, name
