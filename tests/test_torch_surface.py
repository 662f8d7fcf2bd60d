"""The closest hit's surface on the CPU: the dispatcher in
``render/surface.py`` runs the plain version (``render/pathtrace.py::
surface_plain``) on CPU tensors and its kernel wrapper refuses them; the
primaries' accounting equals the eager primary it stands in for (the
emission and env map of ``path_trace``'s first hit), bit for bit; the
kernel's bytes bound; the scene's ``textured`` flag that picks the
kernel's texture form.  The kernel's own equality with the plain version,
bit for bit, is held on the card (tests/test_torch_cuda.py)."""

import os

import pytest

torch = pytest.importorskip("torch")

from radish_pt_tpu_torch.utils.timing import Tally  # noqa: E402

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _scene(name, res=16, engine=None):
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, _ = load_scene(os.path.join(SCENES, name), device="cpu", intersector=engine)
    return ds, cam.replace(width=res, height=res)


def test_surface_on_cpu_runs_the_plain_version():
    """On CPU tensors every surface of a frame is ``surface_plain``: one
    plain call for the primaries and one a bounce, no kernel launch; the
    dispatcher called alone counts one more; ``surface_cuda`` raises."""
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import surface as sf

    ds, cam = _scene("cornell_box.txt")
    seen = []
    orig = sf.surface

    def spy(*args):
        seen.append(args)
        return orig(*args)

    tally = Tally()
    sf.surface = spy
    try:
        pt.path_trace(ds, cam, 2, 3, n_slices=0)
    finally:
        sf.surface = orig
    assert tally("launch.surface") == {} and tally("plain.surface") == {"surface": 4}
    assert [a[5] == sf.PRIMARY for a in seen] == [True, False, False, False]
    out = sf.surface(*seen[1])
    assert tally("launch.surface") == {} and tally("plain.surface") == {"surface": 5}
    assert isinstance(out, sf.Surface) and out.acc.shape == seen[1][3].shape
    with pytest.raises(ValueError, match="CUDA tensor"):
        sf.surface_cuda(*seen[1])
    assert tally("launch.surface") == {}


@pytest.mark.parametrize("name,engine", [("cornell_box.txt", None), ("env_teapot.txt", None),
                                         ("glass.txt", "dense")])
def test_primary_accounting_is_the_eager_primary(name, engine):
    """The primaries' accounting (``surface.PRIMARY``: a bounce from every
    lane alive, throughput 1 after a delta sample, nothing accumulated)
    gives what the path tracer's first hit computed before it: ``acc`` the
    env map where the ray missed plus a light's base colour where it hits
    a light's visible side, ``active`` a hit that is not a light, bit for
    bit (an env map, its only light; a dielectric with the interpolating
    dense engine)."""
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import surface as sf
    from radish_pt_tpu_torch.sampling import rng
    from radish_pt_tpu_torch.scene import device_scene as dsc

    ds, cam = _scene(name, 24, engine)
    idx, _ = pt._lanes(ds, cam)
    ray_o, ray_d, _ = pt._gen_primary(ds, cam, rng.make_sampler(3, idx), idx)
    prim, bary = dsc.intersect_primary_ids(ds, ray_o, ray_d)
    got = sf.surface(ds, prim, bary, ray_o, ray_d, sf.PRIMARY)
    plain = sf.surface(ds, prim, bary, ray_o, ray_d)

    it = dsc.intersect_primary(ds, ray_o, ray_d)
    hit = it.prim_id != pt.NULL_PRIMITIVE
    direct = pt._mask3(~hit, dsc.env_radiance(ds, ray_d))
    mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
    is_light = hit & (mat.mtype == dsc.MAT_LIGHT)
    direct = direct + pt._mask3(is_light & pt._light_visible_side(ds, norm, ray_d),
                                mat.base_color)
    assert bool(hit.any())
    assert torch.equal(got.acc.view(torch.int32), direct.view(torch.int32))
    assert torch.equal(got.active, hit & ~is_light)
    for a, b in ((got.pos, it.pos), (got.norm, norm), (got.mat_id, it.mat_id),
                 (plain.pos, it.pos), (plain.norm, norm)):
        assert torch.equal(a, b)
    for f in ("mtype", "base_color", "metallic", "roughness", "ior"):
        assert torch.equal(getattr(got.mat, f), getattr(mat, f)), f
        assert torch.equal(getattr(plain.mat, f), getattr(mat, f)), f
    assert plain.acc is None and plain.active is None


def test_bytes_moved_counts_each_form():
    """The kernel's bound: 84 bytes a lane from the winner id without the
    accounting (winner, ray, outputs), 68 from barycentrics; 97 and 93
    with the primaries' accounting (the direction and acc, active out);
    139 and 135 with a bounce's path state; and 100 bytes for each
    triangle row read (a miss reads row 0)."""
    from radish_pt_tpu_torch.render import surface as sf

    ds, _ = _scene("cornell_box.txt")
    prim = torch.tensor([3, 3, -1, 7, 7, 7], dtype=torch.int32)
    rows = 3 * 100  # rows 3, 0 and 7
    for interpolated, account, lane in ((False, sf.ACCOUNT_NONE, 84),
                                        (True, sf.ACCOUNT_NONE, 68),
                                        (False, sf.ACCOUNT_PRIMARY, 97),
                                        (True, sf.ACCOUNT_PRIMARY, 93),
                                        (False, sf.ACCOUNT_BOUNCE, 139),
                                        (True, sf.ACCOUNT_BOUNCE, 135)):
        assert sf.bytes_moved(ds, prim, interpolated, account) == 6 * lane + rows
    assert sf.bytes_moved(ds, prim[:0], False, sf.ACCOUNT_BOUNCE) == 0
    assert [sf.account_mode(p) for p in (None, sf.PRIMARY, object())] == [0, 1, 2]


@pytest.mark.parametrize("name,textured", [("cornell_box.txt", False), ("teapot.txt", True),
                                           ("textured.txt", True), ("env_teapot.txt", False)])
def test_textured_flag_names_scenes_with_maps(name, textured):
    """``DeviceScene.textured``, which picks the kernel's texture form: set
    where a material has a map (teapot's procedural floor, textured's
    images), clear elsewhere (an env map is no material's map)."""
    ds, _ = _scene(name)
    assert ds.textured is textured
