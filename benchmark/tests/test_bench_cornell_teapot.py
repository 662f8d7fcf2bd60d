"""The ``cornell_teapot`` configuration: its mesh is Newell's patches as the
table in ``configs/cornell_teapot/newell_teapot.txt`` gives them, through
the port's tessellator and through the plain one in ``reference/bezier.py``;
its cell loads as data alone; on the CPU at 32x32, with the teapot cut at 8
segments a patch (4,032 triangles, so clusters of 128 and the sorted sweeps
still run), a run is correct and the control is not; ``reorder_ms.pt`` reads
the reorder marks."""

import os

import numpy as np
import pytest

import tiny  # first: puts the benchmark on the path
from harness import check, spec
from harness.session import Session
from reference import bezier as rbz
from reference import obj_loader as robj

bz = pytest.importorskip("radish_pt_tpu_torch.scene.bezier")

CONFIG_DIR = os.path.join(spec.BENCH_DIR, "configs", "cornell_teapot")
TABLE = os.path.join(CONFIG_DIR, "newell_teapot.txt")
MESH = os.path.join(CONFIG_DIR, "newell_teapot_s42.obj")
CELL = "cornell_teapot.pt"


def test_the_plain_tessellator_equals_the_ports_at_8_segments():
    pts, idx = rbz.load_table(TABLE)
    v, n, faces, dropped = rbz.tessellate(pts, idx, 8)
    mesh = bz.tessellate(bz.load_patches(TABLE), 8)
    assert np.array_equal(faces, mesh.faces) and dropped == mesh.dropped == 64
    ulp = np.abs(v.view(np.int32).astype(np.int64) - mesh.vertices.view(np.int32))
    assert ulp.max() <= 1
    assert np.abs(n - mesh.normals).max() <= 2.0 ** -23


def test_the_committed_mesh_is_the_ports_tessellation_at_42(tmp_path):
    """``python -m radish_pt_tpu_torch.scene.bezier ... --segments 42``
    writes the committed file byte for byte."""
    out = tmp_path / os.path.basename(MESH)
    assert bz.main([TABLE, str(out), "--segments", "42"]) == 0
    with open(MESH, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()


def test_the_committed_mesh_is_the_plain_tessellation_of_the_table():
    """The committed mesh, read by the reference's own OBJ parser, is the
    plain tessellator's at 42 segments, turned y up: each triangle's
    corners to float32 rounding, 112,560 triangles."""
    pts, idx = rbz.load_table(TABLE)
    v, n, faces, dropped = rbz.tessellate(pts, idx, 42)
    assert (len(faces), dropped) == (112560, 336)
    got = robj.load_obj(MESH)
    want_v = v[faces.reshape(-1)][:, [0, 2, 1]] * np.float32([1, 1, -1])
    want_n = n[faces.reshape(-1)][:, [0, 2, 1]] * np.float32([1, 1, -1])
    ulp = np.abs(got.vertices.view(np.int32).astype(np.int64) - want_v.view(np.int32))
    assert ulp.max() <= 1
    assert np.abs(got.normals - want_n).max() <= 2.0 ** -23


def test_the_cell_loads_as_data_alone():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic == spec.load_traffic("pt_offline")
    assert cell.config["engine"] is None and cell.config["reduced"] == []
    assert os.path.exists(spec.path_in_checkout(cell.config["scene"]))
    assert {m["name"] for m in cell.end_to_end} == {"pt_frame_ms", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert "reorder_ms.pt" in names and "isect_ms.pt" in names
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """The cell's scene with its teapot cut at 8 segments a patch side, in
    a folder of its own (the box's planes named by absolute path)."""
    d = tmp_path_factory.mktemp("cornell_teapot8")
    mesh = bz.to_y_up(bz.tessellate(bz.load_patches(TABLE), 8))
    bz.write_obj(mesh, str(d / "newell_teapot_s8.obj"))
    plane = os.path.join(spec.ROOT, "scenes", "models", "plane.obj")
    with open(os.path.join(CONFIG_DIR, "scene.txt"), encoding="utf-8") as f:
        text = f.read()
    text = text.replace("../../../scenes/models/plane.obj", plane)
    text = text.replace("newell_teapot_s42.obj", "newell_teapot_s8.obj")
    (d / "scene.txt").write_text(text)
    return str(d / "scene.txt")


def test_a_small_teapot_run_is_correct_through_the_sorted_sweeps(small_scene):
    from radish_pt_tpu_torch.utils import timing

    before = timing.counters().get("isect.sorted_wavefronts", 0)
    out = tiny.run(CELL, seconds=0.4, scene=small_scene)
    assert out["checks"] and out["correct"], out["checks"]
    assert "engine plucker" in out["notes"][0]
    assert timing.counters().get("isect.sorted_wavefronts", 0) > before


def test_the_control_is_not_correct_on_the_small_teapot(small_scene):
    c = spec.load_cell(CELL)
    c.traffic = {**c.traffic, **tiny.traffic("pt")}
    sess = Session(c, 2147483659, device="cpu", overrides={**tiny.TINY, "scene": small_scene})
    sess.setup()
    sess.window(0.3)
    inputs = sess.check_inputs()
    sess.close()
    judged = check.judge(check.readings(inputs, "cpu", control=True), "pt")
    assert check.failures(judged) >= 1, judged


def _rec(ops, frames=2):
    return {"trace": {"frames": frames, "ops": ops}}


def test_reorder_ms_reads_the_reorder_marks():
    read = spec.metric_reader("reorder_ms.pt")
    ops = [("stage_mark_extend", 0, 1), ("stage_mark_reorder", 1, 2),
           ("signature_key_kernel", 2, 12), ("void at::native::sort(...)", 12, 20),
           ("stage_mark_reorder_end", 20, 21), ("closest_hit_kernel", 21, 500),
           ("stage_mark_reorder", 500, 501), ("index_copy", 501, 505),
           ("stage_mark_reorder_end", 505, 506), ("elementwise", 506, 600)]
    assert read(_rec(ops)) == pytest.approx((10 + 8 + 4) / 1e3 / 2)
    assert read(_rec([op for op in ops if "reorder" not in op[0]])) is None
    assert read({"trace": None}) is None
