"""The port's frame pair accounting (utils/pairstats.py) on the CPU: a
replay of teapot's 32x32 frame counted with ``plucker.pair_counts``."""

import os

import pytest

torch = pytest.importorskip("torch")

from torch_port_util import SCENES  # noqa: E402

DEPTH = 3


def _scene(name):
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, _ = load_scene(os.path.join(SCENES, name), device="cpu")
    return ds, cam.replace(width=32, height=32)


def test_frame_pair_stats_sums_pair_counts(monkeypatch):
    """Teapot (Plücker, 43 clusters), depth 3: 1 + 2 x 3 wavefronts
    (primaries in sweep order, then per bounce the shadow segments and the
    extension rays), and the totals are the sums of ``pair_counts`` over
    them (its per-lane pairs the floor, its per-warp pairs what the
    Plücker kernels sweep); floor <= swept <= row."""
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.utils import pairstats as ps

    ds, cam = _scene("teapot.txt")
    seen = []
    real = plk.pair_counts

    def record(*args, **kw):
        out = real(*args, **kw)
        seen.append((args[1].shape[0], out))
        return out

    monkeypatch.setattr(plk, "pair_counts", record)
    st = ps.frame_pair_stats(ds, cam, 0, DEPTH)
    assert [n for n, _ in seen] == [32 * 32] * (1 + 2 * DEPTH)
    assert st["pairs_floor"] == sum(c["lane"] for _, c in seen)
    assert st["pairs_swept"] == sum(c["warp"] for _, c in seen)
    assert st["pairs_row"] == sum(c["row"] for _, c in seen)
    assert 0 < st["pairs_floor"] <= st["pairs_swept"] <= st["pairs_row"]
    # the primaries go in the frame's sweep order: the tile-order lanes
    # sorted on their key
    assert ds.sort_primaries and pt._lanes(ds, cam)[1] is not None


def test_cornell_has_no_stats_and_utilization_fields():
    from radish_pt_tpu_torch.utils import pairstats as ps

    ds, cam = _scene("cornell_box.txt")
    assert ps.frame_pair_stats(ds, cam, 0, DEPTH) is None
    st = {"pairs_swept": 4.1e9, "pairs_row": 9e9, "pairs_floor": 1.2e9}
    u = ps.utilization(st, 100.0)
    assert set(u) == {"gpairs_per_s", "cull_efficiency_pct", "pct_of_f32_peak",
                      "pct_of_f32_unfused_rate", "pct_of_memory_rate"}
    assert u["gpairs_per_s"] == 41.0 and u["cull_efficiency_pct"] == 29.3
    assert u["pct_of_f32_unfused_rate"] == pytest.approx(2 * u["pct_of_f32_peak"], rel=0.01)
    assert ps.utilization(None, 10.0) == {} and ps.utilization(st, 0.0) == {}
