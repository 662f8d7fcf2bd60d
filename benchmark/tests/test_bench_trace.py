"""The trace's record and the per-layer readers, on a recorded sample."""

import json
import os

import pytest

import tiny  # noqa: F401  (puts the benchmark on the path)
from harness import readers, spec, trace

SAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "trace_sample.json")


@pytest.fixture(scope="module")
def rec():
    s = json.load(open(SAMPLE))
    tr = trace.record([tuple(e) for e in s["device"]], [tuple(e) for e in s["host"]],
                      s["frames"])
    return {"trace": tr, "setup_s": 9.0, "load_scene_s": 0.1, "warmup_s": 1.5,
            "window": {"window_s": 1.0, "calls": 10, "frames": 40, "host_s": 0.2,
                       "stamps_ms": [0.0, 25.0, 50.0]}}


def test_record_busy_window_and_gaps(rec):
    tr = rec["trace"]
    # from the first frame's start (90 us) to the closing sync's end (720)
    assert tr["window_s"] == pytest.approx(630e-6)
    # busy: 100-260, 300-400, 600-700
    assert tr["busy_s"] == pytest.approx(360e-6)
    gaps = tr["breakdown"]["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([200e-6, 40e-6, 20e-6, 10e-6])
    assert gaps[0][0] == "bench.frame / cudaStreamSynchronize"
    assert gaps[2][0] == "bench.sync"
    top = tr["breakdown"]["device_ops"]
    assert top[0][0].startswith("void at::native::vectorized") and top[0][1] == pytest.approx(140e-6)
    assert len(top) <= 10


def test_readers(rec):
    read = {n: spec.metric_reader(n) for n in (
        "isect_ms.pt", "shade_ms.pt", "kernels_frame.pt", "idle_pct.pt", "restir_ms",
        "host_ms.restir", "load_scene_s", "warmup_s", "setup_s", "pt_frame_ms",
        "display_ms", "display_p95_ms")}
    assert read["isect_ms.pt"](rec) == pytest.approx((10 + 100 + 40) / 1e3 / 2)
    assert read["shade_ms.pt"](rec) == pytest.approx((40 + 10 + 60 + 100) / 1e3 / 2)
    assert read["restir_ms"](rec) == read["shade_ms.pt"](rec)
    assert read["kernels_frame.pt"](rec) == 3.5
    # 360 us busy over 2 traced frames, against the window's 1 s over 40
    assert read["idle_pct.pt"](rec) == pytest.approx(100 * (1 - 0.18 / 25.0))
    assert read["host_ms.restir"](rec) == pytest.approx(5.0)
    assert read["load_scene_s"](rec) == 0.1 and read["warmup_s"](rec) == 1.5
    assert read["setup_s"](rec) == 9.0
    assert read["pt_frame_ms"](rec) == pytest.approx(25.0)
    assert read["display_ms"](rec) == pytest.approx(100.0)
    assert read["display_p95_ms"](rec) == 25.0


def test_readers_find_nothing_without_a_trace():
    rec = {"trace": None, "window": {"window_s": 1.0, "calls": 1, "frames": 4,
                                     "host_s": 0.0, "stamps_ms": [0.0, 1.0]}}
    for n in ("isect_ms.restir", "restir_ms", "kernels_frame.restir", "idle_pct.restir"):
        assert spec.metric_reader(n)(rec) is None
    empty = {"trace": trace.record([], [], 4)}
    assert spec.metric_reader("idle_pct.pt")(empty) is None
    assert readers.ops_per_frame(empty) is None
