"""The device stage split (harness/stages.py) on a recorded trace with the
port's stage marks, and the host readers of the port's spans and counters."""

import json
import os
import sys
import types

import pytest

import tiny  # noqa: F401  (puts the benchmark on the path)
from harness import readers, spec, stages, trace

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
RESTIR = ("gbuffer", "primary", "ris", "shadow", "temporal", "spatial", "shade", "accumulate")
PT = ("primary", "nee", "bsdf", "extend", "hit", "accumulate")


def _rec(sample: str) -> dict:
    s = json.load(open(os.path.join(DATA, sample)))
    tr = trace.record([tuple(e) for e in s["device"]], [tuple(e) for e in s["host"]],
                      s["frames"])
    return {"trace": tr, "setup_s": 9.0, "load_scene_s": 0.1, "warmup_s": 1.5,
            "window": {"window_s": 1.0, "calls": 10, "frames": 10, "host_s": 0.2,
                       "stamps_ms": [0.0, 25.0, 50.0]}}


@pytest.fixture(scope="module")
def rec():
    return _rec("stage_trace_sample.json")


def test_stages_and_unstaged_are_the_device_time_less_the_marks(rec):
    read = {n: spec.metric_reader(n)(rec) for n in (
        *(f"stage_{s}_ms.restir" for s in RESTIR), "unstaged_ms.restir", "marks_ms.restir",
        "restir_ms", "isect_ms.restir", "kernels_frame.restir")}
    staged = sum(read[f"stage_{s}_ms.restir"] for s in RESTIR) + read["unstaged_ms.restir"]
    total = read["restir_ms"] + read["isect_ms.restir"]
    assert staged + read["marks_ms.restir"] == pytest.approx(total)
    assert staged == pytest.approx(total - 9 / 1e3)  # nine 1-us marks a frame
    # the recorded frame (us): G-buffer 10, primaries 7, RIS 30, shadow 3,
    # temporal 4, spatial 8, shade 2, accumulate 3; upload, view basis and
    # display 6 outside the graph
    want = {"gbuffer": 10, "primary": 7, "ris": 30, "shadow": 3, "temporal": 4,
            "spatial": 8, "shade": 2, "accumulate": 3}
    for s, us in want.items():
        assert read[f"stage_{s}_ms.restir"] == pytest.approx(us / 1e3), s
    assert read["unstaged_ms.restir"] == pytest.approx(6 / 1e3)
    assert read["kernels_frame.restir"] == 23  # 9 of them the marks: device operations


def test_a_stage_never_marked_reads_none(rec):
    assert stages.stage_ms_per_frame(rec, "nee") is None
    for s in PT[1:5]:
        assert spec.metric_reader(f"stage_{s}_ms.pt")(rec) is None


def test_no_marks_or_no_trace_reads_none():
    """The parent's trace (no marks) and a run without ``--trace 1``."""
    bare = _rec("trace_sample.json")
    none = {"trace": None}
    for rec in (bare, none):
        for n in (*(f"stage_{s}_ms.restir" for s in RESTIR),
                  *(f"stage_{s}_ms.pt" for s in PT),
                  "unstaged_ms.restir", "unstaged_ms.pt", "marks_ms.restir", "marks_ms.pt"):
            assert spec.metric_reader(n)(rec) is None, n


def test_mark_names_match_the_port_and_no_intersection_kernel():
    from radish_pt_tpu_torch.utils import timing

    names = stages.mark_names()
    assert names == tuple(f"stage_mark_{s}" for s in timing.STAGES)
    frags = readers.isect_kernels()
    assert not any(readers.is_isect(n, frags) for n in names)
    assert stages.stage_of("stage_mark_shade", names) == "shade"
    assert stages.stage_of("void stage_mark_end()", names) == "end"
    assert stages.stage_of("stage_mark_shadows", names) is None
    assert stages.stage_of("(anonymous namespace)::closest_hit_kernel(float4 const*)",
                           names) is None


SNAPSHOT = {
    "unprofiled": {
        "setup.kernel_libs": {"count": 9, "total_s": 0.25, "self_s": 0.25, "max_s": 0.1,
                              "counts": {}},
        "graph.build": {"count": 1, "total_s": 1.5, "self_s": 0.5, "max_s": 1.5,
                        "counts": {}},
        "frame.camera": {"count": 4, "total_s": 0.08, "self_s": 0.01, "max_s": 0.03,
                         "counts": {"host_syncs": 4}},
        "call.step_batched_restir": {"count": 4, "total_s": 0.16, "self_s": 0.01,
                                     "max_s": 0.05, "counts": {"host_syncs": 4}},
        "call.run_block": {"count": 5, "total_s": 0.01, "self_s": 0.001, "max_s": 0.005,
                           "counts": {"marks.nee": 100}},
    },
    "profiled": {"call.step_batched_restir": {"count": 9, "total_s": 1.0, "self_s": 0.1,
                                              "max_s": 0.2, "counts": {"host_syncs": 99}}},
    "counters": {"host_syncs": 130}, "calls": 13}


def test_host_readers_read_the_ports_unprofiled_spans(monkeypatch):
    port = types.ModuleType(stages.PORT_TIMING)
    port.snapshot = lambda: SNAPSHOT
    monkeypatch.setitem(sys.modules, stages.PORT_TIMING, port)
    read = {n: spec.metric_reader(n)({}) for n in (
        "camera_ms.restir", "host_syncs.restir", "host_syncs.pt", "kernel_load_s",
        "capture_s")}
    assert read["camera_ms.restir"] == pytest.approx(20.0)
    assert read["host_syncs.restir"] == 1.0 and read["host_syncs.pt"] == 0.0
    assert read["kernel_load_s"] == 0.25 and read["capture_s"] == 1.5


def test_host_readers_find_nothing_in_a_port_without_tracing(monkeypatch):
    monkeypatch.setitem(sys.modules, stages.PORT_TIMING, types.ModuleType("bare"))
    for n in ("camera_ms.restir", "host_syncs.restir", "host_syncs.pt", "kernel_load_s",
              "capture_s"):
        assert spec.metric_reader(n)({}) is None, n
    empty = types.ModuleType(stages.PORT_TIMING)
    empty.snapshot = lambda: {"unprofiled": {}, "profiled": {}, "counters": {}, "calls": 0}
    monkeypatch.setitem(sys.modules, stages.PORT_TIMING, empty)
    for n in ("camera_ms.restir", "host_syncs.pt", "kernel_load_s", "capture_s"):
        assert spec.metric_reader(n)({}) is None, n
