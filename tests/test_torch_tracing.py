"""The port's tracing (radish_pt_tpu_torch/utils/timing.py) on the CPU:
spans with their nesting and self time, counters charged to the spans
open around them, the profiled and unprofiled tables, the profiler ranges,
the stage marks' counts, the per-pass timer as a view over the spans; then
a tiny renderer's calls: the spans a call opens, each stage mark's count a
frame and the host syncs a call of ``run_block`` and
``step_batched_restir``, on one device and on a mesh, and the set-up spans
of ``load_scene``.  The marks' kernels and the sync count against
``torch.cuda.set_sync_debug_mode`` are card tests
(tests/test_torch_cuda.py)."""

import os

import pytest

torch = pytest.importorskip("torch")

from radish_pt_tpu_torch.utils import timing  # noqa: E402

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
PT_STAGES = ("primary", "nee", "bsdf", "extend", "hit", "accumulate")
RESTIR_STAGES = ("gbuffer", "primary", "ris", "shadow", "temporal", "spatial", "shade",
                 "accumulate")


class _Clock:
    """A host clock that moves only when told to."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(timing, "time", c)
    timing.reset()
    yield c
    timing.reset()


@pytest.fixture
def fresh():
    timing.reset()
    yield
    timing.reset()


def test_span_nesting_self_time_and_max(clock):
    with timing.span("outer"):
        clock.t += 1.0
        for d in (2.0, 3.0):
            with timing.span("inner"):
                clock.t += d
        clock.t += 0.5
    with timing.span("outer"):
        clock.t += 0.25
    t = timing.snapshot()["unprofiled"]
    assert t["outer"]["count"] == 2 and t["inner"]["count"] == 2
    assert t["outer"]["total_s"] == pytest.approx(6.75)
    assert t["outer"]["self_s"] == pytest.approx(1.75)  # 6.75 less the inner 5
    assert t["outer"]["max_s"] == pytest.approx(6.5)
    assert t["inner"]["total_s"] == t["inner"]["self_s"] == pytest.approx(5.0)
    assert t["inner"]["max_s"] == pytest.approx(3.0)
    assert timing.snapshot()["profiled"] == {}


def test_counters_are_charged_to_the_open_spans(clock):
    timing.count("a")
    with timing.span("outer"):
        timing.count("a", 2)
        with timing.span("inner"):
            timing.host_sync()
            timing.count("a")
        timing.host_sync(3)
    snap = timing.snapshot()
    assert snap["counters"] == {"a": 4, "host_syncs": 4}
    assert snap["unprofiled"]["outer"]["counts"] == {"a": 3, "host_syncs": 4}
    assert snap["unprofiled"]["inner"]["counts"] == {"a": 1, "host_syncs": 1}
    assert timing.counters() == snap["counters"]
    snap["counters"]["a"] = 99  # a copy
    assert timing.counters()["a"] == 4
    timing.reset()
    assert timing.snapshot() == {"unprofiled": {}, "profiled": {}, "counters": {}, "calls": 0}


def test_a_span_raising_still_closes(clock):
    with pytest.raises(ValueError):
        with timing.span("outer"):
            with timing.span("inner"):
                clock.t += 1.0
                raise ValueError
    with timing.span("after"):
        clock.t += 1.0
    t = timing.snapshot()["unprofiled"]
    assert t["outer"]["count"] == t["inner"]["count"] == 1
    assert t["after"]["self_s"] == pytest.approx(1.0)  # no stale span around it


def test_profiled_table_and_record_function_ranges(fresh):
    from torch.profiler import ProfilerActivity, profile

    with timing.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.call("call.test"):
            with timing.span("inside"):
                torch.ones(4).sum()
    snap = timing.snapshot()
    assert set(snap["unprofiled"]) == {"outside"}
    assert set(snap["profiled"]) == {"call.test", "inside"}
    assert snap["calls"] == 1
    events = {e.name: e for e in prof.events()}
    assert {"call.test", "inside"} <= set(events)
    outer, inner = events["call.test"], events["inside"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def test_marks_count_on_the_cpu(fresh):
    cpu = torch.device("cpu")
    for stage in ("primary", "nee", "nee", "end"):
        timing.mark(stage, cpu)
    assert timing.counters() == {"marks.primary": 1, "marks.nee": 2, "marks.end": 1}
    with pytest.raises(KeyError):
        timing.mark("no_such_stage", cpu)
    assert len(set(timing.STAGES)) == len(timing.STAGES) == 13


def test_stage_marks_match_the_kernel_source():
    """``STAGES`` then ``INNER_MARKS`` is the order of the kernels in
    csrc/stage_mark.cu, whose entry point takes the index."""
    import re

    import radish_pt_tpu_torch

    src = os.path.join(os.path.dirname(radish_pt_tpu_torch.__file__), "csrc", "stage_mark.cu")
    with open(src, encoding="utf-8") as f:
        body = f.read()
    listed = re.findall(r"^\s+X\((\w+)\)", body, re.M)
    assert tuple(listed) == timing.STAGES + timing.INNER_MARKS


def test_pass_timer_is_a_view_over_spans(clock):
    on = timing.PassTimer(enabled=True, device="cpu")
    off = timing.PassTimer(enabled=False, device="cpu")
    for t in (on, off):
        with t.time("shade"):
            clock.t += 0.002
        with t.time("block of 4"):
            clock.t += 0.001
    assert on.mean_ms("shade") == pytest.approx(2.0)
    assert "shade" in on.table() and "block of 4" in on.table()
    assert off.table() == "" and off.times == {}
    t = timing.snapshot()["unprofiled"]
    assert t["pass.shade"]["count"] == 2 and t["pass.block of 4"]["count"] == 2


@pytest.fixture(scope="module")
def cornell():
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cpu")
    return ds, cam.replace(width=16, height=16)


def _renderer(cornell, mesh=None, **settings):
    from radish_pt_tpu_torch.config import Settings
    from radish_pt_tpu_torch.render.renderer import Renderer

    ds, cam = cornell
    return Renderer(ds=ds, cam=cam, desc=None, settings=Settings(**settings), device="cpu",
                    mesh=mesh)


def _marks(counts: dict) -> dict:
    return {k[len("marks."):]: n for k, n in counts.items() if k.startswith("marks.")}


@pytest.mark.parametrize("depth", [2, 3])
def test_run_block_spans_marks_and_syncs(cornell, depth, fresh):
    """``run_block(4)`` of the path tracer: one ``call.run_block`` span a
    call; a frame marks ``primary`` and ``accumulate`` once and ``nee``,
    ``bsdf``, ``extend``, ``hit`` once a bounce; the block ends with one
    ``end``; no host sync."""
    from radish_pt_tpu_torch.config import Tracer

    r = _renderer(cornell, tracer=Tracer.STREAMED, trace_depth=depth)
    r.run_block(4)
    timing.reset()
    r.run_block(4)
    snap = timing.snapshot()
    call = snap["unprofiled"]["call.run_block"]
    assert call["count"] == 1 and snap["calls"] == 1
    want = {"primary": 4, "accumulate": 4, "end": 1,
            **{s: 4 * depth for s in ("nee", "bsdf", "extend", "hit")}}
    assert _marks(call["counts"]) == want
    assert call["counts"].get("host_syncs", 0) == 0
    assert snap["counters"].get("host_syncs", 0) == 0
    assert set(snap["unprofiled"]) == {"call.run_block", "pass.block of 4"}


def test_step_batched_restir_spans_marks_and_syncs(cornell, fresh):
    """``step_batched_restir(1)`` with the camera orbiting: the camera span
    with its upload (the one host sync of a call), the block, the display;
    each ReSTIR stage marked once a frame, the G-buffer once a block."""
    from radish_pt_tpu_torch.config import ReservoirReuse, Tracer

    r = _renderer(cornell, tracer=Tracer.RESTIR_DI, reservoir_size=4, animate_camera=True,
                  reservoir_reuse=ReservoirReuse.TEMPORAL_SPATIAL)
    r.step_batched_restir(1)
    timing.reset()
    for _ in range(2):
        r.step_batched_restir(1)
    snap = timing.snapshot()
    t = snap["unprofiled"]
    assert set(t) == {"call.step_batched_restir", "frame.camera", "frame.camera_upload",
                      "pass.block of 1", "frame.display"}
    assert all(e["count"] == 2 for e in t.values())
    call = t["call.step_batched_restir"]
    assert call["counts"]["host_syncs"] == 2  # one a call
    assert t["frame.camera_upload"]["counts"] == {"host_syncs": 2}
    assert _marks(call["counts"]) == {s: 2 for s in (*RESTIR_STAGES, "end")}
    assert call["self_s"] < call["total_s"]


def test_denoiser_span_where_a_denoiser_runs(cornell, fresh):
    from radish_pt_tpu_torch.config import Denoiser, Tracer

    r = _renderer(cornell, tracer=Tracer.RESTIR_DI, reservoir_size=4,
                  denoiser=Denoiser.GAUSSIAN)
    r.step_batched_restir(1)
    r.step()
    t = timing.snapshot()["unprofiled"]
    assert t["frame.denoise"]["count"] == 2 and t["call.step"]["count"] == 1
    assert {"pass.gbuffer", "pass.restir", "pass.denoise", "pass.display"} <= set(t)
    # the eager frame marks its stages and ends them before the denoiser,
    # which marks where it starts and stops (the Gaussian has no SVGF levels)
    assert _marks(t["call.step"]["counts"]) == {
        s: 1 for s in (*RESTIR_STAGES, "end", "denoise", "denoise_end")}


def test_mesh_restir_block_marks_every_tile(cornell, fresh):
    """Batched ReSTIR on 2 tiles of one device: every tile's stages are
    marked, and each of its three block functions (G-buffer, front,
    back) ends with ``end``."""
    from radish_pt_tpu_torch.config import Tracer
    from radish_pt_tpu_torch.parallel import sharding as sh

    mesh = sh.make_mesh(2, devices=[torch.device("cpu")] * 2)
    r = _renderer(cornell, mesh=mesh, tracer=Tracer.RESTIR_DI, reservoir_size=4)
    r.step_batched_restir(1)
    timing.reset()
    r.step_batched_restir(1)
    marks = _marks(timing.counters())
    assert marks == {**{s: 2 for s in RESTIR_STAGES}, "end": 6}


@pytest.mark.parametrize("scene, sorted_per_frame", [("teapot.txt", 2 * 2 + 1),
                                                     ("cornell_box.txt", 0)])
def test_sorted_sweeps_count_and_mark_their_reordering(scene, sorted_per_frame, fresh):
    """``run_block(2)`` at depth 2: on a scene with clusters a frame sorts
    2d + 1 wavefronts (the primaries, each bounce's extension rays and
    shadow segments), each counting ``isect.sorted_wavefronts`` once and
    marking ``reorder`` and ``reorder_end`` twice (around the key, the sort
    and the gathers; around the scatter back); cornell, without clusters,
    none of either."""
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, _ = load_scene(os.path.join(SCENES, scene), device="cpu")
    r = Renderer(ds=ds, cam=cam.replace(width=16, height=16), desc=None, device="cpu",
                 settings=Settings(tracer=Tracer.STREAMED, trace_depth=2))
    timing.reset()
    r.run_block(2)
    counts = timing.snapshot()["unprofiled"]["call.run_block"]["counts"]
    n = 2 * sorted_per_frame
    assert counts.get("isect.sorted_wavefronts", 0) == n
    assert counts.get("marks.reorder", 0) == counts.get("marks.reorder_end", 0) == 2 * n
    assert _marks(counts)["extend"] == 2 * 2


def test_load_scene_spans(fresh):
    from radish_pt_tpu_torch.scene.build import load_scene

    load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cpu")
    snap = timing.snapshot()
    t = snap["unprofiled"]
    assert {"setup.load_scene", "setup.parse", "setup.bvh", "setup.sobol",
            "setup.upload"} <= set(t)
    load = t["setup.load_scene"]
    parts = sum(t[n]["total_s"] for n in ("setup.parse", "setup.bvh", "setup.sobol",
                                          "setup.upload"))
    assert load["total_s"] >= parts - 1e-9
    assert load["self_s"] == pytest.approx(load["total_s"] - parts, abs=1e-6)
    # every tensor of the scene is a copy from pageable host memory
    assert t["setup.upload"]["counts"]["host_syncs"] >= 30


def test_native_build_is_a_setup_span(fresh):
    from radish_pt_tpu_torch import native

    native.build()
    t = timing.snapshot()["unprofiled"]
    assert t["setup.native"]["count"] == 1
