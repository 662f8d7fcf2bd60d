"""The ``svgf`` reference stage and the denoiser's readers: the port reads
under the stage's limits at a tiny size on the CPU, the control and each
planted fault read over one, and the readers of the denoiser's marks read
a recorded trace and nothing where the marks are missing."""

import sys
import types

import pytest

import tiny  # first: puts the benchmark on the path
from harness import check, spec, stages, trace
from harness.session import Session

CELL = "cornell.restir.svgf"
dn = pytest.importorskip("radish_pt_tpu_torch.render.denoise")
pt = pytest.importorskip("radish_pt_tpu_torch.render.pathtrace")
renderer = pytest.importorskip("radish_pt_tpu_torch.render.renderer")


def _history_unchanged(monkeypatch):
    """The filter hands on the history it was given."""
    orig = dn.svgf_filter

    def stale(color_in, state, *a, **k):
        return orig(color_in, state, *a, **k)[0], state

    monkeypatch.setattr(dn, "svgf_filter", stale)


def _own_frame_as_last(monkeypatch):
    """The denoiser after a block reads the block's own G-buffer frame and
    a first-frame flag already cleared (the hand-off of the JAX package's
    ``step_batched_restir``)."""
    orig = renderer.Renderer._apply_denoiser

    def late(self, image, history, indirect=None, **kw):
        return orig(self, image, (self.gbuf_last, self.first_frame), indirect, **kw)

    monkeypatch.setattr(renderer.Renderer, "_apply_denoiser", late)


def _frame_overwritten(monkeypatch):
    """The frame before overwritten by the block's own, the first-frame flag
    kept: what a replayed block does to a ``gbuf_last`` the denoiser is
    handed uncopied (the block's graph writes its frame into the tensors
    that held the frame before)."""
    orig = renderer.Renderer._apply_denoiser

    def aliased(self, image, history, indirect=None, **kw):
        return orig(self, image, (self.gbuf_last, history[1]), indirect, **kw)

    monkeypatch.setattr(renderer.Renderer, "_apply_denoiser", aliased)


def _level_left_out(monkeypatch):
    """The first guided level (tap spacing 1) left out: its images pass
    through, and the history handed on is the unfiltered blend.  (The last
    level, spacing 16, barely weighs at 32x32: its taps lie 16 pixels
    apart, far in depth, and after four levels the luminance weights are
    near their floor.)"""
    orig = dn._guided_level

    def skipped(colors, variances, var_filtered, normal, prim_id, pos, step, *a, **k):
        if step == 1:
            return colors, variances
        return orig(colors, variances, var_filtered, normal, prim_id, pos, step, *a, **k)

    monkeypatch.setattr(dn, "_guided_level", skipped)


def _more_light(monkeypatch):
    """Each frame's samples altered where they are produced: 5% more light."""
    orig = pt.scrub_and_compress
    monkeypatch.setattr(pt, "scrub_and_compress", lambda img: orig(img * 1.05))


FAULTS = {"history_unchanged": _history_unchanged, "own_frame_as_last": _own_frame_as_last,
          "frame_overwritten": _frame_overwritten, "level_left_out": _level_left_out,
          "more_light": _more_light}


def _inputs(seed: int) -> dict:
    c = spec.load_cell(CELL)
    c.traffic = {**c.traffic, **tiny.traffic("svgf")}
    sess = Session(c, seed, device="cpu", overrides=tiny.TINY)
    sess.setup()
    sess.window(0.3)
    inputs = sess.check_inputs()
    sess.close()
    return inputs


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_denoiser_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = tiny.run(CELL, seconds=0.4)
    assert out["checks"], "the window ended before the calls the check compares"
    assert not out["correct"] and out["failed"] >= 1, out["checks"]


def test_the_configuration_states_the_filter_the_cell_runs():
    """The cell's configuration file names the filter of the deployment
    (denoiser.cu's SpatioTemporalFilter as it creates it); the port's
    ``Settings`` for the cell, from the scene file and the mix, are that
    filter, field for field."""
    from harness import session
    from radish_pt_tpu_torch.scene.build import load_scene

    c = spec.load_cell(CELL)
    _, _, desc = load_scene(spec.path_in_checkout(c.config["scene"]), device="cpu")
    settings = session._settings(desc, c.config, c.traffic)
    for field, value in c.config["filter"].items():
        assert getattr(settings, field) == session.resolve_setting(value), field


@pytest.mark.parametrize("seed", [2147483659, 3000000019, 4000000007])
def test_the_port_is_correct_and_the_control_is_not(seed):
    inputs = _inputs(seed)
    port = check.judge(check.readings(inputs, "cpu"), "svgf")
    control = check.judge(check.readings(inputs, "cpu", control=True), "svgf")
    assert check.failures(port) == 0, port
    assert check.failures(control) > 0, control


def test_the_stage_snapshots_the_history_around_the_followed_call():
    inputs = _inputs(2147483659)
    followed = [s for s in inputs["snapshots"] if s.before is not None]
    assert len(followed) == 1 and set(followed[0].before) == {"reservoir", "history"}
    for s in inputs["snapshots"]:
        assert {"direct", "display", "reservoir", "image", "history"} <= set(s.after)
        assert s.after["history"]["moment"].shape == s.after["image"].shape == (32 * 32, 3)


# a traced frame (us): the ReSTIR block's marks and kernels, then the
# denoiser's: the temporal blend and variance 5, the guided levels 20 over
# four operations; then the display 2
FRAME = [("stage_mark_gbuffer", 0, 1), ("gbuffer_op", 1, 11), ("stage_mark_end", 11, 12),
         ("stage_mark_denoise", 20, 21), ("blend", 21, 24), ("variance", 24, 26),
         ("stage_mark_svgf_levels", 26, 27), ("level_a", 27, 32), ("level_b", 32, 37),
         ("level_c", 37, 42), ("level_d", 42, 47), ("stage_mark_denoise_end", 47, 48),
         ("display", 48, 50)]
SPANS = {"unprofiled": {"frame.denoise": {
    "count": 4, "total_s": 0.2, "self_s": 0.2, "max_s": 0.06,
    "counts": {"denoise.svgf": 4, "denoise.svgf_level": 20, "denoise.svgf_pixels": 4 * 640000}}},
         "profiled": {}, "counters": {}, "calls": 4}


def _rec(frames: int, ops) -> dict:
    dev = [(n, float(s + 100 * f), float(e + 100 * f)) for f in range(frames) for n, s, e in ops]
    host = [(trace.FRAME_RANGE, 100.0 * f, 100.0 * f + 60) for f in range(frames)]
    return {"trace": trace.record(dev, host, frames),
            "window": {"window_s": 1.0, "calls": 10, "frames": 10, "host_s": 0.2,
                       "stamps_ms": [0.0, 25.0]}}


DENOISER = ("denoise_ms.svgf", "svgf_levels_ms.svgf", "kernels_denoise.svgf",
            "denoise_host_ms.svgf", "denoise_roofline_pct.svgf")


def test_the_denoiser_readers_read_between_the_marks(monkeypatch):
    port = types.ModuleType(stages.PORT_TIMING)
    port.snapshot = lambda: SPANS
    monkeypatch.setitem(sys.modules, stages.PORT_TIMING, port)
    rec = _rec(2, FRAME)
    read = {n: spec.metric_reader(n)(rec) for n in DENOISER}
    assert read["denoise_ms.svgf"] == pytest.approx(25 / 1e3)
    assert read["svgf_levels_ms.svgf"] == pytest.approx(20 / 1e3)
    assert read["kernels_denoise.svgf"] == 6
    assert read["denoise_host_ms.svgf"] == pytest.approx(50.0)
    bound = spec._load("metrics", "denoise_roofline_pct.svgf").bound_ms
    assert bound(800 * 800, 5) == pytest.approx(1e3 * 800 * 800 * 432 / 3.35e12)
    assert read["denoise_roofline_pct.svgf"] == pytest.approx(100 * bound(640000, 5) / 0.025)
    # the size is the run's own: two images of 400 pixels at 3 levels
    # each, in two passes of 25 us, read a quarter as much
    counts = {"denoise.svgf": 4, "denoise.svgf_level": 12, "denoise.svgf_pixels": 4 * 400}
    small = {"unprofiled": {"frame.denoise": {**SPANS["unprofiled"]["frame.denoise"],
                                              "count": 2, "counts": counts}}}
    port.snapshot = lambda: small
    assert spec.metric_reader("denoise_roofline_pct.svgf")(rec) == pytest.approx(
        100 * bound(800, 3) / 0.025)
    # the stage readers charge the denoiser and its marks to "unstaged"
    assert stages.stage_ms_per_frame(rec, "unstaged") == pytest.approx(30 / 1e3)


def test_the_denoiser_readers_read_nothing_without_the_marks(monkeypatch):
    """A cell without a denoiser, the parent's trace (no denoiser marks),
    a pair never closed, and a run without ``--trace 1``."""
    port = types.ModuleType(stages.PORT_TIMING)
    port.snapshot = lambda: SPANS
    monkeypatch.setitem(sys.modules, stages.PORT_TIMING, port)
    no_marks = [op for op in FRAME if not op[0].startswith(("stage_mark_denoise",
                                                            "stage_mark_svgf"))]
    unclosed = [op for op in FRAME if op[0] != "stage_mark_denoise_end"]
    for rec in (_rec(2, FRAME[:3]), _rec(2, no_marks), _rec(1, unclosed), {"trace": None}):
        for n in DENOISER:
            assert spec.metric_reader(n)(rec) is None, n
    # another denoiser between the marks: SVGF counted no pixel
    port.snapshot = lambda: {"unprofiled": {"frame.denoise": {
        **SPANS["unprofiled"]["frame.denoise"], "counts": {}}}}
    assert spec.metric_reader("denoise_ms.svgf")(_rec(2, FRAME)) is not None
    assert spec.metric_reader("denoise_roofline_pct.svgf")(_rec(2, FRAME)) is None
