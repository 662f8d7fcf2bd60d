"""The comparison has teeth: a whole run on the CPU (the look for a card
skipped) with the timed path broken underneath comes out not correct, once
for each fault a cell can have, and so does the control, the reference
computed in bfloat16 in the port's place.  (There is no exchange between
chips to leave out: every cell takes one.)"""

import pytest

import tiny  # first: puts the benchmark on the path
from harness import check, spec
from harness.session import Session

pt = pytest.importorskip("radish_pt_tpu_torch.render.pathtrace")
rs = pytest.importorskip("radish_pt_tpu_torch.render.restir")
renderer = pytest.importorskip("radish_pt_tpu_torch.render.renderer")


def _state_unchanged(monkeypatch, tracer):
    """A step that returns its state unchanged: the accumulation (pt), the
    reservoir (ReSTIR)."""
    if tracer == "pt":
        monkeypatch.setattr(pt, "accumulate", lambda prev, new, it: prev)
    else:
        orig = rs.restir_direct

        def stale(ds, cam, looper, gbuf, last_frame, last_reservoir, *a, **k):
            d, _ = orig(ds, cam, looper, gbuf, last_frame, last_reservoir, *a, **k)
            return d, last_reservoir

        monkeypatch.setattr(rs, "restir_direct", stale)


def _half_left_out(monkeypatch, tracer):
    """Half of the batch left out, the mean taken over the rest: half of a
    block's frames (pt), half of the RIS candidates (ReSTIR)."""
    if tracer == "pt":
        orig = renderer._pt_batch

        def half(*a, block, **k):
            return orig(*a, block=max(1, block // 2), **k)

        monkeypatch.setattr(renderer, "_pt_batch", half)
    else:
        orig = rs.restir_candidates

        def half(ds, cam, looper, idx, reservoir_size=32):
            return orig(ds, cam, looper, idx, reservoir_size // 2)

        monkeypatch.setattr(rs, "restir_candidates", half)


def _answer_altered(monkeypatch, tracer):
    """Each frame's samples altered where they are produced: 5% more light."""
    orig = pt.scrub_and_compress
    monkeypatch.setattr(pt, "scrub_and_compress", lambda img: orig(img * 1.05))


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["cornell.pt", "cornell.restir"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch, tiny.reference_of(cell))
    out = tiny.run(cell, seconds=0.4)
    assert out["checks"], "the window ended before the calls the check compares"
    assert not out["correct"] and out["failed"] >= 1, out["checks"]


@pytest.mark.parametrize("cell", ["cornell.pt", "cornell.restir"])
@pytest.mark.parametrize("seed", [2147483659, 3000000019, 4000000007])
def test_the_control_is_not_correct(cell, seed):
    c = spec.load_cell(cell)
    kind = c.traffic["check"]["reference"]
    c.traffic = {**c.traffic, **tiny.traffic(kind)}
    sess = Session(c, seed, device="cpu", overrides=tiny.TINY)
    sess.setup()
    sess.window(0.3)
    inputs = sess.check_inputs()
    sess.close()
    port = check.judge(check.readings(inputs, "cpu"), kind)
    control = check.judge(check.readings(inputs, "cpu", control=True), kind)
    assert check.failures(port) == 0, port
    assert check.failures(control) > 0, control


def test_a_nan_reading_fails_its_limit():
    assert check.failures([("mean_err", float("nan"), 1e-3), ("bias", 0.0, 1e-2)]) == 1
    assert check.failures(check.judge({"p90_err": 0.0, "mean_err": 0.0, "bias": 0.0}, "pt")) == 0
