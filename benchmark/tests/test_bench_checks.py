"""The reference stages (``checks/pt.py``, ``checks/restir.py``) compare what
the comparison compared before it was split into stage files: on a session
driven for a fixed number of calls at a tiny size, the port's and the
control's numbers equal, to the last bit, those that the harness of commit
24af04b gave on the same seed, calls and sizes (each ``repr`` as it printed
them), and the same pixels and calls are snapshotted."""

import pytest

import tiny  # first: puts the benchmark on the path
from harness import check, spec
from harness.session import Session

SEED = 2147483659
# calls after set-up's first; the ReSTIR chain is calls 0 and 1, and the
# followed call is call 1 (follow_call [1, 1] at the tiny size)
CALLS = {"cornell.pt": 3, "cornell.restir": 2}
RECORDED = {
    "cornell.pt": {
        "port": {"p90_err": 0.0, "mean_err": 1.8503207684261724e-05,
                 "bias": 4.364580458254097e-05},
        "control": {"p90_err": 0.197207972407341, "mean_err": 0.11771347297690227,
                    "bias": 0.42614351093061614}},
    "cornell.restir": {
        "port": {"p90_err": 0.0, "mean_err": 0.0, "bias": 0.0, "reservoir_err": 0.0,
                 "display_share": 0.0},
        "control": {"p90_err": 0.2819321721792221, "mean_err": 0.08722087279693369,
                    "bias": 0.45577588444872047, "reservoir_err": 0.3995186526943797,
                    "display_share": 0.630859375}},
}


def _inputs(cell: str) -> dict:
    c = spec.load_cell(cell)
    c.traffic = {**c.traffic, **tiny.traffic(c.traffic["check"]["reference"])}
    sess = Session(c, SEED, device="cpu", overrides=tiny.TINY)
    sess.setup()
    for _ in range(CALLS[cell]):
        sess.call()
    inputs = sess.check_inputs()
    sess.close()
    return inputs


@pytest.mark.parametrize("cell", sorted(RECORDED))
def test_stage_readings_equal_the_recorded_ones(cell):
    inputs = _inputs(cell)
    want = RECORDED[cell]
    got = {kind: check.readings(inputs, "cpu", control=kind == "control") for kind in want}
    assert got == want
    stage = spec.stage(inputs["reference"])
    assert [k for k, _, _ in check.judge(got["port"], inputs["reference"])] == list(stage.LIMITS)
    assert check.problems(inputs) == []
    if cell == "cornell.pt":
        assert len(inputs["pixels"]) == 256 and len(inputs["loopers"]) == 16
        assert inputs["snapshots"] == []
    else:
        assert [(s.call, s.chain, s.before is not None) for s in inputs["snapshots"]] == [
            (0, True, False), (1, True, True)]
        assert "pixels" not in inputs
