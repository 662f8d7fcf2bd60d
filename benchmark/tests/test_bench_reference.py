"""The reference agrees with the port's plain CPU path at a tiny size, on
both traffic mixes and on the cornell and teapot scenes (teapot put in the
cornell configuration's place): a whole run on the CPU (the look for a card
skipped) comes out correct, each number well under its limit."""

import pytest

import tiny  # first: puts the benchmark on the path
from harness import spec


@pytest.mark.parametrize("scene", ["cornell", "teapot"])
@pytest.mark.parametrize("cell", ["cornell.pt", "cornell.restir"])
def test_reference_agrees_with_the_port_on_the_cpu(cell, scene):
    kw = {"resolution": [16, 16], "scene": "scenes/teapot.txt"} if scene == "teapot" else {}
    # long enough for the calls the ReSTIR check compares (0 and 1)
    out = tiny.run(cell, seconds=1.0 if kw else 0.4, **kw)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    for name, c in out["checks"].items():
        assert c["value"] <= 0.1 * c["limit"], (name, c)
    assert list(out["checks"]) == list(spec.stage(tiny.reference_of(cell)).LIMITS)
