"""On the card: one short run of each mix comes out correct.  Skips without
a card (the port's kernels have no CPU mode); run on the card as

    python -m pytest benchmark/tests/test_bench_card.py -q
"""

import os
import subprocess
import sys

import pytest

import tiny  # noqa: F401  (puts the benchmark on the path)
from harness.main import run_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cornell.pt", "cornell.restir"])
def test_a_short_run_on_the_card_is_correct(card, cell):
    import time

    out = run_cell(cell, 2147483659, 3.0, True, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "cornell.pt", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
