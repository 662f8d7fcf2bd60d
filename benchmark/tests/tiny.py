"""What the benchmark's CPU tests share: the benchmark's directory and the
checkout's root on the path, as ``benchmark/run.py`` puts them (each test
module imports this first), and a cell run on the CPU at a tiny size with
the look for a card skipped.

    python -m pytest benchmark/tests -q

The repository's tier-1 suite does not collect these; tests marked
``cuda`` skip without a card."""

import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = {"resolution": [32, 32], "depth": 2}


def reference_of(cell: str) -> str:
    from harness import spec

    return spec.load_cell(cell).traffic["check"]["reference"]


def traffic(stage: str) -> dict:
    """The traffic keys replaced at a tiny size: the reference stage's own
    (``checks/<stage>.py``, ``TINY_TRAFFIC``)."""
    from harness import spec

    return spec.stage(stage).TINY_TRAFFIC


def run(cell: str, seed: int = 2147483659, seconds: float = 0.5, **overrides):
    from harness.main import run_cell

    return run_cell(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                    overrides={**TINY, **overrides},
                    traffic_overrides=traffic(reference_of(cell)))
