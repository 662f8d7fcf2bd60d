"""The port's benchmark: one run of one cell on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks`` (each number compared beside its limit, also the last lines of
standard error).  Exits non-zero, printing no result, without a card.
"""

import time

T0 = time.perf_counter()  # setup_s counts from here

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache of the program and of its libraries inside the checkout, at
# fixed paths, so that only a checkout's first run builds
# (the port's own kernels and Sobol table live in radish_pt_tpu_torch/_build/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
sys.path[:0] = [HERE, ROOT]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
