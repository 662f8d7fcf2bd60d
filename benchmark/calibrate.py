"""The readings the comparison's limits are set from (PERF.md, section 2):
for each seed, one short window of a cell at its own size and load, then
the numbers compared, of the port's outputs against the reference and,
for the control seeds, of the reference computed in bfloat16 in the
port's place.  All seeds run in one process, one line of JSON each.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--seconds 4] [--out FILE]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import check, spec  # noqa: E402
from harness.session import Session  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    out = open(args.out, "a", encoding="utf-8") if args.out else None
    for seed in args.seeds:
        t = time.perf_counter()
        sess = Session(cell, seed)
        sess.setup()
        w = sess.window(args.seconds)
        inputs = sess.check_inputs()
        sess.close()
        kinds = [("port", False)] + ([("control", True)] if seed in args.control_seeds else [])
        for kind, control in kinds:
            nums = check.readings(inputs, "cuda", control=control)
            line = json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                               "calls": w["calls"], "readings": nums,
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
