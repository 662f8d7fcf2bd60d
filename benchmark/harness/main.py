"""One run of one cell: set-up, the measured window, with ``--trace 1`` a
traced stretch, the comparison with the reference, and the result line."""

from __future__ import annotations

import argparse
import json
import sys
import time

# top-level module names no run may hold once its window has closed: JAX,
# and the JAX package the port was made from (compared whole: the port's
# name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "radish_pt_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> dict:
    """Everything of a run but the look for a card and the printing:
    returns the result object.  ``overrides`` / ``traffic_overrides`` (the
    CPU tests only) replace configuration or traffic keys."""
    import torch

    from . import check, spec
    from .session import Session

    cell = spec.load_cell(name)
    if traffic_overrides:
        cell.traffic = {**cell.traffic, **traffic_overrides}
    sess = Session(cell, seed, device=device, overrides=overrides)
    sess.setup()
    rec = {"setup_s": time.perf_counter() - t0, **sess.timings}
    rec["window"] = sess.window(seconds)
    rec["trace"] = sess.traced(int(cell.traffic["trace_frames"])) if trace else None
    peak = sess.memory_peak()
    inputs = sess.check_inputs()
    sess.close()

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = spec.metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    problems = check.problems(inputs)
    t = time.perf_counter()
    judged = [] if problems else check.judge(check.readings(inputs, device), inputs["reference"])
    out_notes = [f"set-up {rec['setup_s']:.3f} s (load_scene {rec['load_scene_s']:.3f}, "
                 f"first call {rec['warmup_s']:.3f}), window {rec['window']['window_s']:.3f} s "
                 f"for {rec['window']['calls']} calls, reference {time.perf_counter() - t:.3f} s, "
                 f"engine {sess.engine}, batch mode {sess.batch_mode}"]
    failed = check.failures(judged) + len(problems)
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": failed == 0, "attempted": rec["window"]["calls"], "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in judged}
    out["problems"] = problems
    out["notes"] = out_notes
    return out


def main(argv, t0: float) -> int:
    args = parse(argv)
    import torch

    from . import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0)
    problems = out.pop("problems")
    for n in out.pop("notes"):
        print(n, file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"refused: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for p in problems:
        print(f"check: {p}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0  # a run whose outputs are wrong still reports: "correct" says so
