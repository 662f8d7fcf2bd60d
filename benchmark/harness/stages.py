"""What the stage readers (``metrics/stage_*``, ``unstaged_ms.*``,
``marks_ms.*``) and the port's own spans and counters give the readers.

Device stages: the port launches an empty kernel named in
``metrics/stage_marks.txt`` where a stage of the frame starts, in stream
order among the stage's kernels (inside a CUDA graph too).  A traced
stretch's device operations, taken in the order they started, belong to
the stage of the last mark before them; ``stage_mark_end`` closes a block,
and the operations after it until the next mark (the eager work between
replays) are "unstaged".  The marks' own time is in no stage.

Host spans and counters: the port keeps them in memory for the whole
process (``radish_pt_tpu_torch.utils.timing.snapshot()``); this reads
them after the run, from its unprofiled table (set-up, the first call and
the window).  A port without them, or a run without a device trace, gives
None."""

from __future__ import annotations

import os
import re
import sys

from .readers import METRICS_DIR

PORT_TIMING = "radish_pt_tpu_torch.utils.timing"
_KERNEL = re.compile(r"^(?:void )?([A-Za-z_]\w*)(?:\(.*\))?$")


def mark_names() -> tuple:
    """The stage marks' kernel names (``metrics/stage_marks.txt``)."""
    with open(os.path.join(METRICS_DIR, "stage_marks.txt"), encoding="utf-8") as f:
        return tuple(ln.strip() for ln in f if ln.strip() and not ln.startswith("#"))


def stage_of(name: str, marks) -> str | None:
    """The stage a device operation named ``name`` marks, or None."""
    m = _KERNEL.match(name.strip())
    if not m or m.group(1) not in marks:
        return None
    return m.group(1)[len("stage_mark_"):]


def split(rec: dict):
    """{stage: device us, ..., "unstaged": us} of the traced stretch, with
    "marks" the marks' own us and "seen" the stages marked; None without a
    trace or without a mark in it."""
    tr = rec.get("trace")
    if not tr or not tr["ops"]:
        return None
    marks = set(mark_names())
    out = {"unstaged": 0.0, "marks": 0.0, "seen": set()}
    stage = None
    for name, s, e in sorted(tr["ops"], key=lambda op: (op[1], op[2])):
        mark = stage_of(name, marks)
        if mark is not None:
            out["marks"] += e - s
            out["seen"].add(mark)
            stage = None if mark == "end" else mark
            continue
        key = stage or "unstaged"
        out[key] = out.get(key, 0.0) + (e - s)
    return out if out["seen"] else None


def stage_ms_per_frame(rec: dict, stage: str):
    """Device ms a traced frame in ``stage`` ("unstaged", "marks", or a
    stage of ``metrics/stage_marks.txt``); None where the stretch has no
    marks or never marked the stage."""
    got = split(rec)
    if got is None or (stage not in ("unstaged", "marks") and stage not in got["seen"]):
        return None
    return got.get(stage, 0.0) / 1e3 / rec["trace"]["frames"]


def port_snapshot():
    """The port's spans and counters (``timing.snapshot()``), or None where
    the port has none."""
    snap = getattr(sys.modules.get(PORT_TIMING), "snapshot", None)
    return snap() if callable(snap) else None


def span_total_s(name: str):
    """Seconds in the port's unprofiled span ``name``, all its calls."""
    snap = port_snapshot()
    entry = snap and snap["unprofiled"].get(name)
    return entry["total_s"] if entry else None


def span_ms_per_call(name: str):
    snap = port_snapshot()
    entry = snap and snap["unprofiled"].get(name)
    return 1e3 * entry["total_s"] / entry["count"] if entry else None


def count_per_call(counter: str, call: str):
    """The port's ``counter`` counted inside its unprofiled span ``call``
    (a renderer entry, ``call.<entry>``: set-up's first call and the
    window's), a call."""
    snap = port_snapshot()
    entry = snap and snap["unprofiled"].get(call)
    return entry["counts"].get(counter, 0) / entry["count"] if entry else None
