"""Arithmetic the metric readers (``metrics/<name>.py``) share.  A reader
takes the run's record and returns a number, or None where the run gave it
nothing to read; the harness then leaves the metric out.

The record: ``setup_s``, ``load_scene_s``, ``warmup_s`` (host clock);
``window`` (:meth:`harness.session.Session.window`); ``trace`` (None
without ``--trace 1``; else :func:`harness.trace.record`)."""

from __future__ import annotations

import os

from . import window as win

METRICS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "metrics")


def isect_kernels() -> tuple:
    """The fragments that name the port's hand-written intersection
    kernels (``metrics/isect_kernels.txt``, one a line)."""
    with open(os.path.join(METRICS_DIR, "isect_kernels.txt"), encoding="utf-8") as f:
        return tuple(ln.strip() for ln in f if ln.strip() and not ln.startswith("#"))


def is_isect(name: str, frags) -> bool:
    return any(f in name for f in frags)


def device_ms_per_frame(rec: dict, isect: bool):
    """Device ms a traced frame in the intersection kernels (``isect``) or
    in every other device operation."""
    tr = rec.get("trace")
    if not tr or not tr["ops"]:
        return None
    frags = isect_kernels()
    us = sum(e - s for n, s, e in tr["ops"] if is_isect(n, frags) == isect)
    return us / 1e3 / tr["frames"]


def ops_per_frame(rec: dict):
    tr = rec.get("trace")
    if not tr or not tr["ops"]:
        return None
    return len(tr["ops"]) / tr["frames"]


def idle_pct(rec: dict):
    """The device's idle share of the unprofiled window, in percent: one
    less the device's busy ms a frame, read from the traced stretch (the
    union of its device operations), over the window's wall ms a frame.
    The profiler's own host cost slows the traced stretch's frames but not
    its device operations, so the share prices the program's host work
    and syncs, not the profiler's."""
    tr, w = rec.get("trace"), rec.get("window")
    if not tr or tr["busy_s"] <= 0 or not tr["frames"] or not w or not w["frames"]:
        return None
    busy_ms = 1e3 * tr["busy_s"] / tr["frames"]
    return 100.0 * (1.0 - busy_ms / win.per_frame_ms(w["window_s"], w["frames"]))


def host_ms_per_frame(rec: dict):
    w = rec.get("window")
    if not w or not w["frames"]:
        return None
    return 1e3 * w["host_s"] / w["frames"]


def frame_ms(rec: dict, per_call: bool = False):
    """Wall time of the whole window over its frames (``per_call``: over its
    calls, each of which displays one image)."""
    w = rec["window"]
    return win.per_frame_ms(w["window_s"], w["calls"] if per_call else w["frames"])


def interval_p95_ms(rec: dict):
    return win.percentile(win.intervals_ms(rec["window"]["stamps_ms"]), 95.0)
