"""The traced stretch's record, from ``torch.profiler``: the device
operations it ran, the share of it the device was busy, and the idle gaps
by what the host was doing.  The per-layer readers (``metrics/*.py``) take
their numbers from this record."""

from __future__ import annotations

FRAME_RANGE = "bench.frame"  # the harness's range around each call into the port
SYNC_RANGE = "bench.sync"  # the range around the stretch's closing sync


def _events(prof):
    """(device ops, host ranges) of a finished profile, each a list of
    (name, start_us, end_us) on the profiler's one clock."""
    import torch

    dev, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(span)
        elif not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
            dev.append(span)  # a device operation, not a range's shadow on the device
    return dev, host


def merged(spans):
    """The union of (start, end) spans as sorted, disjoint spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, t):
    """The name of the shortest host range around time ``t``, with the
    harness range it lies in, or "host idle"."""
    around = [(e - s, n) for n, s, e in host if s <= t <= e]
    if not around:
        return "host idle"
    inner = min(around)[1]
    outer = [n for _, n in sorted(around, reverse=True) if n.startswith("bench.")]
    return inner if not outer or outer[0] == inner else f"{outer[0]} / {inner}"


def record(dev, host, frames: int, top: int = 10) -> dict:
    """The record of a traced stretch of ``frames`` frames: from the start
    of its first call into the port to the end of its last device
    operation or of its closing sync, whichever is later."""
    starts = [s for n, s, _ in host if n == FRAME_RANGE]
    if not starts or not dev:
        return {"frames": frames, "ops": [], "busy_s": 0.0, "window_s": 0.0,
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    lo = min(starts)
    hi = max([e for _, _, e in dev] + [e for n, _, e in host if n == SYNC_RANGE])
    ops = [(n, max(s, lo), min(e, hi)) for n, s, e in dev if e > lo and s < hi]
    busy = merged([(s, e) for _, s, e in ops])
    gaps, t = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > t:
            gaps.append((s - t, 0.5 * (s + t)))
        t = max(t, e)
    gaps = sorted(gaps, reverse=True)[:top]
    by_name: dict = {}
    for n, s, e in ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "frames": frames,
        "ops": ops,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (hi - lo) / 1e6,
        "breakdown": {
            "device_ops": [[n, us / 1e6] for n, us in device_ops],
            "idle_gaps": [[_innermost(host, mid), us / 1e6] for us, mid in gaps],
        },
    }


def record_of_profile(prof, frames: int) -> dict:
    dev, host = _events(prof)
    return record(dev, host, frames)
