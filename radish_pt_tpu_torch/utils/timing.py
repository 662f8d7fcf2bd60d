"""The port's tracing: spans, counters and device stage marks, and the
per-pass timer built on them (``--timing``).

* :func:`span` times a region on the host clock.  Per name it keeps the
  count, the total, the self time (the total less the time of its child
  spans, the spans opened inside it on the same thread) and the longest,
  in memory, for the whole process: one table for spans run while a
  ``torch.profiler`` records and one for the others, so set-up and an
  unprofiled window read apart from a traced stretch.  While a profiler
  records, a span also opens ``torch.profiler.record_function(name)``
  (its argument the call's index, :func:`call`), so it sits on the
  profiler's clock beside the device operations.
* :func:`count` adds to a counter.  A count is also charged to every span
  open on the thread, so a span's entry says what its calls counted
  (``counts``): e.g. the host syncs of a renderer call.  The kernel
  layer counts ``launch.<module>.<kernel>`` a launch, ``plain.<module>.<kernel>``
  a plain version's call and ``prepass.<module>.<name>`` an eager culling
  prepass's (``<module>`` the wrapper's under accel/ or render/:
  ``launch.plucker.closest_hit``); a CUDA graph's replay counts its
  capture's (render/graph.py).  :func:`under` and :class:`Tally` read them.
* :func:`host_sync` counts ``host_syncs``: a point where the port blocks
  the host on the card (a copy from pageable host memory, ``.item()``,
  ``bool(tensor)``, ``.cpu()``, an event or stream synchronize).  It is
  counted on every device, so a CPU run counts what the card would wait
  on.
* :func:`mark` marks where a device stage starts.  On a CUDA device's
  current stream it launches an empty one-thread kernel named
  ``stage_mark_<stage>`` (``csrc/stage_mark.cu``); a CUDA graph capture
  records it, so every replay runs it in stream order among the stage's
  kernels.  A stage runs from its mark to the next mark on the stream;
  an inner mark (:data:`INNER_MARKS`) brackets work inside a stage and
  starts none.  On every device it counts ``marks.<stage>``.
* :func:`snapshot` returns the tables and counters as plain dicts;
  :func:`reset` clears them.

:class:`PassTimer` is a view over the spans: ``time(name)`` opens a span
and, with ``enabled`` on a CUDA device, also times the pass with CUDA
events recorded on the current stream (no host sync in the frame; read
when the table is asked for).  ``profiler_trace`` is a ``torch.profiler``
trace of a region.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

# the device stages, in the order of their kernels in csrc/stage_mark.cu:
# ReSTIR (gbuffer, primary, ris, shadow, temporal, spatial, shade,
# accumulate), the path tracer (primary, then per bounce nee, bsdf, extend,
# hit, then accumulate), and "end", which closes a block function
STAGES = ("gbuffer", "primary", "ris", "shadow", "temporal", "spatial", "shade",
          "accumulate", "nee", "bsdf", "extend", "hit", "end")
# marks inside a stage, which start none (their kernels follow the stages'
# in csrc/stage_mark.cu): the sorted sweeps' wavefront reordering
# (scene/device_scene.py), "reorder" where it starts and "reorder_end"
# where it stops, once around the sort key, the sort and the gathers into
# key order and once around the scatter back to lane order; the denoiser
# (render/renderer.py, render/denoise.py), "denoise" where it starts,
# "svgf_levels" before SVGF's first variance prefilter and guided level,
# "denoise_end" where it stops
INNER_MARKS = ("reorder", "reorder_end", "denoise", "svgf_levels", "denoise_end")
_STAGE_INDEX = {s: i for i, s in enumerate(STAGES + INNER_MARKS)}


class Registry:
    """The spans' tables, the counters and the open spans of each thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.tables = {"unprofiled": {}, "profiled": {}}
            self.counters = {}
            self.calls = 0

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def count(self, name: str, n=1) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n
        for frame in self.stack():
            frame.counts[name] = frame.counts.get(name, 0) + n

    def record(self, sp: "_Span") -> None:
        with self.lock:
            table = self.tables["profiled" if sp.profiled else "unprofiled"]
            e = table.get(sp.name)
            if e is None:
                e = table[sp.name] = {"count": 0, "total_s": 0.0, "self_s": 0.0,
                                      "max_s": 0.0, "counts": {}}
            e["count"] += 1
            e["total_s"] += sp.seconds
            e["self_s"] += sp.seconds - sp.child_s
            e["max_s"] = max(e["max_s"], sp.seconds)
            for k, n in sp.counts.items():
                if n:  # a count taken back inside the span nets to nothing
                    e["counts"][k] = e["counts"].get(k, 0) + n

    def snapshot(self) -> dict:
        with self.lock:
            return {"unprofiled": {k: {**e, "counts": dict(e["counts"])}
                                   for k, e in self.tables["unprofiled"].items()},
                    "profiled": {k: {**e, "counts": dict(e["counts"])}
                                 for k, e in self.tables["profiled"].items()},
                    "counters": dict(self.counters), "calls": self.calls}


REGISTRY = Registry()


class _Span:
    """One open span (:func:`span`); ``seconds`` holds its time once it
    has closed."""

    __slots__ = ("name", "profiled", "counts", "child_s", "seconds", "_t0", "_rf", "_reg")

    def __init__(self, name: str, reg: Registry):
        self.name, self._reg = name, reg
        self.counts: dict = {}
        self.child_s = self.seconds = 0.0
        self._rf = None

    def __enter__(self):
        self.profiled = torch.autograd._profiler_enabled()
        if self.profiled:
            self._rf = torch.profiler.record_function(self.name, f"call {self._reg.calls}")
            self._rf.__enter__()
        self._reg.stack().append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        stack = self._reg.stack()
        stack.pop()
        if stack:
            stack[-1].child_s += self.seconds
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._reg.record(self)
        return False


def span(name: str) -> _Span:
    """A context manager that times the region as span ``name``."""
    return _Span(name, REGISTRY)


def call(name: str) -> _Span:
    """The span of one call into the renderer (``call.<entry>``): it
    numbers the calls, and the spans inside it carry that number to the
    profiler."""
    with REGISTRY.lock:
        REGISTRY.calls += 1
    return _Span(name, REGISTRY)


def count(name: str, n=1) -> None:
    REGISTRY.count(name, n)


def host_sync(n: int = 1) -> None:
    """Count ``n`` points where the host waits for the card."""
    REGISTRY.count("host_syncs", n)


def sync_check(fn) -> tuple:
    """Run ``fn()`` once on the card under
    ``torch.cuda.set_sync_debug_mode("warn")``: returns (the ``host_syncs``
    it counted, the synchronizing operations torch reported), which are
    equal where every point that blocks the host is counted."""
    import warnings

    before = counters().get("host_syncs", 0)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reported = [str(w.message) for w in seen
                if "called a synchronizing CUDA operation" in str(w.message)]
    return counters().get("host_syncs", 0) - before, reported


def counters() -> dict:
    """The counters as they stand (a copy)."""
    with REGISTRY.lock:
        return dict(REGISTRY.counters)


def snapshot() -> dict:
    """{"unprofiled": {span: entry}, "profiled": {span: entry},
    "counters": {name: n}, "calls": calls so far}; an entry is {"count",
    "total_s", "self_s", "max_s", "counts"} (``counts``: what was counted
    while the span was open)."""
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()


def under(counts: dict, prefix: str) -> dict:
    """The counts of ``counts`` named ``<prefix>.<name>`` that are not 0,
    keyed by ``<name>``: ``under(counters(), "launch.plucker")`` ->
    {"closest_hit": n, "occlusion": n}."""
    p = prefix + "."
    return {k[len(p):]: n for k, n in counts.items() if k.startswith(p) and n}


class Tally:
    """What the counters count from the moment it is made:
    ``Tally()("plain.plucker")`` is :func:`under` of the counters' moves
    since."""

    def __init__(self):
        self.before = counters()

    def __call__(self, prefix: str) -> dict:
        return under({k: n - self.before.get(k, 0) for k, n in counters().items()}, prefix)


def mark(stage: str, device) -> None:
    """Mark the start of device stage ``stage`` (:data:`STAGES`), or an
    inner mark (:data:`INNER_MARKS`), on the current stream of ``device``
    (a ``torch.device``): on a CUDA device the empty kernel
    ``stage_mark_<stage>``; on every device the counter ``marks.<stage>``."""
    idx = _STAGE_INDEX[stage]
    if device.type == "cuda":
        from ..accel import _build

        lib = _build.load_library("stage_mark")
        rc = lib.stage_mark(idx, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"stage_mark({stage!r}) launch failed: CUDA error {rc}")
    REGISTRY.count(f"marks.{stage}")


class PassTimer:
    """Collects per-pass milliseconds; print with :meth:`table`.  Every
    pass is also a span, ``pass.<name>``."""

    def __init__(self, enabled: bool = True, device="cpu"):
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self.times = defaultdict(list)
        self._pending = []  # (name, start event, end event) not read yet

    @contextlib.contextmanager
    def time(self, name: str):
        with span(f"pass.{name}") as sp:
            if not (self.enabled and self.cuda):
                yield
            else:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                yield
                end.record()
                self._pending.append((name, start, end))
        if self.enabled and not self.cuda:
            self.times[name].append(sp.seconds * 1e3)

    def _read(self) -> None:
        for name, start, end in self._pending:
            host_sync()
            end.synchronize()
            self.times[name].append(start.elapsed_time(end))
        self._pending.clear()

    def table(self, last_n: int = 16) -> str:
        self._read()
        rows = []
        for name, samples in self.times.items():
            recent = samples[-last_n:]
            rows.append(f"  {name:<24s} {sum(recent) / len(recent):8.3f} ms"
                        f"  (last {samples[-1]:8.3f} ms, n={len(samples)})")
        return "\n".join(rows)

    def mean_ms(self, name: str, last_n: int = 16) -> float:
        self._read()
        s = self.times.get(name, [])
        if not s:
            return float("nan")
        recent = s[-last_n:]
        return sum(recent) / len(recent)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Wrap a region in a ``torch.profiler`` trace (host and, where there
    is a card, device activity) written to ``log_dir/trace.json`` (Chrome
    trace format) when ``log_dir`` is given.  The port's spans inside the
    region appear in it as ``record_function`` ranges."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
