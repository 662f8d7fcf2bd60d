"""Per-pass timing and profiling: the port of
``radish_pt_tpu/utils/timing.py`` (the reference's cudaEvent printf
instrumentation, pathtrace.cu:352-374).

On a CUDA device a pass is timed with CUDA events recorded on the current
stream around it, so timing adds no host sync to the frame; the times are
read when the table is asked for.  On the CPU the host clock times it.
``profiler_trace`` is a ``torch.profiler`` trace of a region.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PassTimer:
    """Collects per-pass milliseconds; print with :meth:`table`."""

    def __init__(self, enabled: bool = True, device="cpu"):
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self.times = defaultdict(list)
        self._pending = []  # (name, start event, end event) not read yet

    @contextlib.contextmanager
    def time(self, name: str):
        if not self.enabled:
            yield
            return
        if self.cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self._pending.append((name, start, end))
            return
        t0 = time.perf_counter()
        yield
        self.times[name].append((time.perf_counter() - t0) * 1e3)

    def _read(self) -> None:
        for name, start, end in self._pending:
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
    trace format) when ``log_dir`` is given."""
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
