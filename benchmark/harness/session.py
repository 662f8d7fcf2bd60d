"""The general generator: one cell's configuration and traffic mix turned into
calls into the port, from its set-up through the measured window to the
inputs of the comparison.  Everything a mix varies is a parameter of its
file (``traffic/<mix>.json``); everything a configuration varies, of its
file (``configs/<name>.json``).

What the comparison copies around the calls it follows and at the
window's end is the reference stage's (``checks/<stage>.py``, the mix's
``check.reference``): the session calls its hooks and names no stage.

The port is imported here and nowhere else in the harness; the reference
(``reference/``) imports nothing of it.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import math
import time

import numpy as np
import torch

from . import spec
from .trace import FRAME_RANGE, SYNC_RANGE, record_of_profile

SOBOL_SAMPLE_NUM = 10000  # the port's looper wraps here (reference sampler.h:12)


def resolve_setting(value):
    """A setting as the mix's file gives it: a string ``"Enum.MEMBER"``
    names a member of one of the port's enums in ``radish_pt_tpu_torch.config``
    (``"Tracer.RESTIR_DI"``); anything else is the value itself."""
    from radish_pt_tpu_torch import config

    if isinstance(value, str) and "." in value:
        enum, member = value.split(".", 1)
        if isinstance(getattr(config, enum, None), type):
            return getattr(getattr(config, enum), member)
    return value


def _settings(desc, config: dict, traffic: dict):
    """The port's ``Settings`` for the cell: the scene file's, then the
    configuration's depth, then every field the mix's ``settings`` names
    (enum members by name)."""
    fields = {k: resolve_setting(v) for k, v in traffic.get("settings", {}).items()}
    return dataclasses.replace(desc.settings, trace_depth=int(config["depth"]), **fields)


class _HostClock:
    """Stand-in for CUDA events where there is no card (the CPU tests)."""

    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return 1e3 * (other.t - self.t)


@dataclasses.dataclass
class Snapshot:
    """Copies of the port's state around one call, on its device."""

    call: int  # the call's index, set-up's first call = 0
    looper: int
    cam_time_before: float | None  # the animation's clock before the call (None: unmoved)
    cam_time: float | None  # the camera animation's clock after the call
    before: dict | None  # the stage's copies the call started from (the followed call only)
    after: dict  # the stage's copies of what the call produced
    chain: bool  # one of the consecutive calls from set-up's first


class Session:
    """One cell driven from one seed.  ``overrides`` (the CPU tests only):
    configuration keys replaced, such as a tiny ``resolution``.

    The mix's file names the entry (a method of the port's ``Renderer``),
    its arguments, the frames a call renders and the camera steps a call
    takes; the session calls it and counts the sample sequence and the
    camera's clock itself, for the reference."""

    def __init__(self, cell: spec.Cell, seed: int, device: str = "cuda",
                 overrides: dict | None = None):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.config = {**cell.config, **(overrides or {})}
        self.traffic = tr = cell.traffic
        self.rng = np.random.default_rng(self.seed)
        self.entry, self.args = tr["entry"], list(tr.get("args", []))
        self.frames_per_call = int(tr["frames_per_call"])
        if SOBOL_SAMPLE_NUM % self.frames_per_call:
            raise ValueError(f"a call of {self.frames_per_call} frames would straddle the "
                             "looper's wrap")
        self.in_flight = int(tr["in_flight"])
        settings = tr.get("settings", {})
        self.cam_step = (float(tr.get("camera_steps_per_call", 0)) / 60.0
                         * float(settings.get("animate_speed", 1.0)))
        self.cam_radius = float(settings.get("animate_radius", 0.0))
        self.calls = 0  # calls into the port so far, set-up's included
        self.snapshots: list[Snapshot] = []
        self.timings: dict = {}
        self.check = check = tr["check"]
        self.stage = spec.stage(check["reference"])
        # the seed picks where the sample sequence starts (a whole call
        # from the wrap, so that no call straddles it) and where the orbit
        # starts; every seed renders the same sizes and the same number of
        # samples a frame
        self.looper0 = (int(self.rng.integers(SOBOL_SAMPLE_NUM // self.frames_per_call))
                        * self.frames_per_call)
        self.next_looper = self.looper0  # counted here, not read from the port
        self.orbit0 = (float(self.rng.uniform(0.0, 2.0 * math.pi))
                       if settings.get("animate_camera") else None)
        self.drawn = None  # what the stage drew from the seed in set-up
        self.loopers: list[int] = []  # loopers of the frames since the last reset
        self.chain_calls = int(check.get("chain_calls", 0))
        self.follow_call = None
        if "follow_call" in check:
            lo, hi = check["follow_call"]
            self.follow_call = int(self.rng.integers(lo, hi + 1))
        self.display = None
        self.r = None

    # -- set-up ----------------------------------------------------------

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return _HostClock()

    def setup(self):
        """Load the scene, build the renderer and run the first call, which
        warms up, captures and replays the cell's block: the only shape the
        window runs."""
        from radish_pt_tpu_torch.render.renderer import Renderer
        from radish_pt_tpu_torch.scene.build import load_scene

        cfg = self.config
        if self.device.type == "cuda":  # the context first: load_scene_s is the load alone
            torch.zeros(1, device=self.device)
            self.sync()
        t = time.perf_counter()
        ds, cam, desc = load_scene(spec.path_in_checkout(cfg["scene"]), device=self.device,
                                   intersector=cfg.get("engine"))
        self.sync()
        self.timings["load_scene_s"] = time.perf_counter() - t
        w, h = cfg["resolution"]
        if (cam.width, cam.height) != (w, h):
            cam = cam.replace(width=int(w), height=int(h))
        self.engine = ds.intersector
        self.r = Renderer(ds=ds, cam=cam, desc=desc, settings=_settings(desc, cfg, self.traffic),
                          device=self.device)
        self.r.state.looper = self.looper0
        self.r.state.iteration = 0
        if self.orbit0 is not None:
            self.r._time = self.orbit0  # the orbit's clock (Renderer._animate_camera)
        self.cam_time = self.orbit0
        self.drawn = self.stage.draw(self)
        t = time.perf_counter()
        self.call()
        self.sync()
        self.timings["warmup_s"] = time.perf_counter() - t
        self.batch_mode = self.r.batch_mode

    # -- one call into the port -------------------------------------------

    def call(self):
        """One call of the mix's entry; snapshots around the calls the
        comparison follows."""
        r, tr = self.r, self.traffic
        k = self.calls
        looper = self.next_looper
        self.next_looper = (looper + self.frames_per_call) % SOBOL_SAMPLE_NUM
        chain = k < self.chain_calls
        followed = k == self.follow_call
        before = self.stage.before(r) if followed and k > 0 else None
        cam_time_before = self.cam_time if k > 0 else None
        every = tr.get("reset_every_frames")
        if self.cam_step:  # a moving camera resets the port's accumulation itself
            self.loopers = []
        elif every and len(self.loopers) + self.frames_per_call > every:
            r.reset_accumulation()
            self.loopers = []
        with torch.profiler.record_function(FRAME_RANGE):
            out = getattr(r, self.entry)(*self.args)
        if isinstance(out, torch.Tensor):
            self.display = out
        self.loopers += [(looper + i) % SOBOL_SAMPLE_NUM for i in range(self.frames_per_call)]
        if self.cam_time is not None:
            self.cam_time += self.cam_step
        if chain or followed:
            after = self.stage.after(r, self.display)
            self.snapshots.append(Snapshot(call=k, looper=looper,
                                           cam_time_before=cam_time_before,
                                           cam_time=self.cam_time, before=before, after=after,
                                           chain=chain))
        self.calls += 1

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Calls for ``seconds`` of the host's clock, at most ``in_flight``
        calls ahead of the device, then a sync.  Returns the window's
        record: its wall time, the calls and frames completed in it, the
        device time stamp of each call's end (ms from the window's start)
        and the host's time inside the calls."""
        self.sync()
        pending = collections.deque()
        stamps = []
        host_s = 0.0
        calls0 = self.calls
        t0 = time.perf_counter()
        start = self.mark()
        while time.perf_counter() - t0 < seconds:
            while len(pending) >= self.in_flight:
                pending.popleft().synchronize()
            t = time.perf_counter()
            self.call()
            host_s += time.perf_counter() - t
            ev = self.mark()
            pending.append(ev)
            stamps.append(ev)
        self.sync()
        window_s = time.perf_counter() - t0
        calls = self.calls - calls0
        return {"window_s": window_s, "calls": calls, "frames": calls * self.frames_per_call,
                "stamps_ms": [0.0] + [start.elapsed_time(ev) for ev in stamps],
                "host_s": host_s}

    def traced(self, frames: int) -> dict:
        """``frames`` more frames (whole calls) under ``torch.profiler``:
        the record the per-layer readers take their numbers from."""
        from torch.profiler import ProfilerActivity, profile, record_function

        calls = max(1, -(-frames // self.frames_per_call))
        self.sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                self.call()
            with record_function(SYNC_RANGE):
                self.sync()
        return record_of_profile(prof, calls * self.frames_per_call)

    # -- after the window ------------------------------------------------------

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def check_inputs(self) -> dict:
        """What the comparison reads of the port's outputs, copied off the
        renderer, whose state is then freed: the snapshots and what the
        stage reads at the window's end."""
        cfg, tr = self.config, self.traffic
        out = {"reference": self.check["reference"],
               "scene": spec.path_in_checkout(cfg["scene"]),
               "resolution": list(cfg["resolution"]), "depth": int(cfg["depth"]),
               "settings": dict(tr.get("settings", {})), "cam_radius": self.cam_radius,
               "cam_time": self.cam_time, "chain_calls": self.chain_calls,
               "follow_call": self.follow_call}
        out.update(self.stage.at_end(self))
        out["snapshots"] = [dataclasses.replace(s, before=_to_cpu(s.before),
                                                after=_to_cpu(s.after))
                            for s in self.snapshots]
        return out

    def close(self):
        self.r = None
        self.snapshots = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _to_cpu(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()
