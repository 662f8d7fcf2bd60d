"""A block of frames run as one CUDA graph: the port's counterpart of the
JAX renderer's batched programs (``fori_loop`` of ``block`` frames in one
jit, ``radish_pt_tpu/render/renderer.py``).

:class:`BlockRunner` runs a block function ``fn(*args)`` whose arguments
and result are nested dataclasses, lists and tuples of tensors, flattened
to dicts of tensors keyed by path.  Which way it runs is decided from the
scene's engine and device before anything is captured (:func:`batch_mode`):

* ``"graph"``: on a CUDA device with a capturable engine
  (``scene/engines.py``).  The first call runs one eager warm-up block
  on a side stream (it builds the kernels and the cached constants, and
  changes no state), then captures the block once on static copies of the
  inputs; every call copies its inputs into them (``copy_``) and replays.  An error in the capture or the replay
  raises: nothing falls back to the eager run.
* ``"eager"``: the same ``fn`` called directly, on every engine on the
  CPU and on the compact engine, whose work list reads its length on the
  host (``accel/compact.py``, ``work_list``).

The counters (utils/timing.py: the kernels' ``launch.*``, the stage marks'
``marks.<stage>``) count a wrapper's call, which a capture makes without
launching anything on the card: the runner takes back what the capture
counted (``counts_per_replay``) and adds it again on every replay, so they
keep counting what the card ran.

Spans (utils/timing.py): ``graph.build`` (the first call: ``graph.warmup``,
the eager block on a side stream, and ``graph.capture``), then on every
later call ``block.inputs`` (the ``copy_`` into the static inputs) and
``block.replay``.
"""

from __future__ import annotations

import dataclasses
import gc

import torch

from ..scene import engines
from ..utils import timing


def batch_mode(ds) -> str:
    """"graph" or "eager": how a block of frames runs on scene ``ds``."""
    if ds.device.type == "cuda" and engines.of(ds).capturable:
        return "graph"
    return "eager"


def block_input(value, device) -> torch.Tensor:
    """A block input as a tensor on ``device``: a tensor as it is, a Python
    bool, int or float as a 0-d bool, int64 or float32 fill (no copy from
    the host)."""
    if isinstance(value, torch.Tensor):
        return value
    dtype = (torch.bool if isinstance(value, bool) else
             torch.int64 if isinstance(value, int) else torch.float32)
    return torch.full((), value, dtype=dtype, device=device)


def flatten(tree, prefix: str = "") -> dict:
    """The tensor leaves of ``tree`` (nested dataclasses, lists, tuples and
    tensors) as a flat dict, keyed by their path ("1.0.frame.depth"); a
    leaf that is not a tensor is static and left out."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten(flat: dict, like, prefix: str = ""):
    """``like``'s structure with its tensor leaves taken from ``flat``
    (:func:`flatten`'s keys); its other leaves as they are in ``like``."""
    if isinstance(like, torch.Tensor):
        return flat[prefix]
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: unflatten(flat, getattr(like, f.name), f"{prefix}.{f.name}" if prefix
                              else f.name) for f in dataclasses.fields(like)})
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(flat, v, f"{prefix}.{k}" if prefix else str(k))
                          for k, v in enumerate(like))
    return like


class BlockRunner:
    """Runs ``fn(*args)`` as one block, in ``mode`` (:func:`batch_mode`).
    The arguments and the result are nested dataclasses, lists and tuples
    of tensors (:func:`flatten`): their structure and their leaves that
    are not tensors are those of the first call (a scalar that changes
    from call to call is passed as a tensor, :func:`block_input`).
    ``carry``: (result path, argument path) pairs, paths as
    :func:`flatten`'s keys; a part of the result that replaces a part of
    the arguments for the next block (the state a block hands on), e.g.
    ("0", "6"): the result's first item replaces the seventh argument.  In
    a graph the carried result is written back into that argument's static
    tensors at the end of the block, and returned as those tensors."""

    def __init__(self, fn, mode: str, device, carry=()):
        if mode not in ("graph", "eager"):
            raise ValueError(f"unknown batch mode {mode!r}")
        self.fn, self.mode, self.device = fn, mode, torch.device(device)
        self.tree_carry = tuple(carry)
        self.carry: dict = {}  # flat result key -> flat argument key
        self._like = self._out = None
        self.graph = None
        self.static: dict = {}
        self.outputs: dict = {}
        self.counts_per_replay: dict = {}  # counter -> what a replay adds
        self.replays = 0

    def _body(self, x: dict) -> dict:
        out = self.fn(*unflatten(x, self._like))
        self._out = out
        return flatten(out)

    def __call__(self, *args):
        inputs = flatten(args)
        if self._like is None:
            self._like = args
            self.carry = {o + k[len(i):]: k for o, i in self.tree_carry
                          for k in inputs if k == i or k.startswith(i + ".")}
        if self.mode == "eager":
            return unflatten(self._body(inputs), self._out)
        if self.graph is None:
            with timing.span("graph.build"):
                self._capture(inputs)
        else:
            with timing.span("block.inputs"):
                for name, value in inputs.items():
                    if value is not self.static[name]:
                        self.static[name].copy_(value)
        with timing.span("block.replay"):
            self.graph.replay()
            for name, n in self.counts_per_replay.items():
                timing.count(name, n)
        self.replays += 1
        out = dict(self.outputs)
        out.update({o: self.static[i] for o, i in self.carry.items()})
        return unflatten(out, self._out)

    def _capture(self, inputs: dict) -> None:
        self.static = {k: v.clone() for k, v in inputs.items()}
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with timing.span("graph.warmup"), torch.cuda.stream(side):
            self._body(self.static)  # warm-up: kernels and constants built
        current.wait_stream(side)
        with timing.span("graph.capture") as sp:
            graph = torch.cuda.CUDAGraph()
            # no garbage collection while capturing: a dead reference cycle
            # that holds another block's CUDA graph (a renderer and its
            # runners) would free that graph mid-capture, which CUDA does
            # not permit on a capturing stream, and the capture fails
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    outputs = self._body(self.static)
                    for out, name in self.carry.items():
                        self.static[name].copy_(outputs[out])
            finally:
                if collecting:
                    gc.enable()
            # what the capture counted on this thread, taken back: it
            # launched nothing
            self.counts_per_replay = {n: c for n, c in sp.counts.items() if c}
            for name, n in self.counts_per_replay.items():
                timing.count(name, -n)
        self.outputs = {k: v for k, v in outputs.items() if k not in self.carry}
        self.graph = graph
