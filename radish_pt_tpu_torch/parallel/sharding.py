"""Multi-device rendering: pixel-tile x sample parallelism over a grid of
torch devices.

Port of ``radish_pt_tpu/parallel/sharding.py``.  One process drives a
:class:`Mesh`, ``devices[tile][sample]``, from Python:

* ``tile``: the flat pixel-index space is cut into equal contiguous
  shards, padded up to a multiple of the tile count; pad lanes re-trace
  the last pixel and are dropped at display.  Tile t's state lives on its
  sample-0 device, ``devices[t][0]``, as one tensor a tile (a list of
  tensors is a tile-sharded buffer).
* ``sample``: device ``[t][s]`` traces tile t at looper ``looper + 37 s``
  and its image is copied to ``devices[t][0]``, where the replicas are
  averaged: summed in sample order, left to right, then divided by the
  sample count (``pmean``; the sum of two is exact in either order).

The scene is replicated, one copy per distinct device
(:func:`replicate_scene`), and so is the camera.  Copies between devices
happen at the sample mean and at the gather (:func:`gather`), never
inside a frame's trace.  Several tiles may share a device
(``make_mesh(devices=[dev] * n)``): the port's counterpart of XLA's
virtual host devices, which tests and the dry run use.

The ReSTIR state shards with its pixels.  In the eager step
(:func:`restir_step_sharded`) temporal and spatial reuse stay within a
tile: a candidate in another tile is rejected, as at an image border
(``restir_direct(pixel_idx=...)``).  The batched block
(:func:`restir_batch_sharded`) exchanges what reuse reads across the seams
instead, so its frames equal one device's bit for bit: every tile gathers
its temporal neighbours from last frame's whole packed image, and its
spatial neighbours from its own rows plus a halo of ``HALO * W + HALO``
rows on either side (:func:`whole_image`, :func:`halo_rows`).  The sample
axis is not used by ReSTIR (the reservoirs are a per-pixel history).

Tiles run one after another from the calling thread; their kernels are
queued asynchronously, so tiles on different devices overlap on the cards
wherever the frame reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ReservoirReuse
from ..render import gbuffer as gb
from ..render import pathtrace as pt
from ..render import restir as rs
from ..utils import timing

# looper stride between the sample axis' replicas (the JAX package's 37)
SAMPLE_STRIDE = 37


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (tile, sample) grid of torch devices: ``devices[t][s]``.

    ``shape`` is ``{"tile": .., "sample": ..}`` over the whole mesh; this
    process drives the rows of ``devices``, tiles ``tile_offset`` to
    ``tile_offset + len(devices) - 1`` (a multi-process mesh,
    parallel/multihost.py, gives each process its own rows)."""

    def __init__(self, devices, tile_offset: int = 0, n_tile: int | None = None):
        rows = [[_device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError(f"a mesh needs equal non-empty rows of devices, got {devices}")
        self.devices = rows
        self.tile_offset = tile_offset
        self.shape = {"tile": n_tile or len(rows), "sample": len(rows[0])}

    @property
    def tile_devices(self) -> list:
        """The device that holds each of this process' tiles: its sample-0
        device."""
        return [row[0] for row in self.devices]

    def __repr__(self) -> str:
        return (f"Mesh(tile={self.shape['tile']}, sample={self.shape['sample']}, "
                f"tiles {self.tile_offset}..{self.tile_offset + len(self.devices) - 1} "
                f"on {[[str(d) for d in r] for r in self.devices]})")


def visible_devices() -> list:
    """The CUDA devices this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_tile: int | None = None, n_sample: int = 1, devices=None) -> Mesh:
    """A (tile, sample) mesh over ``devices`` (row-major: device
    ``t * n_sample + s`` is ``[t][s]``); ``n_tile`` None takes every
    device on the tile axis.  ``devices`` None: the visible CUDA devices,
    and a mesh that needs more raises; nothing falls back to other
    devices.  To put several tiles on one device, pass that device several
    times."""
    if devices is None:
        devices = visible_devices()
        need = (n_tile or 1) * n_sample
        if len(devices) < need:
            raise RuntimeError(
                f"a mesh of {n_tile or 1} tile(s) x {n_sample} sample(s) needs {need} "
                f"devices, and {len(devices)} CUDA device(s) are visible (to put several "
                f"tiles on one device, pass devices=[device] * n)")
    devices = list(devices)
    if n_tile is None:
        n_tile = len(devices) // n_sample
    if n_tile < 1 or n_sample < 1 or len(devices) < n_tile * n_sample:
        raise ValueError(f"a mesh of {n_tile} tile(s) x {n_sample} sample(s) needs "
                         f"{n_tile * n_sample} devices, got {len(devices)}")
    return Mesh([devices[t * n_sample:(t + 1) * n_sample] for t in range(n_tile)])


def parse_mesh(spec: str) -> tuple:
    """``"TILE[xSAMPLE]"`` (the CLI's ``--mesh``) -> (n_tile, n_sample)."""
    parts = spec.lower().split("x")
    if len(parts) > 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"--mesh takes TILE or TILExSAMPLE, got {spec!r}")
    return int(parts[0]), int(parts[1]) if len(parts) > 1 else 1


def _padded_pixel_count(cam, n_shards: int) -> int:
    n = cam.width * cam.height
    return ((n + n_shards - 1) // n_shards) * n_shards


def tile_pixels(mesh: Mesh, cam) -> list:
    """Each of this process' tiles' global flat pixel indices (i32, on the
    tile's device): contiguous, ascending, the pad lanes clamped to the
    last pixel."""
    n = cam.width * cam.height
    per = _padded_pixel_count(cam, mesh.shape["tile"]) // mesh.shape["tile"]
    out = []
    for t, dev in enumerate(mesh.tile_devices):
        lo = (mesh.tile_offset + t) * per
        idx = torch.arange(lo, lo + per, dtype=torch.int32, device=dev)
        out.append(torch.clamp(idx, max=n - 1))
    return out


def replicate_scene(mesh: Mesh, ds) -> dict:
    """The scene on every device of this process' rows, {device: scene}:
    ``DeviceScene.to`` once for each distinct device."""
    out = {}
    for row in mesh.devices:
        for dev in row:
            if dev not in out:
                out[dev] = ds if ds.device == dev else ds.to(dev)
    return out


def _scene(scenes, dev):
    """The scene on ``dev``: from :func:`replicate_scene`'s dict, or a
    scene moved there."""
    if isinstance(scenes, dict):
        return scenes[dev]
    return scenes if scenes.device == dev else scenes.to(dev)


def _on(x, dev):
    """A step's scalar argument (int, bool or 0-d tensor) on ``dev``."""
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def _map(fn, x):
    """``fn`` over a tensor, or over each tensor field of a dataclass."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    return dataclasses.replace(x, **{f.name: _map(fn, getattr(x, f.name))
                                     for f in dataclasses.fields(x)})


def shard_image(mesh: Mesh, img) -> list:
    """A flat [n_pad, ...] buffer (a tensor, or a dataclass of them) cut
    into this process' tiles, each on its tile's device; ``n_pad`` a
    multiple of the tile count."""
    first = img
    while not isinstance(first, torch.Tensor):
        first = getattr(first, dataclasses.fields(first)[0].name)
    rows = first.shape[0]
    if rows % mesh.shape["tile"]:
        raise ValueError(f"{rows} pixel rows do not split into {mesh.shape['tile']} tiles")
    per = rows // mesh.shape["tile"]
    return [_map(lambda x: x[(mesh.tile_offset + t) * per:
                             (mesh.tile_offset + t + 1) * per].to(dev), img)
            for t, dev in enumerate(mesh.tile_devices)]


def gather(tiles: list, device=None, n: int | None = None):
    """Tiles (tensors, or dataclasses of them) concatenated in tile order
    on ``device`` (None: the first tile's), the first ``n`` rows."""
    first = tiles[0]
    if isinstance(first, torch.Tensor):
        dev = first.device if device is None else device
        out = torch.cat([t.to(dev) for t in tiles])
        return out if n is None else out[:n]
    return dataclasses.replace(first, **{
        f.name: gather([getattr(t, f.name) for t in tiles], device, n)
        for f in dataclasses.fields(first)})


def _sample_mean(images: list):
    """The sample axis' mean: summed in sample order, then divided."""
    if len(images) == 1:
        return images[0]
    acc = images[0]
    for img in images[1:]:
        acc = acc + img
    return acc / float(len(images))


def _trace_tile(mesh: Mesh, scenes, cam, looper, max_depth: int, t: int, idx,
                n_slices=None):
    """Tile t's direct + indirect image [per, 3] on its device, the mean of
    its sample replicas."""
    home = mesh.devices[t][0]
    images = []
    for s, dev in enumerate(mesh.devices[t]):
        d, ind = pt.path_trace(_scene(scenes, dev), cam.to(dev),
                               _on(looper, dev) + s * SAMPLE_STRIDE, max_depth,
                               idx.to(dev), n_slices=n_slices)
        images.append((d + ind).to(home))
    return _sample_mean(images)


def render_frame_sharded(mesh: Mesh, ds, cam, looper, max_depth: int):
    """One full-PT frame over the mesh: [H*W, 3] HDR on the first tile's
    device.  Each sample replica traces with a decorrelated looper and the
    replicas are averaged, so one call yields ``mesh.shape['sample']``
    spp."""
    scenes = replicate_scene(mesh, ds) if not isinstance(ds, dict) else ds
    tiles = [_trace_tile(mesh, scenes, cam, looper, max_depth, t, idx)
             for t, idx in enumerate(tile_pixels(mesh, cam))]
    return gather(tiles, n=cam.width * cam.height)


def pt_step_sharded(mesh: Mesh, ds, cam, direct: list, looper, iteration, *,
                    max_depth: int) -> list:
    """Full-PT trace + scrub + accumulate on the tile-sharded padded
    accumulation ``direct`` (one [per, 3] tensor a tile): the per-frame
    step of ``Renderer(mesh=...)``.  ``ds``: a scene, or
    :func:`replicate_scene`'s dict.  Returns the new tiles."""
    out = []
    for t, idx in enumerate(tile_pixels(mesh, cam)):
        img = pt.scrub_and_compress(_trace_tile(mesh, ds, cam, looper, max_depth, t, idx))
        out.append(pt.accumulate(direct[t], img, _on(iteration, direct[t].device)))
    return out


def render_accumulate_sharded(mesh: Mesh, ds, cam, accum, looper, iteration,
                              max_depth: int):
    """Trace + NaN-scrub + HDR compress + running-mean accumulate into the
    [H*W, 3] buffer ``accum`` (on the first tile's device); returns the
    new one."""
    img = pt.scrub_and_compress(render_frame_sharded(mesh, ds, cam, looper, max_depth))
    return pt.accumulate(accum, img, iteration)


def gbuffer_sharded(mesh: Mesh, ds, cam, last_cam, encode_normal: bool = False) -> list:
    """The G-buffer of each tile (a ``GBufferOut`` on its device); motion
    is a global index into the last frame."""
    return [gb.render_gbuffer(_scene(ds, dev), cam.to(dev), last_cam.to(dev),
                              encode_normal=encode_normal, pixel_idx=idx)
            for dev, idx in zip(mesh.tile_devices, tile_pixels(mesh, cam))]


def restir_step_sharded(mesh: Mesh, ds, cam, last_cam, looper, gbuf_last: list,
                        last_reservoir: list, first_frame, direct: list, iteration, *,
                        reuse: int, reservoir_size: int = 32, temporal_clamp: int = 20,
                        encode_normal: bool = False):
    """One interactive ReSTIR frame (G-buffer + RIS + temporal + spatial
    reuse + accumulate) on each tile; ``gbuf_last``, ``last_reservoir``
    and ``direct`` are tile-sharded (lists of ``GBufferFrame``,
    ``DirectReservoir`` and [per, 3] tensors).

    Seam rule: the state lives with its pixels, so a temporal or spatial
    candidate whose pixel is in another tile is rejected by the packed
    global-index column, as at an image border (restir.cu:43-60).  Pixels
    more than the disk radius (5 rows) from a seam, under a static camera,
    equal the single-device frame bit for bit.

    Returns (direct, reservoir_out, gbuf) as lists, ``gbuf`` each tile's
    ``GBufferOut``."""
    out_d, out_r, out_g = [], [], []
    for t, (dev, idx) in enumerate(zip(mesh.tile_devices, tile_pixels(mesh, cam))):
        ds_t, cam_t = _scene(ds, dev), cam.to(dev)
        g = gb.render_gbuffer(ds_t, cam_t, last_cam.to(dev), encode_normal=encode_normal,
                              pixel_idx=idx)
        d, res = rs.restir_direct(ds_t, cam_t, _on(looper, dev), g, gbuf_last[t],
                                  last_reservoir[t], _on(first_frame, dev), reuse,
                                  reservoir_size, temporal_clamp, pixel_idx=idx)
        out_d.append(pt.accumulate(direct[t], pt.scrub_and_compress(d),
                                   _on(iteration, dev)))
        out_r.append(res)
        out_g.append(g)
    return out_d, out_r, out_g


def tile_bounds(mesh: Mesh, n: int) -> list:
    """The global pixel range [lo, hi) of each of the mesh's tiles, when
    ``n`` pixels split into them without padding."""
    per = n // mesh.shape["tile"]
    return [(t * per, (t + 1) * per) for t in range(mesh.shape["tile"])]


def whole_image(rows: list, devices: list) -> list:
    """Each tile's packed rows (one tensor a tile, in tile order)
    assembled into the whole image on each tile's device: one
    concatenation a distinct device, copies to the others."""
    held = {}
    for dev in devices:
        if dev not in held:
            held[dev] = torch.cat([r.to(dev) for r in rows])
    return [held[dev] for dev in devices]


def halo_rows(rows: list, bounds: list, t: int, width: int, device):
    """Tile t's rows and its spatial halo, (rows, base): the global rows
    [lo - h, hi + h) clipped to the image, h = ``HALO * width + HALO``
    (restir.merge_spatial's reach), from whichever tiles hold them (a small
    tile's halo can span several), on ``device``; ``base`` the first row's
    global index."""
    h = rs.HALO * width + rs.HALO
    a, b = max(bounds[t][0] - h, 0), min(bounds[t][1] + h, bounds[-1][1])
    pieces = [r[max(a, lo) - lo:min(b, hi) - lo].to(device)
              for r, (lo, hi) in zip(rows, bounds) if max(a, lo) < min(b, hi)]
    return torch.cat(pieces), a


def restir_batch_sharded(mesh: Mesh, ds, idx: list, cam, last_cam, looper0, gbuf_last: list,
                         reservoir: list, first_frame, direct: list, iteration, *, reuse: int,
                         reservoir_size: int, clamp: int, encode_normal: bool, block: int,
                         segment=None):
    """``block`` ReSTIR frames with a static camera on every tile of
    ``mesh`` (``render/renderer.py::_restir_batch`` on tiles), equal to the
    single-device block bit for bit, seams included.  ``ds``: a scene or
    :func:`replicate_scene`'s dict; ``idx``: :func:`tile_pixels`;
    ``gbuf_last``, ``reservoir`` and ``direct`` tile-sharded;
    ``looper0``, ``first_frame`` and ``iteration`` 0-d tensors.  W * H must
    split into the tiles without padding.

    Each tile renders its G-buffer once (frame 0's motion through
    ``last_cam``, later frames' through ``cam``).  A frame then runs, on
    every tile: the exchange of last frame's packed temporal rows
    (:func:`whole_image`), stage "front" (candidates, shadow test, temporal
    reuse on the whole image, the packed spatial rows), the exchange of the
    spatial halos (:func:`halo_rows`), and stage "back" (spatial reuse,
    shade, scrub, accumulate, this frame's temporal rows).

    ``segment(key, fn, *args)`` runs a tile's stage, ``key`` = (stage,
    tile): None calls ``fn(*args)`` (all of it inside the caller's one
    capture when the tiles share a device); the renderer passes a captured
    segment a (stage, tile) when the tiles span devices, the exchanges'
    copies running between the segments.  Returns (direct, reservoir,
    gbuf) as lists, ``gbuf`` each tile's ``GBufferOut`` (frame 0's
    motion)."""
    run = segment or (lambda key, fn, *args: fn(*args))
    devs = mesh.tile_devices
    bounds = tile_bounds(mesh, cam.width * cam.height)[mesh.tile_offset:][:len(devs)]
    if len(bounds) != mesh.shape["tile"]:
        raise NotImplementedError("batched ReSTIR on a mesh runs every tile in one "
                                  "process")
    temporal = bool(reuse & ReservoirReuse.TEMPORAL)
    spatial = bool(reuse & ReservoirReuse.SPATIAL)
    scene = [_scene(ds, dev) for dev in devs]
    cams = [cam.to(dev) for dev in devs]

    def gbuffer(t):
        def fn(cam, last_cam, res, last):
            g, motion = gb.render_gbuffer(scene[t], cam, last_cam, encode_normal=encode_normal,
                                          pixel_idx=idx[t], extra_motion_cam=cam)
            rows = rs.temporal_rows(res, last)
            timing.mark("end", scene[t].device)
            return g, motion, rows
        return fn

    def front(t):
        def fn(cam, looper, g, first, rows):
            lanes, res = rs.restir_candidates(scene[t], cam, looper, idx[t], reservoir_size)
            if temporal:
                timing.mark("temporal", scene[t].device)
                lanes, res = rs.restir_temporal(lanes, res, rows, g, first, clamp,
                                                scene[t].sobol)
            out = rs._check_validity(res)
            rows = rs.spatial_rows(out, g.frame, idx[t])
            timing.mark("end", scene[t].device)
            return lanes, res, out, rows
        return fn

    def back(t):
        def fn(cam, looper, lanes, res, out, g, halo, acc, it):
            d = rs.restir_shade(scene[t], cam, looper, lanes, res, out, g, spatial, idx[t],
                                halo=(halo, halo_base[t]))
            acc = pt.accumulate(acc, pt.scrub_and_compress(d), it)
            rows = rs.temporal_rows(out, g.frame)
            timing.mark("end", scene[t].device)
            return acc, rows
        return fn

    h = rs.HALO * cam.width + rs.HALO
    halo_base = [max(lo - h, 0) for lo, _ in bounds]
    gbufs, steady, rows = [], [], []
    for t, dev in enumerate(devs):
        g, motion, r = run(("gbuffer", t), gbuffer(t), cams[t], last_cam.to(dev),
                           reservoir[t], gbuf_last[t])
        gbufs.append(g)
        steady.append(dataclasses.replace(g, motion=motion))
        rows.append(r)
    direct, out = list(direct), list(reservoir)
    for k in range(block):
        whole = whole_image(rows, devs) if temporal else [None] * len(devs)
        fronts, spat = [], []
        for t, dev in enumerate(devs):
            first = first_frame.to(dev) if k == 0 else torch.zeros((), dtype=torch.bool,
                                                                    device=dev)
            f = run(("front", t), front(t), cams[t], looper0.to(dev) + k,
                    gbufs[t] if k == 0 else steady[t], first, whole[t])
            fronts.append(f)
            spat.append(f[3])
        for t, dev in enumerate(devs):
            lanes, res, out[t], _ = fronts[t]
            halo = halo_rows(spat, bounds, t, cam.width, dev)[0] if spatial else None
            direct[t], rows[t] = run(("back", t), back(t), cams[t], looper0.to(dev) + k,
                                     lanes, res, out[t], gbufs[t] if k == 0 else steady[t],
                                     halo, direct[t], iteration.to(dev) + k)
    return direct, out, gbufs
