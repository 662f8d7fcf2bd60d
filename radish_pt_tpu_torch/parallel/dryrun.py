"""Dry run of the multi-device path: the port of
``__graft_entry__.dryrun_multichip``.

``python -m radish_pt_tpu_torch.parallel.dryrun N`` runs its four checks on
a mesh of N visible CUDA devices (raising when there are fewer);
``dryrun_multichip(N, devices=[dev] * N)`` runs them with N tiles on one
device.  Each check raises on failure:

1. a full-PT accumulate step (``pt_step_sharded``) on a (tile, sample)
   mesh (2 samples when N is even), cornell at 16x16, depth 2: finite and
   non-zero;
2. teapot (clusters, the sliced bounce loop) on 4 tiles against 1 tile,
   16x16, depth 3, under the frames rule of :func:`frames_match`;
3. ReSTIR's seam rule: two frames of temporal + spatial reuse on 2 tiles
   (cornell 16x32) against one device: the rows more than 5 from the seam
   equal, and at least one pixel of the 10-row band at the seam differs
   (a cross-tile candidate rejected);
4. SVGF on the mesh's G-buffer (rendered tile by tile, gathered) equal to
   SVGF on the single-device G-buffer.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import ReservoirReuse
from ..render import denoise as dn
from ..render import gbuffer as gb
from ..render import pathtrace as pt
from ..render import restir as rs
from ..scene.build import load_scene
from . import sharding as sh

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scenes")


def frames_match(got, want, atol: float = 1e-4, max_flips: int = 2,
                 mean_atol: float = 5e-5) -> int:
    """The JAX package's rule for a sharded frame against the
    single-device one (tests/test_sharding.py::_assert_frames_match): at
    most ``max_flips`` pixels differ by more than ``atol`` in a channel
    (a grazing ray's discrete decision follows its culling group, and
    a tile regroups lanes), and the mean pixel difference stays below
    ``mean_atol``.  Returns the count of such pixels; raises past the
    bounds."""
    diff = np.abs(np.asarray(got) - np.asarray(want)).max(axis=-1)
    flips = int((diff > atol).sum())
    if flips > max_flips or diff.mean() >= mean_atol:
        raise AssertionError(f"{flips} pixels differ by more than {atol} (at most "
                             f"{max_flips} allowed), mean difference {diff.mean()}, "
                             f"max {diff.max()}")
    return flips


def _cornell(device, width, height):
    ds, cam, _ = load_scene(os.path.join(SCENES, "cornell_box.txt"), device=device)
    return ds, cam.replace(width=width, height=height)


def seam_check(mesh: sh.Mesh, ds, cam, frames: int = 2,
               reuse: int = ReservoirReuse.TEMPORAL_SPATIAL):
    """``frames`` ReSTIR frames of the static camera ``cam`` on ``mesh``
    (tiles of whole rows) and on one device (the first tile's), through
    ``restir_step_sharded`` and ``restir_direct``; returns (tiled image
    [H, W, 3], single-device image, seam rows) as numpy."""
    dev = mesh.tile_devices[0]
    n = cam.width * cam.height
    res0 = rs.empty_reservoir(n, device=dev)
    frame0 = gb.empty_frame(n, device=dev)
    direct0 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    d_sh, r_sh = sh.shard_image(mesh, direct0), sh.shard_image(mesh, res0)
    g_sh = sh.shard_image(mesh, frame0)
    state = (res0, frame0, direct0)
    for i in range(frames):
        d_sh, r_sh, g_out = sh.restir_step_sharded(mesh, ds, cam, cam, i, g_sh, r_sh,
                                                   i == 0, d_sh, i, reuse=reuse)
        g_sh = [g.frame for g in g_out]
        res, last, direct = state
        g = gb.render_gbuffer(ds, cam, cam)
        d, res = rs.restir_direct(ds, cam, i, g, last, res, i == 0, reuse, 32, 20)
        state = (res, g.frame, pt.accumulate(direct, pt.scrub_and_compress(d), i))
    shape = (cam.height, cam.width, 3)
    per_rows = cam.height // mesh.shape["tile"]
    return (sh.gather(d_sh, dev, n).cpu().numpy().reshape(shape),
            state[2].cpu().numpy().reshape(shape),
            [per_rows * t for t in range(1, mesh.shape["tile"])])


def seam_rule(tiled, single, seams, radius: int = 5) -> int:
    """The seam rule: rows farther than ``radius`` from every seam equal
    (rtol 1e-5, atol 1e-6, as the JAX package's test), and some pixel in
    each seam's band of ``2 * radius`` rows differs.  Returns the count of
    differing band pixels; raises otherwise."""
    height = tiled.shape[0]
    near = np.zeros(height, bool)
    rejected = 0
    for seam in seams:
        band = np.arange(max(0, seam - radius), min(height, seam + radius))
        near[band] = True
        n = int((np.abs(tiled[band] - single[band]).max(axis=-1) > 1e-6).sum())
        if n == 0:
            raise AssertionError(f"no cross-tile rejection in the band at row {seam}")
        rejected += n
    np.testing.assert_allclose(tiled[~near], single[~near], rtol=1e-5, atol=1e-6)
    return rejected


def dryrun_multichip(n_devices: int, devices=None, log=print) -> dict:
    """Run the four checks on ``n_devices`` devices (``devices`` None: the
    visible CUDA devices, raising when there are fewer); returns their
    numbers."""
    n_sample = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_tile = n_devices // n_sample
    mesh = sh.make_mesh(n_tile=n_tile, n_sample=n_sample, devices=devices)
    flat = [d for row in mesh.devices for d in row]
    dev = flat[0]
    log(f"[dryrun_multichip] {mesh}")
    out = {}

    ds, cam = _cornell(dev, 16, 16)
    n_pad = sh._padded_pixel_count(cam, n_tile)
    accum = sh.shard_image(mesh, torch.zeros((n_pad, 3), device=dev))
    img = sh.gather(sh.pt_step_sharded(mesh, ds, cam, accum, 0, 0, max_depth=2))
    if img.shape != (n_pad, 3) or not bool(torch.isfinite(img).all()) or \
            float(img.mean()) <= 0.0:
        raise AssertionError(f"PT step: shape {tuple(img.shape)}, mean {float(img.mean())}")
    out["pt_mean"] = float(img.mean())
    log(f"[dryrun_multichip] PT OK: mesh=(tile={n_tile}, sample={n_sample}), "
        f"out={tuple(img.shape)}, mean={out['pt_mean']:.4f}")

    ds_t, cam_t, _ = load_scene(os.path.join(SCENES, "teapot.txt"), device=dev)
    cam_t = cam_t.replace(width=16, height=16)
    frames = {}
    for nt in (1, 4):
        mesh_t = sh.make_mesh(n_tile=nt, devices=(flat * 4)[:nt])
        frames[nt] = sh.render_frame_sharded(mesh_t, ds_t, cam_t, 0, 3).cpu().numpy()
    out["teapot_flips"] = frames_match(frames[4], frames[1])
    log(f"[dryrun_multichip] sliced-loop PT OK: 4-tile mesh == 1-tile (teapot, "
        f"{out['teapot_flips']} flipped pixels, mean {frames[4].mean():.4f})")

    ds_r, cam_r = _cornell(dev, 16, 32)
    mesh_r = sh.make_mesh(n_tile=2, devices=(flat * 2)[:2])
    tiled, single, seams = seam_check(mesh_r, ds_r, cam_r)
    out["seam_rejections"] = seam_rule(tiled, single, seams)
    log(f"[dryrun_multichip] ReSTIR seam rules OK: interior equal, "
        f"{out['seam_rejections']} seam-band pixels show cross-tile rejections")

    mesh_s = sh.make_mesh(devices=flat)
    rng = np.random.default_rng(3)
    n_r = cam_r.width * cam_r.height
    color = torch.from_numpy(rng.uniform(0, 2, (n_r, 3)).astype(np.float32)).to(dev)
    g_full = gb.render_gbuffer(ds_r, cam_r, cam_r)
    g_mesh = sh.gather(sh.gbuffer_sharded(mesh_s, ds_r, cam_r, cam_r), dev, n_r)
    want, _ = dn.svgf_filter(color, dn.empty_svgf_state(n_r, device=dev), g_full,
                             g_full.frame, cam_r, False, levels=5)
    got, _ = dn.svgf_filter(color, dn.empty_svgf_state(n_r, device=dev), g_mesh,
                            g_mesh.frame, cam_r, False, levels=5)
    if not torch.equal(got, want):
        raise AssertionError(f"mesh SVGF differs from the single-device filter by "
                             f"{float((got - want).abs().max())}")
    out["svgf_mean"] = float(got.mean())
    log(f"[dryrun_multichip] mesh SVGF OK: {mesh_s.shape['tile']} tiles == single device "
        f"(mean {out['svgf_mean']:.4f})")
    return out


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
