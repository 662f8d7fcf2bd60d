"""Render-state checkpoint and resume: the port of
``radish_pt_tpu/render/checkpoint.py``.

The accumulation buffers, the ReSTIR reservoirs, the last G-buffer frame,
both SVGF histories, the camera and the sampler counters go to one
``.npz`` with the JAX package's keys and ``__meta__`` fields, so each
package loads the other's file.  A renderer whose last frame rendered no
G-buffer writes the G-buffer of its last camera, the bytes the JAX
renderer (which renders one every frame) would hold.  A mesh renderer
writes the JAX package's mesh layout: every pixel buffer ``n_alloc`` rows
(the tiles gathered, tile padding kept; the denoisers' histories, which it
keeps whole, padded with empty rows) and reads it back into its tiles.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils import timing

FORMAT_VERSION = 1


def _np(t: torch.Tensor, rows: int | None = None) -> np.ndarray:
    """``t`` on the host, zero rows appended up to ``rows``."""
    timing.host_sync()
    a = t.detach().cpu().numpy()
    if rows is not None and a.shape[0] < rows:
        a = np.concatenate([a, np.zeros((rows - a.shape[0], *a.shape[1:]), a.dtype)])
    return a


def _host(x):
    """A pixel state whole: a mesh renderer's tiles (a list) gathered on
    the host, padding kept."""
    if not isinstance(x, list):
        return x
    from ..parallel.sharding import gather

    return gather(x, "cpu")


def save_checkpoint(renderer, path: str) -> str:
    """Write a Renderer's progressive state to ``path`` (.npz)."""
    r = renderer
    r._ensure_gbuf_last()
    res, frame, rows = _host(r.reservoir), _host(r.gbuf_last), r.n_alloc
    arrays = {
        "direct": _np(_host(r.direct)),
        "indirect": _np(_host(r.indirect)),
        "res_li": _np(res.li),
        "res_wi": _np(res.wi),
        "res_dist": _np(res.dist),
        "res_num": _np(res.num),
        "res_weight": _np(res.weight),
        "gbuf_normal": _np(frame.normal),
        "gbuf_prim": _np(frame.prim_id),
        "gbuf_depth": _np(frame.depth),
        "svgf_color": _np(r.svgf_direct.accum_color, rows),
        "svgf_moment": _np(r.svgf_direct.accum_moment, rows),
        "svgf_i_color": _np(r.svgf_indirect.accum_color, rows),
        "svgf_i_moment": _np(r.svgf_indirect.accum_moment, rows),
        "cam_position": _np(r.cam.position),
        "cam_rotation": _np(r.cam.rotation),
    }
    meta = {
        "version": FORMAT_VERSION,
        "iteration": r.state.iteration,
        "looper": r.state.looper,
        "first_frame": bool(r.first_frame),
        "width": r.cam.width,
        "height": r.cam.height,
        "image_name": r.state.image_name,
        "n_alloc": int(r.n_alloc),
        "normal_dim": int(frame.normal.shape[-1]),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    return os.path.abspath(path)


def load_checkpoint(renderer, path: str) -> None:
    """Restore progressive state into a Renderer built for the same scene,
    resolution and normal encoding; raises ValueError on a file of another
    version or layout."""
    from ..scene.camera import update_camera
    from . import restir as rs
    from .gbuffer import GBufferFrame

    r = renderer
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} unsupported")
    if (meta["width"], meta["height"]) != (r.cam.width, r.cam.height):
        raise ValueError(f"checkpoint resolution {meta['width']}x{meta['height']} != "
                         f"renderer {r.cam.width}x{r.cam.height}")
    ck_alloc = meta.get("n_alloc", data["direct"].shape[0])
    if ck_alloc != r.n_alloc:
        raise ValueError(f"checkpoint pixel buffers are {ck_alloc} rows but this "
                         f"renderer allocates {r.n_alloc} (a JAX file saved under a "
                         f"mesh holds tile padding: resume it with the same --mesh)")
    have_ndim = 2 if r.settings.encode_normal else 3  # what the next frame renders
    ck_ndim = meta.get("normal_dim", data["gbuf_normal"].shape[-1])
    if ck_ndim != have_ndim:
        raise ValueError(f"checkpoint G-buffer normals are {ck_ndim}-component but this "
                         f"renderer uses {have_ndim} (encode_normal setting differs)")

    def dev(key, rows=None):
        return torch.from_numpy(np.ascontiguousarray(data[key][:rows])).to(r.device)

    def tiles(x):  # a mesh renderer's pixel state goes back to its tiles
        if r.mesh is None:
            return x
        from ..parallel.sharding import shard_image

        return shard_image(r.mesh, x)

    r.direct, r.indirect = tiles(dev("direct")), tiles(dev("indirect"))
    res = rs.DirectReservoir(li=dev("res_li"), wi=dev("res_wi"), dist=dev("res_dist"),
                             num=dev("res_num"), weight=dev("res_weight"))
    r.reservoir = tiles(res)
    r.gbuf_last = tiles(GBufferFrame(normal=dev("gbuf_normal"), prim_id=dev("gbuf_prim"),
                                     depth=dev("gbuf_depth")))
    n = r.n_pixels  # the histories stay whole
    r.svgf_direct = type(r.svgf_direct)(accum_color=dev("svgf_color", n),
                                        accum_moment=dev("svgf_moment", n))
    if "svgf_i_color" in data:  # split-SVGF history (absent in old files)
        r.svgf_indirect = type(r.svgf_indirect)(accum_color=dev("svgf_i_color", n),
                                                accum_moment=dev("svgf_i_moment", n))
    r.cam = update_camera(r.cam.replace(position=dev("cam_position"),
                                        rotation=dev("cam_rotation")))
    r.last_cam = r.cam
    r.state.iteration = int(meta["iteration"])
    r.state.looper = int(meta["looper"])
    r.first_frame = bool(meta["first_frame"])
