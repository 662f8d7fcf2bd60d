"""Multi-process render launcher: run ONE copy per rank.

    python -m radish_pt_tpu_torch.parallel.multihost_render \\
        --coordinator 127.0.0.1:29511 --num-processes 2 --process-id 0 \\
        scenes/cornell_box.txt --spp 8 --device cpu

The port of ``tools/multihost_render.py``, with the same flags and
``--device``.  Every rank loads the same scene, joins the global (tile,
sample) mesh (parallel/multihost.py: its own device's tiles), runs the
sharded accumulate step (parallel/sharding.py::pt_step_sharded) on them,
and gathers the image on every rank; rank 0 saves it (``--out-npy``: the
HDR accumulation [H, W, 3] as .npy).  On the card run a world of one on
NCCL (``--num-processes 1``); several CPU processes (``--device cpu``)
run on gloo.
"""

from __future__ import annotations

import argparse


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="radish_pt_tpu_torch.parallel.multihost_render")
    ap.add_argument("scene")
    ap.add_argument("--coordinator", required=True, help="HOST:PORT of rank 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--res", type=int, nargs=2, default=None)
    ap.add_argument("--n-sample", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one GPU a rank) or cpu (gloo); default cuda")
    ap.add_argument("--out", default="multihost.png")
    ap.add_argument("--out-npy", default=None)
    return ap


def render(args) -> "np.ndarray":  # noqa: F821
    """This rank's part of the render; every rank returns the whole
    accumulation [H, W, 3] (numpy)."""
    from ..scene.build import load_scene
    from . import multihost as mh
    from . import sharding as sh

    me = args.process_id
    ds, cam, _ = load_scene(args.scene, device=mh.local_devices(args.device)[0])
    if args.res:
        cam = cam.replace(width=args.res[0], height=args.res[1])
    mesh = mh.make_global_mesh(n_sample=args.n_sample,
                               devices=mh.local_devices(args.device) * args.n_sample)
    print(f"[proc {me}] {args.num_processes} processes, {mesh}", flush=True)
    n_pad = sh._padded_pixel_count(cam, mesh.shape["tile"])
    ds_g = mh.replicate_scene_global(mesh, ds)
    direct = mh.make_sharded_zeros(mesh, (n_pad, 3))
    for i in range(args.spp):
        direct = sh.pt_step_sharded(mesh, ds_g, cam, direct, i, i, max_depth=args.depth)
    img = mh.gather_image(direct)[: cam.width * cam.height]
    return img.reshape(cam.height, cam.width, 3)


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    from . import multihost as mh

    mh.initialize(args.coordinator, args.num_processes, args.process_id, args.device)
    try:
        img = render(args)
    finally:
        mh.shutdown()
    if args.process_id == 0:
        import numpy as np

        if args.out_npy:
            np.save(args.out_npy, img)
            print(f"[proc 0] saved {args.out_npy}", flush=True)
        else:
            import torch

            from ..render import post
            from ..scene.image_io import save_image
            from ..utils import math as m

            disp = m.gamma_correction(post.tonemap(torch.from_numpy(img), 2))
            save_image(args.out, np.ascontiguousarray(
                torch.clamp(disp, 0.0, 1.0).numpy()[:, ::-1]))
            print(f"[proc 0] saved {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
