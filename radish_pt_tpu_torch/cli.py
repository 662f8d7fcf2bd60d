"""Command-line entry point of the port.

``python -m radish_pt_tpu_torch SCENEFILE.txt --device cuda`` loads the
scene, renders the scene's ``Sample`` count (or ``--spp``) of full-MIS path
traced frames on the device and saves the image — the port's form of
``python -m radish_pt_tpu``.  ``--device`` names where everything runs; it
is never switched behind the user's back.
"""

from __future__ import annotations

import argparse
import time


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="radish_pt_tpu_torch",
        description="PyTorch/CUDA path tracer (port of radish_pt_tpu)",
    )
    p.add_argument("scene", help="scene file (reference text grammar)")
    p.add_argument("--spp", type=int, default=None, help="override Sample count")
    p.add_argument("--depth", type=int, default=None, help="override trace depth")
    p.add_argument("--res", type=int, nargs=2, metavar=("W", "H"), default=None,
                   help="override scene resolution")
    p.add_argument("--tonemap", choices=["none", "filmic", "aces"], default="aces")
    p.add_argument("--out", default=None, help="output image path")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("--intersector",
                   choices=["plucker", "compact", "quad", "band", "brute"],
                   default=None,
                   help="intersection engine (default: plucker up to 131,072 "
                        "triangles, compact above; quad and band only by name)")
    p.add_argument("--band-g", type=int, default=None,
                   choices=[1, 2, 4, 8, 16, 32, 64, 128],
                   help="bands per 128-lane row for the band engine (default 8)")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    import torch

    from .config import ToneMapping
    from .render.renderer import Renderer
    from .scene.build import load_scene

    device = torch.device(args.device)
    t0 = time.time()
    ds, cam, desc = load_scene(args.scene, device=device,
                               intersector=args.intersector)
    if args.res is not None:
        cam = cam.replace(width=args.res[0], height=args.res[1])
    if args.band_g is not None:
        ds = ds.replace(band_g=args.band_g)
    r = Renderer(ds=ds, cam=cam, desc=desc, device=device)
    print(f"[scene loaded in {time.time() - t0:.1f}s: {ds.num_triangles} "
          f"tris, {ds.n_area_lights} area lights, {cam.width}x{cam.height}, "
          f"engine {ds.intersector}, device {device}]")

    s = r.settings
    s.tone_mapping = {"none": ToneMapping.NONE, "filmic": ToneMapping.FILMIC,
                      "aces": ToneMapping.ACES}[args.tonemap]
    if args.depth is not None:
        s.trace_depth = args.depth
    spp = args.spp or r.state.iterations
    print(f"[rendering {spp} spp, depth={s.trace_depth}]")

    t0 = time.time()
    for i in range(spp):
        r.step()
        if (i + 1) % 16 == 0 or i == 0:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.time() - t0
            print(f"  [{i + 1}/{spp} spp, {dt / (i + 1) * 1e3:.1f} ms/frame avg]")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    total = time.time() - t0
    print(f"[done: {total:.2f}s total, {total / spp * 1e3:.2f} ms/frame]")
    path = r.save(args.out)
    print(f"[saved {path}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
