"""Command-line entry point of the port.

``python -m radish_pt_tpu_torch SCENEFILE.txt --device cuda`` loads the
scene, renders the scene's ``Sample`` count (or ``--spp``) of frames on the
device — full-MIS path tracing, direct lighting, ReSTIR DI, the G-buffer
preview or the BVH traversal heatmap (``--tracer``), optionally denoised
(``--denoiser``) — and saves the image: the port's form of ``python -m
radish_pt_tpu``.  ``--device`` names where everything runs; it is never
switched behind the user's back.  ``--batch-spp N`` renders the
path tracer or ReSTIR DI N frames a block (one CUDA graph a block on the
card with a capturable engine); ``--checkpoint`` / ``--resume`` write and
read the render state; ``--timing`` prints the per-pass table,
``--preview-every N`` saves an image every N frames, ``--profile DIR``
writes a ``torch.profiler`` trace, ``--debug-nans`` stops at the first
non-finite tracer output, and an ``--out`` ending in ``.hdr`` writes the
raw Radiance image.  ``--mesh TILE[xSAMPLE]`` renders the pt or restir
tracer tile-sharded over the visible CUDA devices (parallel/sharding.py)
and raises when there are too few; with ``--batch-spp`` ReSTIR's blocks
exchange the reservoirs across the tiles' seams and equal one device's.
"""

from __future__ import annotations

import argparse
import contextlib
import time

from .scene import engines


TRACERS = {"pt": "STREAMED", "direct": "DIRECT_LIGHT", "restir": "RESTIR_DI",
           "bvh": "BVH_VISUALIZE", "gbuffer": "GBUFFER_PREVIEW"}
DENOISERS = {"none": "NONE", "gaussian": "GAUSSIAN", "eaw": "EA_WAVELET",
             "svgf": "SVGF"}
REUSE = {"none": "NONE", "temporal": "TEMPORAL", "spatial": "SPATIAL",
         "both": "TEMPORAL_SPATIAL"}


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
    p.add_argument("--tracer", choices=list(TRACERS), default="pt",
                   help="tracer mode (reference Tracer enum; default pt)")
    p.add_argument("--denoiser", choices=list(DENOISERS), default="none")
    p.add_argument("--reuse", choices=list(REUSE), default="both",
                   help="ReSTIR reservoir reuse mode")
    p.add_argument("--encode-normal", action="store_true",
                   help="store G-buffer normals hemi-oct encoded as 2 floats "
                        "(DENOISER_ENCODE_NORMAL, gBuffer.h:7-13)")
    p.add_argument("--no-denoiser-split", action="store_true",
                   help="filter the path tracer's combined image instead of "
                        "its direct and indirect halves apart")
    p.add_argument("--sigmas", type=float, nargs=3, metavar=("DEPTH", "NORMAL", "LUM"),
                   default=None,
                   help="filter sigmas of the active denoiser (the reference "
                        "GUI's sliders, preview.cpp:261-267)")
    p.add_argument("--gbuffer-view", choices=["albedo", "normal", "depth", "motion"],
                   default="albedo", help="channel of --tracer gbuffer")
    p.add_argument("--animate-camera", action="store_true",
                   help="circle the camera about its start, one step a frame")
    p.add_argument("--tonemap", choices=["none", "filmic", "aces"], default="aces")
    p.add_argument("--out", default=None, help="output image path")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("--intersector",
                   choices=engines.NAMES, default=None,
                   help="intersection engine (default: plucker up to 131,072 "
                        "triangles, compact above; quad, band, dense and bvh "
                        "only by name)")
    p.add_argument("--band-g", type=int, default=None,
                   choices=[1, 2, 4, 8, 16, 32, 64, 128],
                   help="bands per 128-lane row for the band engine (default 8)")
    p.add_argument("--batch-spp", type=int, default=0,
                   help="frames a block (pt and restir tracers): one CUDA graph a "
                        "block on the card with the plucker, band, quad, dense or "
                        "bvh engine")
    p.add_argument("--mesh", default=None, metavar="TILE[xSAMPLE]",
                   help="device mesh over the visible CUDA devices, e.g. '4' (4 pixel "
                        "tiles) or '4x2' (4 tiles x 2 decorrelated sample streams); "
                        "pt and restir tracers")
    p.add_argument("--checkpoint", default=None,
                   help="write the render-state checkpoint here when done")
    p.add_argument("--resume", default=None, help="resume from a checkpoint")
    p.add_argument("--timing", action="store_true", help="print the per-pass ms table")
    p.add_argument("--preview-every", type=int, default=0,
                   help="save a preview image every N frames")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first frame whose tracer output holds a "
                        "non-finite value (before the scrub)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render loop to "
                        "DIR/trace.json")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    import torch

    from .config import Denoiser, ReservoirReuse, ToneMapping, Tracer
    from .render.renderer import Renderer
    from .scene.build import load_scene
    from .utils.timing import profiler_trace

    device = torch.device(args.device)
    mesh = None
    if args.mesh:
        from .parallel.sharding import make_mesh, parse_mesh

        n_tile, n_sample = parse_mesh(args.mesh)
        mesh = make_mesh(n_tile=n_tile, n_sample=n_sample)
        print(f"[mesh: {n_tile} tile x {n_sample} sample over "
              f"{[str(d) for row in mesh.devices for d in row]}]")
    t0 = time.time()
    ds, cam, desc = load_scene(args.scene, device=device,
                               intersector=args.intersector)
    if args.res is not None:
        cam = cam.replace(width=args.res[0], height=args.res[1])
    if args.band_g is not None:
        ds = ds.replace(band_g=args.band_g)
    r = Renderer(ds=ds, cam=cam, desc=desc, device=device, timing=args.timing, mesh=mesh)
    r.debug_nans = args.debug_nans
    print(f"[scene loaded in {time.time() - t0:.1f}s: {ds.num_triangles} "
          f"tris, {ds.n_area_lights} area lights, "
          f"{'env map, ' if ds.has_env else ''}{cam.width}x{cam.height}, "
          f"engine {ds.intersector}, device {device}]")

    s = r.settings
    s.tone_mapping = {"none": ToneMapping.NONE, "filmic": ToneMapping.FILMIC,
                      "aces": ToneMapping.ACES}[args.tonemap]
    s.tracer = getattr(Tracer, TRACERS[args.tracer])
    s.denoiser = getattr(Denoiser, DENOISERS[args.denoiser])
    s.reservoir_reuse = getattr(ReservoirReuse, REUSE[args.reuse])
    s.encode_normal = args.encode_normal
    s.denoiser_split = not args.no_denoiser_split
    s.gbuffer_view = args.gbuffer_view
    s.animate_camera = args.animate_camera
    if args.sigmas:
        if s.denoiser == Denoiser.EA_WAVELET:
            s.eaw_sig_depth, s.eaw_sig_normal, s.eaw_sig_luminance = args.sigmas
        else:
            s.svgf_sig_depth, s.svgf_sig_normal, s.svgf_sig_luminance = args.sigmas
    if args.depth is not None:
        s.trace_depth = args.depth
    if args.resume:
        r.load_checkpoint(args.resume)
        print(f"[resumed from {args.resume}: {r.state.iteration} spp accumulated]")
    spp = args.spp or r.state.iterations
    print(f"[rendering {spp} spp, tracer={args.tracer}, denoiser={args.denoiser}, "
          f"depth={s.trace_depth}]")

    batch = args.batch_spp
    if batch > 1 and args.denoiser != "none":
        print("[--batch-spp renders without the denoiser; using the "
              "per-frame loop so denoising applies]")
        batch = 0
    if batch > 1 and args.debug_nans:
        print("[--debug-nans checks each frame; using the per-frame loop]")
        batch = 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    profile = profiler_trace(args.profile) if args.profile else contextlib.nullcontext()
    if args.profile:
        print(f"[profiling -> {args.profile}/trace.json]")
    t0 = time.time()
    with profile:
        if batch > 1 and args.tracer in ("pt", "restir"):
            r.render_batched(spp, block=batch)
            print(f"[{spp} spp in blocks of {batch}, batch mode {r.batch_mode}]")
        else:
            for i in range(spp):
                r.step()
                if args.preview_every and (i + 1) % args.preview_every == 0:
                    p = r.save(f"{r.state.image_name}_preview_{i + 1}.png")
                    print(f"  [{i + 1}/{spp}] preview -> {p}")
                elif (i + 1) % 16 == 0 or i == 0:
                    sync()
                    dt = time.time() - t0
                    print(f"  [{i + 1}/{spp} spp, {dt / (i + 1) * 1e3:.1f} ms/frame avg]")
        sync()
    total = time.time() - t0
    print(f"[done: {total:.2f}s total, {total / spp * 1e3:.2f} ms/frame]")
    if args.checkpoint:
        print(f"[checkpoint -> {r.save_checkpoint(args.checkpoint)}]")
    if args.timing:
        print(r.timer.table())
    path = r.save(args.out)
    print(f"[saved {path}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
