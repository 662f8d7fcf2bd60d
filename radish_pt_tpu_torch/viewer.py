"""Interactive rendering shell over the port's ``Renderer``: the port of
``radish_pt_tpu/viewer.py``, the terminal stand-in for the reference's
GLFW + ImGui preview (``preview.cpp``, ``main.cpp:204-284``).

Each command changes live settings or the camera (resetting the
accumulation, like ``State::camChanged``), renders a burst of frames on
the device, writes ``preview.png`` and prints the live stats the
reference's ImGui panel shows.

Run:  python -m radish_pt_tpu_torch.viewer SCENE.txt [--res W H] [--device cuda]
      [--spp-per-step N] [--http PORT] [--mesh TILE[xSAMPLE]]

Commands (reference key bindings, keyboard-ized):
  w/s/a/d/q/e   move camera (forward/back/left/right/down/up)
  h/l           yaw left/right     j/k  pitch down/up
  t             cycle tracer (pt -> direct -> restir -> bvh -> gbuffer)
  n             cycle denoiser (none -> gaussian -> eaw -> svgf)
  m             cycle tonemap (none -> filmic -> aces)
  g             cycle g-buffer view (albedo/normal/depth/motion)
  v             cycle denoiser AOV preview (composed/input/output
                direct+indirect/moments/variance — preview.cpp:254-276)
  r             reset accumulation   o    toggle accumulate
  fov D | aperture R | focal D | depth N   live camera / depth params
  <enter>       render another burst
  p [path]      save PNG        c [path]  save checkpoint
  i             print stats     x         quit (saves like Esc in the ref)
"""

from __future__ import annotations

import time

import numpy as np

from .config import Denoiser, ToneMapping, Tracer

TRACERS = [("pt", Tracer.STREAMED), ("direct", Tracer.DIRECT_LIGHT),
           ("restir", Tracer.RESTIR_DI), ("bvh", Tracer.BVH_VISUALIZE),
           ("gbuffer", Tracer.GBUFFER_PREVIEW)]
MESH_TRACERS = TRACERS[0:1] + TRACERS[2:3]  # mesh mode runs pt and restir
DENOISERS = [("none", Denoiser.NONE), ("gaussian", Denoiser.GAUSSIAN),
             ("eaw", Denoiser.EA_WAVELET), ("svgf", Denoiser.SVGF)]
TONEMAPS = [("none", ToneMapping.NONE), ("filmic", ToneMapping.FILMIC),
            ("aces", ToneMapping.ACES)]
GVIEWS = ["albedo", "normal", "depth", "motion"]
# keys that move the camera (right, up, view; in steps) and turn it (yaw,
# pitch; in degrees)
MOVES = {"w": (0, 0, 1), "s": (0, 0, -1), "a": (-1, 0, 0), "d": (1, 0, 0),
         "q": (0, -1, 0), "e": (0, 1, 0)}
TURNS = {"h": (-5.0, 0.0), "l": (5.0, 0.0), "j": (0.0, -5.0), "k": (0.0, 5.0)}


def tracers_of(r) -> list:
    """(name, tracer) pairs the renderer cycles through."""
    return MESH_TRACERS if r.mesh is not None else TRACERS


def name_of(pairs, value) -> str:
    return next(n for n, v in pairs if v == value)


def cycle(pairs, value):
    """The value after ``value`` in (name, value) ``pairs``."""
    values = [v for _, v in pairs]
    return values[(values.index(value) + 1) % len(values)]


def move_step(r) -> float:
    """The camera's step: 2% of the scene's extent, plus 0.1."""
    v = r.ds.tri_v.reshape(-1, 3)
    return float((v.amax(0) - v.amin(0)).norm()) * 0.02 + 0.1


def move(r, dx=0.0, dy=0.0, dz=0.0) -> None:
    """Move the camera along its right / up / view axes."""
    cam = r.cam
    axes = [a.cpu().numpy() for a in (cam.position, cam.right, cam.up, cam.view)]
    r.update_camera(position=axes[0] + axes[1] * dx + axes[2] * dy + axes[3] * dz)


def rotate(r, dyaw=0.0, dpitch=0.0) -> None:
    r.update_camera(rotation=r.cam.rotation.cpu().numpy() + np.array([dyaw, dpitch, 0.0]))


def stats_line(r) -> str:
    s = r.settings
    return (f"iter {r.state.iteration} | tracer {name_of(TRACERS, s.tracer)} | "
            f"denoiser {name_of(DENOISERS, s.denoiser)} | "
            f"tonemap {name_of(TONEMAPS, s.tone_mapping)} | {r.ds.num_triangles} tris, "
            f"BVH {r.ds.bvh_packed.shape[0] // 6} nodes | intersector {r.ds.intersector}")


def build_renderer(args):
    """The ``Renderer`` of ``args`` (scene, --res, --device, --mesh,
    --timing, --tracer)."""
    from .render.renderer import Renderer
    from .scene.build import load_scene

    mesh = None
    if args.mesh:
        from .parallel.sharding import make_mesh, parse_mesh

        n_tile, n_sample = parse_mesh(args.mesh)
        mesh = make_mesh(n_tile=n_tile, n_sample=n_sample)
    ds, cam, desc = load_scene(args.scene, device=args.device)
    if args.res:
        cam = cam.replace(width=args.res[0], height=args.res[1])
    r = Renderer(ds=ds, cam=cam, desc=desc, device=args.device, timing=args.timing,
                 mesh=mesh)
    if args.tracer:
        r.settings.tracer = dict(TRACERS)[args.tracer]
        r.settings.use_reservoir = args.tracer == "restir"
    return r


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="radish_pt_tpu_torch.viewer")
    ap.add_argument("scene")
    ap.add_argument("--res", type=int, nargs=2, metavar=("W", "H"), default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--spp-per-step", type=int, default=4)
    ap.add_argument("--spp-per-frame", type=int, default=4,
                    help="frames advanced per displayed frame in --http mode (ReSTIR "
                         "rides the batched path; 1 = one frame a display)")
    ap.add_argument("--timing", action="store_true", help="per-pass ms table")
    ap.add_argument("--tracer", default=None, choices=[n for n, _ in TRACERS],
                    help="initial tracer mode")
    ap.add_argument("--preview", default="preview.png")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve a browser live preview (MJPEG stream + key/mouse "
                         "commands) instead of the terminal REPL (0: any free port)")
    ap.add_argument("--mesh", default=None, metavar="TILE[xSAMPLE]",
                    help="device mesh over the visible CUDA devices (see --mesh of "
                         "python -m radish_pt_tpu_torch)")
    args = ap.parse_args(argv)
    r = build_renderer(args)

    if args.http is not None:
        from .webviewer import serve

        return serve(r, port=args.http, spp_per_frame=args.spp_per_frame)

    step = move_step(r)

    def stats():
        print(f"  [{stats_line(r)}]")
        if r.timer.times:
            print(r.timer.table(last_n=8))

    def burst(n=None):
        n = n or args.spp_per_step
        t0 = time.time()
        for _ in range(n):
            r.step()
        path = r.save(args.preview)
        print(f"  [{n} frames, {(time.time() - t0) / n * 1e3:.1f} ms/frame -> {path}]")

    def handle(cmd, arg):
        """One REPL command; returns "quit", "continue" or None (None:
        render another burst)."""
        s = r.settings
        if cmd == "x":
            print(f"[saved {r.save()}]")
            return "quit"
        if cmd in MOVES and not arg:
            move(r, *(c * step for c in MOVES[cmd]))
        elif cmd in TURNS:
            rotate(r, *TURNS[cmd])
        elif cmd == "t":
            s.tracer = cycle(tracers_of(r), s.tracer)
            r.reset_accumulation()
        elif cmd == "n":
            s.denoiser = cycle(DENOISERS, s.denoiser)
        elif cmd == "m":
            s.tone_mapping = cycle(TONEMAPS, s.tone_mapping)
        elif cmd == "g":
            s.gbuffer_view = GVIEWS[(GVIEWS.index(s.gbuffer_view) + 1) % len(GVIEWS)]
        elif cmd == "v":
            aovs = type(r).PREVIEW_AOVS
            s.preview_aov = aovs[(aovs.index(s.preview_aov) + 1) % len(aovs)]
            print(f"  [preview aov: {s.preview_aov}]")
        elif cmd == "r":
            r.reset_accumulation()
        elif cmd == "o":
            s.accumulate = not s.accumulate
            print(f"  [accumulate: {s.accumulate}]")
        elif cmd == "fov" and arg:  # the FOV slider (preview.cpp:321-323)
            r.update_camera(fov_y=float(arg))
        elif cmd == "aperture" and arg:  # preview.cpp:325-327
            r.update_camera(lens_radius=float(arg))
        elif cmd == "focal" and arg:  # preview.cpp:328
            r.update_camera(focal_dist=float(arg))
        elif cmd == "depth" and arg:  # the Max Depth input (preview.cpp:294-296)
            s.trace_depth = int(arg)
            r.reset_accumulation()
        elif cmd == "p":
            print(f"[saved {r.save(arg or None)}]")
            return "continue"
        elif cmd == "c":
            print(f"[checkpoint {r.save_checkpoint(arg or 'render.ckpt.npz')}]")
            return "continue"
        elif cmd == "i":
            stats()
            return "continue"
        elif cmd not in ("", None):
            print("  unknown command; see header for keys")
            return "continue"
        return None

    print(__doc__.split("Commands")[1])
    stats()
    burst()
    while True:
        try:
            line = input("radish> ").strip()
        except (EOFError, KeyboardInterrupt):
            line = "x"
        cmd, _, arg = line.partition(" ")
        try:
            action = handle(cmd, arg)
        except ValueError as e:  # a malformed number must not end the REPL
            print(f"  [bad argument: {e}]")
            continue
        if action == "quit":
            return 0
        if action == "continue":
            continue
        burst()
        stats()


if __name__ == "__main__":
    raise SystemExit(main())
