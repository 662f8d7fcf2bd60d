"""Where a frame's device time goes: one frame under ``torch.profiler``,
kernel time summed by stage.

    python -m radish_pt_tpu_torch.profile scenes/teapot.txt [--res 800] [--depth 5]
        [--intersector plucker|compact|quad|band|dense|bvh|brute] [--band-g 8]
        [--tracer pt|direct|restir] [--batch-spp N]
        [--schedule [--rows A B] [--device cpu|cuda]]

The frame is one ``path_trace`` call for ``--tracer pt`` (the default; the
sliced bounce loop where it is gated, with the live lanes of each
extension wavefront printed), and one ``Renderer.step`` (G-buffer, tracer,
accumulation, display) for the direct-light tracer and for ReSTIR DI (T+S
reuse, 32 candidates).  Besides the sweeps, the stages name the sort-key
kernel ("sort key") and the sorts and permutations of the lanes ("sort +
permute").

Prints the card, the frame's wall time (CUDA events, profiler off), the
device-busy time the profiler saw during a profiled frame, the share of it
spent in each stage, each sweep kernel's time per call in launch order (for
``--tracer pt`` a frame's closest hits are the primaries' and bounces
1-depth's, its shadow sweeps bounces 1-depth's), and the top kernels;
the eager mask-prepass calls a frame makes (``cluster_mask_words``,
``band_mask_words``); then, timed alone with CUDA events on the frame's
primaries, the culling stages the profiler cannot name (the quad engine's
row-mask prepass, which its closest hits read; the compact engine's sphere
operands, sphere kernel and work list; none for the Plücker and band
engines, whose kernels cull for themselves, nor for the quad shadow
kernel, which votes its rows' words itself).

With ``--schedule`` it prints instead the heatmap kernel's schedule from
its plain model (``accel/traverse.py::heatmap_warp_model``) on the
heatmap's pinhole primaries in raster order (``--rows A B``: rows A to
B - 1 of the frame, default all): a warp's steps against a lane's node
visits and a thread-a-ray warp's longest lane, and a warp's leaf steps
against a lane's leaves.  It runs on the CPU too (``--device cpu``).

With ``--batch-spp N`` (``--tracer pt`` or ``restir``) the frame is one
block of N frames through ``Renderer.run_block``: one CUDA graph replay
on the Plücker, band, quad, dense and bvh engines (``Renderer.batch_mode``),
N eager frames on the compact engine.  It then prints the block's ms and
ms a frame (CUDA events, profiler off), the device-busy time and idle
share of a profiled block (and that kernel time's share of the unprofiled
block: the profiler slows the host), the device operations a frame, and each sweep
kernel's launches a block: from the runner's replay counters and from
the kernel names in the trace.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess

from .scene import engines
from .utils import timing

# a kernel's stage, from the first name fragment it contains (else "other")
# (engine-prefixed names first: "closest_hit_kernel" is part of theirs)
STAGES = (
    ("bvh_closest_hit_kernel", "bvh closest hit"),
    ("bvh_occlusion_kernel", "bvh shadow"),
    ("bvh_heatmap_kernel", "bvh heatmap"),
    ("bvh_bin_kernel", "bvh binning"),
    ("dense_closest_hit_kernel", "dense closest hit"),
    ("dense_occlusion_kernel", "dense shadow"),
    ("quad_closest_hit_kernel", "quad closest hit"),
    ("quad_occlusion_kernel", "quad shadow"),
    ("band_closest_hit_kernel", "band closest hit"),
    ("band_occlusion_kernel", "band shadow"),
    ("sphere_flags_kernel", "sphere prepass kernel"),
    ("compact_closest_hit_kernel", "compact closest hit"),
    ("compact_occlusion_kernel", "compact shadow"),
    ("closest_hit_kernel", "closest-hit kernel"),
    ("occlusion_kernel", "shadow kernel"),
    ("signature_key_kernel", "sort key"),
    ("ris_candidates_kernel", "ReSTIR candidate RIS"),
    ("vertex_kernel", "path vertex (NEE, BSDF sample)"),
    ("surface_kernel", "hit surface, material, accounting"),
    # the sorts of the wavefront's keys (any kernel named for sorting:
    # cub's radix sort, torch's small-segment sorts) and the gathers and
    # scatters that permute its lanes (index_select, index_copy_; the
    # sampler's one-element Sobol fetch is an index_select too)
    ("Sort", "sort + permute"),
    ("sort", "sort + permute"),
    ("indexSelect", "sort + permute"),
    ("index_copy", "sort + permute"),
)


def sweep_calls(prof) -> dict:
    """stage -> device ms of each launch of its kernel under ``prof``, in
    launch order, for the sweep kernels (the stages of :data:`STAGES`)."""
    import torch

    calls: dict = {}
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        stage = next((s for frag, s in STAGES if frag in e.name), None)
        if stage is not None:
            calls.setdefault(stage, []).append(e.time_range.elapsed_us() / 1e3)
    return calls


def culling_stages(ds, cam, start, end, reps: int = 10):
    """(stage, ms per call) of the culling stages that run before each
    sweep, on the frame's primaries, each timed alone with CUDA events."""
    from .accel import compact as cpt
    from .accel import plucker as plk
    from .render import pathtrace as pt
    from .sampling import rng

    prepass = engines.of(ds).prepass
    if ds.cluster_bounds is None or prepass is None:
        return []  # no culling, or the sweep kernels run the slab test themselves
    idx, _ = pt._lanes(ds, cam)
    o, d, _ = pt._gen_primary(ds, cam, rng.make_sampler(0, idx), idx)

    def timed(fn):
        fn()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    if prepass == "rows":  # the quad engine's closest hits
        return [("mask prepass", timed(
            lambda: plk.cluster_mask_words(ds.cluster_bounds, o, d, None)))]
    center, cb = ds.sweep_center, ds.cluster_bounds
    sph = cpt.sphere_operands(center, cb, o, d)
    flags, tn, _ = cpt.prepass(center, cb, o, d)
    stages = [("work list", timed(lambda: cpt.work_list(flags, tn)))]
    if cb.shape[0] > cpt.PER_RAY_PREPASS_MAX:
        stages[:0] = [("sphere operands", timed(
                          lambda: cpt.sphere_operands(center, cb, o, d))),
                      ("sphere kernel", timed(lambda: cpt.sphere_flags_cuda(*sph)))]
    else:
        stages[:0] = [("slab prepass", timed(lambda: cpt.prepass(center, cb, o, d)))]
    return stages


def heatmap_schedule(leaf_tris, bvh_packed, ray_o, ray_d) -> dict:
    """The heatmap kernel's schedule on rays ``ray_o`` / ``ray_d`` from the
    plain model, whose counts must equal the plain walk's: means of a
    warp's steps ("warp_steps"), a lane's node visits ("lane_visits"), a
    32-lane warp's longest lane ("longest_lane"), a warp's leaf steps
    ("leaf_steps") and a lane's leaves ("lane_leaves")."""
    import torch

    from .accel import traverse as trv

    st, ms = {}, {}
    want = trv.intersect_bvh_heatmap_plain(leaf_tris, bvh_packed, ray_o, ray_d, stats=st)
    counts, warp_steps = trv.heatmap_warp_model(leaf_tris, bvh_packed, ray_o, ray_d, stats=ms)
    assert torch.equal(counts, want), "the warp model's counts differ from the plain walk's"
    visits = st["visits"].double()
    pad = torch.zeros((-visits.numel()) % trv.WARP, dtype=visits.dtype, device=visits.device)
    longest = torch.cat([visits, pad]).view(-1, trv.WARP).max(1).values
    return {"warp_steps": float(warp_steps.double().mean()),
            "lane_visits": float(visits.mean()), "longest_lane": float(longest.mean()),
            "leaf_steps": float(ms["leaf_steps"].double().mean()),
            "lane_leaves": float(st["leaf_visits"].double().mean())}


def schedule_line(sc: dict) -> str:
    return (f"the warp-coherent walk's plain model takes {sc['warp_steps']:.2f} steps a warp "
            f"against {sc['lane_visits']:.2f} visits a lane "
            f"({sc['warp_steps'] / sc['lane_visits']:.3f} x) and a thread-a-ray warp's "
            f"{sc['longest_lane']:.2f} (its longest lane); {sc['leaf_steps']:.2f} leaf steps a "
            f"warp against {sc['lane_leaves']:.3f} leaves a lane")


def profile_schedule(args) -> int:
    """``--schedule``: the heatmap kernel's schedule on the frame's
    primaries (see the module's docstring)."""
    import torch

    from .scene import camera as cam_mod
    from .scene.build import load_scene

    ds, cam, _ = load_scene(args.scene, device=args.device, intersector="bvh")
    cam = cam.replace(width=args.res, height=args.res)
    y0, y1 = args.rows or (0, args.res)
    idx = torch.arange(y0 * args.res, y1 * args.res, dtype=torch.int32, device=args.device)
    ray_o, ray_d = cam_mod.pinhole_rays(cam, idx % args.res, idx // args.res)
    sc = heatmap_schedule(ds.leaf_tris, ds.bvh_packed, ray_o, ray_d)
    print(f"{args.scene} (bvh) {args.res}x{args.res}, rows {y0}-{y1 - 1}, {idx.numel()} "
          f"pinhole primaries in raster order: {schedule_line(sc)}")
    return 0


def profile_block(args, ds, cam, card) -> int:
    """``--batch-spp``: one block of ``args.batch_spp`` frames, timed with
    the profiler off, then profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .config import Settings, Tracer

    if args.tracer == "direct":
        raise SystemExit("--batch-spp runs the pt and restir tracers")
    from .render.renderer import Renderer

    block = args.batch_spp
    tracer = Tracer.RESTIR_DI if args.tracer == "restir" else Tracer.STREAMED
    r = Renderer(ds=ds, cam=cam, settings=Settings(tracer=tracer, trace_depth=args.depth),
                 device="cuda")
    for _ in range(2):  # build, warm up, capture
        run = r.run_block(block)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.frames):
        r.run_block(block)
    end.record()
    end.synchronize()
    block_ms = start.elapsed_time(end) / args.frames
    replays = run.replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        r.run_block(block)
        end.record()
        torch.cuda.synchronize()
    profiled_ms = start.elapsed_time(end)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    traced = {}
    for e in kernels:
        stage = next((st for frag, st in STAGES if frag in e.name), None)
        if stage is not None:
            traced[stage] = traced.get(stage, 0) + 1
    print(card)
    print(f"{os.path.basename(args.scene)} {args.res}x{args.res} tracer {args.tracer} "
          f"depth {args.depth}, blocks of {block} ({ds.intersector}, batch mode "
          f"{r.batch_mode}, {run.replays - replays} replay(s) profiled): "
          f"{block_ms:.3f} ms a block, {block_ms / block:.3f} ms/frame (profiler off); "
          f"device busy {busy:.3f} ms of a {profiled_ms:.3f} ms profiled block "
          f"({100 * (1 - busy / profiled_ms):.1f}% idle; the same kernel time is "
          f"{100 * busy / block_ms:.1f}% of the unprofiled block), "
          f"{len(kernels) / block:.0f} device operations a frame")
    print(f"  sweep launches a block: replay counters "
          f"{timing.under(run.counts_per_replay, 'launch')}, trace {traced}")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="radish_pt_tpu_torch.profile")
    p.add_argument("scene")
    p.add_argument("--res", type=int, default=800)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--intersector",
                   choices=engines.NAMES, default=None, help="engine (default: by scene size)")
    p.add_argument("--tracer", choices=["pt", "direct", "restir"], default="pt")
    p.add_argument("--band-g", type=int, default=None,
                   help="bands per 128-lane row for the band engine (default 8)")
    p.add_argument("--batch-spp", type=int, default=0,
                   help="profile one block of N frames (Renderer.run_block)")
    p.add_argument("--schedule", action="store_true",
                   help="print the heatmap kernel's schedule from its plain model")
    p.add_argument("--rows", type=int, nargs=2, metavar=("A", "B"),
                   help="--schedule: rows A to B - 1 of the frame")
    p.add_argument("--device", default="cuda", help="--schedule: cuda or cpu")
    args = p.parse_args(argv)
    if args.schedule:
        return profile_schedule(args)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .config import Settings, Tracer
    from .render import pathtrace as pt
    from .render.renderer import Renderer
    from .scene.build import load_scene

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    ds, cam, _ = load_scene(args.scene, device="cuda", intersector=args.intersector)
    cam = cam.replace(width=args.res, height=args.res)
    if args.band_g is not None:
        ds = ds.replace(band_g=args.band_g)
    if args.batch_spp:
        return profile_block(args, ds, cam, card)
    loop_stats: dict = {}
    if args.tracer == "pt":
        def frame(looper):
            pt.path_trace(ds, cam, looper, args.depth, stats=loop_stats)
    else:
        tracer = Tracer.RESTIR_DI if args.tracer == "restir" else Tracer.DIRECT_LIGHT
        r = Renderer(ds=ds, cam=cam, settings=Settings(tracer=tracer), device="cuda")

        def frame(looper):  # the renderer keeps its own looper
            r.step()
    for looper in range(2):  # build + warm up
        frame(looper)
    torch.cuda.synchronize()

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    tally = timing.Tally()
    start.record()
    for k in range(args.frames):
        frame(2 + k)
    end.record()
    end.synchronize()
    frame_ms = start.elapsed_time(end) / args.frames
    prepass = {k: v / args.frames for k, v in tally("prepass.plucker").items()}
    prepass.update({k: v / args.frames for k, v in tally("prepass.band").items()})

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(args.frames):
            with record_function("frame"):
                frame(2 + args.frames + k)
        torch.cuda.synchronize()
    # device-side events, less the "frame" range annotation itself
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != "frame"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / args.frames
    launches = sum(e.count for e in kernels) / args.frames
    stages: dict = {}
    for e in kernels:
        stage = next((s for frag, s in STAGES if frag in e.key), "other")
        stages[stage] = stages.get(stage, 0.0) + e.self_device_time_total / 1e3
    name = os.path.basename(args.scene)
    print(f"{card}")
    print(f"{name} {args.res}x{args.res} tracer {args.tracer} depth {args.depth}: "
          f"{frame_ms:.3f} ms/frame "
          f"(profiler off); device busy {busy:.3f} ms/frame under the profiler "
          f"({100 * (1 - busy / frame_ms):.1f}% idle against the unprofiled frame), "
          f"{launches:.0f} device operations a frame; eager prepass calls a frame "
          f"{prepass}")
    if loop_stats:
        live = loop_stats.get("live")
        print(f"  bounce loop: {loop_stats['loop']}" + ("" if live is None else (
            f", slices of {loop_stats['slice']} lanes; live lanes of the extension "
            f"wavefronts, bounce 1 first: " + ", ".join(
                f"{n} ({100 * n / (args.res * args.res):.1f}%)" for n in live))))
    for stage, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {stage:20s} {ms / args.frames:9.3f} ms/frame  "
              f"{100 * ms / args.frames / max(busy, 1e-9):5.1f}% of busy")
    for stage, ms in sweep_calls(prof).items():
        per = len(ms) // args.frames
        print(f"  {stage} ms per call, {per} a frame, frame by frame: " + "; ".join(
            ", ".join(f"{x:.3f}" for x in ms[k * per:(k + 1) * per])
            for k in range(args.frames)))
    # closest hits and shadow sweeps a frame (ReSTIR: the G-buffer's, the
    # primaries' and the winners' shadow test); on the quad engine the
    # shadow kernel votes its words itself: the prepass runs before the
    # closest hits alone
    sweeps = {"pt": 2 * args.depth + 1, "direct": 2, "restir": 3}[args.tracer]
    if engines.of(ds).prepass == "rows":
        sweeps = {"pt": args.depth + 1, "direct": 1, "restir": 2}[args.tracer]
    for stage, ms in culling_stages(ds, cam, start, end):
        # each runs before every one of the frame's sweeps; all but the
        # sphere kernel fall under "other" above
        print(f"  {stage:20s} {ms:9.3f} ms per full-frame call, ~{ms * sweeps:.3f} "
              f"ms/frame over {sweeps} sweeps")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
