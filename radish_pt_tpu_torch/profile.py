"""Where a frame's device time goes: one path-traced frame under
``torch.profiler``, kernel time summed by stage.

    python -m radish_pt_tpu_torch.profile scenes/teapot.txt [--res 800] [--depth 5]

Prints the card, the frame's wall time (CUDA events, profiler off), the
device-busy time the profiler saw during a profiled frame, the share of it
spent in each stage, and the top kernels.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess

# a kernel's stage, from the first name fragment it contains (else "other")
STAGES = (
    ("closest_hit_kernel", "closest-hit kernel"),
    ("occlusion_kernel", "shadow kernel"),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="radish_pt_tpu_torch.profile")
    p.add_argument("scene")
    p.add_argument("--res", type=int, default=800)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--frames", type=int, default=2)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .render import pathtrace as pt
    from .scene.build import load_scene

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    ds, cam, _ = load_scene(args.scene, device="cuda")
    cam = cam.replace(width=args.res, height=args.res)
    for looper in range(2):  # build + warm up
        pt.path_trace(ds, cam, looper, args.depth)
    torch.cuda.synchronize()

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for k in range(args.frames):
        pt.path_trace(ds, cam, 2 + k, args.depth)
    end.record()
    end.synchronize()
    frame_ms = start.elapsed_time(end) / args.frames

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(args.frames):
            with record_function("frame"):
                pt.path_trace(ds, cam, 2 + args.frames + k, args.depth)
        torch.cuda.synchronize()
    # device-side events, less the "frame" range annotation itself
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != "frame"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / args.frames
    stages: dict = {}
    for e in kernels:
        stage = next((s for frag, s in STAGES if frag in e.key), "other")
        stages[stage] = stages.get(stage, 0.0) + e.self_device_time_total / 1e3
    name = os.path.basename(args.scene)
    print(f"{card}")
    print(f"{name} {args.res}x{args.res} depth {args.depth}: {frame_ms:.3f} ms/frame "
          f"(profiler off); device busy {busy:.3f} ms/frame under the profiler "
          f"({100 * (1 - busy / frame_ms):.1f}% idle against the unprofiled frame)")
    for stage, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {stage:20s} {ms / args.frames:9.3f} ms/frame  "
              f"{100 * ms / args.frames / max(busy, 1e-9):5.1f}% of busy")
    if ds.cluster_bounds is not None:
        # the culling prepass runs before each of the frame's 2*depth+1
        # sweeps; its ops fall under "other" above
        from .accel import plucker as plk
        from .sampling import rng

        idx, _ = pt._lanes(ds, cam)
        o, d, _ = pt._gen_primary(ds, cam, rng.make_sampler(0, idx), idx)
        plk.cluster_mask_words(ds.cluster_bounds, o, d, None)
        start.record()
        for _ in range(10):
            plk.cluster_mask_words(ds.cluster_bounds, o, d, None)
        end.record()
        end.synchronize()
        one = start.elapsed_time(end) / 10
        print(f"  mask prepass: {one:.3f} ms per full-frame call, ~"
              f"{one * (2 * args.depth + 1):.3f} ms/frame over "
              f"{2 * args.depth + 1} sweeps (inside \"other\")")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
