#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (radish_pt_tpu_torch) on one GPU.

Drives the port's main path — full-MIS path-traced 800x800 frames, depth 5,
through ``Renderer`` — on the card, and checks the hand-written CUDA
kernels of that path against their plain torch versions.  Phases:

1. device: the card's name and power limit, torch and CUDA versions;
2. cold start: teapot scene load + first 800x800 frame, which builds the
   kernels from ``radish_pt_tpu_torch/csrc`` with nvcc (build seconds shown);
3. kernel parity at the main path's shapes (800x800 tile-order primaries,
   one bounce wavefront with dead lanes, its NEE shadow segments);
4. the main path: cornell and teapot, loopers 0-7, with kernel launch
   counts, finite non-zero images and teapot's looper-7 mean radiance
   against the reference's 800x800 golden;
5. a 128x128 teapot frame through the kernels against the plain sweeps;
6. timing with CUDA events: ms/frame and Mrays/s per scene, each kernel
   against its plain version.

Prints a JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit).
Needs one CUDA device; imports no jax.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RES = 800
DEPTH = 5
# mean radiance of the looper-7 frame at 800x800, depth 5 (bench.py
# MEAN_GOLDEN, measured on the reference)
MEAN_GOLDEN = {"cornell": 1.00752, "teapot": 0.43335}
SCENE_FILES = {"cornell": "cornell_box.txt", "teapot": "teapot.txt"}
KERNEL_SOURCE = "radish_pt_tpu_torch/csrc/plucker.cu"
REPLACES = {
    "plucker_closest_hit": "radish_pt_tpu/accel/pallas_kernels.py:344",
    "plucker_occlusion": "radish_pt_tpu/accel/pallas_kernels.py:463",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "radish_pt_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain sweeps: full f32

    from radish_pt_tpu_torch.accel import _build
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.sampling import rng
    from radish_pt_tpu_torch.scene import device_scene as dsc
    from radish_pt_tpu_torch.scene.build import load_scene

    assert "jax" not in sys.modules
    dev = torch.device("cuda")

    # ---- 1. device ----
    card = gpu_name_and_power()
    log(card)  # name, power limit: the figure every timing below rests on
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # ---- 2. cold start: scene load + first frame, including the build ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scenes = {}
    ds, cam, _ = load_scene(os.path.join(REPO, "scenes", SCENE_FILES["teapot"]),
                            device=dev)
    cam = cam.replace(width=RES, height=RES)
    t_load = time.perf_counter() - t0
    d, i = pt.path_trace(ds, cam, 0, DEPTH)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    build_s = _build.BUILD_SECONDS.get("plucker")
    scenes["teapot"] = (ds, cam)
    log(f"[build] csrc/plucker.cu -> {os.path.relpath(_build.library_path('plucker'), REPO)}"
        f" in {build_s if build_s is None else round(build_s, 2)} s "
        f"(None: reused a library built before this run)")
    log(f"[cold start] teapot: scene load {t_load:.2f} s, load + first "
        f"{RES}x{RES} frame (build included) {cold_s:.2f} s")
    ds, cam, _ = load_scene(os.path.join(REPO, "scenes", SCENE_FILES["cornell"]),
                            device=dev)
    scenes["cornell"] = (ds, cam.replace(width=RES, height=RES))

    # ---- 3. kernel parity at the main path's shapes ----
    ds, cam = scenes["teapot"]
    sub = ds.cluster_sub
    idx, _ = pt._lanes(ds, cam)  # tile-order lanes
    sampler = rng.make_sampler(0, idx)
    ray_o, ray_d, sampler = pt._gen_primary(ds, cam, sampler, idx)
    feats_p = plk.plucker_features(ray_o, ray_d, ds.sweep_center)
    mask_p = plk.cluster_mask_words(ds.cluster_bounds, ray_o, ray_d, None)
    it = dsc.intersect(ds, ray_o, ray_d)
    # one bounce: NEE shadow segments + the extension wavefront
    mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
    active = (it.prim_id >= 0) & (mat.mtype != dsc.MAT_LIGHT)
    wo = -ray_d
    norm = torch.where(((norm * wo).sum(-1) < 0)[..., None], -norm, norm)
    r4, sampler = rng.sample_4d(ds.sobol, sampler)
    _, wi, dist, pdf = dsc.sample_direct_light_no_vis(ds, it.pos, r4)
    ok = active & (pdf > 0) & ((norm * wi).sum(-1) > 0)
    x = it.pos
    y = torch.where(ok[..., None], it.pos + wi * dist[..., None], it.pos)
    so, sd_, stm = plk.segment_rays(x, y)
    feats_s = plk.plucker_features(so, sd_, ds.sweep_center)
    mask_s = plk.cluster_mask_words(ds.cluster_bounds, so, sd_, stm)
    from radish_pt_tpu_torch.bsdf import materials as bsdf

    r3, sampler = rng.sample_3d(ds.sobol, sampler)
    samp = bsdf.bsdf_sample(mat, norm, wo, r3, types=ds.mat_types)
    active = active & ~bsdf.is_invalid(samp.type) & (samp.pdf >= 1e-8)
    eo = it.pos + samp.dir * 1e-5
    tmax = torch.where(active, plk.FLT_MAX, -plk.FLT_MAX)
    feats_e = plk.plucker_features(eo, samp.dir, ds.sweep_center)
    mask_e = plk.cluster_mask_words(ds.cluster_bounds, eo, samp.dir, tmax)
    stm = stm.contiguous()
    log(f"[parity] teapot {ds.num_triangles} stored triangles, "
        f"{ds.cluster_bounds.shape[0]} clusters of {sub}; primaries "
        f"{feats_p.shape[0]}, extension rays live {int(active.sum())}, "
        f"shadow segments live {int(ok.sum())}")

    results = {}
    max_err = {"plucker_closest_hit": 0.0, "plucker_occlusion": 0.0}
    for what, feats, mask, live in (("primary", feats_p, mask_p, None),
                                    ("extension", feats_e, mask_e, active)):
        pk, dk = plk.closest_hit_cuda(ds.sweep_coeffs, feats, mask, sub)
        pp, dp = plk.closest_hit_plain(ds.sweep_coeffs, feats, mask, sub)
        torch.cuda.synchronize()
        lanes = torch.ones_like(pk, dtype=torch.bool) if live is None else live
        diff = (pk != pp) & lanes
        n_diff, n_lanes = int(diff.sum()), int(lanes.sum())
        near_tie = torch.abs(dk - dp) <= 1e-4 * torch.abs(dp)
        agree = (pk == pp) & (pp >= 0) & lanes
        err = float(torch.abs(dk - dp)[agree].max()) if bool(agree.any()) else 0.0
        max_err["plucker_closest_hit"] = max(max_err["plucker_closest_hit"], err)
        log(f"[parity] closest hit, {what}: {n_diff} / {n_lanes} prim ids "
            f"differ ({n_diff / max(n_lanes, 1):.2e}), all near-ties: "
            f"{bool(near_tie[diff].all())}; hits {int(agree.sum())}, "
            f"max |dist err| {err:.3e}")
        assert n_diff <= 1e-4 * n_lanes, "closest-hit prim parity"
        assert bool(near_tie[diff].all()), "a prim mismatch is not a near-tie"
        results[f"closest_{what}"] = (feats, mask)
    ok_k = plk.occlusion_cuda(ds.sweep_coeffs, feats_s, stm, mask_s, sub)
    ok_p = plk.occlusion_plain(ds.sweep_coeffs, feats_s, stm, mask_s, sub)
    torch.cuda.synchronize()
    n_diff = int((ok_k != ok_p).sum())
    max_err["plucker_occlusion"] = float((ok_k != ok_p).any())
    log(f"[parity] occlusion, NEE segments: {n_diff} / {ok_k.numel()} bits "
        f"differ; occluded {int(ok_p.sum())} of {int(ok.sum())} live")
    assert n_diff <= 1e-4 * ok_k.numel(), "occlusion parity"

    # ---- 4. the main path ----
    plk.reset_counts()
    means = {}
    for name in ("cornell", "teapot"):
        ds, cam = scenes[name]
        r = Renderer(ds=ds, cam=cam, desc=None, device=dev)
        r.settings.trace_depth = DEPTH
        for _ in range(8):  # loopers 0-7
            r.step()
        img = r.current_image()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(img).all()), f"{name}: non-finite pixels"
        assert float(img.mean()) > 0.0, f"{name}: black image"
        log(f"[main path] {name}: {RES}x{RES}, depth {DEPTH}, 8 spp accumulated,"
            f" mean (compressed) {float(img.mean()):.5f}")
    launches = dict(plk.LAUNCHES)
    plain_calls = dict(plk.PLAIN_CALLS)
    log(f"[main path] kernel launches {launches}, plain-version calls {plain_calls}")
    assert launches["closest_hit"] > 0 and launches["occlusion"] > 0
    assert plain_calls == {"closest_hit": 0, "occlusion": 0}
    for name in ("cornell", "teapot"):
        ds, cam = scenes[name]
        d7, i7 = pt.path_trace(ds, cam, 7, DEPTH)
        means[name] = float((d7 + i7).mean())
        drift = means[name] / MEAN_GOLDEN[name] - 1.0
        log(f"[main path] {name} looper-7 mean radiance {means[name]:.5f} vs "
            f"golden {MEAN_GOLDEN[name]:.5f}: drift {drift * 100:+.3f}%")
    assert abs(means["teapot"] / MEAN_GOLDEN["teapot"] - 1.0) < 0.01, \
        "teapot mean radiance drifted more than 1%"

    # ---- 5. kernel path against plain path, 128x128 teapot ----
    ds, cam = scenes["teapot"]
    small = cam.replace(width=128, height=128)
    d, i = pt.path_trace(ds, small, 0, DEPTH)
    dp, ip = pt.path_trace(ds.replace(intersector="plucker_plain"), small, 0, DEPTH)
    mad = float(torch.abs((d + i) - (dp + ip)).mean())
    log(f"[kernel vs plain path] teapot 128x128 mean |pixel diff| {mad:.3e}")
    assert mad < 2e-3

    # ---- 6. timing (CUDA events) ----
    for name in ("cornell", "teapot"):
        ds, cam = scenes[name]
        loopers = iter(range(8, 10_000))

        def block():  # back-to-back frames, one sync: as bench.py times
            for _ in range(4):
                pt.path_trace(ds, cam, next(loopers), DEPTH)

        ms = cuda_ms(block, reps=3) / 4
        mrays = RES * RES * (1 + 2 * DEPTH) / (ms * 1e-3) / 1e6
        log(f"[timing] {name} {RES}x{RES} depth {DEPTH} 1 spp: {ms:.3f} ms/frame"
            f" (median of 3 blocks of 4 frames), {mrays:.2f} Mrays/s ({card})")
    ds, _ = scenes["teapot"]
    kernel_ms = {}
    for what in ("primary", "extension"):
        feats, mask = results[f"closest_{what}"]
        k = cuda_ms(lambda: plk.closest_hit_cuda(ds.sweep_coeffs, feats, mask, sub), 5)
        p = cuda_ms(lambda: plk.closest_hit_plain(ds.sweep_coeffs, feats, mask, sub), 1)
        kernel_ms[f"closest_{what}"] = (k, p)
        log(f"[timing] closest hit, teapot {what} wavefront: kernel {k:.3f} ms,"
            f" plain {p:.3f} ms")
    k = cuda_ms(lambda: plk.occlusion_cuda(ds.sweep_coeffs, feats_s, stm, mask_s, sub), 5)
    p = cuda_ms(lambda: plk.occlusion_plain(ds.sweep_coeffs, feats_s, stm, mask_s, sub), 1)
    kernel_ms["occlusion"] = (k, p)
    log(f"[timing] occlusion, teapot NEE segments: kernel {k:.3f} ms, plain {p:.3f} ms")

    print(json.dumps({"kernels": [
        {"name": "plucker_closest_hit", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["plucker_closest_hit"],
         "launches": launches["closest_hit"],
         "max_abs_err": max_err["plucker_closest_hit"],
         "ms": kernel_ms["closest_primary"][0],
         "plain_ms": kernel_ms["closest_primary"][1]},
        {"name": "plucker_occlusion", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["plucker_occlusion"],
         "launches": launches["occlusion"],
         "max_abs_err": max_err["plucker_occlusion"],
         "ms": kernel_ms["occlusion"][0], "plain_ms": kernel_ms["occlusion"][1]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
