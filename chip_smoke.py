#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (radish_pt_tpu_torch) on one GPU.

Drives the port's main paths through ``Renderer`` on the card, at
800x800: full-MIS path-traced frames, depth 5 — cornell and teapot on the
Plücker engine, teapot_hires on the compact work-list engine (and on the
Plücker engine its size picks), teapot on the quad engine, teapot_hires on
the band engine, cornell and teapot on the dense engine, cornell, teapot
and teapot_hires on the bvh engine (the MTBVH walk); the other four
shipped scenes on the Plücker engine: glass (depth 8, dielectric, a thin
lens with a star-shaped aperture mask), env_teapot (an env map its only
light), many_light (72 emitters) and textured (image maps) — and the
interactive direct-lighting path on cornell's dense engine: ReSTIR DI (the
G-buffer, 32-candidate RIS, temporal and spatial reuse; also on the
Plücker engine, and with the camera animated), the direct tracer with SVGF,
and the path tracer with split SVGF — and the BVH heatmap tracer.  The
path tracer's frames run the sliced bounce loop on the scenes with
clusters and at least 2,000 triangles, their divergent wavefronts sorted on
the cluster-signature key (``csrc/sort_key.cu``).  Checks the hand-written
CUDA kernels of those paths against their plain torch versions.  Phases:

1. device: the card's name and power limit, torch and CUDA versions;
2. cold start: the seven kernel sources built with nvcc at once, and the
   native host library (``radish_pt_tpu_torch/native``) with g++ beside
   them (seconds shown, and each kernel's registers and spills as ptxas
   reports them), then teapot and teapot_hires (compact) loaded and rendered once
   at 800x800, and the quad, band, dense, bvh and other shipped scenes
   loaded;
3. kernel parity at the main paths' shapes (800x800 primaries, one bounce
   wavefront with dead lanes, its NEE shadow segments): the Plücker sweeps
   on teapot, on teapot_hires' Plücker build, on glass (its primaries
   through the masked thin lens, its bounce-1 rays refracted into the
   glass sphere) and on env_teapot (its bounce-1 NEE segments to the env
   map, 1e6 long), against the plain
   versions culled per 32-lane warp as the kernels cull (and, logged, the
   lanes that differ from the plain versions culled per 128-lane row); the
   quad sweeps on teapot (the shadow kernel, which votes its rows' words
   itself, against the plain version on the row-mask prepass's words);
   the sphere prepass, the compact sweeps and the band sweeps (8 bands a
   row; both kernels vote their bands' words themselves, held against the
   plain versions on the band-mask prepass's words) on teapot_hires; the
   dense sweeps on cornell and teapot, bit for bit; the three BVH walks
   (closest hit, heatmap, shadow) on teapot and teapot_hires, ids, t,
   barycentrics, counts and shadow bits bit for bit, the closest hit also
   with the frame's dead-lane range and on a wavefront that interleaves
   the six direction classes lane by lane (the heatmap on the primaries,
   the extension rays and that wavefront), and the binning kernel's
   classes against ``bin_by_dir_class``, with the per-thread walk's warp
   efficiency in raster and in class-binned order and the heatmap
   kernel's schedule from its plain model (a warp's steps against a
   lane's visits); for the Plücker
   sweeps, the compact sweeps, the band sweeps and the quad shadow sweep
   also the (lane, triangle) pairs their wavefronts need when culled per
   row (group, band), per warp and per lane; the sort-key kernel equal to
   its plain version on every lane of teapot's and teapot_hires'
   (Plücker: 115 super-clusters; compact: 1,755 clusters paired to 220)
   primaries, bounce-1 extension rays (the dead bit) and NEE segments
   (bounded at their end), and in the band engine's count-major form;
   ReSTIR's candidate RIS kernel against its plain loop, bit for bit, on
   cornell (32 and 16 candidates, the hash sampler), teapot, env_teapot,
   many_light and glass, timed beside it with its bound, and its one launch
   a replayed ReSTIR frame; the path tracer's vertex kernel against its
   plain version, every output bit for bit, on the bounce-1 and bounce-3
   wavefronts of cornell (also with the hash sampler), the benchmark's
   cornell_teapot, glass, env_teapot, many_light and textured, timed beside
   it with its bound (and the whole vertex, its sorted shadow test and
   resolve included, replayed), and its one launch a bounce of a replayed
   block; the closest hit's surface kernel against its plain version,
   every output bit for bit, with the wavefront's accounting and without,
   on the primaries and bounce-1 extension rays of cornell and the
   benchmark's cornell_teapot, timed beside it with its bound, and its
   launches (one for the primaries and one a bounce of a replayed block,
   two a replayed ReSTIR frame);
4. the main paths, loopers 0-7, each with the launch counts of its kernels
   set to 0 just before and read just after (a frame of depth d: d + 1
   closest hits, d shadow sweeps, no plain call; on Plücker and band no
   mask prepass, on quad the closest hits' 6 row-mask prepass calls; a
   ReSTIR frame one candidate RIS launch),
   finite non-zero images, and
   looper-7 mean radiance within 2e-3 (bench.py's bound) of each scene's
   800x800 golden, the JAX package's exact-f32 CPU mean (the teapot_hires
   engines also within 0.2% of each other, band and compact within
   0.05%); the direct-lighting paths' 8-frame means within 2e-3 of the JAX
   package's 800x800 goldens (ReSTIR on Plücker within 0.2% of dense), and
   the animated ReSTIR run's share of valid motion and of accepted
   temporal neighbours; the BVH heatmap tracer (``Renderer``, 800x800) on
   teapot and teapot_hires, one heatmap walk a frame, its image equal to
   the plain walk's; on the Plücker paths 2d + 1 sort-key launches a frame
   of depth d on a scene with clusters; then loopers 0-7 of teapot,
   env_teapot and glass through the sliced loop (as ``step()`` runs them)
   equal to the dense loop (``n_slices=0``, as a captured block runs
   them) bit for bit, with the live share of each bounce's extension
   wavefront, the looper-7 mean against its golden, and the key kernel's
   and the sorts' and permutations' device ms in a profiled frame;
5. 128x128 frames through the kernels against the plain versions (teapot
   on Plücker and quad, teapot_hires on compact and band, cornell and
   teapot on dense, teapot on bvh, cornell ReSTIR on dense); then, logged
   only, the mean
   squared error of 8 frames of the direct tracer, of ReSTIR without reuse
   and of ReSTIR with reuse against a 256-frame direct-tracer accumulation;
6. timing with CUDA events: ms/frame and Mrays/s per scene and engine, the
   ReSTIR and denoised frames, each kernel against its plain version (the
   plain version's one run in phase 3, where it is the reference), and
   each kernel's least time on the card (bound) for the same work (the
   kernels that issue only unfused f32 operations — the dense sweeps and
   the sphere prepass and the BVH walks, each operation ``__fmul_rn`` /
   ``__fadd_rn`` / ``__fsub_rn`` to stay bit-equal to its plain version —
   at the instruction rate: half the f32 peak that counts an FMA as two;
   a walk's operations are its node visits and leaf pairs, counted by the
   plain walk on the same rays; every kernel timed one call at a time,
   the BVH walks and the binning also as 10 calls back to back; the path
   tracer at 4, 8 and 16 slices a wavefront beside the dense loop (wall
   and device ms, in turns); the Plücker pair on the
   bounce-1 wavefronts sorted on their key beside the unsorted; the key
   kernel one call and 10 back to back against its instruction-rate
   bound; the heatmap kernel also as 10 calls replayed in one CUDA graph,
   its share of the bound and the plain model's warp steps beside it; with
   ``--parent DIR``, the sort-key, binning and heatmap kernels beside the
   parent checkout's (built from DIR's csrc into ``_build/parent``), the
   same inputs and the same results, one call, 10 back to back and 10
   replayed in one CUDA graph, and the heatmap tracer's frame through
   either tree's kernel, in turns: parent, this, this, parent;
7. batched frames (``Renderer.run_block``, ``step_batched_restir``): the
   ReSTIR spatial offsets computed on the card equal to the CPU's for all
   10,000 loopers x 5 neighbours; then per cell — the path tracer on
   teapot (Plücker), teapot_hires (band), teapot (quad), cornell (dense),
   teapot and teapot_hires (bvh), blocks of 4 (teapot_hires 2), each block
   one CUDA graph
   replay, and teapot_hires on the compact engine, eager; ReSTIR DI on
   cornell (dense), blocks of 8 with a camera move between — the launch
   counts set to 0 just before its two blocks and read just after, the
   blocks equal to the same frames run eagerly by ``step()`` bit for bit,
   ``batch_mode`` "graph" on the capturable engines, the sweeps a replay
   (block x (d + 1) closest hits and block x d shadow sweeps; on ReSTIR
   also block candidate RIS launches) from the
   replay counters and from a ``torch.profiler`` trace of one replay,
   and, timed with CUDA events, the batched ms/frame beside the eager
   ``step()`` frame and the device-busy share of a profiled block; then
   the benchmark's two entries on cornell at 800x800 (``run_block(4)`` of
   the path tracer, ``step_batched_restir(1)`` with the camera orbiting):
   the tracing's ``host_syncs`` a call equal to the synchronizing
   operations ``torch.cuda.set_sync_debug_mode("warn")`` reports, over 3
   calls after the first (0 and 1 a call);
8. with ``--parent DIR``: eager ``step()`` and replayed-block ms/frame of
   teapot, teapot_hires, glass, env_teapot and cornell ReSTIR for the
   checkout at DIR and for this tree, each in a subprocess of its own
   (``--frame-times``), in turns: parent, this, this, parent; then 16
   replayed blocks of 4 frames of cornell and cornell_teapot (800x800,
   depth 5, from looper 4321) by either tree, each in a subprocess of its
   own (``--frames``), their accumulations equal bit for bit;
9. the multi-device path (parallel/sharding.py), each tile of a mesh on
   this card (``make_mesh(devices=[cuda:0] * n)``), each path driven with
   its kernels' launch counts set to 0 just before and read just after:
   teapot (Plücker, the sliced loop on each tile) and cornell on 4 tiles
   against the single-device frame (cornell bit for bit, teapot under the
   JAX package's frames rule, its flipped pixels counted), the launches
   4 x (d + 1) closest hits, 4 x d shadow sweeps and 4 x (2d + 1) keys on
   teapot; a (2 tiles x 2 samples) ``pt_step_sharded`` against the mean of
   the two loopers' frames; cornell ReSTIR (dense) through
   ``Renderer(mesh=2 tiles)``, 2 frames, the rows more than 5 from the
   seam equal to one device and the seam band showing rejections; SVGF in
   mesh mode equal to SVGF on the single-device inputs; teapot's
   ``render_batched`` on 4 tiles (one CUDA graph a tile) equal to its
   ``step()`` frames; cornell ReSTIR (dense) through
   ``step_batched_restir(8)`` on 2 and on 4 tiles, a camera move between
   two blocks, the frames, reservoir and last G-buffer equal to one
   device's bit for bit (the seams exchanged), one CUDA graph over all
   tiles, its launches counted, and teapot ReSTIR (Plücker) on 4 tiles
   under the frames rule, each mesh's ms/frame beside the single-device
   replay; a world of one on NCCL (tcp on 127.0.0.1, a free
   port) equal to the in-process mesh; ``dryrun_multichip(4, [cuda:0] *
   4)``; teapot's ``frame_pair_stats`` and ``utilization``; the webviewer
   serving a card ``Renderer`` on port 0, one ``/stream`` JPEG fetched.
   The mesh frame times are printed beside the single-device ones;
10. the native host build: every shipped scene loaded on the card with
   the C++ builders and with ``RADISH_NATIVE=0`` (the numpy builders),
   every tensor of the two scenes equal bit for bit, both load times and
   teapot's and teapot_hires' cold start either way.

Prints a JSON line of per-kernel results, then the card's name and power
limit, then, as the last line, ``{"ok": true, "device": {...}}``.  Any
failure raises (non-zero exit).  Needs one CUDA device; imports no jax.

Run from the repository root:  python3 chip_smoke.py [--parent DIR]
(DIR: a ``git archive`` of the parent commit unpacked into ``_checkout/``)

``python3 chip_smoke.py --offsets-loop RUNS`` runs only the ReSTIR offsets
check's comparison, RUNS times alone, RUNS times after every kernel and a
CUDA graph capture, and RUNS times alone again, and counts the runs with a
difference (``offsets_loop``)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RES = 800
DEPTH = 5
SMALL_RES = 128  # the kernel-path against plain-path frames (phase 5)
# mean radiance of the looper-7 frame at 800x800, depth 5 (glass at 8, its
# scene file's depth): the JAX package's exact-f32 mean on a CPU, with the
# engine its CPU build picks (brute force up to 128 triangles, the BVH walk
# above), over the whole frame:
#   JAX_PLATFORMS=cpu python tests/torch_goldens.py cornell teapot many_light \
#       textured glass env_teapot teapot_hires
# (cornell 1.0424518 there, 1.0424516 as one f32 mean).  bench.py's
# MEAN_GOLDEN are the reference's TPU runs: cornell's 1.00752 in its bf16x3
# mode, which drops grazing hits; many_light's 0.17366 is 15% below the
# exact mean; glass's 0.35154 is at depth 5.  The teapot_hires frames of the
# Plücker, compact and band engines are also held to each other.
MEAN_GOLDEN = {"cornell": 1.04245, "teapot": 0.4333722, "teapot_hires": 0.4354982,
               "many_light": 0.2045663, "textured": 1.0500741, "glass": 0.3522674,
               "env_teapot": 0.6923553}
# bench.py's bound on a mean's drift from its golden (bench.py:189)
MEAN_DRIFT = 2e-3
# glass at its scene file's depth; the others at DEPTH, as bench.py renders
# them (many_light's file says 3)
SCENE_DEPTH = {"glass": 8}
ENGINE_SUFFIXES = ("_plucker", "_quad", "_band", "_dense", "_bvh")
# mean of ``Renderer.current_image()`` after loopers 0-7 of cornell at
# 800x800 on the direct-lighting paths, computed by the JAX package on a
# CPU (its brute-force engine): JAX_PLATFORMS=cpu; ds, cam, _ =
# load_scene("scenes/cornell_box.txt"); r = Renderer(ds=ds, cam=cam at
# 800x800, desc=None, settings=S); 8 x r.step(); r.current_image().mean(),
# with S = Settings(tracer=Tracer.RESTIR_DI) (T+S reuse, 32 candidates,
# clamp 20: 0.1643293), Settings(tracer=Tracer.DIRECT_LIGHT,
# denoiser=Denoiser.SVGF) (0.1584340) and Settings(tracer=Tracer.STREAMED,
# denoiser=Denoiser.SVGF, trace_depth=5) (split SVGF: 0.2697894)
PATH_GOLDEN = {"restir": 0.1643293, "direct_svgf": 0.1584340,
               "pt_split_svgf": 0.2697894}
SCENE_FILES = {"cornell": "cornell_box.txt", "teapot": "teapot.txt",
               "teapot_hires": "teapot_hires.txt", "glass": "glass.txt",
               "env_teapot": "env_teapot.txt", "many_light": "many_light.txt",
               "textured": "textured.txt"}
# the shipped scenes first rendered on the card in this script's fourth
# group: the Plücker engine their size picks
OTHER_SCENES = ("glass", "env_teapot", "many_light", "textured")
SOURCES = {"plucker": "radish_pt_tpu_torch/csrc/plucker.cu",
           "compact": "radish_pt_tpu_torch/csrc/compact.cu",
           "quad": "radish_pt_tpu_torch/csrc/quad.cu",
           "band": "radish_pt_tpu_torch/csrc/band.cu",
           "dense": "radish_pt_tpu_torch/csrc/dense.cu",
           "bvh": "radish_pt_tpu_torch/csrc/bvh.cu",
           "sort_key": "radish_pt_tpu_torch/csrc/sort_key.cu",
           "ris": "radish_pt_tpu_torch/csrc/ris.cu",
           "vertex": "radish_pt_tpu_torch/csrc/vertex.cu",
           "surface": "radish_pt_tpu_torch/csrc/surface.cu"}
REPLACES = {
    "plucker_closest_hit": "radish_pt_tpu/accel/pallas_kernels.py:344",
    "plucker_occlusion": "radish_pt_tpu/accel/pallas_kernels.py:463",
    "compact_sphere_flags": "radish_pt_tpu/accel/pallas_kernels.py:1151",
    "compact_closest_hit": "radish_pt_tpu/accel/pallas_kernels.py:1291",
    "compact_occlusion": "radish_pt_tpu/accel/pallas_kernels.py:1393",
    "quad_closest_hit": "radish_pt_tpu/accel/pallas_kernels.py:1974",
    "quad_occlusion": "radish_pt_tpu/accel/pallas_kernels.py:2058",
    "band_closest_hit": "radish_pt_tpu/accel/pallas_kernels.py:2687",
    "band_occlusion": "radish_pt_tpu/accel/pallas_kernels.py:2777",
    "dense_closest_hit": "radish_pt_tpu/accel/pallas_kernels.py:37",
    "dense_occlusion": "radish_pt_tpu/accel/pallas_kernels.py:37",
    # XLA walks of the JAX package, not Pallas bodies
    "bvh_closest_hit": "radish_pt_tpu/accel/traverse.py:408",
    "bvh_occlusion": "radish_pt_tpu/accel/traverse.py:469",
    "bvh_heatmap": "radish_pt_tpu/accel/traverse.py:570",
    # the dead-lane sort of intersect_sorted (an XLA sort)
    "bvh_bin": "radish_pt_tpu/scene/device_scene.py:354",
}
# the sort-key kernel: an XLA slab test of the JAX package (no Pallas body)
KEY_REPLACES = "radish_pt_tpu/scene/device_scene.py:547"
# (scene entry, wavefront) the key kernel's row reports; every wavefront it
# was held and timed on goes beside it
KEY_ROW = ("teapot", "extension")
# the scene each engine's kernels are timed and bounded on
KERNEL_SCENE = {"plucker": "teapot", "compact": "teapot_hires", "quad": "teapot_quad",
                "band": "teapot_hires_band", "dense": "cornell_dense", "bvh": "teapot_bvh"}
# one H100 SXM at its 700 W limit (NVIDIA's data sheet): f32 outside the
# tensor cores (an FMA counted as two flops), and device memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# f32 instructions a second: what a kernel of unfused single operations
# (__fmul_rn / __fadd_rn / __fsub_rn: the dense sweeps, the sphere
# prepass, the BVH walks) can issue
PEAK_F32_OPS_UNFUSED = PEAK_F32_FLOPS / 2
# the mesh path (phase 9): tiles a mesh, the tile count of its frames
MESH_TILES = 4
# the JAX package's frames rule for teapot's tiles against the full frame
# (tests/test_sharding.py::_assert_frames_match): a pixel off by more than
# 1e-4 in a channel is a flip; a tile takes its lanes in raster order and
# the full frame in tile order, so the 32-lane groups that share a culling
# decision differ, and a grazing ray's discrete decision may go the other
# way (PERF.md section 6); the bound is 0.01% of the 800x800 frame's pixels
FLIP_ATOL = 1e-4
FLIP_MAX = 64
FLIP_MEAN = 5e-5


# ReSTIR's candidate RIS kernel (csrc/ris.cu), held against its plain loop
# (render/restir.py::ris_plain, eager on the card) and timed at 800x800:
# (scene entry, candidates, hash sampler); the first is the main path's, the
# row of the kernels line
RIS_CASES = (("cornell", 32, False), ("cornell", 16, False), ("cornell", 32, True),
             ("teapot", 32, False), ("env_teapot", 32, False), ("many_light", 32, False),
             ("glass", 16, False))
RIS_REPLACES = ("radish_pt_tpu/render/restir.py:348, the candidate loop of restir_direct "
                "(XLA, no Pallas body)")


# the path tracer's vertex kernel (csrc/vertex.cu), held against its plain
# version (render/pathtrace.py::vertex_plain, eager on the card) on the
# bounce-1 and bounce-3 wavefronts of an 800x800 frame and timed on them:
# (scene entry, hash sampler); the first is the main path's, the row of the
# kernels line; cornell_teapot is the benchmark's scene file
VERTEX_CASES = (("cornell", False), ("cornell", True), ("cornell_teapot", False),
                ("glass", False), ("env_teapot", False), ("many_light", False),
                ("textured", False))
VERTEX_BOUNCES = (1, 3)
VERTEX_REPLACES = ("radish_pt_tpu/render/pathtrace.py:316 _nee_contrib and :345 "
                   "_bsdf_advance, but the shadow test (XLA, no Pallas body)")
CORNELL_TEAPOT = "benchmark/configs/cornell_teapot/scene.txt"
# the closest hit's surface kernel (csrc/surface.cu), held against its plain
# version (render/pathtrace.py::surface_plain, eager on the card) and timed
# on the primaries and bounce-1 extension rays of an 800x800 frame of the
# benchmark's two path-traced scenes; the first is the row of the kernels
# line
SURFACE_CASES = ("cornell", "cornell_teapot")
SURFACE_REPLACES = ("radish_pt_tpu/scene/device_scene.py's surface recovery and "
                    "get_textured_material, radish_pt_tpu/render/pathtrace.py's hit "
                    "accounting (XLA, no Pallas body)")
# the replayed frames held to the parent's bit for bit with --parent (phase
# 8): blocks of 4 frames from this looper, 800x800, depth 5
PARENT_FRAME_SCENES = {"cornell": "scenes/cornell_box.txt", "cornell_teapot": CORNELL_TEAPOT}
PARENT_FRAME_BLOCKS = 16
PARENT_FRAME_LOOPER = 4321


def log(msg: str) -> None:
    print(msg, flush=True)


def scene_of(name: str) -> str:
    """The scene file key of a scene entry ("teapot_hires_band" ->
    "teapot_hires")."""
    for suffix in ENGINE_SUFFIXES:
        name = name.removesuffix(suffix)
    return name


def depth_of(name: str) -> int:
    return SCENE_DEPTH.get(scene_of(name), DEPTH)


def gpu_name_and_power() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def restir_offsets_check(dev, log, tag: str) -> None:
    """The ReSTIR spatial offsets (``restir._shared_offset``) computed on
    the card equal to the CPU's for every looper of the Sobol table (0-9,999)
    and every neighbour (0-4).  On a difference: each step of the hash and
    disk chain on both devices for the first differing components, whether
    the card gives the same offsets a second time, and the offsets in f64,
    then the failure."""
    import torch

    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.utils import math as m

    loopers, ks = torch.arange(10_000)[:, None], torch.arange(5)
    off_cpu = torch.stack(rs._shared_offset(loopers, ks), -1)
    off_dev = torch.stack(rs._shared_offset(loopers.to(dev), ks.to(dev)), -1).cpu()
    n_diff = int((off_cpu != off_dev).sum())
    log(f"{tag} ReSTIR spatial offsets, 10000 loopers x 5 neighbours: {n_diff} of "
        f"100000 components differ between the card and the CPU")
    if n_diff == 0:
        return

    def chain(looper, k, dtype=torch.float32):
        a = (looper.to(torch.int64) * 31 + (2 * k + 1)) & m.U32
        h1 = m.utilhash(a)
        h2 = m.utilhash(h1 ^ 0x9E3779B9)
        u1, u2 = h1.to(dtype) * m.INV_2_32, h2.to(dtype) * m.INV_2_32
        r, theta = torch.sqrt(u1), m.TWO_PI * u2
        cos, sin = torch.cos(theta), torch.sin(theta)
        p = torch.stack([r * cos, r * sin], -1) * 5.0
        return {"a": a, "h1": h1, "h2": h2, "u1": u1, "u2": u2, "r": r, "theta": theta,
                "cos": cos, "sin": sin, "p": p}

    again = torch.stack(rs._shared_offset(loopers.to(dev), ks.to(dev)), -1).cpu()
    log(f"{tag} the card a second time: {int((again != off_dev).sum())} components differ "
        f"from its first result, {int((again != off_cpu).sum())} from the CPU's")
    where = (off_cpu != off_dev).any(-1).nonzero()[:8]
    lp, kk = loopers[where[:, 0], 0], ks[where[:, 1]]
    on_cpu, on_dev = chain(lp, kk), chain(lp.to(dev), kk.to(dev))
    in_f64 = torch.round(chain(lp, kk, torch.float64)["p"]).to(torch.int32)
    for i in range(len(lp)):
        steps = [f"{s} cpu {on_cpu[s][i].tolist()} card {on_dev[s][i].cpu().tolist()}"
                 for s in on_cpu if not torch.equal(on_cpu[s][i], on_dev[s][i].cpu())]
        log(f"{tag} looper {int(lp[i])} neighbour {int(kk[i])}: offset cpu "
            f"{off_cpu[lp[i], kk[i]].tolist()} card {off_dev[lp[i], kk[i]].tolist()} f64 "
            f"{in_f64[i].tolist()}; steps that differ: {'; '.join(steps) or 'none'}")
    raise AssertionError("the card's ReSTIR offsets differ from the CPU's")


def offsets_differ(dev) -> int:
    """The components of the ReSTIR spatial offsets (10,000 loopers x 5
    neighbours x 2) that differ between the card and the CPU."""
    import torch

    from radish_pt_tpu_torch.render import restir as rs

    loopers, ks = torch.arange(10_000)[:, None], torch.arange(5)
    off_cpu = torch.stack(rs._shared_offset(loopers, ks), -1)
    off_dev = torch.stack(rs._shared_offset(loopers.to(dev), ks.to(dev)), -1).cpu()
    return int((off_cpu != off_dev).sum())


def offsets_loop(runs: int, log, card) -> int:
    """``--offsets-loop RUNS``: the ReSTIR offsets of the card against the
    CPU's (:func:`offsets_differ`) ``runs`` times with nothing else on the
    card (the control), then ``runs`` times after the card ran every kernel
    of the port as phases 3, 6 and 7 run them: an eager frame of each
    engine's main path (teapot on Plücker, quad and bvh, teapot_hires on
    compact and band, cornell on dense and its ReSTIR frame), a heatmap
    frame, the sort-key, binning and heatmap kernels captured in a CUDA
    graph after a side-stream warm-up and replayed, and a fresh renderer's
    captured block (its warm-up on a side stream, then its capture and a
    replay); then the control again.  Counts the runs in which some
    component differs; after a difference, runs ``restir_offsets_check``
    (which prints the chain on both devices and fails).  Returns 0 when
    no run differed."""
    import torch

    from radish_pt_tpu_torch.accel import _build
    from radish_pt_tpu_torch.accel import sort_key as sk
    from radish_pt_tpu_torch.accel import traverse as trv
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import build_device_scene, load_scene
    from radish_pt_tpu_torch.scene.parser import parse_scene

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    scenes = {}
    for name, engine in (("teapot", None), ("teapot_quad", "quad"), ("teapot_bvh", "bvh"),
                         ("cornell_dense", "dense")):
        ds, cam, _ = load_scene(os.path.join(REPO, "scenes", SCENE_FILES[scene_of(name)]),
                                device=dev, intersector=engine)
        scenes[name] = (ds, cam.replace(width=RES, height=RES))
    desc = parse_scene(os.path.join(REPO, "scenes", SCENE_FILES["teapot_hires"]))
    for name, engine in (("teapot_hires", "compact"), ("teapot_hires_band", "band")):
        ds, cam = build_device_scene(desc, use_sobol=desc.settings.use_sobol, device=dev,
                                     intersector=engine)
        scenes[name] = (ds, cam.replace(width=RES, height=RES))
    ds, cam = scenes["teapot"]
    o, d, _ = (t.contiguous() for t in bounce_one(ds, cam)["primary"])
    dsb, camb = scenes["teapot_bvh"]
    wb = bounce_one(dsb, camb)
    ob, db, _ = (t.contiguous() for t in wb["primary"])
    _, de, te = (t.contiguous() for t in wb["extension"])
    graphed = (lambda: sk.signature_key_cuda(ds.key_bounds, o, d),
               lambda: trv.bin_cuda(de, te),
               lambda: trv.intersect_bvh_heatmap_cuda(dsb.leaf_tris, dsb.bvh_packed, ob, db))
    heat = Renderer(ds=dsb, cam=camb, desc=None, settings=Settings(tracer=Tracer.BVH_VISUALIZE),
                    device=dsb.device)
    dsr, camr = scenes["cornell_dense"]
    restir = Renderer(ds=dsr, cam=camr, desc=None, settings=Settings(tracer=Tracer.RESTIR_DI),
                      device=dsr.device)
    log(f"[offsets] kernels built and scenes loaded in {time.perf_counter() - t0:.1f} s")

    def control():
        return offsets_differ(dev)

    def loaded(k):
        for name, (ds_, cam_) in scenes.items():
            pt.path_trace(ds_, cam_, k % 10_000, depth_of(name))
        heat.step()
        restir.step()
        for fn in graphed:
            replayed_ms(fn, reps=1)
        block = Renderer(ds=ds, cam=cam, desc=None,
                         settings=Settings(tracer=Tracer.STREAMED, trace_depth=DEPTH),
                         device=ds.device)
        block.run_block(2)
        block.run_block(2)
        return offsets_differ(dev)

    failed = {}
    for what, fn in (("control", lambda k: control()), ("after the kernels", loaded),
                     ("control again", lambda k: control())):
        t1 = time.perf_counter()
        diffs = [fn(k) for k in range(runs)]
        failed[what] = sum(x > 0 for x in diffs)
        log(f"[offsets] {what}: {failed[what]} of {runs} runs with a difference (components "
            f"differing, the most in one run: {max(diffs)}), {time.perf_counter() - t1:.1f} s "
            f"({card})")
    if any(failed.values()):
        restir_offsets_check(dev, log, "[offsets]")
        return 1
    return 0


def cuda_ms(fn, reps: int, warmup: int = 1, inner: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events; a
    run is ``inner`` calls back to back, and the time is per call (with
    ``inner`` > 1 the host's launch latency hides behind the card's work,
    as in a replayed frame)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    return times[len(times) // 2]


def replayed_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """ms a call of ``calls`` calls of ``fn`` captured in one CUDA graph
    and replayed (median of ``reps`` replays): the card's time alone, no
    host issue between the calls.  ``fn`` runs once first on a side stream
    (its kernels built, its constants made)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps) / calls


# (kernel/wavefront key, scene) -> ms of the plain version's one run in
# phase 3, where it is the parity reference; phase 6 reports it as plain_ms
PLAIN_MS = {}


def plain_run(key: str, scene: str, fn):
    """``fn()``, the plain version's run that a kernel is held against,
    timed with CUDA events (no warm-up) into ``PLAIN_MS[key, scene]``."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    PLAIN_MS[key, scene] = start.elapsed_time(end)
    return out


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """(least ms on the card, what bounds it): the larger of the operations
    over the f32 peak ``peak`` and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def group_pairs(flags, tris_per_flag: int, lanes: int, n: int) -> float:
    """(lane, triangle) pairs a sweep visits: per lane group of ``lanes``
    lanes (the last one ragged), its flagged clusters or units (bool
    [groups, C]) times ``tris_per_flag`` triangles, for each of its lanes."""
    import torch

    groups = flags.shape[0]
    lane_counts = (n - torch.arange(groups, device=flags.device) * lanes).clamp(0, lanes)
    return float((flags.sum(1).double() * lane_counts.double()).sum()) * tris_per_flag


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bounce_one(ds, cam):
    """The main path's wavefronts for a scene: the tile-order primaries,
    the bounce-1 NEE shadow segments and the bounce-1 extension wavefront
    (dead lanes included), built as ``path_trace`` builds them."""
    import torch

    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.bsdf import materials as bsdf
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.sampling import rng
    from radish_pt_tpu_torch.scene import device_scene as dsc

    idx, _ = pt._lanes(ds, cam)  # tile-order lanes
    sampler = rng.make_sampler(0, idx)
    ray_o, ray_d, sampler = pt._gen_primary(ds, cam, sampler, idx)
    it = dsc.intersect(ds, ray_o, ray_d)
    mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
    active = (it.prim_id >= 0) & (mat.mtype != dsc.MAT_LIGHT)
    wo = -ray_d
    delta = mat.mtype == dsc.MAT_DIELECTRIC  # no flip, no NEE
    norm = torch.where((~delta & ((norm * wo).sum(-1) < 0))[..., None], -norm, norm)
    r4, sampler = rng.sample_4d(ds.sobol, sampler)
    _, wi, dist, pdf = dsc.sample_direct_light_no_vis(ds, it.pos, r4)
    ok = active & ~delta & (pdf > 0) & ((norm * wi).sum(-1) > 0)
    y = torch.where(ok[..., None], it.pos + wi * dist[..., None], it.pos)
    r3, sampler = rng.sample_3d(ds.sobol, sampler)
    samp = bsdf.bsdf_sample(mat, norm, wo, r3, types=ds.mat_types)
    active = active & ~bsdf.is_invalid(samp.type) & (samp.pdf >= 1e-8)
    # rays that enter a dielectric: they start just inside its surface
    refracted = active & delta & ((samp.dir * it.norm).sum(-1) < 0)
    return {
        "refracted": refracted,
        "primary": (ray_o, ray_d, torch.full_like(ray_d[:, 0], plk.FLT_MAX)),
        "extension": (it.pos + samp.dir * 1e-5, samp.dir,
                      torch.where(active, plk.FLT_MAX, -plk.FLT_MAX)),
        "segments": (it.pos, y, ok),
    }


def plucker_parity(ds, waves, max_err, log, scene):
    """Phase 3 on a Plücker-engine scene: each kernel (which culls per
    warp from the cluster boxes) against its plain version on the prepass
    words of the same 32-lane groups: prim ids equal on every live lane,
    dist equal by value, shadow bits equal.  Logged beside it: the lanes
    that differ from the plain version culled per 128-lane row, and the
    (lane, triangle) pairs per row, warp and lane.  Returns the timing
    inputs."""
    import torch

    from radish_pt_tpu_torch.accel import plucker as plk

    sub, cb, c, packed = ds.cluster_sub, ds.cluster_bounds, ds.sweep_coeffs, ds.sweep_packed
    inputs = {}
    for what in ("primary", "extension", "segments"):
        if what == "segments":
            x, y, live = waves["segments"]
            o, d, tmax = (t.contiguous() for t in plk.segment_rays(x, y))
        else:
            o, d, tmax = (t.contiguous() for t in waves[what])
            live = tmax >= 0
            if what == "primary":
                tmax = None  # as the path's first closest hit: no range
        feats = plk.plucker_features(o, d, ds.sweep_center)
        words = {g: plk.cluster_mask_words(cb, o, d, tmax, g) for g in (plk.GROUP, plk.ROW)}
        pairs = plk.pair_counts(cb, o, d, tmax, sub, ds.num_triangles)
        log(f"[pairs] plucker {what}, {scene}: (lane, triangle) pairs culled per "
            f"{plk.ROW}-lane row {pairs['row']:.4e}, per {plk.GROUP}-lane warp "
            f"{pairs['warp']:.4e} ({pairs['warp'] / pairs['row']:.4f} of it), per lane "
            f"{pairs['lane']:.4e} ({pairs['lane'] / pairs['row']:.4f}: what the data "
            f"needs under this culling)")
        assert pairs["lane"] <= pairs["warp"] <= pairs["row"]
        if what == "segments":
            ok_k = plk.occlusion_cuda(packed, feats, cb, o, d, tmax, sub)
            ok_p = plain_run("plucker_occlusion/segments", scene, lambda: plk.occlusion_plain(
                c, feats, tmax, words[plk.GROUP], sub))
            ok_r = plk.occlusion_plain(c, feats, tmax, words[plk.ROW], sub, plk.ROW)
            torch.cuda.synchronize()
            n_diff = int((ok_k != ok_p).sum())
            log(f"[parity] plucker occlusion, {scene} NEE segments: {n_diff} / "
                f"{ok_k.numel()} bits differ from the plain version culled per warp; "
                f"occluded {int((ok_p & live).sum())} of {int(live.sum())} live; "
                f"{int((ok_k != ok_r).sum())} bits differ from the plain version culled "
                f"per {plk.ROW}-lane row")
            assert n_diff == 0, f"plucker occlusion, {scene}: shadow parity"
            assert not bool(ok_k[~live].any()), "a masked segment was blocked"
            max_err["plucker_occlusion"] = max(max_err["plucker_occlusion"], float(n_diff))
        else:
            pk, dk = plk.closest_hit_cuda(packed, feats, cb, o, d, tmax, sub)
            pp, dp = plain_run(f"plucker_closest_hit/{what}", scene,
                               lambda: plk.closest_hit_plain(c, feats, words[plk.GROUP], sub,
                                                             dead=plk.dead_lanes(tmax)))
            pr, _ = plk.closest_hit_plain(c, feats, words[plk.ROW], sub, plk.ROW)
            torch.cuda.synchronize()
            n_prim, n_val = int((pk != pp).sum()), int((dk != dp).sum())
            hit = (pp >= 0) & live
            err = float(torch.abs(dk - dp)[hit].max()) if bool(hit.any()) else 0.0
            log(f"[parity] plucker closest hit, {scene} {what}: {n_prim} / {pk.numel()} "
                f"prim ids differ from the plain version culled per warp (dead lanes "
                f"included), dist differs by value on {n_val} lanes (max |dist err| "
                f"{err:.3e}); live {int(live.sum())}, hits {int(hit.sum())}; "
                f"{int((~live).sum())} dead lanes, all misses; "
                f"{int(((pk != pr) & live).sum())} live prim ids differ from the plain "
                f"version culled per {plk.ROW}-lane row")
            assert bool((pk[~live] == -1).all()), "plucker closest hit: a dead lane hit"
            assert n_prim == 0, f"plucker closest hit, {scene} {what}: prim parity"
            assert n_val == 0, f"plucker closest hit, {scene} {what}: dist parity"
            max_err["plucker_closest_hit"] = max(max_err["plucker_closest_hit"], err)
        inputs[what] = (feats, o, d, tmax, words[plk.GROUP], pairs)
    return inputs


def compact_parity(ds, waves, max_err, log):
    """Phase 3 on a compact-engine scene: the sphere kernel against its
    plain version on the same features, then each sweep kernel against its
    plain version on the kernel's flags.  Returns the timing inputs."""
    import torch

    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel import plucker as plk

    inputs = {}
    for what in ("primary", "extension", "segments"):
        if what == "segments":
            x, y, live = waves["segments"]
            o, d, tmax = plk.segment_rays(x, y)
            tmax = tmax.contiguous()
        else:
            o, d, tmax = waves[what]
            live = tmax >= 0
        sph = cpt.sphere_operands(ds.sweep_center, ds.cluster_bounds, o, d, tmax)
        fk, tk = cpt.sphere_flags_cuda(*sph)
        fp, tp = plain_run(f"compact_sphere_flags/{what}", "teapot_hires",
                           lambda: cpt.sphere_flags_plain(*sph))
        torch.cuda.synchronize()
        both = fk & fp
        n_flag_diff = int((fk != fp).sum())
        tn_err = float(torch.abs(tk - tp)[both].max()) if bool(both.any()) else 0.0
        log(f"[parity] compact sphere flags, {what}: {n_flag_diff} / {fk.numel()} "
            f"flags differ; flagged {float(fp.float().mean()):.4f} of (row group,"
            f" unit) pairs, {float(fp.sum(1).float().mean()):.1f} units per row "
            f"group; max |tn err| {tn_err:.3e}")
        assert n_flag_diff <= 1e-4 * fk.numel(), "sphere flag parity"
        assert tn_err <= 1e-4 * max(1.0, float(tp[both].abs().max())), "tn parity"
        max_err["compact_sphere_flags"] = max(max_err["compact_sphere_flags"], tn_err)
        feats = plk.plucker_features(o, d, ds.sweep_center)
        items, item_tn, offsets = cpt.work_list(fk, tk)
        if what == "segments":
            ok_k = cpt.occlusion_cuda(ds.sweep_packed, ds.unit_spheres, feats, tmax,
                                      items, item_tn, offsets, 1)
            ok_p = plain_run("compact_occlusion/segments", "teapot_hires",
                             lambda: cpt.occlusion_plain(ds.sweep_coeffs, feats, tmax, fk, 1))
            torch.cuda.synchronize()
            err = check_occlusion(ok_k, ok_p, live, "compact", log)
            assert int((ok_k != ok_p).sum()) == 0, "compact occlusion: shadow parity"
            assert not bool(ok_k[~live].any()), "a masked segment was blocked"
            max_err["compact_occlusion"] = max(max_err["compact_occlusion"], err)
            reach = tmax  # a segment's reach is its range
        else:
            pk, dk = cpt.closest_hit_cuda(ds.sweep_packed, ds.unit_spheres, feats, tmax,
                                          items, item_tn, offsets, 1)
            pp, dp = plain_run(f"compact_closest_hit/{what}", "teapot_hires",
                               lambda: cpt.closest_hit_plain(ds.sweep_coeffs, feats, tmax, fk, 1))
            torch.cuda.synchronize()
            err = check_closest(pk, dk, pp, dp, live, f"compact closest hit, {what}", log)
            # the compact kernel reads tmax: a dead lane sweeps nothing
            assert bool((pk[~live] == -1).all()), "compact closest hit: a dead lane hit"
            max_err["compact_closest_hit"] = max(max_err["compact_closest_hit"], err)
            reach = dk  # a ray's reach is its final t
        # what culling finer than the row group can save, and the floor
        pairs = cpt.pair_counts(ds.unit_spheres, feats, tmax, fk, reach, 1,
                                ds.num_triangles)
        log(f"[pairs] compact {what}: (lane, triangle) pairs culled per "
            f"{cpt.LANES}-lane row group {pairs['row']:.4e}, per {cpt.WARP}-lane warp "
            f"{pairs['warp']:.4e} ({pairs['warp'] / pairs['row']:.4f} of it), per lane "
            f"{pairs['lane']:.4e} ({pairs['lane'] / pairs['row']:.4f}); with each unit "
            f"cut at the lane's reach ({'range' if what == 'segments' else 'final t'}): "
            f"row group {pairs['row_cut']:.4e}, warp {pairs['warp_cut']:.4e}, lane "
            f"{pairs['lane_cut']:.4e} ({pairs['lane_cut'] / pairs['row']:.4f}: what the "
            f"data needs)")
        assert pairs["lane"] <= pairs["warp"] <= pairs["row"]
        assert pairs["lane_cut"] <= pairs["warp_cut"] <= pairs["row_cut"]
        inputs[what] = (feats, tmax, fk, items, item_tn, offsets, pairs, sph)
    return inputs


def quad_parity(ds, waves, max_err, log):
    """Phase 3 on a quad-engine scene: each kernel against its plain
    version on the same cluster masks (the Plücker prepass; the segments
    carried unnormalized over t in [0, 1]).  Returns the timing inputs."""
    import torch

    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import quad as qd

    sub, n_c = ds.cluster_sub, ds.cluster_bounds.shape[0]
    inputs = {}
    for what in ("primary", "extension"):
        o, d, tmax = waves[what]
        live = tmax >= 0
        feats = qd.quad_features(o, d, ds.sweep_center)
        mask = plk.cluster_mask_words(ds.cluster_bounds, o, d,
                                      None if what == "primary" else tmax)
        pk, dk = qd.closest_hit_cuda(ds.quad_packed, feats, mask, sub)
        pp, dp = plain_run(f"quad_closest_hit/{what}", "teapot_quad",
                           lambda: qd.closest_hit_plain(ds.quad_coeffs, feats, mask, sub))
        torch.cuda.synchronize()
        n_val = int(((dk != dp) & live).sum())
        log(f"[parity] quad closest hit, {what}: dist differs by value on {n_val} live "
            f"lanes (the plain version emulates each fused multiply-add in f64, which "
            f"can round twice; the terms the kernel drops add exact zeros)")
        log(f"[parity] quad {what}: {float(plk.unpack_mask(mask, n_c).sum(1).float().mean()):.2f}"
            f" clusters of {sub} per 128-lane row")
        err = check_closest(pk, dk, pp, dp, live, f"quad closest hit, {what}", log)
        max_err["quad_closest_hit"] = max(max_err["quad_closest_hit"], err)
        inputs[what] = (feats, mask)
    # the shadow kernel votes its rows' words itself and culls per segment
    x, y, ok = waves["segments"]
    so, seg = (t.contiguous() for t in qd.quad_segments(x, y))
    feats = qd.quad_features(so, seg, ds.sweep_center)
    ones = torch.ones_like(so[:, 0])
    mask = plk.cluster_mask_words(ds.cluster_bounds, so, seg, ones)
    ok_k = qd.occlusion_cuda(ds.quad_occl_packed, feats, ds.cluster_bounds, so, seg, sub)
    ok_p = plain_run("quad_occlusion/segments", "teapot_quad",
                     lambda: qd.occlusion_plain(ds.quad_coeffs, feats, mask, sub))
    torch.cuda.synchronize()
    max_err["quad_occlusion"] = max(max_err["quad_occlusion"],
                                    check_occlusion(ok_k, ok_p, ok, "quad", log))
    zero = qd.zero_segments(feats)
    swept = plk.unpack_mask(mask, n_c).any(1).repeat_interleave(plk.ROW)[:so.shape[0]]
    log(f"[parity] quad occlusion: {int(ok_k[~ok].sum())} of {int((~ok).sum())} "
        f"masked (zero-length) segments read as blocked, as in the reference; "
        f"{int(zero.sum())} segments zero-length, blocked exactly where their row "
        f"sweeps a triangle: {bool(torch.equal(ok_k[zero], swept[zero]))}")
    assert torch.equal(ok_k[zero], swept[zero]), "quad occlusion: a zero-length segment"
    # what the data needs: each non-zero segment's own clusters at reach 1
    pairs = plk.pair_counts(ds.cluster_bounds, so, seg, ones, sub, ds.num_triangles)
    pairs["lane"] = plk.pair_counts(ds.cluster_bounds, so[~zero], seg[~zero], ones[~zero],
                                    sub, ds.num_triangles)["lane"]
    log(f"[pairs] quad occlusion: (lane, triangle) pairs culled per {plk.ROW}-lane row "
        f"{pairs['row']:.4e}, per {plk.GROUP}-lane warp {pairs['warp']:.4e} "
        f"({pairs['warp'] / pairs['row']:.4f} of it), per non-zero lane "
        f"{pairs['lane']:.4e} ({pairs['lane'] / pairs['row']:.4f}: what the data needs)")
    assert pairs["lane"] <= pairs["warp"] <= pairs["row"]
    inputs["segments"] = (feats, so, seg, mask, pairs)
    return inputs


def band_parity(ds, waves, max_err, log):
    """Phase 3 on a band-engine scene: each kernel, which votes its bands'
    words itself from the boxes and the rays, against its plain version on
    the band-mask prepass's words (closest hit: winners and distances equal
    on every live lane, dead lanes missing; shadow: <= 1e-4 of bits differ,
    masked and zero-length segments never blocked).  Logged beside it: the
    (lane, triangle) pairs per band, warp and lane.  Returns the timing
    inputs."""
    import torch

    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import plucker as plk

    g, n_c, cb, wb = ds.band_g, ds.cluster_bounds.shape[0], ds.cluster_bounds, ds.word_bounds
    inputs = {}
    for what in ("primary", "extension", "segments"):
        if what == "segments":
            x, y, live = waves["segments"]
            o, d, tmax = (t.contiguous() for t in plk.segment_rays(x, y))
        else:
            o, d, tmax = (t.contiguous() for t in waves[what])
            live = tmax >= 0
            if what == "primary":
                tmax = None  # as the path's first closest hit: no range
        feats = plk.plucker_features(o, d, ds.sweep_center)
        mask = bnd.band_mask_words(cb, o, d, tmax, g)
        flags = plk.unpack_mask(mask, n_c)
        rows = plk.unpack_mask(plk.pack_words(flags.view(-1, g, n_c).any(1)), n_c)
        log(f"[parity] band {what}: {float(flags.sum(1).float().mean()):.2f} "
            f"clusters per {plk.ROW // g}-lane band, "
            f"{float(rows.sum(1).float().mean()):.2f} per 128-lane row")
        if what == "segments":
            ok_k = bnd.occlusion_cuda(ds.sweep_packed, feats, cb, wb, o, d, tmax, g)
            ok_p = plain_run("band_occlusion/segments", "teapot_hires_band",
                             lambda: bnd.occlusion_plain(ds.sweep_coeffs, feats, tmax, mask, g))
            torch.cuda.synchronize()
            err = check_occlusion(ok_k, ok_p, live, "band", log)
            log(f"[parity] band occlusion: {int(ok_k[~live].sum())} of {int((~live).sum())} "
                f"masked segments and {int(ok_k[tmax < 0].sum())} of "
                f"{int((tmax < 0).sum())} with a negative range read as blocked")
            assert not bool(ok_k[~live | (tmax < 0)].any()), "a masked segment was blocked"
            max_err["band_occlusion"] = max(max_err["band_occlusion"], err)
            pairs = bnd.pair_counts(cb, o, d, tmax, g, ds.num_triangles, tmax)
            log(f"[pairs] band occlusion: (lane, triangle) pairs culled per "
                f"{plk.ROW // g}-lane band {pairs['band']:.4e}, per {bnd.WARP}-lane warp "
                f"{pairs['warp']:.4e} ({pairs['warp'] / pairs['band']:.4f} of it), per lane "
                f"{pairs['lane']:.4e} ({pairs['lane'] / pairs['band']:.4f}); each lane's "
                f"clusters its grown box admits within its range {pairs['lane_cut']:.4e} "
                f"({pairs['lane_cut'] / pairs['band']:.4f}: what the data needs)")
            assert pairs["lane_cut"] <= pairs["lane"] <= min(pairs["band"], pairs["warp"])
            inputs[what] = (feats, o, d, tmax, mask, pairs)
            continue
        pk, dk = bnd.closest_hit_cuda(ds.sweep_packed, feats, cb, wb, o, d, tmax, g)
        pp, dp = plain_run(f"band_closest_hit/{what}", "teapot_hires_band",
                           lambda: bnd.closest_hit_plain(ds.sweep_coeffs, feats, mask, g,
                                                         dead=plk.dead_lanes(tmax)))
        torch.cuda.synchronize()
        n_prim, n_val = int(((pk != pp) & live).sum()), int(((dk != dp) & live).sum())
        hit = (pp >= 0) & live
        err = float(torch.abs(dk - dp)[hit].max()) if bool(hit.any()) else 0.0
        log(f"[parity] band closest hit, {what}: {n_prim} / {int(live.sum())} live prim "
            f"ids and {n_val} distances differ from the plain version on the prepass's "
            f"words (max |dist err| {err:.3e}); hits {int(hit.sum())}; "
            f"{int((~live).sum())} dead lanes, all misses")
        assert n_prim == 0 and n_val == 0, f"band closest hit, {what}: parity"
        assert bool((pk[~live] == -1).all()), "band closest hit: a dead lane hit"
        max_err["band_closest_hit"] = max(max_err["band_closest_hit"], err)
        pairs = bnd.pair_counts(cb, o, d, tmax, g, ds.num_triangles, dk)
        log(f"[pairs] band closest hit, {what}: (lane, triangle) pairs culled per "
            f"{plk.ROW // g}-lane band {pairs['band']:.4e}, per {bnd.WARP}-lane warp "
            f"{pairs['warp']:.4e} ({pairs['warp'] / pairs['band']:.4f} of it), per lane "
            f"{pairs['lane']:.4e} ({pairs['lane'] / pairs['band']:.4f}); each lane's "
            f"clusters its grown box admits at its final t {pairs['lane_cut']:.4e} "
            f"({pairs['lane_cut'] / pairs['band']:.4f}: what the data needs)")
        assert pairs["lane_cut"] <= pairs["lane"] <= min(pairs["band"], pairs["warp"])
        inputs[what] = (feats, o, d, tmax, mask, pairs)
    return inputs


def max_ulps(a, b) -> int:
    """Largest distance in units in the last place between two f32 tensors
    of finite values (0: bit-equal)."""
    import torch

    def ordered(t):
        bits = t.contiguous().view(torch.int32).long()
        return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def calls_of(module, name: str, run) -> list:
    """The arguments of each call of ``module.<name>`` while ``run()`` runs
    (the calls themselves go through)."""
    seen = []
    orig = getattr(module, name)

    def spy(*args):
        seen.append(args)
        return orig(*args)

    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return seen


def same_bits(a, b):
    """Per element of two tensors: equal bit for bit, or both NaN."""
    import torch

    if a.dtype != torch.float32:
        return a == b
    return (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))


def ris_args(ds, cam, reservoir_size: int, looper: int = 5) -> tuple:
    """What ``restir_candidates`` hands the candidate RIS on the frame's
    lanes: (scene, pos, material, normal, wo, sampler, candidates)."""
    import torch

    from radish_pt_tpu_torch.render import restir as rs

    idx = torch.arange(cam.width * cam.height, dtype=torch.int32, device=ds.device)
    return calls_of(rs, "candidate_ris", lambda: rs.restir_candidates(
        ds, cam, torch.tensor(looper, device=ds.device), idx, reservoir_size))[0]


def ris_phase(scenes, log, card) -> dict:
    """ReSTIR's candidate RIS kernel on :data:`RIS_CASES` at 800x800: the
    kernel's reservoir and sampler state against the plain loop's (the
    lanes whose winner, weight or count differ, the largest ulp distance,
    the scramble and pointer exactly), then its time (one call, 10 back to
    back, 10 replayed in one CUDA graph) beside the plain loop's one run and
    its bound (render/ris.py's operations a candidate at the f32
    instruction rate; the lanes' bytes at the memory rate), and the launches
    a replayed ReSTIR frame of ``Renderer.step_batched_restir``.  Returns
    the kernels line's row."""
    import torch

    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.render import ris
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.utils import timing

    cases = {}
    for name, size, hash_mode in RIS_CASES:
        ds, cam = scenes[name]
        if hash_mode:
            ds = ds.replace(sobol=None)
        args = ris_args(ds, cam, size)
        key = f"{name} R={size}{' hash' if hash_mode else ''}"
        got = rs.candidate_ris(*args)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = rs.ris_plain(*args)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        (res, smp), (pres, psmp) = got, want
        ulps, err, differ = 0, 0.0, torch.zeros_like(res.num, dtype=torch.bool)
        for f in ("li", "wi", "dist", "weight"):
            a, b = getattr(res, f), getattr(pres, f)
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            differ |= ~same if a.dim() == 1 else ~same.all(-1)
            both = torch.isfinite(a) & torch.isfinite(b)
            if both.any():
                ulps = max(ulps, max_ulps(a[both], b[both]))
                err = max(err, float((a[both] - b[both]).abs().max()))
        assert torch.equal(res.num, pres.num) and torch.equal(smp.scramble, psmp.scramble)
        assert int(smp.ptr) == int(psmp.ptr)
        n = res.num.shape[0]
        ms = cuda_ms(lambda: rs.candidate_ris(*args), 5)
        b2b = cuda_ms(lambda: rs.candidate_ris(*args), 5, inner=10)
        replayed = replayed_ms(lambda: rs.candidate_ris(*args))
        ops = n * size * ris.OPS_PER_CANDIDATE
        io = n * ris.BYTES_PER_LANE
        b_ms, b_by = bound(ops, io, PEAK_F32_OPS_UNFUSED)
        cases[key] = {"lanes": n, "lanes_differ": int(differ.sum()), "max_ulps": ulps,
                      "max_abs_err": err,
                      "ms": ms, "ms_back_to_back": b2b, "ms_replayed": replayed,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        log(f"[ris] {key} ({ds.n_area_lights} area lights, env {ds.has_env}, types "
            f"{ds.mat_types}): lanes differing from the plain loop {int(differ.sum())} of "
            f"{n}, largest ulp distance {ulps}, largest |difference| {err:.3e}; kernel {ms:.4f} ms one call, "
            f"{b2b:.4f} back to back, {replayed:.4f} replayed; plain {plain_ms:.3f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}: {ops / 1e9:.2f} G operations at "
            f"{PEAK_F32_OPS_UNFUSED / 1e12:.1f} T/s, {io / 1e6:.1f} MB), the kernel at "
            f"{100 * b_ms / replayed:.1f}% of it replayed ({card})")
        assert int(differ.sum()) == 0 and ulps == 0, key
    # the main path: one launch a replayed ReSTIR frame
    ds, cam = scenes["cornell"]
    r = Renderer(ds=ds, cam=cam, device="cuda",
                 settings=Settings(tracer=Tracer.RESTIR_DI, animate_camera=True,
                                   animate_radius=2.0))
    r.step_batched_restir(1)
    tally = timing.Tally()
    r.step_batched_restir(1)
    torch.cuda.synchronize()
    per = timing.under(r.last_runner.counts_per_replay, "launch.ris")
    log(f"[ris] cornell step_batched_restir(1): {per['ris']} launch(es) a replay, counted "
        f"{tally('launch.ris')}, plain calls {tally('plain.ris')}")
    assert per == {"ris": 1} and tally("launch.ris") == per and tally("plain.ris") == {}
    main = cases[f"{RIS_CASES[0][0]} R={RIS_CASES[0][1]}"]
    return {"name": "ris_candidates", "route": "cuda", "source": SOURCES["ris"],
            "replaces": RIS_REPLACES, "launches": per["ris"], "launches_per_frame": per["ris"],
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "lanes_differ": main["lanes_differ"], "max_ulps": main["max_ulps"],
            "ms": main["ms"], "ms_replayed": main["ms_replayed"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": "cornell 800x800, 32 candidates", "cases": cases}


def vertex_waves(ds, cam, bounces, looper: int = 5) -> dict:
    """What the dense bounce loop hands the vertex at ``bounces`` of a
    frame: {bounce: (scene, sampler, active, material, normal, ray
    direction, position, throughput)}."""
    import torch

    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import vertex as vx

    seen = calls_of(vx, "vertex", lambda: pt.path_trace(
        ds, cam, torch.tensor(looper, device=ds.device), max(bounces), n_slices=0))
    return {b: seen[b - 1] for b in bounces}


def vertex_phase(scenes, log, card) -> dict:
    """The path tracer's vertex kernel on :data:`VERTEX_CASES`' bounce-1 and
    bounce-3 wavefronts at 800x800: every field of its output against the
    plain version's, bit for bit (the lanes differing, each field), then its
    time (one call, 10 back to back, 10 replayed in one CUDA graph) beside
    the plain version's one run, the whole vertex's (kernel, sorted shadow
    test, resolve) replayed, and its bound (render/vertex.py's bytes over
    the wavefront's material types at the memory rate); then the launches
    a replayed ``run_block(4)`` of cornell and cornell_teapot at depth 5.
    Returns the kernels line's row."""
    import torch

    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import vertex as vx
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.utils import timing

    cases = {}
    for name, hash_mode in VERTEX_CASES:
        ds, cam = scenes[name]
        if hash_mode:
            ds = ds.replace(sobol=None)
        for bounce, args in vertex_waves(ds, cam, VERTEX_BOUNCES).items():
            key = f"{name}{' hash' if hash_mode else ''} bounce {bounce}"
            got = vx.vertex_cuda(*args)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            want = pt.vertex_plain(*args)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            differ = {}
            for f in ("seg_end", "ok", "contrib", "active", "throughput", "new_dir", "pdf",
                      "delta"):
                same = same_bits(getattr(got, f), getattr(want, f))
                differ[f] = int((~(same if same.dim() == 1 else same.all(-1))).sum())
            differ["scramble"] = int((got.sampler.scramble != want.sampler.scramble).sum())
            differ["ptr"] = int(int(got.sampler.ptr) != int(want.sampler.ptr))
            err = 0.0
            for f in ("seg_end", "contrib", "throughput", "new_dir", "pdf"):
                a, b = getattr(got, f), getattr(want, f)
                both = torch.isfinite(a) & torch.isfinite(b)
                if both.any():
                    err = max(err, float((a[both] - b[both]).abs().max()))
            n = args[4].shape[0]
            ms = cuda_ms(lambda: vx.vertex_cuda(*args), 5)
            b2b = cuda_ms(lambda: vx.vertex_cuda(*args), 5, inner=10)
            replayed = replayed_ms(lambda: vx.vertex_cuda(*args))
            whole = replayed_ms(lambda: pt._vertex(*args))
            io = vx.bytes_moved(args[3].mtype)
            b_ms, b_by = bound(0.0, io)
            live, ok = int(args[2].sum()), int(want.ok.sum())
            cases[key] = {"lanes": n, "active": live, "ok": ok, "lanes_differ": differ,
                          "max_abs_err": err, "ms": ms, "ms_back_to_back": b2b, "ms_replayed": replayed,
                          "vertex_ms_replayed": whole, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by}
            log(f"[vertex] {key} ({ds.n_area_lights} area lights, env {ds.has_env}, types "
                f"{ds.mat_types}; {live} of {n} lanes active, {ok} light samples ok): lanes "
                f"differing from the plain version {differ}, largest |difference| {err:.3e}; "
                f"kernel {ms:.4f} ms one call, "
                f"{b2b:.4f} back to back, {replayed:.4f} replayed; the whole vertex (kernel, "
                f"sorted shadow test, resolve) {whole:.4f} replayed; plain {plain_ms:.3f} ms; "
                f"bound {b_ms:.4f} ms ({b_by}: {io / 1e6:.1f} MB), the kernel at "
                f"{100 * b_ms / replayed:.1f}% of it replayed ({card})")
            assert not any(differ.values()), (key, differ)
    # the main path: one launch a bounce of a replayed block, no plain call
    launches = {}
    for name in ("cornell", "cornell_teapot"):
        ds, cam = scenes[name]
        r = Renderer(ds=ds, cam=cam, device="cuda",
                     settings=Settings(tracer=Tracer.STREAMED, trace_depth=DEPTH))
        r.run_block(4)
        tally = timing.Tally()
        r.run_block(4)
        torch.cuda.synchronize()
        per = timing.under(r.last_runner.counts_per_replay, "launch.vertex")
        log(f"[vertex] {name} run_block(4), depth {DEPTH}: {per['vertex']} launch(es) a "
            f"replay, counted {tally('launch.vertex')}, plain calls {tally('plain.vertex')}")
        assert r.last_runner.mode == "graph"
        assert per == {"vertex": 4 * DEPTH} and tally("launch.vertex") == per
        assert tally("plain.vertex") == {}
        launches[name] = per["vertex"]
    main = cases[f"{VERTEX_CASES[0][0]} bounce 1"]
    return {"name": "vertex_kernel", "route": "cuda", "source": SOURCES["vertex"],
            "replaces": VERTEX_REPLACES, "launches": launches["cornell"],
            "launches_per_frame": launches["cornell"] / 4,
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "lanes_differ": sum(main["lanes_differ"].values()), "ms": main["ms"],
            "ms_replayed": main["ms_replayed"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "shape": "cornell 800x800, bounce 1", "cases": cases}


def surface_waves(ds, cam, looper: int = 5) -> dict:
    """What the dense bounce loop hands the surface kernel in a frame:
    {"primary" | "bounce 1": (scene, prim, bary, ray origin, ray
    direction, path)}."""
    import torch

    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import surface as sf

    seen = calls_of(sf, "surface", lambda: pt.path_trace(
        ds, cam, torch.tensor(looper, device=ds.device), 1, n_slices=0))
    return {"primary": seen[0], "bounce 1": seen[1]}


def surface_phase(scenes, log, card) -> dict:
    """The closest hit's surface kernel on :data:`SURFACE_CASES`' primaries
    and bounce-1 extension rays at 800x800, with the wavefront's accounting
    and without: every output against the plain version's, bit for bit,
    then its time (one call, 10 back to back, 10 replayed in one CUDA graph)
    beside the plain version's one run and its bound (render/surface.py's
    bytes at the memory rate); then the launches a replayed ``run_block(4)``
    at depth 5 and a replayed ReSTIR frame count.  Returns the kernels
    line's row."""
    import torch

    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import surface as sf
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.utils import timing

    def outputs(x):
        out = {"pos": x.pos, "norm": x.norm, "mat_id": x.mat_id, "acc": x.acc,
               "active": x.active}
        out.update({f: getattr(x.mat, f) for f in ("mtype", "base_color", "metallic",
                                                   "roughness", "ior")})
        return {k: v for k, v in out.items() if v is not None}

    cases = {}
    for name in SURFACE_CASES:
        ds, cam = scenes[name]
        for wave, (ds_, prim, bary, o, d, path) in surface_waves(ds, cam).items():
            for mode in (path, None):
                key = f"{name} {wave}{'' if mode is not None else ', no accounting'}"
                args = (ds_, prim, bary, o, d, mode)
                got = sf.surface_cuda(*args)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                want = pt.surface_plain(*args)
                end.record()
                end.synchronize()
                plain_ms = start.elapsed_time(end)
                a, b = outputs(got), outputs(want)
                assert a.keys() == b.keys(), key
                differ, err = {}, 0.0
                for f in a:
                    same = same_bits(a[f], b[f])
                    differ[f] = int((~(same if same.dim() == 1 else same.all(-1))).sum())
                    if a[f].dtype == torch.float32:
                        both = torch.isfinite(a[f]) & torch.isfinite(b[f])
                        if both.any():
                            err = max(err, float((a[f][both] - b[f][both]).abs().max()))
                ms = cuda_ms(lambda: sf.surface_cuda(*args), 5)
                b2b = cuda_ms(lambda: sf.surface_cuda(*args), 5, inner=10)
                replayed = replayed_ms(lambda: sf.surface_cuda(*args))
                io = sf.bytes_moved(ds_, prim, bary is not None, sf.account_mode(mode))
                b_ms, b_by = bound(0.0, io)
                n, hits = prim.shape[0], int((prim >= 0).sum())
                cases[key] = {"lanes": n, "hits": hits, "lanes_differ": differ,
                              "max_abs_err": err, "ms": ms,
                              "ms_back_to_back": b2b, "ms_replayed": replayed,
                              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
                log(f"[surface] {key} ({ds_.intersector}, from the "
                    f"{'barycentrics' if bary is not None else 'winner id'}; {hits} of {n} "
                    f"lanes hit): lanes differing from the plain version {differ}, largest "
                    f"|difference| {err:.3e}; kernel "
                    f"{ms:.4f} ms one call, {b2b:.4f} back to back, {replayed:.4f} replayed; "
                    f"plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}: {io / 1e6:.1f} "
                    f"MB), the kernel at {100 * b_ms / replayed:.1f}% of it replayed ({card})")
                assert not any(differ.values()), (key, differ)
    # the main paths: one launch for the primaries and one a bounce of a
    # replayed block, two a replayed ReSTIR frame, no plain call
    launches = {}
    for name in SURFACE_CASES + ("cornell restir",):
        restir = name.endswith("restir")
        ds, cam = scenes[name.split()[0]]
        settings = (Settings(tracer=Tracer.RESTIR_DI) if restir else
                    Settings(tracer=Tracer.STREAMED, trace_depth=DEPTH))
        r = Renderer(ds=ds, cam=cam, device="cuda", settings=settings)
        call = (lambda: r.step_batched_restir(1)) if restir else (lambda: r.run_block(4))
        call()
        tally = timing.Tally()
        call()
        torch.cuda.synchronize()
        per = timing.under(r.last_runner.counts_per_replay, "launch.surface")
        want = {"surface": 2 if restir else 4 * (DEPTH + 1)}
        log(f"[surface] {name} {'step_batched_restir(1)' if restir else 'run_block(4)'}: "
            f"{per['surface']} launch(es) a replay, counted {tally('launch.surface')}, plain "
            f"calls {tally('plain.surface')}")
        assert r.last_runner.mode == "graph"
        assert per == want and tally("launch.surface") == per
        assert tally("plain.surface") == {}
        launches[name] = per["surface"]
    main = cases[f"{SURFACE_CASES[0]} bounce 1"]
    return {"name": "surface_kernel", "route": "cuda", "source": SOURCES["surface"],
            "replaces": SURFACE_REPLACES, "launches": launches["cornell"],
            "launches_per_frame": launches["cornell"] / 4,
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "lanes_differ": sum(main["lanes_differ"].values()), "ms": main["ms"],
            "ms_replayed": main["ms_replayed"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
            "shape": "cornell 800x800, bounce 1", "cases": cases,
            "restir_launches_per_frame": launches["cornell restir"]}


def dense_parity(ds, waves, max_err, log, scene):
    """Phase 3 on a dense-engine scene: each kernel against its plain
    version, which rounds the same operations: prim ids, dist and
    barycentrics bit for bit on every lane (dead ones too: the dense sweep
    reads no tmax), shadow bits equal.  Returns the timing inputs."""
    import torch

    from radish_pt_tpu_torch.accel import dense as dns
    from radish_pt_tpu_torch.accel import traverse as trv

    tri, inputs = ds.tri_packed, {}
    for what in ("primary", "extension"):
        o, d = (t.contiguous() for t in waves[what][:2])
        pk, dk, bk = dns.closest_hit_cuda(tri, o, d)
        pp, dp, bp = plain_run(f"dense_closest_hit/{what}", f"{scene}_dense",
                               lambda: dns.closest_hit_plain(tri, o, d))
        torch.cuda.synchronize()
        n_prim = int((pk != pp).sum())
        ulps = {"dist": max_ulps(dk, dp), "bary": max_ulps(bk, bp)}
        hit = pp >= 0
        err = max(float(torch.abs(dk - dp)[hit].max()) if bool(hit.any()) else 0.0,
                  float(torch.abs(bk - bp).max()))
        log(f"[parity] dense closest hit, {scene} {what} (N = {o.shape[0]}, T = "
            f"{tri.shape[0]}): {n_prim} prim ids differ; hits {int(hit.sum())}; "
            f"largest difference {ulps['dist']} ulp on dist, {ulps['bary']} ulp on "
            f"bary (max |err| {err:.3e})")
        assert n_prim == 0, f"dense closest hit, {scene} {what}: prim parity"
        assert ulps == {"dist": 0, "bary": 0}, f"dense {scene} {what}: not bit-equal"
        max_err["dense_closest_hit"] = max(max_err["dense_closest_hit"], err)
        inputs[what] = (o, d)
    x, y, live = waves["segments"]
    so, sd, tm = (t.contiguous() for t in trv.segment_rays(x, y))
    ok_k = dns.occlusion_cuda(tri, so, sd, tm)
    ok_p = plain_run("dense_occlusion/segments", f"{scene}_dense",
                     lambda: dns.occlusion_plain(tri, so, sd, tm))
    torch.cuda.synchronize()
    n_diff = int((ok_k != ok_p).sum())
    log(f"[parity] dense occlusion, {scene} NEE segments: {n_diff} / {ok_k.numel()} bits "
        f"differ; occluded {int((ok_p & live).sum())} of {int(live.sum())} live; "
        f"{int(ok_k[~live].sum())} masked (zero-length) segments read as blocked")
    assert n_diff == 0, f"dense occlusion, {scene}: shadow parity"
    assert not bool(ok_k[~live].any()), "a zero-length segment was blocked"
    max_err["dense_occlusion"] = max(max_err["dense_occlusion"], float(n_diff))
    inputs["segments"] = (so, sd, tm)
    return inputs


def warp_efficiency(visits, order=None) -> float:
    """Mean node visits a lane over the mean of each 32-lane warp's most,
    the lanes taken in launch order or in ``order``: the share of a warp's
    issue slots a walk of one thread a ray, each warp as long as its
    longest walk, keeps busy on node visits."""
    import torch

    v = (visits if order is None else visits[order]).double()
    if not v.numel():
        return 1.0
    pad = torch.zeros((-v.numel()) % 32, dtype=v.dtype, device=v.device)
    most = torch.cat([v, pad]).view(-1, 32).max(1).values
    return float(v.mean() / most.mean())


def interleave_classes(d, live):
    """Lane indices that cycle through the six direction classes lane by
    lane: the k-th live lane of each class in turn, as many rounds as the
    rarest class has lanes."""
    import torch

    from radish_pt_tpu_torch.accel import traverse as trv

    cls = trv.get_dir_class(-d)
    by_class = [torch.nonzero(live & (cls == k))[:, 0] for k in range(trv.DIR_CLASSES)]
    m = min(len(b) for b in by_class)
    return torch.stack([b[:m] for b in by_class], 1).reshape(-1)


def bvh_parity(ds, waves, max_err, log, scene):
    """Phase 3 on a bvh-engine scene: the walks against their plain versions
    on every lane, prim ids, dist and barycentrics bit for bit, heatmap
    counts and shadow bits equal: the closest hit on the primaries, on the
    bounce-1 extension rays without a range (dead lanes walked as any ray,
    as PR 12's kernel was timed) and with the frame's dead-lane range
    (-FLT_MAX: settled as misses by the binning kernel), and on a
    wavefront that interleaves the six direction classes lane by lane; the
    heatmap on the primaries and the extension rays; the shadow walk on the
    NEE segments; the binning kernel's class counts and queue against
    ``bin_by_dir_class``.  Further plain runs count what the walks do (node
    visits, leaves, pairs, the rows and leaves touched), which phase 6
    bounds the kernels by, and give each wavefront's warp efficiency in
    raster and in class-binned order.  Returns the timing inputs."""
    import torch

    from radish_pt_tpu_torch.accel import traverse as trv
    from radish_pt_tpu_torch.profile import heatmap_schedule, schedule_line

    lt, lm, nodes = ds.leaf_tris, ds.leaf_map, ds.bvh_packed
    o_e, d_e, t_e = (t.contiguous() for t in waves["extension"])
    live_e = t_e >= 0
    idx = interleave_classes(d_e, live_e)
    walks = {"primary": (*(t.contiguous() for t in waves["primary"][:2]), None),
             "extension": (o_e, d_e, None), "extension_ranged": (o_e, d_e, t_e),
             "interleaved": (o_e[idx].contiguous(), d_e[idx].contiguous(), None)}
    inputs = {}
    for what, (o, d, tmax) in walks.items():
        pk, dk, bk = trv.intersect_bvh_cuda(lt, lm, nodes, o, d, tmax)
        pp, dp, bp = plain_run(f"bvh_closest_hit/{what}", scene,
                               lambda: trv.intersect_bvh_plain(lt, lm, nodes, o, d, tmax))
        st = {}
        trv.intersect_bvh_plain(lt, lm, nodes, o, d, tmax, stats=st)
        torch.cuda.synchronize()
        n_prim = int((pk != pp).sum())
        ulps = {"dist": max_ulps(dk, dp), "bary": max_ulps(bk, bp)}
        hit = pp >= 0
        err = max(float(torch.abs(dk - dp)[hit].max()) if bool(hit.any()) else 0.0,
                  float(torch.abs(bk - bp).max()))
        cls_order, _ = trv.bin_by_dir_class(d, tmax)
        eff = (warp_efficiency(st["visits"]), warp_efficiency(st["visits"], cls_order))
        settled = 0 if tmax is None else int((~(tmax > 0)).sum())
        log(f"[parity] bvh closest hit, {scene} {what} (N = {o.shape[0]}, {settled} lanes "
            f"settled up front): {n_prim} prim ids differ; hits {int(hit.sum())}; largest "
            f"difference {ulps['dist']} ulp on dist, {ulps['bary']} ulp on bary; a lane visits "
            f"{float(st['visits'].float().mean()):.2f} nodes and "
            f"{float(st['leaf_visits'].float().mean()):.3f} leaves, "
            f"{int(st['rows'].sum())} of {nodes.shape[0]} node rows and "
            f"{int(st['leaves'].sum())} of {lt.shape[0]} leaves touched; warp efficiency "
            f"of a thread a ray (mean visits / mean warp-maximum visits): raster order "
            f"{eff[0]:.3f}, class-binned live lanes {eff[1]:.3f}")
        assert n_prim == 0, f"bvh closest hit, {scene} {what}: prim parity"
        assert ulps == {"dist": 0, "bary": 0}, f"bvh {scene} {what}: not bit-equal"
        if tmax is not None:
            dead = ~(tmax > 0)
            assert bool((pk[dead] == -1).all()) and bool((dk[dead] == trv.FLT_MAX).all())
            assert not bool(st["visits"][dead].any())
        max_err["bvh_closest_hit"] = max(max_err["bvh_closest_hit"], err)
        inputs[what] = (o, d, tmax, st)
    assert torch.equal(inputs["extension_ranged"][3]["visits"][live_e],
                       inputs["extension"][3]["visits"][live_e])
    sched = inputs["heatmap_schedule"] = {}
    for what in ("primary", "extension", "interleaved"):
        o, d, _, st = inputs[what]
        hk = trv.intersect_bvh_heatmap_cuda(lt, nodes, o, d)
        hp = plain_run(f"bvh_heatmap/{what}", scene,
                       lambda: trv.intersect_bvh_heatmap_plain(lt, nodes, o, d))
        torch.cuda.synchronize()
        n_steps = int((hk != hp).sum())
        log(f"[parity] bvh heatmap, {scene} {what}: {n_steps} counts differ (mean "
            f"{float(hp.float().mean()):.2f}, max {int(hp.max())} descended nodes)")
        assert n_steps == 0, f"bvh heatmap, {scene} {what}: count parity"
        max_err["bvh_heatmap"] = max(max_err["bvh_heatmap"], float(n_steps))
        if what == "interleaved":
            continue
        # the kernel's schedule from its plain model: a warp's steps (the
        # rows its lanes visit between them) against a lane's visits and
        # the per-thread walk's warp (as long as its longest lane)
        sched[what] = heatmap_schedule(lt, nodes, o, d)
        log(f"[schedule] bvh heatmap, {scene} {what}: {schedule_line(sched[what])}")
    x, y, live = waves["segments"]
    so, sd, tm = (t.contiguous() for t in trv.segment_rays(x, y))
    ok_k = trv.occlusion_bvh_cuda(lt, nodes, so, sd, tm)
    ok_p = plain_run("bvh_occlusion/segments", scene,
                     lambda: trv.occlusion_bvh_plain(lt, nodes, so, sd, tm))
    st = {}
    trv.occlusion_bvh_plain(lt, nodes, so, sd, tm, stats=st)
    torch.cuda.synchronize()
    n_diff = int((ok_k != ok_p).sum())
    live_s = tm > 0
    seg_order, _ = trv.bin_by_dir_class(sd, tm)
    log(f"[parity] bvh occlusion, {scene} NEE segments: {n_diff} / {ok_k.numel()} bits "
        f"differ; occluded {int((ok_p & live).sum())} of {int(live.sum())} live; "
        f"{int(ok_k[~live].sum())} masked (zero-length) segments read as blocked, "
        f"{int((~live_s).sum())} segments settled up front; a lane visits "
        f"{float(st['visits'].float().mean()):.2f} nodes, tests "
        f"{float(st['pairs'].float().mean()):.2f} (lane, triangle) pairs; warp efficiency: "
        f"raster order {warp_efficiency(st['visits']):.3f}, class-binned live lanes "
        f"{warp_efficiency(st['visits'], seg_order):.3f}")
    assert n_diff == 0, f"bvh occlusion, {scene}: shadow parity"
    assert not bool(ok_k[~live].any()), "a zero-length segment was blocked"
    max_err["bvh_occlusion"] = max(max_err["bvh_occlusion"], float(n_diff))
    inputs["segments"] = (so, sd, tm, st)
    # the binning kernel on the frame's two ranged wavefronts
    for what, (d, tmax) in {"extension_ranged": (d_e, t_e), "segments": (sd, tm)}.items():
        queue, counts = trv.bin_by_dir_class_cuda(d, tmax)
        order, want = plain_run(f"bvh_bin/{what}", scene,
                                lambda: trv.bin_by_dir_class(d, tmax))
        torch.cuda.synchronize()
        bounds = [0, *torch.cumsum(want, 0).tolist()]
        n_bad = int((counts.long() != want).sum()) + sum(
            int((torch.sort(queue[a:b].long()).values != order[a:b]).sum())
            for a, b in zip(bounds, bounds[1:]))
        log(f"[parity] bvh binning, {scene} {what}: class counts {counts.tolist()} (plain "
            f"{want.tolist()}), {int(tmax.numel() - want.sum())} lanes settled; {n_bad} counts "
            f"or queue entries differ from bin_by_dir_class's classes")
        assert n_bad == 0 and queue.numel() == order.numel(), f"bvh binning, {scene} {what}"
        max_err["bvh_bin"] = max(max_err["bvh_bin"], float(n_bad))
    return inputs


# (kernel/wavefront key, scene) -> ms a call of 10 calls back to back: the
# BVH walks and the binning, beside the one-call time of every kernel
BACK_TO_BACK_MS = {}
# (kernel/wavefront key, scene) -> ms a call of 10 calls replayed in one
# CUDA graph: the heatmap kernel
REPLAYED_MS = {}


def walk_work(ds, st, n, io_bytes):
    """(f32 operations, bytes read once, bytes at every visit) of a BVH
    walk from the plain walk's counts ``st``: node visits and (lane,
    triangle) pairs at csrc/bvh.cu's operations; the node rows and leaves
    any lane touched, each once, or at every visit (32 B a row, 576 B a
    leaf of 16), beside the rays and the outputs (``io_bytes`` a lane)."""
    from radish_pt_tpu_torch.accel import traverse as trv

    leaf_bytes = ds.leaf_tris.shape[1] * 4
    flops = (float(st["visits"].sum()) * trv.FLOPS_PER_NODE
             + float(st["pairs"].sum()) * trv.FLOPS_PER_PAIR)
    once = (float(st["rows"].sum()) * trv.NODE_BYTES + float(st["leaves"].sum()) * leaf_bytes
            + io_bytes * n)
    every = (float(st["visits"].sum()) * trv.NODE_BYTES
             + float(st["leaf_visits"].sum()) * leaf_bytes + io_bytes * n)
    return flops, once, every


def occlusion_pairs(tri, o, d, tm, chunk: int = 8192) -> float:
    """(ray, triangle) pairs an any-hit sweep in id order needs on these
    segments: each lane's triangles up to its first blocking one, all T
    where none blocks."""
    import torch

    from radish_pt_tpu_torch.accel import traverse as trv

    n, t = o.shape[0], tri.shape[0]
    cols = [tri[None, :, k] for k in range(9)]
    total = 0
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        hit, dist, _, _ = trv._mt_core(*cols, *(o[r0:r1, k:k + 1] for k in range(3)),
                                       *(d[r0:r1, k:k + 1] for k in range(3)))
        blk = hit & (dist < tm[r0:r1, None])
        first = torch.argmax(blk.to(torch.int8), dim=1)  # the first True
        total += int(torch.where(blk.any(1), first + 1, t).sum())
    return float(total)


def drive(scenes, name, settings, module, log, what, frames: int = 8):
    """Loopers 0-``frames - 1`` of scene ``name`` through ``Renderer`` with
    ``settings``, the launches and plain calls of the sweep module
    ``module`` ("plucker", "dense") counted across them.  Returns (the
    renderer, the mean of its current image, the launches)."""
    import torch

    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.utils import timing

    ds, cam = scenes[name]
    tally = timing.Tally()
    r = Renderer(ds=ds, cam=cam, desc=None, settings=settings, device=ds.device)
    for _ in range(frames):
        r.step()
    img = r.current_image()
    torch.cuda.synchronize()
    launches, plain = tally(f"launch.{module}"), tally(f"plain.{module}")
    mean = float(img.mean())
    log(f"[main path] {what}, {name} ({ds.intersector}) {RES}x{RES}: {frames} frames, "
        f"mean {mean:.5f}; kernel launches {launches}, plain-version calls {plain}")
    assert bool(torch.isfinite(img).all()), f"{what}: non-finite pixels"
    assert mean > 0.0, f"{what}: black image"
    assert set(launches) == {"closest_hit", "occlusion"}, f"{what}: a kernel was not launched"
    assert not plain, f"{what}: a plain version ran on the main path"
    return r, mean, launches


def check_closest(pk, dk, pp, dp, live, what, log) -> float:
    """Kernel vs plain closest hit on the live lanes: <= 1e-4 of prim ids
    differ, each a near-tie (|dt| <= 1e-5 t).  Returns max |dist err|
    where both agree."""
    import torch

    diff = (pk != pp) & live
    n_diff, n_lanes = int(diff.sum()), int(live.sum())
    near_tie = torch.abs(dk - dp) <= 1e-5 * torch.abs(dp)
    agree = (pk == pp) & (pp >= 0) & live
    err = float(torch.abs(dk - dp)[agree].max()) if bool(agree.any()) else 0.0
    log(f"[parity] {what}: {n_diff} / {n_lanes} live prim ids differ "
        f"({n_diff / max(n_lanes, 1):.2e}), all near-ties: "
        f"{bool(near_tie[diff].all())}; hits {int(agree.sum())}, "
        f"max |dist err| {err:.3e}")
    assert n_diff <= 1e-4 * n_lanes, f"{what}: prim parity"
    assert bool(near_tie[diff].all()), f"{what}: a prim mismatch is not a near-tie"
    return err


def check_occlusion(ok_k, ok_p, live, what, log) -> float:
    """Kernel vs plain shadow bits: <= 1e-4 differ.  Returns the share that
    differs."""
    n_diff = int((ok_k != ok_p).sum())
    log(f"[parity] {what} occlusion, NEE segments: {n_diff} / {ok_k.numel()} "
        f"bits differ; occluded {int((ok_p & live).sum())} of {int(live.sum())} live")
    assert n_diff <= 1e-4 * ok_k.numel(), f"{what} occlusion parity"
    return n_diff / ok_k.numel()


def key_parity(ds, waves, scene, max_err, log):
    """Phase 3 for the sort-key kernel on a scene's wavefronts: the
    primaries, the bounce-1 extension rays with their dead lanes (the key's
    dead bit) and the NEE segments bounded at their end (``tmax`` 1 on the
    unnormalised segment, masked lanes dead), as ``intersect_primary``,
    ``intersect_sorted`` and ``test_occlusion_sorted`` key them; the band
    engine's count-major form on a band scene.  The kernel's key equals
    the plain version's on every lane.  Returns {wavefront: the kernel's
    arguments} for phase 6."""
    import torch

    from radish_pt_tpu_torch.accel import sort_key as sk
    from radish_pt_tpu_torch.scene import engines

    band = engines.of(ds).group == "band"
    boxes = ds.key_bounds
    o, d, _ = waves["primary"]
    eo, ed, etm = waves["extension"]
    x, y, ok = waves["segments"]
    out = {}
    for what, args in (("primary", (o, d, None, None)),
                       ("extension", (eo, ed, None, etm > 0)),
                       ("segments", (x, y - x, 1.0, ok))):
        args = tuple(a.contiguous() if isinstance(a, torch.Tensor) else a for a in args)
        got = sk.signature_key_cuda(boxes, *args, band=band)
        want = plain_run(f"signature_key/{what}", scene,
                         lambda args=args: sk.signature_key_plain(boxes, *args, band=band))
        n_bad = int((got != want).sum())
        live = got < sk.DEAD_KEY_BIT
        miss_key = sk.miss_key(boxes.shape[0], band)
        log(f"[parity] signature_key, {scene} {what} ({boxes.shape[0]} super-clusters of "
            f"{ds.cluster_bounds.shape[0]} clusters, {'count-major' if band else 'signature'} "
            f"form): {n_bad} of {got.numel()} keys differ from the plain version's; live "
            f"lanes {int(live.sum())}, distinct live keys {int(torch.unique(got[live]).numel())}, "
            f"live lanes that reach no box {int((live & (got == miss_key)).sum())}")
        assert n_bad == 0, f"signature_key, {scene} {what}: keys differ"
        max_err["signature_key"] = max(max_err["signature_key"], float(n_bad))
        out[what] = args
    return out


def frame_stages(fn) -> dict:
    """One ``fn()`` (a frame, after one warm-up call) under
    ``torch.profiler``: stage -> its kernels' summed device ms, the stages
    of ``radish_pt_tpu_torch.profile.STAGES`` ("sort key", "sort +
    permute", the sweeps; "other" for the rest), and "busy", the sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from radish_pt_tpu_torch.profile import STAGES

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"busy": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        stage = next((st for frag, st in STAGES if frag in e.name), "other")
        ms = e.time_range.elapsed_us() / 1e3
        out[stage] = out.get(stage, 0.0) + ms
        out["busy"] += ms
    return out


def main_path(scenes, names, module, log, kinds=("closest_hit", "occlusion")):
    """Loopers 0-7 of each named scene through ``Renderer``, the launches
    and plain calls of the kernel module ``module`` ("plucker", "traverse")
    counted across them; each kernel of ``kinds`` launched.  Returns
    (launches, frames)."""
    import torch

    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.utils import timing

    tally = timing.Tally()
    for name in names:
        ds, cam = scenes[name]
        r = Renderer(ds=ds, cam=cam, desc=None, device=ds.device)
        r.settings.trace_depth = depth_of(name)
        for _ in range(8):  # loopers 0-7
            r.step()
        img = r.current_image()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(img).all()), f"{name}: non-finite pixels"
        assert float(img.mean()) > 0.0, f"{name}: black image"
        log(f"[main path] {name} ({ds.intersector}): {RES}x{RES}, depth "
            f"{depth_of(name)}, 8 spp accumulated, mean (compressed) "
            f"{float(img.mean()):.5f}")
    launches, plain = tally(f"launch.{module}"), tally(f"plain.{module}")
    log(f"[main path] {', '.join(names)}: kernel launches {launches}, "
        f"plain-version calls {plain}")
    assert all(launches.get(k, 0) > 0 for k in kinds), "a kernel was not launched"
    assert not plain, "a plain version ran on the main path"
    return launches, 8 * len(names)


# phase 7: (scene entry, frames a block) of the batched path tracer: block 4,
# teapot_hires 2 as bench.py times it (bench.py:225); the compact engine's
# blocks run eagerly (its work list reads its length on the host)
BATCH_CELLS = (("teapot", 4), ("teapot_hires_band", 2), ("teapot_quad", 4),
               ("cornell_dense", 4), ("teapot_bvh", 4), ("teapot_hires_bvh", 2),
               ("teapot_hires", 2))
RESTIR_BLOCK = 8


def traced_block(fn):
    """``fn()`` (a block of frames) under ``torch.profiler``: (sweep
    launches by kind from the kernel names on the device, its kernels'
    summed device ms, its CUDA-event ms under the profiler, device
    operations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from radish_pt_tpu_torch.profile import STAGES

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kinds = {"closest_hit": 0, "occlusion": 0, "bin": 0}
    for e in kernels:  # the sweep kernels by name; the sphere prepass is neither
        stage = next((st for frag, st in STAGES if frag in e.name), "")
        if "closest" in stage:
            kinds["closest_hit"] += 1
        elif "shadow" in stage:
            kinds["occlusion"] += 1
        elif stage == "bvh binning":
            kinds["bin"] += 1
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return kinds, busy_ms, start.elapsed_time(end), len(kernels)


def batched_phase(scenes, log, card):
    """Phase 7: blocks of frames through ``Renderer.run_block`` (the path
    tracer) and ``Renderer.step_batched_restir`` (ReSTIR), each block one
    CUDA graph replay on the Plücker, band, quad, dense and bvh engines and
    eager on the compact engine.  Each cell: the launch counts set to 0
    just before its two blocks and read just after; both blocks equal to
    the same frames run eagerly by ``step()``, bit for bit; the launches a
    replay, from the replay counters and once from a profiler trace; then
    the block's ms/frame beside the eager ``step()`` frame (CUDA events)
    and the device-busy share of a replayed block.  Returns {cell: record}."""
    import torch

    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.utils.timing import Tally, under

    dev = scenes["teapot"][0].device
    restir_offsets_check(dev, log, "[batched]")

    def renderers(name, settings):
        ds, cam = scenes[name]
        return [Renderer(ds=ds, cam=cam, desc=None, settings=settings, device=ds.device)
                for _ in range(2)]

    def states_equal(a, b):
        pairs = [("direct", a.direct, b.direct), ("indirect", a.indirect, b.indirect)]
        pairs += [(f"reservoir.{f}", getattr(a.reservoir, f), getattr(b.reservoir, f))
                  for f in ("li", "wi", "dist", "num", "weight")]
        return [what for what, x, y in pairs if not torch.equal(x, y)]

    def timing(name, eager, batched, block, expect):
        """(eager ms/frame, batched ms/frame, busy share of a profiled
        block, device operations a frame, the eager frames' busy share) of
        one cell, and the traced launches.  A busy share is the kernels'
        summed time over the block's CUDA-event time under the profiler
        (which slows the host: the eager frames' share reads low); beside
        it, logged, the same kernel time over the unprofiled block."""
        expect = {"bin": 0, **expect}  # the binning kernel: the bvh engine's alone
        eager_ms = cuda_ms(lambda: [eager.step() for _ in range(block)], reps=3) / block
        batch_ms = cuda_ms(lambda: batched.run_block(block), reps=3) / block
        kinds, busy, wall, ops = traced_block(lambda: batched.run_block(block))
        # the profiler can lose a replay's records (one call traced 23 of a
        # quad block's 24 closest hits and 73 fewer operations a frame, its
        # replays bit-equal to step()): a short trace is taken again, at
        # most twice, and the check below holds the last
        for _ in range(2):
            if batched.batch_mode != "graph" or kinds == expect:
                break
            log(f"[batched] {name}: a profiled block traced {kinds} sweeps (want {expect}), "
                f"{ops / block:.0f} device operations a frame: records lost, traced again")
            kinds, busy, wall, ops = traced_block(lambda: batched.run_block(block))
        # one eager frame: tracing a frame's thousands of host-issued
        # operations is what makes the profiler slow
        _, busy_e, wall_e, ops_e = traced_block(eager.step)
        log(f"[batched] {name}: a profiled block launched {kinds} sweeps (want {expect}), "
            f"{ops / block:.0f} device operations a frame, kernels {busy / block:.3f} ms a "
            f"frame: {100 * busy / wall:.1f}% of the profiled block, "
            f"{100 * busy / (batch_ms * block):.1f}% of the unprofiled one; an eager step() "
            f"frame: {ops_e:.0f} device operations, kernels {busy_e:.3f} ms: "
            f"{100 * busy_e / wall_e:.1f}% of the profiled frame, "
            f"{100 * busy_e / eager_ms:.1f}% of an unprofiled one")
        if batched.batch_mode == "graph":
            assert kinds == expect, (name, kinds, expect)
        return eager_ms, batch_ms, busy / wall, ops / block, busy_e / wall_e

    out = {}
    for name, block in BATCH_CELLS:
        t_cell = time.perf_counter()
        ds = scenes[name][0]
        depth = depth_of(name)
        eager, batched = renderers(name, Settings(tracer=Tracer.STREAMED, trace_depth=depth))
        mode = "eager" if ds.intersector == "compact" else "graph"
        assert batched.batch_mode == mode, (name, batched.batch_mode)
        module = "launch." + ("traverse" if ds.intersector == "bvh" else ds.intersector)
        tally = Tally()
        for _ in range(2):
            run = batched.run_block(block)
        torch.cuda.synchronize()
        per = {"closest_hit": block * (depth + 1), "occlusion": block * depth}
        if ds.intersector == "bvh":  # one binning launch before each walk
            per["bin"] = per["closest_hit"] + per["occlusion"]
        launches = {k: n for k, n in tally(module).items() if k in per}
        for _ in range(2 * block):
            eager.step()
        torch.cuda.synchronize()
        differ = states_equal(eager, batched)
        # graph: the warm-up block and two replays; eager: two blocks
        want = {k: (3 if mode == "graph" else 2) * v for k, v in per.items()}
        per_replay = under(run.counts_per_replay, module)
        log(f"[batched] {name} ({ds.intersector}) {RES}x{RES} depth {depth}, blocks of "
            f"{block}: batch mode {batched.batch_mode}; two blocks equal to {2 * block} "
            f"eager step() frames bit for bit: {not differ} {differ or ''}; launches "
            f"{launches} (want {want}), a replay {per_replay}, replays {run.replays}")
        assert not differ, f"{name}: the batched frames differ from step(): {differ}"
        assert launches == want, (name, launches, want)
        if mode == "graph":
            assert per_replay == per, (name, per_replay, per)
        eager_ms, batch_ms, busy, ops, busy_e = timing(name, eager, batched, block, per)
        log(f"[timing] {name} ({ds.intersector}) {RES}x{RES} depth {depth}: batched "
            f"{batch_ms:.3f} ms/frame (blocks of {block}, {mode}) vs eager step() "
            f"{eager_ms:.3f} ms/frame; device busy {100 * busy:.1f}% of a profiled block "
            f"({100 * (1 - busy):.1f}% idle), {ops:.0f} device operations a frame ({card}); "
            f"the cell took {time.perf_counter() - t_cell:.1f} s")
        out[name] = {"engine": ds.intersector, "mode": mode, "block": block,
                     "batched_ms_per_frame": batch_ms, "eager_ms_per_frame": eager_ms,
                     "busy_share": busy, "eager_busy_share": busy_e,
                     "ops_per_frame": ops, "launches": launches,
                     "launches_per_replay": per_replay}

    # ReSTIR DI on cornell's dense engine: step_batched_restir, a camera move
    # between the two blocks
    name, block = "cornell_dense", RESTIR_BLOCK
    eager, batched = renderers(name, Settings(tracer=Tracer.RESTIR_DI))
    assert batched.batch_mode == "graph"
    moved = (scenes[name][1].position + torch.tensor([0.05, 0.0, 0.0], device=dev)).tolist()
    tally = Tally()
    batched.step_batched_restir(block)
    first = {"direct": batched.direct.clone(),
             **{f: getattr(batched.reservoir, f).clone()
                for f in ("li", "wi", "dist", "num", "weight")}}
    batched.update_camera(position=moved)
    batched.step_batched_restir(block)
    torch.cuda.synchronize()
    launches = tally("launch.dense")
    ris_launches, ris_plain = tally("launch.ris"), tally("plain.ris")
    run = batched.last_runner
    per_replay = {m: under(run.counts_per_replay, f"launch.{m}") for m in ("dense", "ris")}
    for _ in range(block):
        eager.step()
    differ = [k for k, v in first.items()
              if not torch.equal(v, eager.direct if k == "direct" else getattr(eager.reservoir, k))]
    eager.update_camera(position=moved)
    for _ in range(block):
        eager.step()
    torch.cuda.synchronize()
    differ += [f"after the move: {d}" for d in states_equal(eager, batched)]
    differ += [f"gbuf_last.{f}" for f in ("normal", "prim_id", "depth")
               if not torch.equal(getattr(eager.gbuf_last, f), getattr(batched.gbuf_last, f))]
    per = {"closest_hit": block + 1, "occlusion": block}  # + the G-buffer's
    want = {k: 3 * v for k, v in per.items()}
    log(f"[batched] ReSTIR DI, {name} {RES}x{RES}, step_batched_restir({block}) twice, "
        f"the camera moved between: equal to {2 * block} eager step() frames bit for "
        f"bit: {not differ} {differ or ''}; launches {launches} (want {want}), a replay "
        f"{per_replay['dense']}; RIS launches {ris_launches} (want "
        f"{3 * block}), plain calls {ris_plain}, a replay {per_replay['ris']}")
    assert not differ, f"ReSTIR: the batched frames differ from step(): {differ}"
    assert launches == want and per_replay["dense"] == per
    # one candidate RIS launch a frame, as the dense sweeps count theirs
    assert ris_launches == {"ris": 3 * block} and ris_plain == {}
    assert per_replay["ris"] == {"ris": block}
    eager_ms, batch_ms, busy, ops, busy_e = timing(f"{name} ReSTIR", eager, batched, block,
                                                   per)
    log(f"[timing] {name} ReSTIR DI {RES}x{RES}: batched {batch_ms:.3f} ms/frame (blocks "
        f"of {block}, graph) vs eager step() {eager_ms:.3f} ms/frame; device busy "
        f"{100 * busy:.1f}% of a profiled block ({100 * (1 - busy):.1f}% idle), {ops:.0f} device "
        f"operations a frame ({card})")
    out[f"{name}_restir"] = {"engine": "dense", "mode": "graph", "block": block,
                             "batched_ms_per_frame": batch_ms,
                             "eager_ms_per_frame": eager_ms, "busy_share": busy,
                             "eager_busy_share": busy_e,
                             "ops_per_frame": ops, "launches": launches,
                             "launches_per_replay": per}
    return out


# (scene, frames a block) whose frames are timed beside the parent
# checkout's (--parent): the path tracer at its engine by size, eager step()
# and replayed blocks; then cornell's ReSTIR DI on the dense engine
FRAME_TIME_CELLS = (("teapot", 4), ("teapot_hires", 2), ("glass", 4), ("env_teapot", 4))
RESTIR_TIME_CELL = ("cornell", RESTIR_BLOCK, "dense")


def frame_times(root: str) -> dict:
    """ms/frame of eager ``step()`` frames and of replayed blocks
    (``run_block``; eager on an engine that is not captured) of the package
    in the checkout at ``root``, at 800x800 on the cells of
    :data:`FRAME_TIME_CELLS` and :data:`RESTIR_TIME_CELL` (CUDA events,
    median of 3 runs of a block).  Runs in a process of its own
    (``--frame-times``): two versions of the package cannot share one."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import radish_pt_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(radish_pt_tpu_torch.__file__)))
    assert pkg_root == os.path.abspath(root), (pkg_root, root)
    assert "jax" not in sys.modules
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    cells = [(name, block, Tracer.STREAMED, None) for name, block in FRAME_TIME_CELLS]
    cells.append((RESTIR_TIME_CELL[0], RESTIR_TIME_CELL[1], Tracer.RESTIR_DI,
                  RESTIR_TIME_CELL[2]))
    out = {}
    for name, block, tracer, engine in cells:
        ds, cam, _ = load_scene(os.path.join(REPO, "scenes", SCENE_FILES[name]),
                                device="cuda", intersector=engine)
        cam = cam.replace(width=RES, height=RES)
        settings = Settings(tracer=tracer, trace_depth=depth_of(name))
        eager, batched = (Renderer(ds=ds, cam=cam, desc=None, settings=settings, device="cuda")
                          for _ in range(2))
        eager_ms = cuda_ms(lambda: [eager.step() for _ in range(block)], reps=3) / block
        for _ in range(2):  # build, warm up, capture
            batched.run_block(block)
        batch_ms = cuda_ms(lambda: batched.run_block(block), reps=3) / block
        key = name if tracer == Tracer.STREAMED else f"{name}_restir"
        out[key] = {"engine": ds.intersector, "mode": batched.batch_mode, "block": block,
                    "eager_ms_per_frame": eager_ms, "batched_ms_per_frame": batch_ms}
    return out


def parent_frame_times(parent: str, log, card) -> dict:
    """The frame times of :func:`frame_times` for the parent checkout and
    this tree, each in a subprocess of its own, in turns: parent, this
    tree, this tree, parent.  Returns {cell: {"parent": [ms, ms], "this":
    [ms, ms]} for eager and batched}."""
    runs = []
    for root in (parent, REPO, REPO, parent):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--frame-times",
                              os.path.abspath(root)], capture_output=True, text=True,
                             timeout=900)
        assert res.returncode == 0, f"frame times of {root}: {res.stderr[-4000:]}"
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("FRAME_TIMES ")][-1]
        runs.append(("parent" if root == parent else "this",
                     json.loads(line.removeprefix("FRAME_TIMES "))))
        log(f"[parent] frame times of {'the parent' if root == parent else 'this tree'} "
            f"({root}) in a subprocess: {time.perf_counter() - t0:.1f} s")
    out = {}
    for cell in runs[0][1]:
        rec = out.setdefault(cell, {"engine": runs[1][1][cell]["engine"],
                                    "mode": runs[1][1][cell]["mode"],
                                    "block": runs[1][1][cell]["block"]})
        for who, times in runs:
            for kind in ("eager_ms_per_frame", "batched_ms_per_frame"):
                rec.setdefault(f"{who}_{kind}", []).append(times[cell][kind])
        log(f"[parent] {cell} ({rec['engine']}, blocks of {rec['block']}, {rec['mode']}) "
            f"{RES}x{RES}: eager step() ms/frame parent "
            f"{' / '.join(f'{x:.3f}' for x in rec['parent_eager_ms_per_frame'])}, this tree "
            f"{' / '.join(f'{x:.3f}' for x in rec['this_eager_ms_per_frame'])}; replayed "
            f"block ms/frame parent "
            f"{' / '.join(f'{x:.3f}' for x in rec['parent_batched_ms_per_frame'])}, this tree "
            f"{' / '.join(f'{x:.3f}' for x in rec['this_batched_ms_per_frame'])} "
            f"(in turns: parent, this, this, parent) ({card})")
    return out


def replayed_frames(root: str, out: str) -> None:
    """:data:`PARENT_FRAME_BLOCKS` replayed ``run_block(4)`` blocks (from
    looper :data:`PARENT_FRAME_LOOPER`, 800x800, depth 5) of each scene of
    :data:`PARENT_FRAME_SCENES` by the package in the checkout at ``root``,
    their accumulated direct and indirect images saved to ``out`` (.npz).
    Runs in a process of its own (``--frames``)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import radish_pt_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(radish_pt_tpu_torch.__file__)))
    assert pkg_root == os.path.abspath(root), (pkg_root, root)
    assert "jax" not in sys.modules
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    images = {}
    for name, path in PARENT_FRAME_SCENES.items():
        ds, cam, _ = load_scene(os.path.join(REPO, path), device="cuda")
        r = Renderer(ds=ds, cam=cam.replace(width=RES, height=RES), desc=None, device="cuda",
                     settings=Settings(tracer=Tracer.STREAMED, trace_depth=DEPTH))
        r.state.looper = PARENT_FRAME_LOOPER
        for _ in range(PARENT_FRAME_BLOCKS):
            r.run_block(4)
        assert r.batch_mode == "graph", (name, r.batch_mode)
        for buf in ("direct", "indirect"):
            images[f"{name}/{buf}"] = getattr(r, buf).cpu().numpy()
    np.savez(out, **images)


def parent_frames(parent: str, log, card) -> dict:
    """The replayed frames of :func:`replayed_frames` from the parent
    checkout and from this tree, each in a subprocess of its own, held equal
    bit for bit.  Returns {scene/buffer: values differing}."""
    import tempfile

    import numpy as np

    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for who, root in (("parent", parent), ("this", REPO)):
            path = os.path.join(tmp, f"frames_{who}.npz")
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--frames",
                                  os.path.abspath(root), path], capture_output=True, text=True,
                                 timeout=900)
            assert res.returncode == 0, f"frames of {root}: {res.stderr[-4000:]}"
            with np.load(path) as npz:
                got[who] = {k: npz[k] for k in npz.files}
            log(f"[parent] {PARENT_FRAME_BLOCKS} replayed blocks of 4 of "
                f"{', '.join(PARENT_FRAME_SCENES)} by {who} ({root}) in a subprocess: "
                f"{time.perf_counter() - t0:.1f} s")
    differ = {}
    for key in got["this"]:
        a, b = got["this"][key], got["parent"][key]
        same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))
        differ[key] = int((~same).sum())
        log(f"[parent] {key}: {a.size} values after {4 * PARENT_FRAME_BLOCKS} frames from "
            f"looper {PARENT_FRAME_LOOPER} ({RES}x{RES}, depth {DEPTH}), {differ[key]} "
            f"differing from the parent's ({card})")
    assert not any(differ.values()), differ
    return differ


def parent_kernel_times(parent: str, scenes, inputs, log, card) -> dict:
    """With ``--parent``: this tree's sort-key, binning and heatmap kernels
    beside the parent checkout's, built from its ``radish_pt_tpu_torch/csrc``
    into ``_build/parent`` and called through this tree's wrappers (the C
    entry points take the same arguments; the binning's workspace is this
    tree's larger one), on phase 3's wavefronts (the heatmap's: the bvh
    scenes' primaries and bounce-1 extension rays).  The parent's keys and
    heatmap counts equal this tree's on every lane and its binning counts
    this tree's classes; each kernel timed one call, 10 calls back to back,
    and 10 calls captured in one CUDA graph and replayed (the card's time
    alone: no host issue between the calls), in turns: parent, this tree,
    this tree, parent.  Then the heatmap tracer's frame (``Renderer.step``,
    teapot and teapot_hires on the bvh engine) through either tree's
    kernel, its image equal, in the same turns.  Returns {"kernel/wavefront
    scene": {"parent_ms": [ms, ms], "this_ms": [...],
    "parent_ms_back_to_back": [...], "this_ms_back_to_back": [...],
    "parent_ms_replayed": [...], "this_ms_replayed": [...]}, "heatmap
    frame scene": {"parent_ms": [...], "this_ms": [...]}}."""
    import torch

    from radish_pt_tpu_torch.accel import _build
    from radish_pt_tpu_torch.accel import sort_key as sk
    from radish_pt_tpu_torch.accel import traverse as trv

    csrc = os.path.join(os.path.abspath(parent), "radish_pt_tpu_torch", "csrc")
    build_dir = os.path.join(_build.BUILD_DIR, "parent")
    t0 = time.perf_counter()
    _build.build_all(("sort_key", "bvh"), csrc=csrc, build_dir=build_dir)
    theirs = {lib: _build.load_library(lib, csrc=csrc, build_dir=build_dir)
              for lib in ("sort_key", "bvh")}
    ours = {lib: _build.load_library(lib) for lib in theirs}
    log(f"[parent] the parent's csrc/sort_key.cu and csrc/bvh.cu built into "
        f"{os.path.relpath(build_dir, REPO)} in {time.perf_counter() - t0:.2f} s")

    def as_parent(lib, fn):
        _build._libs[lib] = theirs[lib]
        try:
            return fn()
        finally:
            _build._libs[lib] = ours[lib]

    cases = {}
    for scene, waves in inputs["signature_key"].items():
        ds = scenes[scene][0]
        band = ds.intersector in ("band", "band_plain")
        for what, (o, d, tmax, active) in waves.items():
            def key(ds=ds, o=o, d=d, tmax=tmax, active=active, band=band):
                return sk.signature_key_cuda(ds.key_bounds, o, d, tmax, active, band)
            cases[f"signature_key/{what} {scene}"] = ("sort_key", key)
    for scene in ("teapot_bvh", "teapot_hires_bvh"):
        for what in ("extension_ranged", "segments"):
            _, d, tmax, _ = inputs["bvh"][scene][what]
            cases[f"bvh_bin/{what} {scene}"] = (
                "bvh", lambda d=d, tmax=tmax: trv.bin_cuda(d, tmax))
        lt, nodes = scenes[scene][0].leaf_tris, scenes[scene][0].bvh_packed
        for what in ("primary", "extension"):
            o, d, _, _ = inputs["bvh"][scene][what]
            cases[f"bvh_heatmap/{what} {scene}"] = (
                "bvh", lambda lt=lt, nodes=nodes, o=o, d=d:
                trv.intersect_bvh_heatmap_cuda(lt, nodes, o, d))
    out = {}
    for case, (lib, fn) in cases.items():
        ours_out, theirs_out = fn(), as_parent(lib, fn)
        torch.cuda.synchronize()
        if lib == "sort_key" or case.startswith("bvh_heatmap/"):
            same = torch.equal(ours_out, theirs_out)
        else:  # the binning's counts, after its six regions in either tree
            k = (ours_out.numel() - trv.WS_COUNTERS) // trv.DIR_CLASSES * trv.DIR_CLASSES
            same = torch.equal(ours_out[k:k + 7], theirs_out[k:k + 7])
        assert same, f"{case}: the parent's kernel disagrees with this tree's"
        rec = out[case] = {}

        def three(fn=fn):  # one call, 10 back to back, 10 in a replayed graph
            return cuda_ms(fn, 5), cuda_ms(fn, 5, inner=10), replayed_ms(fn)

        for who in ("parent", "this", "this", "parent"):
            times = as_parent(lib, three) if who == "parent" else three()
            for kind, ms in zip(("ms", "ms_back_to_back", "ms_replayed"), times):
                rec.setdefault(f"{who}_{kind}", []).append(ms)

        def pair(kind):
            return (f"parent {' / '.join(f'{x:.4f}' for x in rec[f'parent_{kind}'])}, this tree "
                    f"{' / '.join(f'{x:.4f}' for x in rec[f'this_{kind}'])} ms")

        log(f"[parent] {case}: one call {pair('ms')}; 10 back to back {pair('ms_back_to_back')} "
            f"a call; replayed (10 calls in one CUDA graph) {pair('ms_replayed')} a call (in "
            f"turns: parent, this, this, parent; results equal) ({card})")
    # the heatmap tracer's frame through either tree's heatmap kernel
    from radish_pt_tpu_torch.config import Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer

    for scene in ("teapot_bvh", "teapot_hires_bvh"):
        ds, cam = scenes[scene]
        r = Renderer(ds=ds, cam=cam, desc=None, settings=Settings(tracer=Tracer.BVH_VISUALIZE),
                     device=ds.device)
        same = torch.equal(r._bvh_heatmap(), as_parent("bvh", r._bvh_heatmap))
        assert same, f"{scene}: the parent's heatmap image differs from this tree's"
        rec = out[f"heatmap frame {scene}"] = {}
        for who in ("parent", "this", "this", "parent"):
            ms = (as_parent("bvh", lambda: cuda_ms(r.step, reps=5)) if who == "parent"
                  else cuda_ms(r.step, reps=5))
            rec.setdefault(f"{who}_ms", []).append(ms)
        log(f"[parent] BVH heatmap tracer, {scene} {RES}x{RES}, ms a frame (Renderer.step, "
            f"median of 5): parent {' / '.join(f'{x:.3f}' for x in rec['parent_ms'])}, this "
            f"tree {' / '.join(f'{x:.3f}' for x in rec['this_ms'])} (in turns: parent, this, "
            f"this, parent; images equal) ({card})")
    return out


def sync_counts(scenes, log) -> dict:
    """Phase 7's last check: on cornell at the benchmark's size, the
    tracing's ``host_syncs`` a call against the synchronizing operations
    ``torch.cuda.set_sync_debug_mode("warn")`` reports for the same call,
    on the benchmark's two entries (3 calls after the first, which warms
    up and captures).  Returns {entry: [(counted, reported)] a call}."""
    import torch

    from radish_pt_tpu_torch.config import Denoiser, ReservoirReuse, Settings, Tracer
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.utils import timing

    ds, cam = scenes["cornell"]
    pt_r = Renderer(ds=ds, cam=cam, desc=None, device=ds.device, settings=Settings(
        tracer=Tracer.STREAMED, trace_depth=DEPTH, denoiser=Denoiser.NONE))
    rs_r = Renderer(ds=ds, cam=cam, desc=None, device=ds.device, settings=Settings(
        tracer=Tracer.RESTIR_DI, reservoir_reuse=ReservoirReuse.TEMPORAL_SPATIAL,
        reservoir_size=32, temporal_clamp=20, denoiser=Denoiser.NONE,
        animate_camera=True, animate_radius=2.0, animate_speed=1.0))
    out = {}
    for entry, call, want in (("run_block(4)", lambda: pt_r.run_block(4), 0),
                              ("step_batched_restir(1)", lambda: rs_r.step_batched_restir(1), 1)):
        call()
        torch.cuda.synchronize()
        out[entry] = []
        for _ in range(3):
            counted, reported = timing.sync_check(call)
            out[entry].append((counted, len(reported)))
            assert counted == len(reported) == want, (entry, counted, reported)
        torch.cuda.synchronize()
        log(f"[syncs] cornell {cam.width}x{cam.height} {entry}: host_syncs a call "
            f"{[c for c, _ in out[entry]]}, sync debug mode {[n for _, n in out[entry]]}")
    return out


def mesh_phase(scenes, log, card) -> dict:
    """Phase 9: the multi-device path on one card, each tile of a mesh
    over ``[cuda:0] * n`` (parallel/sharding.py).  Each path is driven
    through its entry point with the launch counts of its kernels set to 0
    just before and read just after; every check raises.  Returns the
    phase's record."""
    import socket
    import threading
    import urllib.request

    import numpy as np
    import torch

    from radish_pt_tpu_torch import webviewer as wv
    from radish_pt_tpu_torch.config import Denoiser, ReservoirReuse, Settings, Tracer
    from radish_pt_tpu_torch.parallel import dryrun
    from radish_pt_tpu_torch.parallel import multihost as mh
    from radish_pt_tpu_torch.parallel import sharding as sh
    from radish_pt_tpu_torch.render import denoise as dn
    from radish_pt_tpu_torch.render import gbuffer as gb
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.utils import pairstats as ps
    from radish_pt_tpu_torch.utils import timing

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    rec = {"card": card}

    def mesh(n_tile, n_sample=1):
        return sh.make_mesh(n_tile, n_sample, devices=[dev] * (n_tile * n_sample))

    def counted(fn, mods):
        """``fn()`` and the launches of the kernel modules ``mods`` it
        counted: (result, {module: launches}); no plain call."""
        tally = timing.Tally()
        out = fn()
        torch.cuda.synchronize()
        plain = {m: tally(f"plain.{m}") for m in mods}
        assert not any(plain.values()), f"a plain version ran on the mesh path: {plain}"
        return out, {m: tally(f"launch.{m}") for m in mods}

    # ---- tile-sharded frames against the single-device frame ----
    m4 = mesh(MESH_TILES)
    for name, mods in (("teapot", ("plucker", "sort_key")),
                       ("cornell", ("plucker", "sort_key"))):
        ds, cam = scenes[name]
        d = DEPTH
        got, launches = counted(lambda: sh.render_frame_sharded(m4, ds, cam, 7, d), mods)
        want = sum(pt.path_trace(ds, cam, 7, d))
        keys = 2 * d + 1 if ds.cluster_bounds is not None else 0
        expect = {"plucker": {"closest_hit": MESH_TILES * (d + 1),
                              "occlusion": MESH_TILES * d},
                  "sort_key": {"signature_key": MESH_TILES * keys} if keys else {}}
        assert launches == expect, (name, launches, expect)
        if name == "cornell":  # no clusters: no lane shares a culling decision
            assert torch.equal(got, want), "cornell: the mesh frame differs"
            flips = 0
        else:
            flips = dryrun.frames_match(got.cpu().numpy(), want.cpu().numpy(),
                                        atol=FLIP_ATOL, max_flips=FLIP_MAX,
                                        mean_atol=FLIP_MEAN)
        mesh_ms = cuda_ms(lambda: sh.render_frame_sharded(m4, ds, cam, 8, d), reps=3)
        single_ms = cuda_ms(lambda: pt.path_trace(ds, cam, 8, d), reps=3)
        rec[name] = {"tiles": MESH_TILES, "flips": flips, "mesh_ms": mesh_ms,
                     "single_ms": single_ms, "launches": launches}
        log(f"[mesh] {name} ({ds.intersector}) {RES}x{RES} depth {d}: {MESH_TILES} tiles "
            f"on one card, {flips} pixels off by > {FLIP_ATOL} against the single-device "
            f"frame (bound {FLIP_MAX}); frame {mesh_ms:.3f} ms on the mesh, {single_ms:.3f} "
            f"ms on one device ({card}); launches {launches}")

    # ---- the sample axis: (2 tiles x 2 samples) against two frames ----
    ds, cam = scenes["cornell"]
    m22 = mesh(2, 2)
    zeros = sh.shard_image(m22, torch.zeros((RES * RES, 3), device=dev))
    got = sh.gather(sh.pt_step_sharded(m22, ds, cam, zeros, 3, 0, max_depth=DEPTH))
    a, b = (sum(pt.path_trace(ds, cam, lp, DEPTH)) for lp in (3, 3 + sh.SAMPLE_STRIDE))
    want = pt.accumulate(torch.zeros_like(a), pt.scrub_and_compress((a + b) / 2.0), 0)
    assert torch.equal(got, want), "the sample axis is not the mean of its replicas"
    log("[mesh] cornell (2 tiles x 2 samples) pt_step_sharded: equal to the mean of the "
        "looper 3 and 40 frames, scrubbed and accumulated")

    # ---- ReSTIR on 2 tiles (dense engine): the seam rule ----
    ds, cam = scenes["cornell_dense"]
    m2 = mesh(2)
    settings = Settings(tracer=Tracer.RESTIR_DI)
    r = Renderer(ds=ds, cam=cam, desc=None, settings=settings, device=dev, mesh=m2)
    _, launches = counted(lambda: [r.step() for _ in range(2)], ("dense",))
    assert set(launches["dense"]) == {"closest_hit", "occlusion"}, launches
    tiled, single, seams = dryrun.seam_check(m2, ds, cam)
    rejected = dryrun.seam_rule(tiled, single, seams)
    assert np.array_equal(r.current_image().cpu().numpy().reshape(tiled.shape), tiled)
    r1 = Renderer(ds=ds, cam=cam, desc=None, settings=settings, device=dev)
    restir_mesh_ms = cuda_ms(r.step, reps=3)
    restir_single_ms = cuda_ms(r1.step, reps=3)
    rec["restir"] = {"tiles": 2, "seam_rejections": rejected, "mesh_ms": restir_mesh_ms,
                     "single_ms": restir_single_ms, "launches": launches}
    log(f"[mesh] cornell ReSTIR (dense) on 2 tiles, 2 frames: rows > 5 from the seam "
        f"equal to one device, {rejected} seam-band pixels rejected cross-tile "
        f"candidates; Renderer.step {restir_mesh_ms:.3f} ms on the mesh, "
        f"{restir_single_ms:.3f} ms on one device; launches {launches}")

    # ---- SVGF in mesh mode against the single-device filter ----
    ds, cam = scenes["cornell"]
    r = Renderer(ds=ds, cam=cam, desc=None, device=dev, mesh=m4,
                 settings=Settings(tracer=Tracer.STREAMED, trace_depth=DEPTH,
                                   denoiser=Denoiser.SVGF))
    acc = torch.zeros((RES * RES, 3), device=dev)
    state, last = dn.empty_svgf_state(RES * RES, device=dev), None
    for i in range(2):
        r.step()
        acc = pt.accumulate(acc, pt.scrub_and_compress(sum(pt.path_trace(ds, cam, i, DEPTH))),
                            i)
        g = gb.render_gbuffer(ds, cam, cam)
        last = g.frame if last is None else last
        want, state = dn.svgf_filter(acc, state, g, last, cam, i == 0)
        last = g.frame
    assert torch.equal(r.current_image(), want), "mesh-mode SVGF differs"
    log("[mesh] cornell pt + SVGF on 4 tiles, 2 frames: equal to SVGF on the "
        "single-device accumulation and G-buffer")

    # ---- batched blocks, one CUDA graph a tile, against step() ----
    ds, cam = scenes["teapot"]
    settings = Settings(tracer=Tracer.STREAMED, trace_depth=DEPTH)
    a = Renderer(ds=ds, cam=cam, desc=None, settings=settings, device=dev, mesh=m4)
    b = Renderer(ds=ds, cam=cam, desc=None, settings=settings, device=dev, mesh=m4)
    img, launches = counted(lambda: a.render_batched(4, block=2),
                            ("plucker", "sort_key"))
    runners = [held[1] for held in a._runners.values()]
    assert len(runners) == MESH_TILES and {run.mode for run in runners} == {"graph"}
    per_replay = {"closest_hit": 2 * (DEPTH + 1), "occlusion": 2 * DEPTH}
    for run in runners:  # a tile's replay: its block's sweeps
        assert run.replays == 2 and timing.under(run.counts_per_replay,
                                                 "launch.plucker") == per_replay
    # each tile: its eager warm-up block (2 frames) and two replays (4)
    expect = {k: MESH_TILES * 3 * v for k, v in per_replay.items()}
    assert launches["plucker"] == expect, (launches, expect)
    assert np.array_equal(img, b.render(4)), "mesh blocks differ from step()"
    batched_ms = cuda_ms(lambda: a.run_block(2), reps=3) / 2
    rec["batched"] = {"tiles": MESH_TILES, "block": 2, "ms_per_frame": batched_ms,
                      "launches": launches}
    log(f"[mesh] teapot render_batched on 4 tiles (one graph a tile, blocks of 2): equal "
        f"to 4 step() frames; {batched_ms:.3f} ms/frame; launches {launches}")

    # ---- batched ReSTIR on a mesh: the seams exchanged, equal to one device ----
    def restir_state(r):
        return {"direct": r._full(r.direct).clone(),
                **{f"res.{k}": v.clone() for k, v in
                   vars(r._full(r.reservoir)).items()},
                **{f"gbuf_last.{k}": v.clone() for k, v in
                   vars(r._full(r.gbuf_last)).items()}}

    def two_blocks(r, moved):
        """``step_batched_restir(RESTIR_BLOCK)``, the camera moved, again:
        the state after each block."""
        r.step_batched_restir(RESTIR_BLOCK)
        first = restir_state(r)
        r.update_camera(position=moved)
        r.step_batched_restir(RESTIR_BLOCK)
        return [first, restir_state(r)]

    ds, cam = scenes["cornell_dense"]
    settings = Settings(tracer=Tracer.RESTIR_DI)
    moved = (cam.position + torch.tensor([0.05, 0.0, 0.0], device=dev)).tolist()
    one = Renderer(ds=ds, cam=cam, desc=None, settings=settings, device=dev)
    want = two_blocks(one, moved)
    single_ms = cuda_ms(lambda: one.run_block(RESTIR_BLOCK), reps=3) / RESTIR_BLOCK
    n_px = RES * RES
    rec["restir_batched"] = {}
    for n_tile in (2, MESH_TILES):
        r = Renderer(ds=ds, cam=cam, desc=None, settings=settings, device=dev,
                     mesh=mesh(n_tile))
        got, launches = counted(lambda: two_blocks(r, moved), ("dense",))
        differ = [f"block {b}: {k}" for b in range(2) for k in want[b]
                  if not torch.equal(got[b][k], want[b][k])]
        run = r.last_runner
        per = {"closest_hit": n_tile * (RESTIR_BLOCK + 1), "occlusion": n_tile * RESTIR_BLOCK}
        assert r.batch_mode == "graph" and run.mode == "graph" and len(r._runners) == 1
        assert not differ, f"mesh ReSTIR on {n_tile} tiles differs from one device: {differ}"
        # the warm-up block and two replays
        assert launches["dense"] == {k: 3 * v for k, v in per.items()}, launches
        assert timing.under(run.counts_per_replay, "launch.dense") == per and run.replays == 2
        replays = run.replays
        h = rs.HALO * RES + rs.HALO
        halo_px = sum(min(hi + h, n_px) - max(lo - h, 0)
                      for lo, hi in sh.tile_bounds(r.mesh, n_px))
        exchange = {"temporal_bytes": 13 * 4 * n_px, "spatial_bytes": 15 * 4 * halo_px}
        mesh_ms = cuda_ms(lambda: r.run_block(RESTIR_BLOCK), reps=3) / RESTIR_BLOCK
        rec["restir_batched"][n_tile] = {"ms_per_frame": mesh_ms, "single_ms": single_ms,
                                         "launches": launches, "per_replay": per,
                                         **exchange}
        log(f"[mesh] cornell ReSTIR (dense) batched on {n_tile} tiles over one card, "
            f"step_batched_restir({RESTIR_BLOCK}) twice with a camera move between: the "
            f"frames, reservoir and last G-buffer equal to one device's bit for bit, seams "
            f"included; batch mode {r.batch_mode}, one CUDA graph over all tiles, "
            f"{replays} replays; launches {launches} (a replay {per}); exchanged a frame "
            f"{exchange['temporal_bytes']:,} B of temporal rows (the whole image, one "
            f"concatenation) and {exchange['spatial_bytes']:,} B of tiles with their halos; "
            f"{mesh_ms:.3f} ms/frame on the mesh against {single_ms:.3f} on one device "
            f"({card})")

    # teapot (Plücker): a tile's lanes in raster order, its culling groups
    # differ from the full frame's, so a grazing pixel may flip
    ds, cam = scenes["teapot"]
    one = Renderer(ds=ds, cam=cam, desc=None, settings=settings, device=dev)
    r = Renderer(ds=ds, cam=cam, desc=None, settings=settings, device=dev,
                 mesh=mesh(MESH_TILES))
    one.step_batched_restir(RESTIR_BLOCK)
    _, launches = counted(lambda: r.step_batched_restir(RESTIR_BLOCK),
                          ("plucker", "sort_key"))
    flips = dryrun.frames_match(r.current_image().cpu().numpy(),
                                one.current_image().cpu().numpy(), atol=FLIP_ATOL,
                                max_flips=FLIP_MAX, mean_atol=FLIP_MEAN)
    per = {"plucker": {"closest_hit": MESH_TILES * (RESTIR_BLOCK + 1),
                       "occlusion": MESH_TILES * RESTIR_BLOCK},
           "sort_key": {"signature_key": MESH_TILES * (2 * RESTIR_BLOCK + 1)}}
    replay = {}  # module -> {kernel: launches} of a replay
    for key, n in timing.under(r.last_runner.counts_per_replay, "launch").items():
        module, kernel = key.split(".")
        replay.setdefault(module, {})[kernel] = n
    # besides the sweeps, one candidate RIS launch a tile a frame and a
    # surface launch after each closest hit (the G-buffer's and the
    # primaries')
    assert r.batch_mode == "graph" and replay == {
        **per, "ris": {"ris": MESH_TILES * RESTIR_BLOCK},
        "surface": {"surface": MESH_TILES * (RESTIR_BLOCK + 1)}}, (replay, per)
    # the warm-up block and one replay
    assert launches == {m: {k: 2 * v for k, v in d.items()} for m, d in per.items()}, launches
    mesh_ms = cuda_ms(lambda: r.run_block(RESTIR_BLOCK), reps=3) / RESTIR_BLOCK
    single_ms = cuda_ms(lambda: one.run_block(RESTIR_BLOCK), reps=3) / RESTIR_BLOCK
    rec["restir_batched_teapot"] = {"tiles": MESH_TILES, "flips": flips,
                                    "ms_per_frame": mesh_ms, "single_ms": single_ms,
                                    "launches": launches}
    log(f"[mesh] teapot ReSTIR (Plücker) batched on {MESH_TILES} tiles, one block of "
        f"{RESTIR_BLOCK}: {flips} pixels off by > {FLIP_ATOL} against one device (bound "
        f"{FLIP_MAX}); launches {launches}; {mesh_ms:.3f} ms/frame on the mesh against "
        f"{single_ms:.3f} ms/frame replayed on one device ({card})")

    # ---- a world of one on NCCL against the in-process mesh ----
    ds, cam = scenes["cornell"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mh.initialize(f"127.0.0.1:{port}", 1, 0, "cuda")
    try:
        gm = mh.make_global_mesh()
        n_pad = sh._padded_pixel_count(cam, gm.shape["tile"])
        tiles = sh.pt_step_sharded(gm, mh.replicate_scene_global(gm, ds), cam,
                                   mh.make_sharded_zeros(gm, (n_pad, 3)), 0, 0,
                                   max_depth=DEPTH)
        img = mh.gather_image(tiles)
    finally:
        mh.shutdown()
    m1 = mesh(1)
    want = sh.gather(sh.pt_step_sharded(m1, ds, cam, sh.shard_image(m1, torch.zeros(
        (RES * RES, 3), device=dev)), 0, 0, max_depth=DEPTH)).cpu().numpy()
    assert np.array_equal(img, want), "the NCCL world of one differs from the mesh"
    log("[mesh] multihost: a world of one on NCCL (tcp 127.0.0.1), one accumulate step "
        "gathered with all_gather: equal to the in-process mesh")

    # ---- the dry run ----
    rec["dryrun"] = dryrun.dryrun_multichip(MESH_TILES, devices=[dev] * MESH_TILES,
                                            log=log)

    # ---- pair accounting of teapot's frame ----
    ds, cam = scenes["teapot"]
    stats = ps.frame_pair_stats(ds, cam, 7, DEPTH)
    util = ps.utilization(stats, rec["teapot"]["single_ms"])
    rec["pairstats"] = {**stats, **util}
    log(f"[mesh] teapot frame pairs (replayed, depth {DEPTH}): {stats}; at the "
        f"single-device frame's {rec['teapot']['single_ms']:.3f} ms: {util}")
    assert 0 < stats["pairs_floor"] <= stats["pairs_swept"] <= stats["pairs_row"]

    # ---- the webviewer serving a card renderer ----
    ds, cam = scenes["cornell"]
    r = Renderer(ds=ds, cam=cam, desc=None, device=dev)
    stop, ports = threading.Event(), []
    th = threading.Thread(target=wv.serve, args=(r,), daemon=True,
                          kwargs=dict(port=0, stop=stop, host="127.0.0.1",
                                      on_ready=ports.append))
    th.start()
    try:
        deadline = time.time() + 60
        while not ports and time.time() < deadline:
            time.sleep(0.01)
        head = urllib.request.urlopen(f"http://127.0.0.1:{ports[0]}/stream",
                                      timeout=60).read(4096)
    finally:
        stop.set()
        th.join(60)
    assert b"image/jpeg" in head and b"\xff\xd8" in head and not th.is_alive()
    log(f"[mesh] webviewer: a cuda Renderer served on port {ports[0]}, one /stream JPEG "
        f"fetched, {r.state.iteration} frames rendered, stopped")
    rec["seconds"] = time.perf_counter() - t0
    log(f"[mesh] phase 9 took {rec['seconds']:.1f} s")
    return rec


def host_phase(dev, cold: dict, log) -> dict:
    """Phase 10: every shipped scene loaded on the card through
    ``load_scene`` with the native host build (the C++ BVH, cluster cuts
    and OBJ parser) and with ``RADISH_NATIVE=0`` (the numpy builders), the
    mesh memo cleared before each load: every tensor of the two
    ``DeviceScene`` objects equal bit for bit, and both load times (the card
    machine's CPU); then teapot's and teapot_hires' cold start either way
    (phase 2's kernel builds + the load + the first frame).  Returns the
    phase's record."""
    import dataclasses

    import torch

    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.scene.build import load_scene
    from radish_pt_tpu_torch.scene.parser import Resource

    t0 = time.perf_counter()

    def load(name, flag):
        os.environ["RADISH_NATIVE"] = flag
        Resource.clear()
        try:
            t = time.perf_counter()
            ds, cam, _ = load_scene(os.path.join(REPO, "scenes", SCENE_FILES[name]),
                                    device=dev)
            torch.cuda.synchronize()
            return ds, cam, time.perf_counter() - t
        finally:
            os.environ.pop("RADISH_NATIVE")
            Resource.clear()

    def same(x, y):  # bit for bit: packed tables hold integers bit-cast to f32
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        return x.numel() == 0 or torch.equal(x.reshape(-1).contiguous().view(torch.uint8),
                                             y.reshape(-1).contiguous().view(torch.uint8))

    rec = {}
    for name in SCENE_FILES:
        a, cam, t_native = load(name, "1")
        b, _, t_numpy = load(name, "0")
        differ, n = [], 0
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                n += 1
                if not same(x, y):
                    differ.append(f.name)
            elif type(x) is not type(y) or not (x == y if not hasattr(x, "shape")
                                                else bool((x == y).all())):
                differ.append(f.name)
        rec[name] = {"native_s": t_native, "numpy_s": t_numpy, "tensors": n,
                     "triangles": a.num_triangles}
        log(f"[host] {name}: load_scene native {t_native:.3f} s, RADISH_NATIVE=0 "
            f"{t_numpy:.3f} s (the card machine's CPU); {n} tensors of the DeviceScene "
            f"equal bit for bit: {not differ} {differ or ''}")
        assert not differ, f"{name}: the native build differs from the numpy build: {differ}"
        if name in ("teapot", "teapot_hires"):
            c = cam.replace(width=RES, height=RES)
            t = time.perf_counter()
            pt.path_trace(a, c, 0, DEPTH)
            torch.cuda.synchronize()
            first = time.perf_counter() - t
            rec[name]["cold_start_native_s"] = cold["build_s"] + t_native + first
            rec[name]["cold_start_numpy_s"] = cold["build_s"] + t_numpy + first
            log(f"[host] {name} cold start (phase 2's kernel builds {cold['build_s']:.2f} s + "
                f"load + first {RES}x{RES} frame, its kernels loaded, {first:.3f} s): native "
                f"{rec[name]['cold_start_native_s']:.2f} s, numpy "
                f"{rec[name]['cold_start_numpy_s']:.2f} s")
    rec["seconds"] = time.perf_counter() - t0
    log(f"[host] phase 10 took {rec['seconds']:.1f} s")
    return rec


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--parent", help="a checkout of the parent commit: its sort-key and "
                    "binning kernels are timed beside this tree's in phase 6, its frames in "
                    "phase 8")
    ap.add_argument("--frame-times", metavar="DIR",
                    help="print the frame times of the package in the checkout DIR and "
                    "exit (the subprocess of phase 8)")
    ap.add_argument("--frames", nargs=2, metavar=("DIR", "OUT"),
                    help="save the replayed frames of the package in the checkout DIR to "
                    "OUT (.npz) and exit (the subprocess of phase 8)")
    ap.add_argument("--offsets-loop", type=int, metavar="RUNS",
                    help="count the runs in which the card's ReSTIR offsets differ from the "
                    "CPU's, alone and after every kernel, RUNS times each, and exit")
    args = ap.parse_args(argv)
    if args.frame_times:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        print("FRAME_TIMES " + json.dumps(frame_times(args.frame_times)), flush=True)
        return 0
    if args.frames:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        replayed_frames(*args.frames)
        return 0

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "radish_pt_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain sweeps: full f32
    if args.offsets_loop:
        card = gpu_name_and_power()
        log(card)
        return offsets_loop(args.offsets_loop, log, card)

    from radish_pt_tpu_torch import native
    from radish_pt_tpu_torch.accel import _build
    from radish_pt_tpu_torch.accel import band as bnd
    from radish_pt_tpu_torch.accel import compact as cpt
    from radish_pt_tpu_torch.accel import plucker as plk
    from radish_pt_tpu_torch.accel import dense as dns
    from radish_pt_tpu_torch.accel import quad as qd
    from radish_pt_tpu_torch.accel import sort_key as sk
    from radish_pt_tpu_torch.accel import traverse as trv
    from radish_pt_tpu_torch.config import Denoiser, ReservoirReuse, Settings, Tracer
    from radish_pt_tpu_torch.render import denoise as dn
    from radish_pt_tpu_torch.render import gbuffer as gb
    from radish_pt_tpu_torch.render import pathtrace as pt
    from radish_pt_tpu_torch.render import restir as rs
    from radish_pt_tpu_torch.render import ris
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import build_device_scene, load_scene
    from radish_pt_tpu_torch.scene.parser import parse_scene
    from radish_pt_tpu_torch.utils import timing

    assert "jax" not in sys.modules
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    def scene_path(name):
        return os.path.join(REPO, "scenes", SCENE_FILES[name])

    # ---- 1. device ----
    card = gpu_name_and_power()
    log(card)  # name, power limit: the figure every timing below rests on
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    # the ReSTIR offsets before any kernel of the port ran (phase 7 checks
    # them again after every other phase)
    restir_offsets_check(dev, log, "[device]")

    # ---- 2. cold start: kernel builds (one nvcc per source, in parallel),
    # scene load, first frame ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the native host library (g++) builds beside the kernels (nvcc)
    host_build = {}
    th = threading.Thread(target=lambda: host_build.update(path=native.build()))
    th.start()
    _build.build_all(verbose=True)
    th.join()
    t_build = time.perf_counter() - t0
    assert "path" in host_build, "the native host library did not build"
    built = timing.counters()
    log(f"[build] native host library (g++ {' '.join(native.CXX_FLAGS)}) -> "
        f"{os.path.relpath(host_build['path'], REPO)} "
        f"({'built' if built.get('native.built') else 'reused'}), beside the kernels")
    for lib in SOURCES:
        log(f"[build] csrc/{lib}.cu -> {os.path.relpath(_build.library_path(lib), REPO)}")
    spans = timing.snapshot()["unprofiled"]
    log(f"[build] {built.get('kernels.built', 0)} of {len(_build.SIGNATURES)} libraries "
        f"compiled (the rest reused from before this run); set-up spans: kernel libraries "
        f"{spans.get('setup.kernel_libs', {}).get('total_s', 0.0):.2f} s, native "
        f"{spans.get('setup.native', {}).get('total_s', 0.0):.2f} s (the two in parallel)")
    log(f"[build] all {len(_build.SIGNATURES)} sources, in parallel: {t_build:.2f} s wall")
    for lib in SOURCES:  # ptxas -v: empty when the library was built before
        for kernel, use in _build.kernel_resources(lib).items():
            log(f"[build] {lib}: {kernel}: {use['registers']} registers, spills "
                f"{use['spill_stores']} B stored / {use['spill_loads']} B loaded, "
                f"{use['smem']} B static shared memory")
    scenes = {}
    ds, cam, _ = load_scene(scene_path("teapot"), device=dev)
    cam = cam.replace(width=RES, height=RES)
    t_load = time.perf_counter() - t0 - t_build
    pt.path_trace(ds, cam, 0, DEPTH)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    scenes["teapot"] = (ds, cam)
    log(f"[cold start] teapot: scene load {t_load:.2f} s (native host build), build + "
        f"load + first {RES}x{RES} frame {cold_s:.2f} s")
    cold = {"build_s": t_build}
    ds, cam, _ = load_scene(scene_path("cornell"), device=dev)
    scenes["cornell"] = (ds, cam.replace(width=RES, height=RES))
    t1 = time.perf_counter()
    desc = parse_scene(scene_path("teapot_hires"))
    t_parse = time.perf_counter() - t1
    ds, cam = build_device_scene(desc, use_sobol=desc.settings.use_sobol,
                                 device=dev)  # the size picks the engine
    assert ds.intersector == "plucker", ds.intersector
    t2 = time.perf_counter()
    dsc_, cam = build_device_scene(desc, use_sobol=desc.settings.use_sobol,
                                   device=dev, intersector="compact")
    cam = cam.replace(width=RES, height=RES)
    t_hires = time.perf_counter() - t2
    pt.path_trace(dsc_, cam, 0, DEPTH)
    torch.cuda.synchronize()
    cold_hires = t_build + t_parse + (time.perf_counter() - t2)
    scenes["teapot_hires"] = (dsc_, cam)
    scenes["teapot_hires_plucker"] = (ds, cam)
    log(f"[cold start] teapot_hires (compact): parse {t_parse:.2f} s, build "
        f"{t_hires:.2f} s ({dsc_.num_triangles} stored triangles, "
        f"{dsc_.cluster_bounds.shape[0]} clusters of {dsc_.cluster_sub}); "
        f"kernel build + parse + scene build + first {RES}x{RES} frame "
        f"{cold_hires:.2f} s")
    log(f"[scene] teapot_hires (plucker, the size's choice): "
        f"{ds.num_triangles} stored triangles, {ds.cluster_bounds.shape[0]} "
        f"clusters of {ds.cluster_sub}")
    t3 = time.perf_counter()
    dsq, camq, _ = load_scene(scene_path("teapot"), device=dev, intersector="quad")
    scenes["teapot_quad"] = (dsq, camq.replace(width=RES, height=RES))
    t4 = time.perf_counter()
    dsb, _ = build_device_scene(desc, use_sobol=desc.settings.use_sobol, device=dev,
                                intersector="band")
    scenes["teapot_hires_band"] = (dsb, cam)
    log(f"[scene] teapot (quad): {dsq.num_triangles} stored triangles, "
        f"{dsq.cluster_bounds.shape[0]} clusters of {dsq.cluster_sub}, forms "
        f"{tuple(dsq.quad_coeffs.shape)}, loaded in {t4 - t3:.2f} s; teapot_hires "
        f"(band, g = {dsb.band_g}): {dsb.num_triangles} stored triangles, "
        f"{dsb.cluster_bounds.shape[0]} clusters of {dsb.cluster_sub}, built in "
        f"{time.perf_counter() - t4:.2f} s")
    # the quad and band scenes share the Plücker teapot's and the compact
    # teapot_hires' stored triangles: the same wavefronts feed their parity
    assert torch.equal(dsq.tri_v, scenes["teapot"][0].tri_v)
    assert torch.equal(dsb.tri_v, dsc_.tri_v)
    for name in ("cornell", "teapot"):  # the dense engine: by name only
        ds, cam, _ = load_scene(scene_path(name), device=dev, intersector="dense")
        scenes[f"{name}_dense"] = (ds, cam.replace(width=RES, height=RES))
        log(f"[scene] {name} (dense): {ds.num_triangles} stored triangles, "
            f"{int((ds.tri_packed[:, 3:].abs().sum(1) == 0).sum())} of them zero "
            f"(cluster padding)")
    for name in ("cornell", "teapot", "teapot_hires"):  # the bvh engine: by name only
        t5 = time.perf_counter()
        if name == "teapot_hires":
            ds, _ = build_device_scene(desc, use_sobol=desc.settings.use_sobol, device=dev,
                                       intersector="bvh")
            cam = scenes["teapot_hires"][1]
            assert torch.equal(ds.tri_v, dsc_.tri_v)  # compact's 64-triangle layout
        else:
            ds, cam, _ = load_scene(scene_path(name), device=dev, intersector="bvh")
            cam = cam.replace(width=RES, height=RES)
        scenes[f"{name}_bvh"] = (ds, cam)
        log(f"[scene] {name} (bvh): {ds.num_triangles} stored triangles, node table "
            f"{tuple(ds.bvh_packed.shape)} ({ds.bvh_packed.shape[0] // 6} nodes a direction "
            f"class), {ds.leaf_tris.shape[0]} leaves of {ds.leaf_tris.shape[1] // 9}; "
            f"built in {time.perf_counter() - t5:.2f} s")
    for name in OTHER_SCENES:  # the engine their size picks
        t5 = time.perf_counter()
        ds, cam, _ = load_scene(scene_path(name), device=dev)
        assert ds.intersector == "plucker", (name, ds.intersector)
        scenes[name] = (ds, cam.replace(width=RES, height=RES))
        clusters = ("no clusters" if ds.cluster_bounds is None else
                    f"{ds.cluster_bounds.shape[0]} clusters of {ds.cluster_sub}")
        log(f"[scene] {name} (plucker): {ds.num_triangles} stored triangles, "
            f"{clusters}, {ds.n_area_lights} area lights, env map {ds.has_env}, "
            f"aperture mask {ds.has_aperture} (lens radius {float(cam.lens_radius)}), "
            f"depth {depth_of(name)}; loaded in {time.perf_counter() - t5:.2f} s")
    # the benchmark's teapot in the Cornell box: the vertex phase's GGX case
    t5 = time.perf_counter()
    ds, cam, _ = load_scene(os.path.join(REPO, CORNELL_TEAPOT), device=dev)
    scenes["cornell_teapot"] = (ds, cam.replace(width=RES, height=RES))
    log(f"[scene] cornell_teapot ({ds.intersector}): {ds.num_triangles} stored triangles, "
        f"{ds.cluster_bounds.shape[0]} clusters of {ds.cluster_sub}; loaded in "
        f"{time.perf_counter() - t5:.2f} s")

    log(f"[phase] 3 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- 3. kernel parity at the main path's shapes ----
    max_err = dict.fromkeys(REPLACES, 0.0)
    ds, cam = scenes["teapot"]
    waves = bounce_one(ds, cam)
    log(f"[parity] teapot {ds.num_triangles} stored triangles, "
        f"{ds.cluster_bounds.shape[0]} clusters of {ds.cluster_sub}; primaries "
        f"{waves['primary'][0].shape[0]}, extension rays live "
        f"{int((waves['extension'][2] >= 0).sum())}, shadow segments live "
        f"{int(waves['segments'][2].sum())}")
    max_err["signature_key"] = 0.0
    inputs = {"plucker": {"teapot": plucker_parity(ds, waves, max_err, log, "teapot")},
              "quad": quad_parity(dsq, waves, max_err, log),
              "signature_key": {"teapot": key_parity(ds, waves, "teapot", max_err, log)}}
    ds, cam = scenes["teapot_hires_plucker"]
    waves = bounce_one(ds, cam)
    inputs["plucker"]["teapot_hires_plucker"] = plucker_parity(
        ds, waves, max_err, log, "teapot_hires_plucker")
    inputs["signature_key"]["teapot_hires_plucker"] = key_parity(
        ds, waves, "teapot_hires_plucker", max_err, log)
    # wavefronts the Plücker pair meets only on these scenes: glass's
    # primaries through the masked thin lens and its bounce-1 rays refracted
    # into the glass sphere (their origins inside a cluster's box);
    # env_teapot's bounce-1 NEE segments, 1e6 long toward the env map
    for name in ("glass", "env_teapot"):
        ds, cam = scenes[name]
        waves = bounce_one(ds, cam)
        x, y, live = waves["segments"]
        seg_len = torch.linalg.vector_norm(y - x, dim=-1)[live]
        log(f"[parity] {name}: primaries {waves['primary'][0].shape[0]}, extension "
            f"rays live {int((waves['extension'][2] >= 0).sum())}, of them refracted "
            f"into a dielectric {int(waves['refracted'].sum())}; shadow segments live "
            f"{int(live.sum())}, length {float(seg_len.min()):.4g} to "
            f"{float(seg_len.max()):.4g}")
        if name == "glass":
            assert int(waves["refracted"].sum()) > 0, "glass: no refracted rays"
        else:
            assert float(seg_len.min()) > 9e5, "env_teapot: NEE segments not 1e6 long"
        inputs["plucker"][name] = plucker_parity(ds, waves, max_err, log, name)
    ds, cam = scenes["teapot_hires"]
    waves = bounce_one(ds, cam)
    log(f"[parity] teapot_hires (compact): primaries {waves['primary'][0].shape[0]},"
        f" extension rays live {int((waves['extension'][2] >= 0).sum())}, shadow "
        f"segments live {int(waves['segments'][2].sum())}")
    inputs["compact"] = compact_parity(ds, waves, max_err, log)
    inputs["band"] = band_parity(dsb, waves, max_err, log)
    # the key on the compact layout (1,755 clusters paired to 220) and, on
    # the same rays, the band engine's count-major form
    inputs["signature_key"]["teapot_hires"] = key_parity(ds, waves, "teapot_hires", max_err,
                                                         log)
    inputs["signature_key"]["teapot_hires_band"] = key_parity(dsb, waves, "teapot_hires_band",
                                                              max_err, log)
    inputs["dense"] = {}
    for name in ("cornell", "teapot"):
        ds, cam = scenes[f"{name}_dense"]
        waves = bounce_one(ds, cam)  # raster-order lanes: the dense engine culls nothing
        inputs["dense"][name] = dense_parity(ds, waves, max_err, log, name)
    inputs["bvh"] = {}
    for name in ("teapot_bvh", "teapot_hires_bvh"):
        ds, cam = scenes[name]
        waves = bounce_one(ds, cam)  # raster-order lanes, as the bvh engine's frame
        inputs["bvh"][name] = bvh_parity(ds, waves, max_err, log, name)
    del waves
    ris_row = ris_phase(scenes, log, card)
    vertex_row = vertex_phase(scenes, log, card)
    surface_row = surface_phase(scenes, log, card)

    log(f"[phase] 4 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- 4. the main paths ----
    def sweep_path(names, module, kinds=("closest_hit", "occlusion")):
        """d + 1 closest hits and d shadow sweeps a frame of depth d, each
        one launch."""
        n_launch, n_frames = main_path(scenes, names, module, log, kinds)
        want = {"closest_hit": sum(8 * (depth_of(n) + 1) for n in names),
                "occlusion": sum(8 * depth_of(n) for n in names)}
        assert {k: n_launch[k] for k in want} == want, (n_launch, want)
        return n_launch, n_frames

    key_launches = {}

    def plucker_path(names):
        """A Plücker frame's sweeps cull for themselves: no mask prepass.
        A frame on a scene with clusters launches the sort-key kernel 2d +
        1 times (the primaries, then each bounce's shadow segments and
        extension rays), in the sliced bounce loop where ``path_trace``
        gates it and in the dense loop alike; no plain key."""
        tally = timing.Tally()
        n_launch, n_frames = sweep_path(names, "plucker")
        assert not tally("prepass.plucker"), "the mask prepass ran on the card path"
        want = sum(8 * (2 * depth_of(n) + 1) for n in names
                   if scenes[n][0].cluster_bounds is not None)
        keys = tally("launch.sort_key")
        key_launches[names] = (keys, n_frames)
        log(f"[main path] {', '.join(names)}: sort-key launches {keys} (want "
            f"{want}), plain keys {tally('plain.sort_key')}")
        assert keys.get("signature_key", 0) == want and not tally("plain.sort_key")
        return n_launch, n_frames

    def band_path(names):
        """A band frame: every sweep votes its bands' words in the kernel,
        no band-mask prepass."""
        tally = timing.Tally()
        n_launch, n_frames = sweep_path(names, "band")
        log(f"[main path] {', '.join(names)}: band-mask prepass calls "
            f"{tally('prepass.band')}")
        assert tally("prepass.band") == {}, tally("prepass.band")
        return n_launch, n_frames

    def quad_path(names):
        """A quad frame: the shadow sweeps vote their rows' words in the
        kernel; the row-mask prepass runs for the 6 closest hits only."""
        tally = timing.Tally()
        n_launch, n_frames = sweep_path(names, "quad")
        prepass = tally("prepass.plucker")
        log(f"[main path] {', '.join(names)}: row-mask prepass calls {prepass}")
        assert prepass == {"cluster_mask_words": 6 * n_frames}, prepass
        return n_launch, n_frames

    launches = {"plucker": plucker_path(("cornell", "teapot")),
                "compact": sweep_path(("teapot_hires",), "compact",
                                      ("sphere_flags", "closest_hit", "occlusion")),
                "quad": quad_path(("teapot_quad",)),
                "band": band_path(("teapot_hires_band",))}
    launches_hires_plucker = plucker_path(("teapot_hires_plucker",))
    # the other shipped scenes, each driven alone: glass at depth 8 (9
    # closest hits, 8 shadow sweeps a frame), the others at 5
    launches_other = {name: plucker_path((name,))[0] for name in OTHER_SCENES}
    main_path(scenes, ("cornell_dense", "teapot_dense"), "dense", log)
    walks = ("closest_hit", "occlusion", "bin")  # the heatmap walk: the heatmap tracer's
    launches["bvh"] = sweep_path(("cornell_bvh", "teapot_bvh"), "traverse", walks)
    launches_hires_bvh = sweep_path(("teapot_hires_bvh",), "traverse", walks)
    for n_launch, _ in (launches["bvh"], launches_hires_bvh):
        assert "heatmap" not in n_launch
        # one binning launch before each closest hit and shadow walk
        assert n_launch["bin"] == n_launch["closest_hit"] + n_launch["occlusion"], n_launch

    # the BVH heatmap tracer (Renderer, the pinhole rays in raster order): one
    # heatmap walk a frame through the kernel, no other launch and no plain
    # call; its image equal to the one from the plain walk's counts
    heat_frames = 2
    launches_heatmap = {}
    for name in ("teapot_bvh", "teapot_hires_bvh"):
        ds, cam = scenes[name]
        tally = timing.Tally()
        r = Renderer(ds=ds, cam=cam, desc=None, settings=Settings(tracer=Tracer.BVH_VISUALIZE),
                     device=dev)
        for _ in range(heat_frames):
            r.step()
        img = r.current_image()
        torch.cuda.synchronize()
        launches_heatmap[name] = (tally("launch.traverse"), heat_frames)
        plain = tally("plain.traverse")
        ref = Renderer(ds=ds.replace(intersector="bvh_plain"), cam=cam, desc=None,
                       settings=Settings(tracer=Tracer.BVH_VISUALIZE), device=dev)
        ref.step()
        same = bool(torch.equal(img, ref.current_image()))
        log(f"[main path] BVH heatmap tracer, {name} {RES}x{RES}: {heat_frames} frames, "
            f"launches {launches_heatmap[name][0]}, plain-version calls {plain}; t in "
            f"[{float(img[:, 0].min()):.4f}, {float(img[:, 0].max()):.4f}], mean "
            f"{float(img[:, 0].mean()):.5f}; equal to the plain walk's image: {same}")
        assert launches_heatmap[name][0] == {"heatmap": heat_frames}
        assert not plain, "a plain walk ran on the heatmap's path"
        assert bool(torch.isfinite(img).all()) and float(img[:, 0].max()) == 1.0
        assert same, f"{name}: the heatmap differs from the plain walk's"
    means, frames = {}, {}
    for name in ("cornell", "teapot", "teapot_quad", "teapot_hires",
                 "teapot_hires_plucker", "teapot_hires_band", "cornell_dense",
                 "teapot_dense", "cornell_bvh", "teapot_bvh", "teapot_hires_bvh") + OTHER_SCENES:
        ds, cam = scenes[name]
        d7, i7 = pt.path_trace(ds, cam, 7, depth_of(name))
        frames[name] = d7 + i7
        means[name] = float(frames[name].mean())
        golden = MEAN_GOLDEN[scene_of(name)]
        drift = means[name] / golden - 1.0
        log(f"[main path] {name} ({ds.intersector}) depth {depth_of(name)} looper-7 "
            f"mean radiance {means[name]:.7f} vs golden {golden:.7f}: drift "
            f"{drift * 100:+.4f}%")
        assert abs(drift) < MEAN_DRIFT, f"{name} mean radiance drifted more than 2e-3"

    def compare(a, b, bound_rel, what):
        rel = means[a] / means[b] - 1.0
        mad = float(torch.abs(frames[a] - frames[b]).mean())
        log(f"[main path] {what}: means {means[a]:.5f} vs {means[b]:.5f}, differ by "
            f"{rel * 100:+.4f}%, mean |pixel diff| {mad:.3e}")
        assert abs(rel) < bound_rel, f"{what}: the means differ"
        return mad

    assert compare("teapot_hires", "teapot_hires_plucker", 0.002,
                   "teapot_hires, compact vs plucker engine") < 2e-3
    compare("teapot_hires_band", "teapot_hires", 0.0005,
            "teapot_hires, band vs compact engine")
    compare("teapot_quad", "teapot", 0.01, "teapot, quad vs plucker engine")
    compare("cornell_dense", "cornell", 0.01, "cornell, dense vs plucker engine")
    compare("teapot_dense", "teapot", 0.01, "teapot, dense vs plucker engine")
    compare("teapot_bvh", "teapot_dense", 0.002, "teapot, bvh vs dense engine")
    compare("cornell_bvh", "cornell_dense", 0.002, "cornell, bvh vs dense engine")
    compare("teapot_hires_bvh", "teapot_hires", 0.002, "teapot_hires, bvh vs compact engine")
    del frames

    # the sliced bounce loop against the dense loop: loopers 0-7 of teapot,
    # env_teapot (its env-miss term) and glass (delta BSDFs, depth 8): the
    # default path_trace (the sliced loop, as step() runs it) equal to the
    # dense loop (n_slices=0, as a captured block runs it) bit for bit; the
    # live share of each extension wavefront, the looper-7 mean against its
    # golden, and one profiled sliced frame's device time in the key kernel
    # and in the sorts and permutations of the lanes
    sliced_record = {}
    for name in ("teapot", "env_teapot", "glass"):
        ds, cam = scenes[name]
        depth = depth_of(name)
        differ = []
        for lp in range(8):
            st = {}
            got = pt.path_trace(ds, cam, lp, depth, stats=st)
            want = pt.path_trace(ds, cam, lp, depth, n_slices=0)
            assert st["loop"] == "sliced", (name, st)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                off = torch.cat([a != b for a, b in zip(got, want)], 1).any(1)
                differ.append((lp, int(off.sum()), float(max(
                    (a - b).abs().max() for a, b in zip(got, want)))))
        mean = float((got[0] + got[1]).mean())
        drift = mean / MEAN_GOLDEN[name] - 1.0
        stages = frame_stages(lambda: pt.path_trace(ds, cam, 8, depth))
        share = [n / (RES * RES) for n in st["live"]]
        log(f"[sliced] {name} {RES}x{RES} depth {depth}, loopers 0-7: the sliced loop "
            f"(slices of {st['slice']} lanes) equal to the dense loop bit for bit: "
            f"{not differ} {differ or ''}; live share of the extension wavefronts at "
            f"looper 7, bounce 1 first: {', '.join(f'{x:.4f}' for x in share)}; looper-7 "
            f"mean {mean:.7f} vs golden {MEAN_GOLDEN[name]:.7f}: drift {drift * 100:+.4f}%; "
            f"a profiled frame: sort key {stages.get('sort key', 0.0):.3f} ms, sort + "
            f"permute {stages.get('sort + permute', 0.0):.3f} ms of {stages['busy']:.3f} ms "
            f"busy ({card})")
        assert not differ, f"{name}: the sliced loop differs from the dense loop"
        assert abs(drift) < MEAN_DRIFT, f"{name}: the sliced frame's mean drifted"
        sliced_record[name] = {"live_share": share, "slice": st["slice"],
                               "sort_key_ms": stages.get("sort key", 0.0),
                               "sort_permute_ms": stages.get("sort + permute", 0.0),
                               "busy_ms": stages["busy"]}

    # the interactive direct-lighting path on cornell's dense engine
    restir = Settings(tracer=Tracer.RESTIR_DI)  # T+S reuse, 32 candidates, clamp 20
    paths = {"restir": ("ReSTIR DI (G-buffer, 32-candidate RIS, T+S reuse)", restir),
             "direct_svgf": ("the direct tracer + SVGF",
                             Settings(tracer=Tracer.DIRECT_LIGHT, denoiser=Denoiser.SVGF)),
             "pt_split_svgf": (f"full MIS, depth {DEPTH}, + split SVGF",
                               Settings(tracer=Tracer.STREAMED, denoiser=Denoiser.SVGF,
                                        trace_depth=DEPTH))}
    renderers, path_means = {}, {}

    def ris_launched(tally, what, frames):
        """ReSTIR's candidate RIS counted by ``tally``: one kernel launch a
        frame, no plain call."""
        launched, plain = tally("launch.ris"), tally("plain.ris")
        log(f"[main path] {what}: candidate RIS launches {launched}, plain calls "
            f"{plain} over {frames} frames")
        assert launched == ({"ris": frames} if frames else {}) and plain == {}, what

    for key, (what, settings) in paths.items():
        tally = timing.Tally()
        r, path_means[key], n_launch = drive(scenes, "cornell_dense", settings, "dense", log,
                                             what)
        ris_launched(tally, what, 8 if key == "restir" else 0)
        renderers[key] = r
        if key == "restir":
            launches["dense"] = (n_launch, 8)
        drift = path_means[key] / PATH_GOLDEN[key] - 1.0
        log(f"[main path] {what}: 8-frame mean {path_means[key]:.5f} vs the JAX "
            f"package's {PATH_GOLDEN[key]:.5f}: drift {drift * 100:+.3f}%")
        assert abs(drift) < MEAN_DRIFT, f"{what}: mean drifted more than 2e-3 from its golden"
    tally = timing.Tally()
    _, m_plk, _ = drive(scenes, "cornell", restir, "plucker", log,
                        "ReSTIR DI on the Plücker engine")
    ris_launched(tally, "ReSTIR DI on the Plücker engine", 8)
    rel = m_plk / path_means["restir"] - 1.0
    log(f"[main path] ReSTIR DI, Plücker vs dense engine: means {m_plk:.5f} vs "
        f"{path_means['restir']:.5f}, differ by {rel * 100:+.4f}%")
    assert abs(rel) < 0.002, "ReSTIR: the Plücker and dense engines' means differ"

    # ReSTIR with the camera animated: the G-buffer's motion reprojection
    # feeds the temporal reuse; the counts are read after the 8th frame
    tally = timing.Tally()
    r, _, _ = drive(scenes, "cornell_dense", Settings(tracer=Tracer.RESTIR_DI,
                                                      animate_camera=True), "dense", log,
                    "ReSTIR DI, camera animated (frames 0-6)", frames=7)
    ris_launched(tally, "ReSTIR DI, camera animated (frames 0-6)", 7)
    tally = timing.Tally()
    last_res, last_frame = r.reservoir, r.gbuf_last
    r.step()
    temporal = rs.find_temporal_neighbor(last_res, r.gbuf.motion, r.gbuf.frame, last_frame)
    torch.cuda.synchronize()
    launched, plain = tally("launch.dense"), tally("plain.dense")
    assert set(launched) == {"closest_hit", "occlusion"} and not plain
    ris_launched(tally, "ReSTIR DI, camera animated, frame 7", 1)
    geo = r.gbuf.frame.prim_id > gb.NULL_PRIMITIVE
    moved = r.gbuf.motion != torch.arange(RES * RES, device=dev)
    log(f"[main path] ReSTIR DI, camera animated, frame 7: launches {launched}, "
        f"plain calls {plain}; of {int(geo.sum())} pixels on geometry, "
        f"{float((geo & (r.gbuf.motion >= 0)).sum() / geo.sum()):.4f} have valid motion "
        f"({float((geo & moved).sum() / geo.sum()):.4f} reproject to another pixel) and "
        f"{float((temporal.num > 0).sum() / geo.sum()):.4f} accepted a temporal "
        f"neighbour; mean {float(r.current_image().mean()):.5f}")
    assert float((temporal.num > 0).sum()) > 0.5 * float(geo.sum())

    log(f"[phase] 5 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- 5. kernel path against plain path, 128x128 ----
    for name, plain in (("teapot", "plucker_plain"), ("teapot_hires", "compact_plain"),
                        ("teapot_quad", "quad_plain"),
                        ("teapot_hires_band", "band_plain"), ("glass", "plucker_plain"),
                        ("env_teapot", "plucker_plain")):
        ds, cam = scenes[name]
        small = cam.replace(width=SMALL_RES, height=SMALL_RES)
        d, i = pt.path_trace(ds, small, 0, depth_of(name))
        dp, ip = pt.path_trace(ds.replace(intersector=plain), small, 0, depth_of(name))
        mad = float(torch.abs((d + i) - (dp + ip)).mean())
        log(f"[kernel vs plain path] {name} ({ds.intersector}) {SMALL_RES}x{SMALL_RES} mean "
            f"|pixel diff| {mad:.3e}")
        assert mad < 2e-3
    ds, cam = scenes["teapot_bvh"]
    small = cam.replace(width=SMALL_RES, height=SMALL_RES)
    d, i = pt.path_trace(ds, small, 0, DEPTH)
    dp, ip = pt.path_trace(ds.replace(intersector="bvh_plain"), small, 0, DEPTH)
    mad = float(torch.abs((d + i) - (dp + ip)).mean())
    log(f"[kernel vs plain path] teapot_bvh (bvh) {SMALL_RES}x{SMALL_RES} mean |pixel diff| "
        f"{mad:.3e}, equal: {bool(torch.equal(d, dp) and torch.equal(i, ip))}")
    assert mad < 2e-3
    for name in ("cornell_dense", "teapot_dense"):  # the brute engine: dense's plain path
        ds, cam = scenes[name]
        small = cam.replace(width=SMALL_RES, height=SMALL_RES)
        d, i = pt.path_trace(ds, small, 0, DEPTH)
        dp, ip = pt.path_trace(ds.replace(intersector="brute"), small, 0, DEPTH)
        mad = float(torch.abs((d + i) - (dp + ip)).mean())
        log(f"[kernel vs plain path] {name} full MIS {SMALL_RES}x{SMALL_RES} mean |pixel "
            f"diff| {mad:.3e}")
        assert mad < 2e-3
    ds, cam = scenes["cornell_dense"]
    imgs = [Renderer(ds=ds.replace(intersector=engine), desc=None, settings=restir,
                     cam=cam.replace(width=SMALL_RES, height=SMALL_RES),
                     device=dev).render(spp=2) for engine in ("dense", "brute")]
    mad = float(abs(imgs[0] - imgs[1]).mean())
    log(f"[kernel vs plain path] cornell_dense ReSTIR {SMALL_RES}x{SMALL_RES}, 2 frames, "
        f"mean |pixel diff| {mad:.3e}")
    assert mad < 2e-3

    # logged only: how near 8 frames of each direct-lighting estimator come
    # to a 256-frame direct-tracer accumulation (loopers 8-263)
    ref = Renderer(ds=ds, cam=cam, desc=None, settings=Settings(tracer=Tracer.DIRECT_LIGHT),
                   device=dev)
    ref.state.looper = 8
    t_ref = time.perf_counter()
    reference = ref.render(spp=256)
    t_ref = time.perf_counter() - t_ref
    estimates = {
        "direct tracer": Renderer(ds=ds, cam=cam, desc=None, device=dev, settings=Settings(
            tracer=Tracer.DIRECT_LIGHT)).render(spp=8),
        "ReSTIR, no reuse": Renderer(ds=ds, cam=cam, desc=None, device=dev, settings=Settings(
            tracer=Tracer.RESTIR_DI, reservoir_reuse=ReservoirReuse.NONE)).render(spp=8),
        "ReSTIR, T+S reuse": renderers["restir"].current_image().cpu().numpy().reshape(
            reference.shape)}
    log(f"[estimators] cornell_dense {RES}x{RES}, 8 frames each against a 256-frame "
        f"direct-tracer accumulation (mean {float(reference.mean()):.5f}, {t_ref:.1f} s):"
        f" mean squared error " + ", ".join(
            f"{k} {float(((v - reference) ** 2).mean()):.4e}" for k, v in estimates.items()))

    log(f"[phase] 6 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- 6. timing (CUDA events) ----
    for name in ("cornell", "teapot", "teapot_quad", "teapot_hires",
                 "teapot_hires_plucker", "teapot_hires_band", "cornell_dense",
                 "teapot_dense", "cornell_bvh", "teapot_bvh", "teapot_hires_bvh") + OTHER_SCENES:
        ds, cam = scenes[name]
        loopers = iter(range(8, 10_000))
        depth = depth_of(name)

        def block():  # back-to-back frames, one sync: as bench.py times
            for _ in range(4):
                pt.path_trace(ds, cam, next(loopers), depth)

        ms = cuda_ms(block, reps=3) / 4
        mrays = RES * RES * (1 + 2 * depth) / (ms * 1e-3) / 1e6
        log(f"[timing] {name} ({ds.intersector}) {RES}x{RES} depth {depth} 1 spp: "
            f"{ms:.3f} ms/frame (median of 3 blocks of 4 frames), {mrays:.2f} "
            f"Mrays/s ({card})")
    # the sliced loop's slice count: path_trace at 4, 8 and 16 slices a
    # wavefront beside the dense loop (0), the same frames each time, in
    # turns (0 first and last): the wall ms of a frame (host-bound, as
    # every eager frame) and the device ms of a profiled frame
    slice_ms = {}
    for name in ("teapot", "teapot_hires_plucker", "glass", "env_teapot"):
        ds, cam = scenes[name]
        depth = depth_of(name)
        for n_slices in (0, 4, 8, 16, 0):
            wall = cuda_ms(lambda: [pt.path_trace(ds, cam, 8 + k, depth, n_slices=n_slices)
                                    for k in range(4)], reps=3) / 4
            busy = frame_stages(lambda: pt.path_trace(ds, cam, 8, depth,
                                                      n_slices=n_slices))["busy"]
            slice_ms.setdefault(name, {}).setdefault(n_slices, []).append((wall, busy))
        log(f"[timing] {name} {RES}x{RES} depth {depth}, by slices a wavefront (0: the dense "
            f"loop), ms/frame wall (median of 3 blocks of 4 frames) | device (a profiled "
            f"frame): " + ", ".join(
                f"{k}: " + " / ".join(f"{w:.3f} | {b:.3f}" for w, b in v)
                for k, v in slice_ms[name].items()) + f" ({card})")
    for name in ("cornell_dense", "cornell"):
        ds, cam = scenes[name]
        state = {"res": rs.empty_reservoir(RES * RES, device=dev), "first": True}
        loopers = iter(range(8, 10_000))

        def restir_block():  # bench.py's restir_frame_ms: G-buffer + restir_direct
            for _ in range(4):
                g = gb.render_gbuffer(ds, cam, cam)
                _, state["res"] = rs.restir_direct(
                    ds, cam, next(loopers), g, g.frame, state["res"], state["first"],
                    ReservoirReuse.TEMPORAL_SPATIAL, 32, 20)
                state["first"] = False

        ms = cuda_ms(restir_block, reps=3) / 4
        g_ms = cuda_ms(lambda: gb.render_gbuffer(ds, cam, cam), reps=3)
        log(f"[timing] {name} ({ds.intersector}) {RES}x{RES} ReSTIR frame (G-buffer + "
            f"32-candidate RIS + T+S reuse): {ms:.3f} ms/frame (median of 3 blocks of 4 "
            f"frames), of which the G-buffer {g_ms:.3f} ms ({card})")
    ds, cam = scenes["cornell_dense"]
    for key in ("direct_svgf", "pt_split_svgf"):
        r = renderers[key]

        def step_block():
            for _ in range(4):
                r.step()

        ms = cuda_ms(step_block, reps=3) / 4
        log(f"[timing] cornell_dense {RES}x{RES} {paths[key][0]}: {ms:.3f} ms/frame "
            f"(Renderer.step: G-buffer, tracer, accumulation, denoiser, display; "
            f"median of 3 blocks of 4) ({card})")
    r = renderers["direct_svgf"]
    svgf_ms = cuda_ms(lambda: dn.svgf_filter(r.direct, r.svgf_direct, r.gbuf, r.gbuf_last,
                                             cam, False), reps=3)
    pair_ms = cuda_ms(lambda: dn.svgf_filter_pair(r.direct, r.direct, r.svgf_direct,
                                                  r.svgf_direct, r.gbuf, r.gbuf_last,
                                                  cam, False), reps=3)
    log(f"[timing] cornell {RES}x{RES} denoisers alone: SVGF {svgf_ms:.3f} ms, split "
        f"SVGF pair {pair_ms:.3f} ms ({card})")

    # per kernel and wavefront: (kernel ms, plain ms, flops, bytes, peak)
    timed = {}

    def time_kernel(key, kernel, flops, nbytes_, scene=None, peak=PEAK_F32_FLOPS,
                    back_to_back=False):
        scene = scene or KERNEL_SCENE[key.split("_")[0]]
        # the plain version's time: its one run in phase 3 (PLAIN_MS)
        timed[key, scene] = (cuda_ms(kernel, 5), PLAIN_MS[key, scene], flops, nbytes_, peak)
        if back_to_back:
            BACK_TO_BACK_MS[key, scene] = cuda_ms(kernel, 5, inner=10)

    # (key, scene) -> [(what a further bound is over, its ms)], logged and
    # written beside the first
    other_bounds = {}
    for scene in ("teapot", "teapot_hires_plucker", "glass", "env_teapot"):
        ds = scenes[scene][0]
        sub, cb, pk = ds.cluster_sub, ds.cluster_bounds, ds.sweep_packed
        for what in ("primary", "extension", "segments"):
            feats, o, d, tmax, words, pairs = inputs["plucker"][scene][what]
            n = feats.shape[0]
            kind = "occlusion" if what == "segments" else "closest_hit"
            nb = (nbytes(pk, cb, feats, o, d) + (0 if tmax is None else nbytes(tmax))
                  + (4 if what == "segments" else 8) * n)
            # the pairs the data needs under this culling: each lane's own
            # flagged clusters; beside it the bound over the 128-lane row's
            # flags (what a sweep that culls per row visits)
            if what == "segments":
                time_kernel("plucker_occlusion/segments",
                            lambda: plk.occlusion_cuda(pk, feats, cb, o, d, tmax, sub),
                            pairs["lane"] * plk.FLOPS_PER_PAIR[kind], nb, scene)
            else:
                time_kernel(f"plucker_closest_hit/{what}",
                            lambda: plk.closest_hit_cuda(pk, feats, cb, o, d, tmax, sub),
                            pairs["lane"] * plk.FLOPS_PER_PAIR[kind], nb, scene)
            other_bounds[f"plucker_{kind}/{what}", scene] = [(
                f"the {plk.ROW}-lane row's flagged clusters",
                bound(pairs["row"] * plk.FLOPS_PER_PAIR[kind], nb)[0])]
    # the Plücker pair on the same wavefronts sorted on their key (as
    # intersect_sorted and test_occlusion_sorted sweep them): the winners
    # put back in lane order equal the unsorted sweep's; beside the
    # unsorted kernel's ms
    sorted_ms = {}
    for scene in ("teapot", "teapot_hires_plucker"):
        ds = scenes[scene][0]
        sub, cb, pk = ds.cluster_sub, ds.cluster_bounds, ds.sweep_packed
        for what in ("extension", "segments"):
            feats, o, d, tmax, _, _ = inputs["plucker"][scene][what]
            ko, kd, ktm, kact = inputs["signature_key"][scene][what]
            order = torch.sort(sk.signature_key_cuda(ds.key_bounds, ko, kd, ktm, kact),
                               stable=True)[1]
            fs, os_, ds_ = (t.index_select(0, order).contiguous() for t in (feats, o, d))
            ts = None if tmax is None else tmax.index_select(0, order).contiguous()
            if what == "segments":
                run_u = lambda: plk.occlusion_cuda(pk, feats, cb, o, d, tmax, sub)  # noqa: E731
                run_s = lambda: plk.occlusion_cuda(pk, fs, cb, os_, ds_, ts, sub)  # noqa: E731
                same = torch.equal(run_u(), torch.empty_like(run_u()).index_copy_(
                    0, order, run_s()))
            else:
                run_u = lambda: plk.closest_hit_cuda(pk, feats, cb, o, d, tmax, sub)  # noqa: E731
                run_s = lambda: plk.closest_hit_cuda(pk, fs, cb, os_, ds_, ts, sub)  # noqa: E731
                pu, ps = run_u()[0], run_s()[0]
                same = torch.equal(pu, torch.empty_like(pu).index_copy_(0, order, ps))
            sorted_ms[scene, what] = (cuda_ms(run_u, 5), cuda_ms(run_s, 5), cuda_ms(run_u, 5))
            u1, s1, u2 = sorted_ms[scene, what]
            log(f"[timing] plucker {'occlusion' if what == 'segments' else 'closest_hit'}, "
                f"{scene} bounce-1 {what}: unsorted {u1:.3f} / {u2:.3f} ms (before and "
                f"after), sorted on the key {s1:.3f} ms; results in lane order equal: {same} "
                f"({card})")
            assert same, f"{scene} {what}: the sorted sweep's results differ"
    ds = scenes["teapot_quad"][0]
    sub, n_c, cb = ds.cluster_sub, ds.cluster_bounds.shape[0], ds.cluster_bounds
    qc, qp, qo = ds.quad_coeffs, ds.quad_packed, ds.quad_occl_packed
    for what in ("primary", "extension"):
        feats, mask = inputs["quad"][what]
        n = feats.shape[0]
        pairs = group_pairs(plk.unpack_mask(mask, n_c), sub, plk.ROW, n)
        # the operations of the live terms; beside it the bound of all
        # 5 x 27 terms (a sweep that also multiplies the structural zeros)
        time_kernel(f"quad_closest_hit/{what}",
                    lambda: qd.closest_hit_cuda(qp, feats, mask, sub),
                    pairs * qd.FLOPS_PER_PAIR["closest_hit"],
                    nbytes(qp, feats, mask) + 8 * n)
        other_bounds[f"quad_closest_hit/{what}", "teapot_quad"] = [(
            "all 135 terms", bound(pairs * qd.CLOSEST_FLOPS_ALL_TERMS,
                                   nbytes(qc, feats, mask) + 8 * n)[0])]
    feats, so, seg, mask, pairs = inputs["quad"]["segments"]
    n = feats.shape[0]
    nb = nbytes(qo, cb, feats, so, seg) + 4 * n
    assert pairs["row"] == group_pairs(plk.unpack_mask(mask, n_c), sub, plk.ROW, n)
    # the pairs the data needs: each non-zero segment's own clusters at
    # reach 1, over the 81 live terms; beside it the row's flagged clusters
    # at the live terms and at all 162 (the bound until this kernel)
    time_kernel("quad_occlusion/segments",
                lambda: qd.occlusion_cuda(qo, feats, cb, so, seg, sub),
                pairs["lane"] * qd.FLOPS_PER_PAIR["occlusion"], nb)
    other_bounds["quad_occlusion/segments", "teapot_quad"] = [
        ("the 128-lane row's flagged clusters",
         bound(pairs["row"] * qd.FLOPS_PER_PAIR["occlusion"], nb)[0]),
        ("the row's flagged clusters, all 162 terms",
         bound(pairs["row"] * qd.OCCL_FLOPS_ALL_TERMS, nb)[0])]
    ds = scenes["teapot_hires"][0]
    for what in ("primary", "extension", "segments"):
        sph = inputs["compact"][what][-1]
        rows, units = sph[0].shape[0] // cpt.LANES, sph[1].shape[2]
        # each operation unfused (__fmul_rn / __fadd_rn): bounded at the
        # instruction rate; beside it the bound at the FMA-counting peak
        flops = rows * cpt.LANES * units * cpt.FLOPS_PER_PAIR["sphere_flags"]
        nb = nbytes(*sph) + 5 * rows * units
        time_kernel(f"compact_sphere_flags/{what}",
                    lambda: cpt.sphere_flags_cuda(*sph), flops, nb,
                    peak=PEAK_F32_OPS_UNFUSED)
        other_bounds[f"compact_sphere_flags/{what}", "teapot_hires"] = [
            ("the f32 peak counting an FMA as two flops", bound(flops, nb)[0])]
    cp, us = ds.sweep_packed, ds.unit_spheres
    for what in ("primary", "extension"):
        feats, tmax, flags, items, item_tn, offsets, pairs, _ = inputs["compact"][what]
        n = feats.shape[0]
        nb = nbytes(cp, us, feats, tmax, items, item_tn, offsets) + 8 * n
        # the pairs the data needs: per lane, the units its own sphere test
        # flags with entry within reach of the lane's final t; beside it
        # the bound over the row group's flagged units (a sweep that culls
        # per row group only)
        time_kernel(f"compact_closest_hit/{what}",
                    lambda: cpt.closest_hit_cuda(cp, us, feats, tmax, items, item_tn,
                                                 offsets, 1),
                    pairs["lane_cut"] * cpt.FLOPS_PER_PAIR["closest_hit"], nb)
        assert pairs["row"] == group_pairs(flags, cpt.CLUSTER_SUB, cpt.LANES, n)
        other_bounds[f"compact_closest_hit/{what}", "teapot_hires"] = [(
            "the row group's flagged units",
            bound(pairs["row"] * cpt.FLOPS_PER_PAIR["closest_hit"], nb)[0])]
    feats, tm, flags, items, item_tn, offsets, pairs, _ = inputs["compact"]["segments"]
    n = feats.shape[0]
    nb = nbytes(cp, us, feats, tm, items, item_tn, offsets) + 4 * n
    # the pairs the data needs: per lane, the units its own sphere test
    # flags with entry within its range (a segment that no triangle blocks
    # sweeps them all); beside it the bound over the row group's units
    time_kernel("compact_occlusion/segments",
                lambda: cpt.occlusion_cuda(cp, us, feats, tm, items, item_tn, offsets, 1),
                pairs["lane_cut"] * cpt.FLOPS_PER_PAIR["occlusion"], nb)
    assert pairs["row"] == group_pairs(flags, cpt.CLUSTER_SUB, cpt.LANES, n)
    other_bounds["compact_occlusion/segments", "teapot_hires"] = [(
        "the row group's flagged units",
        bound(pairs["row"] * cpt.FLOPS_PER_PAIR["occlusion"], nb)[0])]
    ds = scenes["teapot_hires_band"][0]
    g, cb, wb, bp = ds.band_g, ds.cluster_bounds, ds.word_bounds, ds.sweep_packed
    n_c = cb.shape[0]
    for what in ("primary", "extension"):
        feats, o, d, tmax, mask, pairs = inputs["band"][what]
        n = feats.shape[0]
        nb = (nbytes(bp, cb, wb, feats, o, d) + (0 if tmax is None else nbytes(tmax))
              + 8 * n)
        # the pairs the data needs: each lane's own flagged clusters that its
        # grown box admits at its final t; beside it the bound over its
        # band's flags (the contract: what a sweep without the per-ray skip
        # visits)
        time_kernel(f"band_closest_hit/{what}",
                    lambda: bnd.closest_hit_cuda(bp, feats, cb, wb, o, d, tmax, g),
                    pairs["lane_cut"] * bnd.FLOPS_PER_PAIR["closest_hit"], nb)
        other_bounds[f"band_closest_hit/{what}", "teapot_hires_band"] = [(
            f"the {plk.ROW // g}-lane band's flagged clusters",
            bound(pairs["band"] * bnd.FLOPS_PER_PAIR["closest_hit"], nb)[0])]
    feats, o, d, tm, mask, pairs = inputs["band"]["segments"]
    n = feats.shape[0]
    nb = nbytes(bp, cb, wb, feats, o, d, tm) + 4 * n
    assert pairs["band"] == group_pairs(plk.unpack_mask(mask, n_c), bnd.CLUSTER_SUB,
                                        plk.ROW // g, n)
    # the pairs the data needs: each lane's own clusters its grown box
    # admits within its range; beside it the bound over its band's flags
    # (the bound until this kernel)
    time_kernel("band_occlusion/segments",
                lambda: bnd.occlusion_cuda(bp, feats, cb, wb, o, d, tm, g),
                pairs["lane_cut"] * bnd.FLOPS_PER_PAIR["occlusion"], nb)
    other_bounds["band_occlusion/segments", "teapot_hires_band"] = [(
        f"the {plk.ROW // g}-lane band's flagged clusters",
        bound(pairs["band"] * bnd.FLOPS_PER_PAIR["occlusion"], nb)[0])]
    # the dense kernels issue unfused single operations: bounded at the
    # instruction rate; beside it the bound at the f32 peak that counts an
    # FMA as two flops
    for name in ("cornell", "teapot"):
        ds = scenes[f"{name}_dense"][0]
        tri, t = ds.tri_packed, ds.tri_packed.shape[0]
        work = {}
        for what in ("primary", "extension"):
            if name == "cornell" and what == "extension":
                continue
            o, d = inputs["dense"][name][what]
            n = o.shape[0]
            work[f"dense_closest_hit/{what}"] = (
                lambda o=o, d=d: dns.closest_hit_cuda(tri, o, d),
                n * t * dns.FLOPS_PER_PAIR["closest_hit"], nbytes(tri, o, d) + 16 * n)
        so, sd, tm = inputs["dense"][name]["segments"]
        work["dense_occlusion/segments"] = (
            lambda: dns.occlusion_cuda(tri, so, sd, tm),
            occlusion_pairs(tri, so, sd, tm) * dns.FLOPS_PER_PAIR["occlusion"],
            nbytes(tri, so, sd, tm) + 4 * so.shape[0])
        for key, (kernel, flops, nb) in work.items():
            time_kernel(key, kernel, flops, nb, f"{name}_dense", PEAK_F32_OPS_UNFUSED)
            other_bounds[key, f"{name}_dense"] = [
                ("the f32 peak counting an FMA as two flops", bound(flops, nb)[0])]
    # the BVH walks issue unfused single operations: bounded at the
    # instruction rate over the node visits and leaf pairs the plain walk
    # counted (on the ranged wavefronts, with the dead lanes settled), the
    # node rows and leaves any lane touched read once; beside it the bytes
    # of every visit's row and leaf.  The binning kernel: the rays'
    # directions and ranges read once, the queue written once.  Each timed
    # one call at a time, as every kernel of the line, and as 10 calls back
    # to back (the host's launch latency hidden: the binning makes a walk's
    # wrapper a memset, two launches and a workspace).
    # The sort-key kernel: unfused single operations (__fsub_rn, __fmul_rn,
    # compares), bounded at the instruction rate over every (ray, box) pair
    # of its slab test; the rays, ranges and dead flags read once, the keys
    # written once, the boxes once.  Timed one call at a time and as 10
    # calls back to back
    for scene, waves in inputs["signature_key"].items():
        ds = scenes[scene][0]
        boxes = ds.key_bounds
        band = ds.intersector in ("band", "band_plain")
        for what, (o, d, tmax, active) in waves.items():
            n = o.shape[0]
            ranged = tmax is not None
            ops = (n * boxes.shape[0] * (sk.OPS_PER_BOX + ranged)
                   + n * sk.OPS_PER_RAY)
            nb = (nbytes(boxes, o, d) + 4 * n + (0 if active is None else nbytes(active))
                  + (nbytes(tmax) if isinstance(tmax, torch.Tensor) else 0))
            time_kernel(f"signature_key/{what}",
                        lambda o=o, d=d, tmax=tmax, active=active, band=band, boxes=boxes:
                        sk.signature_key_cuda(boxes, o, d, tmax, active, band),
                        ops, nb, scene, PEAK_F32_OPS_UNFUSED, back_to_back=True)
    for scene in ("teapot_bvh", "teapot_hires_bvh"):
        ds = scenes[scene][0]
        lt, lm, nodes = ds.leaf_tris, ds.leaf_map, ds.bvh_packed
        work = {}
        for what in ("primary", "extension", "extension_ranged", "interleaved"):
            o, d, tmax, st = inputs["bvh"][scene][what]
            # rays (and ranges) in, (prim, dist, bary) out and the winner's
            # leaf_map entry
            flops, once, every = walk_work(ds, st, o.shape[0], 24 + 20 + 4 * (tmax is not None))
            work[f"bvh_closest_hit/{what}"] = (
                lambda o=o, d=d, tmax=tmax: trv.intersect_bvh_cuda(lt, lm, nodes, o, d, tmax),
                flops, once, every)
            if what in ("primary", "extension"):
                flops, once, every = walk_work(ds, st, o.shape[0], 24 + 4)
                work[f"bvh_heatmap/{what}"] = (
                    lambda o=o, d=d: trv.intersect_bvh_heatmap_cuda(lt, nodes, o, d), flops,
                    once, every)
        so, sd, tm, st = inputs["bvh"][scene]["segments"]
        flops, once, every = walk_work(ds, st, so.shape[0], 28 + 4)
        work["bvh_occlusion/segments"] = (
            lambda: trv.occlusion_bvh_cuda(lt, nodes, so, sd, tm), flops, once, every)
        for key, (kernel, flops, once, every) in work.items():
            time_kernel(key, kernel, flops, once, scene, PEAK_F32_OPS_UNFUSED, back_to_back=True)
            other_bounds[key, scene] = [
                ("every visit's node row (32 B) and leaf (576 B) from device memory",
                 bound(flops, every, PEAK_F32_OPS_UNFUSED)[0])]
            if key.startswith("bvh_heatmap/"):  # the heatmap's device time alone
                REPLAYED_MS[key, scene] = replayed_ms(kernel)
        for what, sc in inputs["bvh"][scene]["heatmap_schedule"].items():
            b_ms = bound(*timed[f"bvh_heatmap/{what}", scene][2:4], PEAK_F32_OPS_UNFUSED)[0]
            t_one, t_rep = timed[f"bvh_heatmap/{what}", scene][0], REPLAYED_MS[
                f"bvh_heatmap/{what}", scene]
            log(f"[timing] bvh heatmap, {scene} {what}: bound {b_ms:.4f} ms; one call "
                f"{t_one:.4f} ms ({100 * b_ms / t_one:.1f}% of the bound), 10 replayed in one "
                f"CUDA graph {t_rep:.4f} ms a call ({100 * b_ms / t_rep:.1f}%); the plain "
                f"model's {sc['warp_steps']:.2f} warp steps against {sc['lane_visits']:.2f} "
                f"visits a lane ({sc['warp_steps'] / sc['lane_visits']:.3f} x) ({card})")
        for what, (d, tmax) in {"extension_ranged": inputs["bvh"][scene]["extension_ranged"][1:3],
                                "segments": (sd, tm)}.items():
            live = int((tmax > 0).sum())
            time_kernel(f"bvh_bin/{what}", lambda d=d, tmax=tmax: trv.bin_cuda(d, tmax), 0.0,
                        nbytes(d, tmax) + 4 * live, scene, back_to_back=True)
    # the redesigned sort-key and binning kernels beside the parent's (--parent)
    parent_kernels = (parent_kernel_times(args.parent, scenes, inputs, log, card)
                      if args.parent else {})
    ds, cam = scenes["teapot_bvh"]
    r = Renderer(ds=ds, cam=cam, desc=None, settings=Settings(tracer=Tracer.BVH_VISUALIZE),
                 device=dev)
    heat_ms = cuda_ms(r.step, reps=5)
    log(f"[timing] BVH heatmap tracer, teapot_bvh {RES}x{RES}: {heat_ms:.3f} ms a frame "
        f"(Renderer.step: pinhole rays, the heatmap walk, colours, display; median of 5) "
        f"({card})")
    for (key, scene), (k, p, flops, nb, peak) in timed.items():
        name, what = key.split("/")
        b_ms, b_by = bound(flops, nb, peak)
        also = "".join(f"; bound over {o_name} {o_ms:.3f} ms"
                       for o_name, o_ms in other_bounds.get((key, scene), ()))
        if (key, scene) in BACK_TO_BACK_MS:
            also += f"; 10 calls back to back {BACK_TO_BACK_MS[key, scene]:.3f} ms a call"
        if (key, scene) in REPLAYED_MS:
            also += f"; 10 replayed in one CUDA graph {REPLAYED_MS[key, scene]:.4f} ms a call"
        log(f"[timing] {name}, {scene} {what}: kernel "
            f"{k:.3f} ms one call, plain {p:.3f} ms; bound {b_ms:.3f} ms ({b_by}: "
            f"{flops / 1e9:.2f} G operations at {peak / 1e12:.1f} T/s, {nb / 1e6:.2f} MB), "
            f"kernel at {100 * b_ms / k:.1f}% of it{also} ({card})")

    def other(key, scene):
        return [{"over": o_name, "ms": o_ms} for o_name, o_ms in other_bounds.get((key, scene), ())]

    rows = []
    for name in REPLACES:
        lib, kind = name.split("_", 1)
        what = {"occlusion": "segments", "bin": "extension_ranged"}.get(kind, "primary")
        k, p, flops, nb, peak = timed[f"{name}/{what}", KERNEL_SCENE[lib]]
        b_ms, b_by = bound(flops, nb, peak)
        # the heatmap's main path is the heatmap tracer's frames
        n_launch, n_frames = (launches_heatmap[KERNEL_SCENE[lib]] if kind == "heatmap"
                              else launches[lib])
        rows.append({"name": name, "route": "cuda", "source": SOURCES[lib],
                     "replaces": REPLACES[name], "launches": n_launch[kind],
                     "launches_per_frame": n_launch[kind] / n_frames,
                     "max_abs_err": max_err[name], "ms": k, "plain_ms": p,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "shape": f"{KERNEL_SCENE[lib]} {what}",
                     "other_bounds": other(f"{name}/{what}", KERNEL_SCENE[lib])})
        if lib == "bvh":
            rows[-1]["stage"] = (f"an XLA {'sort' if kind == 'bin' else 'walk'} of the JAX "
                                 f"package (no Pallas body)")
            # every wavefront it was timed on
            rows[-1]["wavefronts"] = {
                f"{scene} {key.split('/')[1]}": {
                    "ms": t[0], "ms_back_to_back": BACK_TO_BACK_MS.get((key, scene)),
                    "ms_replayed": REPLAYED_MS.get((key, scene)),
                    "plain_ms": t[1], "bound_ms": bound(t[2], t[3], t[4])[0]}
                for (key, scene), t in timed.items() if key.split("/")[0] == name}
            if kind in ("bin", "heatmap") and parent_kernels:
                rows[-1]["parent"] = {k: v for k, v in parent_kernels.items()
                                      if k.startswith(f"bvh_{kind}/")
                                      or (kind == "heatmap" and k.startswith("heatmap frame"))}
            if kind == "heatmap":
                rows[-1]["schedule"] = {scene: inputs["bvh"][scene]["heatmap_schedule"]
                                        for scene in inputs["bvh"]}
        if lib in ("plucker", "bvh"):  # the same kernel on the largest scene of its engine
            scene = f"teapot_hires_{lib}"
            k, p, flops, nb, peak = timed[f"{name}/{what}", scene]
            n_launch, n_frames = (launches_heatmap[scene] if kind == "heatmap" else
                                  launches_hires_plucker if lib == "plucker" else
                                  launches_hires_bvh)
            rows[-1]["also"] = {
                "shape": f"{scene} {what}", "launches": n_launch[kind],
                "launches_per_frame": n_launch[kind] / n_frames, "ms": k, "plain_ms": p,
                "bound_ms": bound(flops, nb, peak)[0], "bound_by": bound(flops, nb, peak)[1],
                "other_bounds": other(f"{name}/{what}", scene)}
        if lib == "plucker":  # the other shipped scenes' main paths (8 frames each)
            rows[-1]["other_scenes"] = {
                scene: {"launches": n.get(kind, 0), "launches_per_frame": n.get(kind, 0) / 8}
                for scene, n in launches_other.items()}
    # the sort-key kernel, launched on the Plücker main path (cornell has no
    # clusters and no key); every wavefront it was timed on beside
    k, p, flops, nb, peak = timed["signature_key/" + KEY_ROW[1], KEY_ROW[0]]
    b_ms, b_by = bound(flops, nb, peak)
    n_launch, n_frames = key_launches["cornell", "teapot"]
    rows.append({"name": "signature_key", "route": "cuda", "source": SOURCES["sort_key"],
                 "replaces": KEY_REPLACES, "launches": n_launch["signature_key"],
                 "launches_per_frame": n_launch["signature_key"] / n_frames,
                 "max_abs_err": max_err["signature_key"], "ms": k, "plain_ms": p,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 "shape": f"{KEY_ROW[0]} {KEY_ROW[1]}",
                 "stage": "an XLA slab test of the JAX package (no Pallas body)",
                 "other_scenes": {
                     ", ".join(names): {"launches": n.get("signature_key", 0),
                                        "launches_per_frame": n.get("signature_key", 0) / f}
                     for names, (n, f) in key_launches.items()},
                 "wavefronts": {
                     f"{scene} {key.split('/')[1]}": {
                         "ms": t[0], "ms_back_to_back": BACK_TO_BACK_MS.get((key, scene)),
                         "plain_ms": t[1], "bound_ms": bound(t[2], t[3], t[4])[0]}
                     for (key, scene), t in timed.items()
                     if key.split("/")[0] == "signature_key"}})
    if parent_kernels:
        rows[-1]["parent"] = {k: v for k, v in parent_kernels.items()
                              if k.startswith("signature_key/")}
    rows.append(ris_row)
    rows.append(vertex_row)
    rows.append(surface_row)
    log(f"[phase] 7 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- 7. batched frames: one CUDA graph a block ----
    batched = batched_phase(scenes, log, card)
    log(f"[batched] {json.dumps(batched)}")
    log(f"[syncs] {json.dumps(sync_counts(scenes, log))}")
    log(f"[sliced] {json.dumps(sliced_record)}")
    log(f"[phase] 8 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- 8. frame times beside the parent checkout's (--parent) ----
    if args.parent:
        torch.cuda.empty_cache()  # the subprocesses load their own scenes
        log(f"[parent] {json.dumps(parent_frame_times(args.parent, log, card))}")
        log(f"[parent] frames differing: {json.dumps(parent_frames(args.parent, log, card))}")
    else:
        log("[parent] frame times beside the parent's: not timed (no --parent)")
    log(f"[phase] 9 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- 9. the multi-device path: tiles of a mesh on the one card ----
    log(f"[mesh] {json.dumps(mesh_phase(scenes, log, card))}")
    log(f"[phase] 10 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- 10. the native host build against the numpy build ----
    log(f"[host] {json.dumps(host_phase(dev, cold, log))}")
    log(f"[done] chip_smoke ran {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
