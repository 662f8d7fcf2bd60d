"""Time the sweep kernels' compile-time shapes on one GPU.

The sweep kernels have compile-time shapes: lanes a block, triangles a
staged tile and triangles a thread holds at a time (``PLUCKER_BLOCK_LANES``,
``PLUCKER_TILE``, ``PLUCKER_TRIS`` in csrc/plucker.cu); the lanes a block
walks and the count of wanting lanes from which a warp sweeps in lockstep,
for the closest hit and for the shadow sweep (``COMPACT_BLOCK_LANES``,
``COMPACT_LOCKSTEP``, ``COMPACT_OCCL_BLOCK_LANES``,
``COMPACT_OCCL_LOCKSTEP`` in csrc/compact.cu); rays a thread and resident
blocks asked of the compiler (``QUAD_RAYS``, ``QUAD_MIN_BLOCKS`` in
csrc/quad.cu), and for the quad shadow sweep its resident blocks
(``QUAD_OCCL_MIN_BLOCKS``); lanes a block, triangles a thread and a one- or
two-level vote of both band kernels (``BAND_BLOCK_LANES``, ``BAND_TRIS``,
``BAND_TWO_LEVEL`` in csrc/band.cu); for the persistent BVH walks (closest
hit and shadow) warps a block, blocks a SM (0: as many as the registers
allow), the free lanes at which a warp refills and node steps between the
warp's votes (``BVH_WARPS``, ``BVH_BLOCKS_PER_SM``, ``BVH_REFILL``,
``BVH_VOTE_EVERY`` in csrc/bvh.cu); for the heatmap's warp-coherent walk
threads a block, node rows a warp fetches in one load, how a leaf is
tested and up to how many rounds its pairs are spread
(``BVH_HEAT_THREADS``, ``BVH_HEAT_ROWS``, ``BVH_HEAT_LEAF``,
``BVH_HEAT_SPREAD``); the binning kernel's threads a block (``BIN_THREADS`` in
csrc/bvh.cu); the sort-key kernel's rays a thread and threads a block
(``KEY_RAYS``, ``KEY_THREADS`` in csrc/sort_key.cu).  This tool builds
each variant as its own library (``-DCOMPACT_LOCKSTEP=n ...``), holds it against the plain
version on the main path's wavefronts (800x800 primaries and the bounce-1
extension rays, for bvh also with the frame's dead-lane range; for
Plücker, the compact, quad, band and bvh shadow sweeps the bounce-1
shadow segments; teapot and teapot_hires for Plücker and bvh,
teapot_hires for compact and band, teapot for quad, built as
``chip_smoke.py`` builds them; for the key the primaries, the bounce-1
extension rays with their dead lanes and the NEE segments of teapot (43
boxes) and teapot_hires (115 boxes, and the compact layout's 220); for the
binning the bounce-1 extension rays with the frame's dead-lane range and
the NEE segments of teapot and teapot_hires on the bvh engine; for the
heatmap the primaries and the bounce-1 extension rays of teapot and
teapot_hires on the bvh engine, in raster order) and times
it with CUDA events, the variants in turns (the walks, the key and the
binning as 10 calls back to back, the heatmap as 10 calls replayed in one
CUDA graph).  It prints registers and spills per
variant, the times, and the card's name and power limit.  The default in
the source is the variant that won.

Run from the repository root:
    python -m radish_pt_tpu_torch.tune [plucker] [compact] [quad] [band] [bvh] [heat] [key] [bin]
(no argument: all eight).
"""

from __future__ import annotations

import os
import sys

# each variant: the -D flags of its build
PLUCKER_VARIANTS = (
    ("-DPLUCKER_BLOCK_LANES=64", "-DPLUCKER_TILE=128", "-DPLUCKER_TRIS=4"),
    ("-DPLUCKER_BLOCK_LANES=32", "-DPLUCKER_TILE=128", "-DPLUCKER_TRIS=4"),
    ("-DPLUCKER_BLOCK_LANES=128", "-DPLUCKER_TILE=128", "-DPLUCKER_TRIS=4"),
    ("-DPLUCKER_BLOCK_LANES=256", "-DPLUCKER_TILE=128", "-DPLUCKER_TRIS=4"),
    ("-DPLUCKER_BLOCK_LANES=64", "-DPLUCKER_TILE=128", "-DPLUCKER_TRIS=2"),
    ("-DPLUCKER_BLOCK_LANES=64", "-DPLUCKER_TILE=128", "-DPLUCKER_TRIS=1"),
    ("-DPLUCKER_BLOCK_LANES=64", "-DPLUCKER_TILE=64", "-DPLUCKER_TRIS=2"),
    ("-DPLUCKER_BLOCK_LANES=64", "-DPLUCKER_TILE=256", "-DPLUCKER_TRIS=4"))
COMPACT_VARIANTS = (("-DCOMPACT_BLOCK_LANES=64", "-DCOMPACT_LOCKSTEP=1"),
                    ("-DCOMPACT_BLOCK_LANES=64", "-DCOMPACT_LOCKSTEP=12"),
                    ("-DCOMPACT_BLOCK_LANES=64", "-DCOMPACT_LOCKSTEP=33"),
                    ("-DCOMPACT_BLOCK_LANES=32", "-DCOMPACT_LOCKSTEP=12"),
                    ("-DCOMPACT_BLOCK_LANES=128", "-DCOMPACT_LOCKSTEP=12"),
                    ("-DCOMPACT_BLOCK_LANES=256", "-DCOMPACT_LOCKSTEP=12"),
                    ("-DCOMPACT_BLOCK_LANES=256", "-DCOMPACT_LOCKSTEP=1"))
COMPACT_OCCL_VARIANTS = (
    ("-DCOMPACT_OCCL_BLOCK_LANES=64", "-DCOMPACT_OCCL_LOCKSTEP=12"),
    ("-DCOMPACT_OCCL_BLOCK_LANES=64", "-DCOMPACT_OCCL_LOCKSTEP=1"),
    ("-DCOMPACT_OCCL_BLOCK_LANES=64", "-DCOMPACT_OCCL_LOCKSTEP=6"),
    ("-DCOMPACT_OCCL_BLOCK_LANES=64", "-DCOMPACT_OCCL_LOCKSTEP=20"),
    ("-DCOMPACT_OCCL_BLOCK_LANES=64", "-DCOMPACT_OCCL_LOCKSTEP=33"),
    ("-DCOMPACT_OCCL_BLOCK_LANES=32", "-DCOMPACT_OCCL_LOCKSTEP=12"),
    ("-DCOMPACT_OCCL_BLOCK_LANES=128", "-DCOMPACT_OCCL_LOCKSTEP=12"),
    ("-DCOMPACT_OCCL_BLOCK_LANES=256", "-DCOMPACT_OCCL_LOCKSTEP=12"))
BAND_VARIANTS = (("-DBAND_BLOCK_LANES=64", "-DBAND_TRIS=2", "-DBAND_TWO_LEVEL=1"),
                 ("-DBAND_BLOCK_LANES=64", "-DBAND_TRIS=2", "-DBAND_TWO_LEVEL=0"),
                 ("-DBAND_BLOCK_LANES=128", "-DBAND_TRIS=2", "-DBAND_TWO_LEVEL=1"),
                 ("-DBAND_BLOCK_LANES=64", "-DBAND_TRIS=1", "-DBAND_TWO_LEVEL=1"))
QUAD_OCCL_VARIANTS = (("-DQUAD_OCCL_MIN_BLOCKS=4",), ("-DQUAD_OCCL_MIN_BLOCKS=1",))
# the persistent walks: the defaults first, then one shape changed at a time
_BVH_DEFAULTS = {"BVH_WARPS": 4, "BVH_BLOCKS_PER_SM": 0, "BVH_REFILL": 16, "BVH_VOTE_EVERY": 4}
BVH_VARIANTS = tuple(
    tuple(f"-D{k}={v}" for k, v in {**_BVH_DEFAULTS, **change}.items())
    for change in ({}, {"BVH_WARPS": 2}, {"BVH_WARPS": 8}, {"BVH_BLOCKS_PER_SM": 4},
                   {"BVH_BLOCKS_PER_SM": 8}, {"BVH_REFILL": 4}, {"BVH_REFILL": 8},
                   {"BVH_REFILL": 24}, {"BVH_REFILL": 32}, {"BVH_VOTE_EVERY": 1},
                   {"BVH_VOTE_EVERY": 2}, {"BVH_VOTE_EVERY": 8}))
# the heatmap's warp-coherent walk: the defaults first, then one macro
# changed at a time (threads a block; node rows a warp fetches a load; how
# a leaf is tested: 0 broadcast, 1 staged, 2 spread below a number of
# rounds)
_HEAT_DEFAULTS = {"BVH_HEAT_THREADS": 64, "BVH_HEAT_ROWS": 1, "BVH_HEAT_LEAF": 2,
                  "BVH_HEAT_SPREAD": 8}
BVH_HEATMAP_VARIANTS = tuple(
    tuple(f"-D{k}={v}" for k, v in {**_HEAT_DEFAULTS, **change}.items())
    for change in ({}, {"BVH_HEAT_THREADS": 128}, {"BVH_HEAT_THREADS": 256},
                   {"BVH_HEAT_ROWS": 4}, {"BVH_HEAT_ROWS": 16}, {"BVH_HEAT_LEAF": 0},
                   {"BVH_HEAT_LEAF": 1}, {"BVH_HEAT_SPREAD": 5}, {"BVH_HEAT_SPREAD": 11},
                   {"BVH_HEAT_SPREAD": 32}))
# the sort-key kernel and the binning kernel: the defaults first, then one
# macro changed at a time
_KEY_DEFAULTS = {"KEY_RAYS": 2, "KEY_THREADS": 128}
KEY_VARIANTS = tuple(
    tuple(f"-D{k}={v}" for k, v in {**_KEY_DEFAULTS, **change}.items())
    for change in ({}, {"KEY_RAYS": 1}, {"KEY_RAYS": 4}, {"KEY_THREADS": 64},
                   {"KEY_THREADS": 256}))
BIN_VARIANTS = (("-DBIN_THREADS=256",), ("-DBIN_THREADS=128",), ("-DBIN_THREADS=512",),
                ("-DBIN_THREADS=1024",))
QUAD_VARIANTS = (("-DQUAD_RAYS=1", "-DQUAD_MIN_BLOCKS=1"),
                 ("-DQUAD_RAYS=2", "-DQUAD_MIN_BLOCKS=1"),
                 ("-DQUAD_RAYS=2", "-DQUAD_MIN_BLOCKS=8"),
                 ("-DQUAD_RAYS=2", "-DQUAD_MIN_BLOCKS=10"),
                 ("-DQUAD_RAYS=4", "-DQUAD_MIN_BLOCKS=1"))


def main(argv=None) -> int:
    import torch

    all_engines = ["plucker", "compact", "quad", "band", "bvh", "heat", "key", "bin"]
    engines = (sys.argv[1:] if argv is None else argv) or all_engines
    if set(engines) - set(all_engines):
        print(f"tune: engines are {', '.join(all_engines)}", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("tune: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs  # the wavefronts, the timer and the parity check

    from .accel import _build
    from .accel import band as bnd
    from .accel import compact as cpt
    from .accel import plucker as plk
    from .accel import quad as qd
    from .accel import sort_key as sk
    from .accel import traverse as trv
    from .scene.build import load_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.gpu_name_and_power()
    print(card, flush=True)

    def variants(lib, flag_sets, kernels="closest_hit"):
        """The variants' libraries, built verbosely, by their flags."""
        out = {}
        for defines in flag_sets:
            _build.PTXAS_LOG.pop(lib, None)
            _build.build_all((lib,), verbose=True, defines=defines)
            for kernel, use in _build.kernel_resources(lib).items():
                if kernels in kernel:
                    print(f"[build] {lib} {' '.join(defines)}: {kernel}: {use['registers']} "
                          f"registers, spills {use['spill_stores']} B stored / "
                          f"{use['spill_loads']} B loaded, {use['smem']} B static "
                          f"shared memory", flush=True)
            out[" ".join(defines)] = _build.load_library(lib, defines)
        return out

    def run(lib, variant, fn):
        """``fn()`` with ``variant`` standing in for library ``lib``."""
        _build._libs[lib] = variant
        try:
            return fn()
        finally:
            _build._libs.pop(lib, None)

    def scene(name, engine):
        ds, cam, _ = load_scene(os.path.join(cs.REPO, "scenes", cs.SCENE_FILES[name]),
                                device=dev, intersector=engine)
        return ds, cam.replace(width=cs.RES, height=cs.RES)

    def race(lib, libs, what, kernel, inner=1, replayed=False):
        """The variants of ``lib`` timed on ``kernel`` in turns, twice (each
        run ``inner`` launches back to back, or ``replayed``: 10 launches
        captured in one CUDA graph and replayed)."""
        for turn in range(2):
            for r, variant in libs.items():
                ms = run(lib, variant, (lambda: cs.replayed_ms(kernel)) if replayed else
                         (lambda: cs.cuda_ms(kernel, 5, inner=inner)))
                print(f"[timing] {lib}, {what}, {r}, turn {turn}: {ms:.3f} ms ({card})",
                      flush=True)

    # ---- plucker, teapot and teapot_hires ----
    libs = variants("plucker", PLUCKER_VARIANTS, "_kernel") if "plucker" in engines else {}
    for name in ("teapot", "teapot_hires") if libs else ():
        ds, cam = scene(name, "plucker")
        waves = run("plucker", next(iter(libs.values())), lambda: cs.bounce_one(ds, cam))
        sub, cb = ds.cluster_sub, ds.cluster_bounds
        for what in ("primary", "extension", "segments"):
            if what == "segments":
                x, y, live = waves[what]
                o, d, tmax = (t.contiguous() for t in plk.segment_rays(x, y))
            else:
                o, d, tmax = (t.contiguous() for t in waves[what])
                live = tmax >= 0
            feats = plk.plucker_features(o, d, ds.sweep_center)
            words = plk.cluster_mask_words(cb, o, d, tmax, plk.GROUP)
            if what == "segments":
                want = plk.occlusion_plain(ds.sweep_coeffs, feats, tmax, words, sub)

                def kernel():
                    return plk.occlusion_cuda(ds.sweep_packed, feats, cb, o, d, tmax, sub)
            else:
                pp, dp = plk.closest_hit_plain(ds.sweep_coeffs, feats, words, sub,
                                               dead=plk.dead_lanes(tmax))

                def kernel():
                    return plk.closest_hit_cuda(ds.sweep_packed, feats, cb, o, d, tmax, sub)

            for r, lib in libs.items():
                got = run("plucker", lib, kernel)
                torch.cuda.synchronize()
                if what == "segments":
                    cs.check_occlusion(got, want, live, f"plucker, {r}, {name}", print)
                else:
                    cs.check_closest(*got, pp, dp, live,
                                     f"plucker closest hit, {r}, {name} {what}", print)
            race("plucker", libs, f"{name} {what}", kernel)

    # ---- compact, teapot_hires ----
    if "compact" in engines:
        libs = variants("compact", COMPACT_VARIANTS)
        ds, cam = scene("teapot_hires", "compact")
        waves = run("compact", next(iter(libs.values())), lambda: cs.bounce_one(ds, cam))
        for what in ("primary", "extension"):
            o, d, tmax = waves[what]
            live = tmax >= 0
            flags, tn, g = run("compact", next(iter(libs.values())), lambda: cpt.prepass(
                ds.sweep_center, ds.cluster_bounds, o, d, tmax))
            feats = plk.plucker_features(o, d, ds.sweep_center)
            items, item_tn, offsets = cpt.work_list(flags, tn)
            pp, dp = cpt.closest_hit_plain(ds.sweep_coeffs, feats, tmax, flags, g)

            def kernel():
                return cpt.closest_hit_cuda(ds.sweep_packed, ds.unit_spheres, feats, tmax,
                                            items, item_tn, offsets, g)

            for r, lib in libs.items():
                pk, dk = run("compact", lib, kernel)
                torch.cuda.synchronize()
                cs.check_closest(pk, dk, pp, dp, live,
                                 f"compact closest hit, {r}, {what}", print)
                assert bool((pk[~live] == -1).all())
            race("compact", libs, f"closest hit, teapot_hires {what}", kernel)
        # the shadow sweep on the bounce-1 segments: its layouts
        libs = variants("compact", COMPACT_OCCL_VARIANTS, "occlusion")
        x, y, live = waves["segments"]
        o, d, tm = (t.contiguous() for t in plk.segment_rays(x, y))
        flags, tn, g = cpt.prepass(ds.sweep_center, ds.cluster_bounds, o, d, tm)
        feats = plk.plucker_features(o, d, ds.sweep_center)
        items, item_tn, offsets = cpt.work_list(flags, tn)
        want = cpt.occlusion_plain(ds.sweep_coeffs, feats, tm, flags, g)

        def shadow():
            return cpt.occlusion_cuda(ds.sweep_packed, ds.unit_spheres, feats, tm, items,
                                      item_tn, offsets, g)

        for r, lib in libs.items():
            got = run("compact", lib, shadow)
            torch.cuda.synchronize()
            cs.check_occlusion(got, want, live, f"compact, {r}", print)
            assert torch.equal(got, want)
        race("compact", libs, "shadow, teapot_hires segments", shadow)

    # ---- quad, teapot ----
    if "quad" in engines:
        libs = variants("quad", QUAD_VARIANTS)
        ds, cam = scene("teapot", "quad")
        waves = run("quad", next(iter(libs.values())), lambda: cs.bounce_one(ds, cam))
        for what in ("primary", "extension"):
            o, d, tmax = waves[what]
            feats = qd.quad_features(o, d, ds.sweep_center)
            mask = plk.cluster_mask_words(ds.cluster_bounds, o, d,
                                          None if what == "primary" else tmax)
            pp, dp = qd.closest_hit_plain(ds.quad_coeffs, feats, mask, ds.cluster_sub)

            def kernel():
                return qd.closest_hit_cuda(ds.quad_packed, feats, mask, ds.cluster_sub)

            for r, lib in libs.items():
                pk, dk = run("quad", lib, kernel)
                torch.cuda.synchronize()
                cs.check_closest(pk, dk, pp, dp, tmax >= 0,
                                 f"quad closest hit, {r}, {what}", print)
            race("quad", libs, f"closest hit, teapot {what}", kernel)
        # the shadow sweep on the bounce-1 segments: its register caps
        libs = variants("quad", QUAD_OCCL_VARIANTS, "occlusion")
        x, y, live = waves["segments"]
        so, seg = (t.contiguous() for t in qd.quad_segments(x, y))
        feats = qd.quad_features(so, seg, ds.sweep_center)
        mask = plk.cluster_mask_words(ds.cluster_bounds, so, seg, torch.ones_like(so[:, 0]))
        want = qd.occlusion_plain(ds.quad_coeffs, feats, mask, ds.cluster_sub)

        def shadow():
            return qd.occlusion_cuda(ds.quad_occl_packed, feats, ds.cluster_bounds, so, seg,
                                     ds.cluster_sub)

        for r, lib in libs.items():
            got = run("quad", lib, shadow)
            torch.cuda.synchronize()
            cs.check_occlusion(got, want, live, f"quad, {r}", print)
        race("quad", libs, "shadow, teapot segments", shadow)

    # ---- band, teapot_hires (8 bands a row) ----
    if "band" in engines:
        libs = variants("band", BAND_VARIANTS, "_kernel")
        ds, cam = scene("teapot_hires", "band")
        waves = run("band", next(iter(libs.values())), lambda: cs.bounce_one(ds, cam))
        cb, wb, g = ds.cluster_bounds, ds.word_bounds, ds.band_g
        for what in ("primary", "extension"):
            o, d, tmax = (t.contiguous() for t in waves[what])
            live = tmax >= 0
            if what == "primary":
                tmax = None
            feats = plk.plucker_features(o, d, ds.sweep_center)
            mask = bnd.band_mask_words(cb, o, d, tmax, g)
            pp, dp = bnd.closest_hit_plain(ds.sweep_coeffs, feats, mask, g,
                                           dead=plk.dead_lanes(tmax))

            def kernel():
                return bnd.closest_hit_cuda(ds.sweep_packed, feats, cb, wb, o, d, tmax, g)

            for r, lib in libs.items():
                pk, dk = run("band", lib, kernel)
                torch.cuda.synchronize()
                assert torch.equal(pk[live], pp[live]) and torch.equal(dk[live], dp[live]), r
            race("band", libs, f"closest hit, teapot_hires {what}", kernel)
        # the shadow sweep (the same shapes) on the bounce-1 segments
        x, y, live = waves["segments"]
        o, d, tm = (t.contiguous() for t in plk.segment_rays(x, y))
        feats = plk.plucker_features(o, d, ds.sweep_center)
        want = bnd.occlusion_plain(ds.sweep_coeffs, feats, tm,
                                   bnd.band_mask_words(cb, o, d, tm, g), g)

        def shadow():
            return bnd.occlusion_cuda(ds.sweep_packed, feats, cb, wb, o, d, tm, g)

        for r, lib in libs.items():
            got = run("band", lib, shadow)
            torch.cuda.synchronize()
            cs.check_occlusion(got, want, live, f"band, {r}", print)
        race("band", libs, "shadow, teapot_hires segments", shadow)

    # ---- bvh, teapot and teapot_hires: the persistent walks ----
    libs = variants("bvh", BVH_VARIANTS, "_kernel") if "bvh" in engines else {}
    for name in ("teapot", "teapot_hires") if libs else ():
        ds, cam = scene(name, "bvh")
        waves = run("bvh", next(iter(libs.values())), lambda: cs.bounce_one(ds, cam))
        lt, lm, nodes = ds.leaf_tris, ds.leaf_map, ds.bvh_packed
        walks = {}
        for what in ("primary", "extension", "extension, ranged"):
            o, d, tmax = (t.contiguous() for t in waves[what.split(",")[0]])
            tmax = tmax if what.endswith("ranged") else None
            walks[f"closest hit, {what}"] = (
                lambda o=o, d=d, tmax=tmax: trv.intersect_bvh_cuda(lt, lm, nodes, o, d, tmax),
                trv.intersect_bvh_plain(lt, lm, nodes, o, d, tmax))
        x, y, _ = waves["segments"]
        so, sd, tm = (t.contiguous() for t in trv.segment_rays(x, y))
        walks["shadow, segments"] = (lambda: trv.occlusion_bvh_cuda(lt, nodes, so, sd, tm),
                                     trv.occlusion_bvh_plain(lt, nodes, so, sd, tm))
        for what, (kernel, want) in walks.items():
            want = want if isinstance(want, tuple) else (want,)
            for r, lib in libs.items():
                got = run("bvh", lib, kernel)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (r, name, what)
            race("bvh", libs, f"{name} {what}", kernel, inner=10)

    # ---- the heatmap, teapot and teapot_hires: primaries, bounce 1 ----
    libs = variants("bvh", BVH_HEATMAP_VARIANTS, "heatmap") if "heat" in engines else {}
    for name in ("teapot", "teapot_hires") if libs else ():
        ds, cam = scene(name, "bvh")
        waves = run("bvh", next(iter(libs.values())), lambda: cs.bounce_one(ds, cam))
        lt, nodes = ds.leaf_tris, ds.bvh_packed
        for what in ("primary", "extension"):
            o, d, _ = (t.contiguous() for t in waves[what])
            want = trv.intersect_bvh_heatmap_plain(lt, nodes, o, d)

            def kernel(o=o, d=d):
                return trv.intersect_bvh_heatmap_cuda(lt, nodes, o, d)

            for r, lib in libs.items():
                got = run("bvh", lib, kernel)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (r, name, what, int((got != want).sum()))
            race("bvh", libs, f"heatmap, {name} {what} (replayed)", kernel, replayed=True)

    # ---- the sort key: teapot (43 boxes), teapot_hires (115; compact's 220) ----
    libs = variants("sort_key", KEY_VARIANTS, "signature_key") if "key" in engines else {}
    for name, engine in (("teapot", "plucker"), ("teapot_hires", "plucker"),
                         ("teapot_hires", "compact")) if libs else ():
        ds, cam = scene(name, engine)
        waves = cs.bounce_one(ds, cam)
        boxes = ds.key_bounds
        o, d, _ = waves["primary"]
        eo, ed, etm = waves["extension"]
        x, y, ok = waves["segments"]
        for what, args in (("primary", (o, d, None, None)),
                           ("extension", (eo, ed, None, etm > 0)),
                           ("segments", (x, y - x, 1.0, ok))):
            args = tuple(a.contiguous() if isinstance(a, torch.Tensor) else a for a in args)
            want = sk.signature_key_plain(boxes, *args)

            def kernel(args=args):
                return sk.signature_key_cuda(boxes, *args)

            for r, lib in libs.items():
                got = run("sort_key", lib, kernel)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (r, name, what, int((got != want).sum()))
            race("sort_key", libs, f"{name} ({boxes.shape[0]} boxes) {what}", kernel, inner=10)

    # ---- the binning: teapot and teapot_hires on the bvh engine ----
    libs = variants("bvh", BIN_VARIANTS, "bin") if "bin" in engines else {}
    for name in ("teapot", "teapot_hires") if libs else ():
        ds, cam = scene(name, "bvh")
        waves = run("bvh", next(iter(libs.values())), lambda: cs.bounce_one(ds, cam))
        _, d_e, t_e = (t.contiguous() for t in waves["extension"])
        x, y, _ = waves["segments"]
        _, sd, tm = (t.contiguous() for t in trv.segment_rays(x, y))
        for what, (d, tmax) in (("extension, ranged", (d_e, t_e)), ("segments", (sd, tm))):
            order, want = trv.bin_by_dir_class(d, tmax)
            bounds = [0, *torch.cumsum(want, 0).tolist()]
            for r, lib in libs.items():
                queue, counts = run("bvh", lib, lambda: trv.bin_by_dir_class_cuda(d, tmax))
                assert torch.equal(counts.long(), want), (r, name, what)
                assert all(torch.equal(torch.sort(queue[a:b].long()).values, order[a:b])
                           for a, b in zip(bounds, bounds[1:])), (r, name, what)
            race("bvh", libs, f"binning, {name} {what}",
                 lambda: trv.bin_cuda(d, tmax), inner=10)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
