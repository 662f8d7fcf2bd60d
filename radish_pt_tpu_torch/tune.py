"""Time the sweep kernels' compile-time shapes on one GPU.

The Plücker kernels, the compact and the quad closest-hit kernels have
compile-time shapes: lanes a block, triangles a staged tile and triangles a
thread holds at a time (``PLUCKER_BLOCK_LANES``, ``PLUCKER_TILE``,
``PLUCKER_TRIS`` in csrc/plucker.cu); the lanes a
block walks and the count of wanting lanes from which a warp sweeps
in lockstep (``COMPACT_BLOCK_LANES``, ``COMPACT_LOCKSTEP`` in
csrc/compact.cu), rays a thread and resident blocks asked of the compiler
(``QUAD_RAYS``, ``QUAD_MIN_BLOCKS`` in csrc/quad.cu).  This tool builds
each variant as its own library (``-DCOMPACT_LOCKSTEP=n ...``), holds it
against the plain version on the main path's wavefronts (800x800 primaries
and the bounce-1 extension rays, for Plücker also the bounce-1 shadow
segments; teapot and teapot_hires for Plücker, teapot_hires for compact,
teapot for quad, built as ``chip_smoke.py`` builds them) and times it with
CUDA events, the variants in turns.  It
prints registers and spills per variant, the times, and the card's name and
power limit.  The default in the source is the variant that won.

Run from the repository root:
    python -m radish_pt_tpu_torch.tune [plucker] [compact] [quad]
(no argument: all three).
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
QUAD_VARIANTS = (("-DQUAD_RAYS=1", "-DQUAD_MIN_BLOCKS=1"),
                 ("-DQUAD_RAYS=2", "-DQUAD_MIN_BLOCKS=1"),
                 ("-DQUAD_RAYS=2", "-DQUAD_MIN_BLOCKS=8"),
                 ("-DQUAD_RAYS=2", "-DQUAD_MIN_BLOCKS=10"),
                 ("-DQUAD_RAYS=4", "-DQUAD_MIN_BLOCKS=1"))


def main(argv=None) -> int:
    import torch

    engines = (sys.argv[1:] if argv is None else argv) or ["plucker", "compact", "quad"]
    if set(engines) - {"plucker", "compact", "quad"}:
        print("tune: engines are plucker, compact, quad", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("tune: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs  # the wavefronts, the timer and the parity check

    from .accel import _build
    from .accel import compact as cpt
    from .accel import plucker as plk
    from .accel import quad as qd
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
            for turn in range(2):  # the variants in turns, twice
                for r, lib in libs.items():
                    ms = run("plucker", lib, lambda: cs.cuda_ms(kernel, 5))
                    print(f"[timing] plucker, {name} {what}, {r}, turn {turn}: "
                          f"{ms:.3f} ms ({card})", flush=True)

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
            for turn in range(2):  # the variants in turns, twice
                for r, lib in libs.items():
                    ms = run("compact", lib, lambda: cs.cuda_ms(kernel, 5))
                    print(f"[timing] compact closest hit, teapot_hires {what}, {r}, "
                          f"turn {turn}: {ms:.3f} ms ({card})", flush=True)

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
            for turn in range(2):
                for r, lib in libs.items():
                    ms = run("quad", lib, lambda: cs.cuda_ms(kernel, 5))
                    print(f"[timing] quad closest hit, teapot {what}, {r}, "
                          f"turn {turn}: {ms:.3f} ms ({card})", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
