"""The JAX package's exact-f32 800x800 means that ``chip_smoke.py`` holds the
port's frames to (``MEAN_GOLDEN``).

For each named scene: the looper-7, 1-spp ``path_trace`` frame at 800x800
and depth 5 (glass at 8, its scene file's depth), rendered by the JAX
package on the CPU with the engine its CPU build picks (the BVH walk above
128 triangles, brute force below: both exact f32), and the mean of
``direct + indirect`` over the frame.  Each pixel depends only on its own
index and the looper, so the frame is rendered through ``path_trace``'s
``pixel_idx`` in chunks of lanes, which bounds the memory a BVH walk over
640,000 lanes would take.

    JAX_PLATFORMS=cpu python tests/torch_goldens.py glass env_teapot

prints one line per scene: name, depth, mean (an f64 sum of the f32
pixels), seconds (about 100 s for glass and env_teapot on one CPU core).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RES = 800
LOOPER = 7
# scene -> (file, depth): depth 5 as chip_smoke.py renders (glass at its
# file's 8)
SCENES = {"cornell": ("cornell_box.txt", 5), "teapot": ("teapot.txt", 5),
          "many_light": ("many_light.txt", 5), "textured": ("textured.txt", 5),
          "glass": ("glass.txt", 8), "env_teapot": ("env_teapot.txt", 5),
          "teapot_hires": ("teapot_hires.txt", 5)}


def golden(name: str, chunk: int = 40_000):
    """(depth, mean, seconds) of scene ``name``."""
    import jax
    import jax.numpy as jnp

    from radish_pt_tpu.render.pathtrace import path_trace
    from radish_pt_tpu.scene.build import load_scene

    file, depth = SCENES[name]
    t0 = time.perf_counter()
    ds, cam, _ = load_scene(os.path.join(REPO, "scenes", file))
    cam = cam.replace(width=RES, height=RES)
    f = jax.jit(path_trace, static_argnames=("max_depth",))
    n = RES * RES
    assert n % chunk == 0  # equal chunks: one compile
    total = 0.0
    for k in range(0, n, chunk):
        idx = jnp.arange(k, k + chunk, dtype=jnp.int32)
        d, i = f(ds, cam, LOOPER, depth, pixel_idx=idx)
        px = np.asarray(d + i, np.float64)
        assert np.isfinite(px).all(), name
        total += px.sum()
    return depth, total / (3 * n), time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scenes", nargs="+", choices=sorted(SCENES))
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    for name in args.scenes:
        depth, mean, secs = golden(name)
        print(f"{name} depth {depth} mean {mean:.7f} seconds {secs:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
