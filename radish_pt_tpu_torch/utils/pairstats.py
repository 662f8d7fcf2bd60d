"""Frame-level sweep-pair accounting: the port of
``radish_pt_tpu/utils/pairstats.py``.

The sweep engines' cost is proportional to the (lane, triangle) pairs
they visit.  :func:`frame_pair_stats` replays a frame's wavefronts —
primaries, then per bounce the NEE shadow segments and the extension
rays, with the frame's sampler and in the order the port's engines sweep
them (tile-order primaries, then each wavefront sorted on (cluster
signature, lane id), as ``intersect_sorted`` / ``test_occlusion_sorted``
order it) — and counts with the engines' own accounting,
``accel/plucker.py::pair_counts`` (``accel/band.py::pair_counts`` on the
band engine; on the compact engine the Plücker accounting of its clusters,
since ``accel/compact.py::pair_counts`` takes the row flags of the work
list, which the replay does not build):

* ``pairs_swept``: the pairs a sweep that culls per group visits, the
  group being the engine's (a 32-lane warp on the Plücker and compact
  kernels, a 128-lane row on the quad engine, a band of 128/g lanes on
  the band engine);
* ``pairs_row``: the same per 128-lane row (the JAX package's measure);
* ``pairs_floor``: each lane's own flagged clusters' triangles (what a
  perfect per-ray engine would visit).

:func:`utilization` turns them and a frame time into the pair rate and
the cull efficiency (the JAX function's ``gpairs_per_s`` and
``cull_efficiency_pct``), and, beside them, the shares of the H100 bounds
that ``PERF.md`` section 6 uses: the pair rate's f32 operations (the
Plücker kernels' 41 a pair) over the 67 TFLOP/s peak (an FMA two) and
over the 33.5 T instructions/s of unfused f32 operations, and the bytes
the swept pairs stream (80 packed bytes a triangle for each 32-lane
group) over 3.35 TB/s.  These are model numbers
from the replay, not hardware counters.
"""

from __future__ import annotations

import torch

from ..accel import band as bnd
from ..accel import plucker as plk
from ..bsdf import materials as bsdf
from ..render import pathtrace as pt
from ..sampling import rng
from ..scene import device_scene as dsc
from ..scene import engines
from ..utils import math as m

# one H100 SXM at its 700 W limit (NVIDIA's data sheet), as PERF.md's bounds
PEAK_F32_FLOPS = 67e12  # an FMA counted as two
PEAK_F32_INSTR = 33.5e12  # f32 instructions a second
PEAK_BYTES_PER_S = 3.35e12
FLOPS_PER_PAIR = plk.FLOPS_PER_PAIR["closest_hit"]
BYTES_PER_GROUP_TRI = plk.PACKED_WIDTH * 4  # a packed triangle, read once a group


def _counts(ds, o, d, tmax):
    """(swept, row, floor) pairs of one wavefront in sweep order."""
    cb, n_tris = ds.cluster_bounds, ds.num_triangles
    group = engines.of(ds).group
    if group == "band":
        c = bnd.pair_counts(cb, o, d, tmax, ds.band_g, n_tris)
        return c["band"], plk.pair_counts(cb, o, d, tmax, ds.cluster_sub, n_tris)["row"], \
            c["lane"]
    c = plk.pair_counts(cb, o, d, tmax, ds.cluster_sub, n_tris)
    return c["row" if group == "row" else "warp"], c["row"], c["lane"]


def _sorted(ds, o, d, active, tmax=None):
    """A wavefront in the order the sorted sweeps take it: (key, lane id),
    dead lanes last, their range -FLT_MAX so that they flag nothing."""
    order = dsc.lane_order(dsc._sort_key(ds, o, d, tmax=tmax, active=active))
    tm = torch.where(active, plk.FLT_MAX if tmax is None else tmax, -plk.FLT_MAX)
    return o[order], d[order], torch.as_tensor(tm, device=o.device)[order]


def frame_pair_stats(ds: dsc.DeviceScene, cam, looper: int, max_depth: int):
    """Replay one frame's wavefronts and return the pair totals (python
    floats), ``None`` on a scene without clusters.  The replay follows
    render/pathtrace.py's dense loop with the frame's sampler, so its
    wavefronts are the frame's up to the estimator's decisions."""
    if ds.cluster_bounds is None:
        return None
    idx, _ = pt._lanes(ds, cam)
    sampler = rng.make_sampler(looper, idx)
    ray_o, ray_d, sampler = pt._gen_primary(ds, cam, sampler, idx)
    totals = [0.0, 0.0, 0.0]

    def add(o, d, tmax):
        for k, v in enumerate(_counts(ds, o, d, tmax)):
            totals[k] += v

    if ds.sort_primaries:
        add(*_sorted(ds, ray_o, ray_d, torch.ones_like(ray_o[:, 0], dtype=torch.bool)))
    else:
        add(ray_o, ray_d, None)
    it = dsc.intersect_primary(ds, ray_o, ray_d)
    hit = it.prim_id != pt.NULL_PRIMITIVE
    mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
    active = hit & (mat.mtype != dsc.MAT_LIGHT)
    pos = it.pos
    n = ray_o.shape[0]
    for _ in range(max_depth):
        wo = -ray_d
        is_delta = mat.mtype == dsc.MAT_DIELECTRIC
        flip = (~is_delta) & (m.dot(norm, wo) < 0.0)
        norm = torch.where(flip[..., None], -norm, norm)
        # the shadow wavefront: segments to the light samples (the horizon
        # cull of sample_direct_light), bounded at their end
        r4, sampler = rng.sample_4d(ds.sobol, sampler)
        _, wi, ldist, lpdf = dsc.sample_direct_light_no_vis(ds, pos, r4)
        ok = active & ~is_delta & (lpdf > 0.0) & (m.dot(norm, wi) > 0.0)
        add(*_sorted(ds, pos, wi * ldist[..., None], ok,
                     torch.ones(n, device=pos.device)))
        # the extension wavefront
        r3, sampler = rng.sample_3d(ds.sobol, sampler)
        samp = bsdf.bsdf_sample(mat, norm, wo, r3, types=ds.mat_types)
        active = active & ~(bsdf.is_invalid(samp.type) | (samp.pdf < 1e-8))
        ray_d = samp.dir
        ray_o = pos + ray_d * 1e-5
        add(*_sorted(ds, ray_o, ray_d, active))
        it = dsc.intersect_sorted(ds, ray_o, ray_d, active=active)
        active = active & (it.prim_id != pt.NULL_PRIMITIVE)
        pos = it.pos
        mat, norm = dsc.get_textured_material(ds, it.mat_id, it.uv, it.norm)
        active = active & (mat.mtype != dsc.MAT_LIGHT)
    return {"pairs_swept": totals[0], "pairs_row": totals[1], "pairs_floor": totals[2]}


def utilization(pair_stats: dict, frame_ms: float) -> dict:
    """Throughput and utilization fields from :func:`frame_pair_stats`
    and a frame time in ms; ``{}`` without stats or time."""
    if not pair_stats or frame_ms <= 0:
        return {}
    rate = pair_stats["pairs_swept"] / (frame_ms * 1e-3)
    bytes_per_s = rate / plk.GROUP * BYTES_PER_GROUP_TRI
    return {
        "gpairs_per_s": round(rate / 1e9, 2),
        "cull_efficiency_pct": round(
            100.0 * pair_stats["pairs_floor"] / max(pair_stats["pairs_swept"], 1.0), 1),
        "pct_of_f32_peak": round(100.0 * rate * FLOPS_PER_PAIR / PEAK_F32_FLOPS, 3),
        "pct_of_f32_unfused_rate": round(100.0 * rate * FLOPS_PER_PAIR / PEAK_F32_INSTR, 3),
        "pct_of_memory_rate": round(100.0 * bytes_per_s / PEAK_BYTES_PER_S, 3),
    }
