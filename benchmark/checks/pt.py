"""Reference stage ``pt``: path tracing.  The accumulated images at the
window's end, at pixels drawn from the seed, against the reference's trace
of the same pixels for every frame since the last reset, accumulated as the
port accumulates.

Traffic keys: ``check.pixels``, the number of pixels compared."""

from __future__ import annotations

import numpy as np
import torch

from harness import check

# the limit of each number compared, set between the port's largest
# reading over a dozen seeds and the control's least (PERF.md, section 2)
LIMITS = {"p90_err": 1e-3, "mean_err": 1e-2, "bias": 2e-2}
# the traffic keys the CPU tests replace at a tiny size
TINY_TRAFFIC = {"check": {"reference": "pt", "pixels": 256}, "trace_frames": 4}


def draw(sess):
    """The pixels compared, drawn from the seed once the renderer is built."""
    w, h = sess.config["resolution"]
    n = int(sess.check["pixels"])
    return np.sort(sess.rng.choice(w * h, size=min(n, w * h), replace=False))


def before(r):
    return None


def after(r, display) -> dict:
    """Nothing: the comparison reads the images at the window's end alone."""
    return {}


def at_end(sess) -> dict:
    """The drawn pixels' accumulated images and the loopers of the frames
    since the last reset."""
    r = sess.r
    pix = torch.as_tensor(sess.drawn, device=sess.device)
    return {"pixels": sess.drawn, "loopers": list(sess.loopers),
            "direct": r.direct[pix].cpu(), "indirect": r.indirect[pix].cpu()}


def problems(inputs: dict) -> list:
    return [] if inputs["loopers"] else ["no frame since the last reset"]


def reference(inputs: dict, device, dtype=torch.float32):
    """The reference's accumulated (direct, indirect) [P, 3] at the check's
    pixels over the frames since the last reset."""
    from reference import pathtrace as rpt
    from reference import precision

    with precision.computed_in(dtype):
        ds, cam0, _ = check.reference_scene(inputs, device, dtype)
        cam = check.camera_at(cam0, inputs["cam_time"], inputs["cam_radius"])
        pix = torch.as_tensor(inputs["pixels"], dtype=torch.int32, device=device)
        loopers = inputs["loopers"]
        p = pix.shape[0]
        acc_d = torch.zeros((p, 3), dtype=dtype, device=device)
        acc_i = torch.zeros_like(acc_d)
        per = max(1, check.REF_LANES // p)
        for f0 in range(0, len(loopers), per):
            lo = torch.as_tensor(loopers[f0:f0 + per], device=device)
            nf = lo.shape[0]
            d, ind = rpt.path_trace(ds, cam, lo.repeat_interleave(p), inputs["depth"],
                                    pix.repeat(nf))
            d = rpt.scrub_and_compress(d).view(nf, p, 3)
            ind = rpt.scrub_and_compress(ind).view(nf, p, 3)
            for k in range(nf):
                it = torch.tensor(float(f0 + k), dtype=dtype, device=device)
                acc_d = rpt.accumulate(acc_d, d[k], it)
                acc_i = rpt.accumulate(acc_i, ind[k], it)
    return acc_d.float().cpu(), acc_i.float().cpu()


def readings(inputs: dict, device, control: bool = False) -> dict:
    ref_d, ref_i = reference(inputs, device)
    if control:
        got_d, got_i = reference(inputs, device, torch.bfloat16)
    else:
        got_d, got_i = inputs["direct"], inputs["indirect"]
    return check.errors(torch.cat([got_d, got_i], -1), torch.cat([ref_d, ref_i], -1))
