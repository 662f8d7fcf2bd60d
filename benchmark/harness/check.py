"""How ``correct`` is decided: what the window's calls produced, held
against the plain reference (``reference/``), number by number, each
against its limit.

The mix's ``check.reference`` names a reference stage,
``checks/<stage>.py``, found by name (:func:`spec.stage`): what the session
copies around the calls it follows and at the window's end, how the
reference follows them, the numbers compared and their limits.  This module
holds what every stage shares: the error of an image (:func:`errors`), the
reference's scene and camera, the look that the window reached every call
the check follows (:func:`problems`), and the judgement of the numbers
against the stage's ``LIMITS`` (:func:`judge`, :func:`failures`).

Each number is an error of the port's output against the reference's.  The
control is the reference itself computed in bfloat16, put in the port's
place (:func:`readings` with ``control``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec

# lanes a reference wavefront traces at once (frames x pixels)
REF_LANES = 1 << 17


def errors(prog: torch.Tensor, ref: torch.Tensor) -> dict:
    """Per-pixel error, the largest over the channels of |port - reference|
    ([P, C] each): its 90th percentile and its mean over the pixels, and
    the bias of the sums."""
    e = (prog.double() - ref.double()).abs().amax(dim=-1)
    s_ref = float(ref.double().sum())
    return {"p90_err": float(torch.quantile(e, 0.9)),
            "mean_err": float(e.mean()),
            "bias": abs(float(prog.double().sum()) - s_ref) / max(abs(s_ref), 1e-12)}


def reference_scene(inputs: dict, device, dtype):
    """The reference's scene (in ``dtype``), camera at the cell's
    resolution, and scene description."""
    from reference import shading

    ds, cam, desc = shading.load_scene(inputs["scene"], device)
    w, h = inputs["resolution"]
    cam = cam.replace(width=int(w), height=int(h))
    return ds.in_float(dtype), cam, desc


def camera_at(cam0, t, radius):
    """The reference's camera ``t`` into its orbit about the scene file's
    eye (Settings::animateCamera), or the unmoved camera for None."""
    from reference import camera as rcm
    from reference import precision

    if t is None:
        return cam0
    orig = cam0.position.float().cpu().numpy()
    off = np.array([np.cos(t), 0.0, np.sin(t)], np.float32) * radius
    pos = torch.from_numpy(orig + off).to(device=cam0.position.device, dtype=precision.FT)
    return rcm.update_camera(cam0.replace(position=pos))


def problems(inputs: dict) -> list:
    """Why the window's outputs cannot be compared: a call the check
    follows that the window never reached, and what the stage finds."""
    out = []
    calls = {s.call for s in inputs["snapshots"]}
    if not set(range(inputs["chain_calls"])) <= calls or (
            inputs["follow_call"] is not None and inputs["follow_call"] not in calls):
        out.append("the window ended before a call the check follows")
    return out + spec.stage(inputs["reference"]).problems(inputs)


def readings(inputs: dict, device, control: bool = False) -> dict:
    """The numbers compared: the port's outputs (``control``: the
    reference's own in bfloat16, in the port's place) against the
    reference's in float32, as the stage ``inputs["reference"]`` compares
    them."""
    return spec.stage(inputs["reference"]).readings(inputs, device, control)


def judge(nums: dict, reference: str) -> list:
    """[(name, value, limit)] of every number compared, in the order of
    the stage's ``LIMITS``."""
    lim = spec.stage(reference).LIMITS
    return [(k, float(nums[k]), lim[k]) for k in lim]


def failures(judged: list) -> int:
    """How many numbers are not within their limit (a NaN is not)."""
    return sum(not v <= lim for _, v, lim in judged)
