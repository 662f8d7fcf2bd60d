"""How ``correct`` is decided: what the window's calls produced, held
against the plain reference (``reference/``), number by number, each
against its limit.

* Path tracing (``reference`` "pt"): the accumulated images at the window's
  end, at pixels drawn from the seed, against the reference's trace of the
  same pixels for every frame since the last reset, accumulated as the
  port accumulates.
* ReSTIR: the display image, the accumulated frame and the reservoir of
  calls of two kinds.  A chain: the first ``chain_calls`` calls, from
  set-up's first, which starts from empty state; the reference follows
  them with its own state (its own reservoirs and G-buffers), so these
  owe nothing to the port's.  And a call inside the window drawn from the
  seed, which the reference follows from the reservoir the port held
  before it (each frame's reservoir descends from every frame before it,
  so the reference takes that one state; it works out the G-buffers of
  both cameras itself).

Each number is an error of the port's output against the reference's
(:func:`errors`).  The control is the reference itself computed in
bfloat16, put in the port's place (:func:`readings` with ``control``).
"""

from __future__ import annotations

import numpy as np
import torch

# the limit of each number compared, set between the port's largest
# reading over a dozen seeds and the control's least (PERF.md, section 2)
LIMITS = {
    "pt": {"p90_err": 1e-3, "mean_err": 1e-2, "bias": 2e-2},
    "restir": {"p90_err": 1e-3, "mean_err": 1e-3, "bias": 3e-3, "reservoir_err": 0.05,
               "display_share": 0.05},
}
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


def _reference_scene(inputs: dict, device, dtype):
    from reference import shading

    ds, cam, desc = shading.load_scene(inputs["scene"], device)
    w, h = inputs["resolution"]
    cam = cam.replace(width=int(w), height=int(h))
    return ds.in_float(dtype), cam, desc


def pt_reference(inputs: dict, device, dtype=torch.float32):
    """The reference's accumulated (direct, indirect) [P, 3] at the check's
    pixels over the frames since the last reset."""
    from reference import pathtrace as rpt
    from reference import precision

    with precision.computed_in(dtype):
        ds, cam0, _ = _reference_scene(inputs, device, dtype)
        cam = _camera_at(cam0, inputs["cam_time"], inputs["cam_radius"])
        pix = torch.as_tensor(inputs["pixels"], dtype=torch.int32, device=device)
        loopers = inputs["loopers"]
        p = pix.shape[0]
        acc_d = torch.zeros((p, 3), dtype=dtype, device=device)
        acc_i = torch.zeros_like(acc_d)
        per = max(1, REF_LANES // p)
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


def _camera_at(cam0, t, radius):
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


def _reuse(inputs: dict) -> tuple:
    """(reuse, reservoir size, temporal clamp) of the mix's settings."""
    from reference import restir as rrs

    st = inputs["settings"]
    return (getattr(rrs.ReservoirReuse, st["reservoir_reuse"].split(".", 1)[1]),
            int(st["reservoir_size"]), int(st["temporal_clamp"]))


def _restir_outputs(d, res, w: int, h: int):
    from reference import pathtrace as rpt
    from reference import post as rpost

    direct = rpt.accumulate(torch.zeros_like(d), rpt.scrub_and_compress(d), 0)
    disp = rpost.to_display(direct.reshape(h, w, 3), tone_mapping=rpost.ToneMapping.ACES)
    fields = {k: getattr(res, k).float().cpu() for k in ("li", "wi", "dist", "num", "weight")}
    return direct.float().cpu(), disp.cpu(), fields


def restir_chain_reference(inputs: dict, snaps: list, device, dtype=torch.float32):
    """The reference's (direct [N, 3], display [H, W, 3] uint8, reservoir
    fields) of each of the consecutive calls ``snaps``, from set-up's first
    call on, each from the reference's own state: the reservoir and the
    G-buffer its previous call left."""
    from reference import gbuffer as rgb
    from reference import precision
    from reference import restir as rrs

    reuse, size, clamp = _reuse(inputs)
    outs = []
    with precision.computed_in(dtype):
        ds, cam0, _ = _reference_scene(inputs, device, dtype)
        w, h = inputs["resolution"]
        n = w * h
        gbuf_last = rgb.empty_frame(n, device=device)
        res = rrs.empty_reservoir(n, device=device)
        last_cam = cam0
        for k, snap in enumerate(snaps):
            if snap.call != k:
                raise ValueError("the chain's calls are not consecutive from the first")
            cam = _camera_at(cam0, snap.cam_time, inputs["cam_radius"])
            gbuf = rgb.render_gbuffer(ds, cam, last_cam)
            d, res = rrs.restir_direct(ds, cam, torch.tensor(snap.looper, device=device), gbuf,
                                       gbuf_last, res, k == 0, reuse, size, clamp)
            outs.append(_restir_outputs(d, res, w, h))
            gbuf_last, last_cam = gbuf.frame, cam
    return outs


def restir_reference(inputs: dict, snap, device, dtype=torch.float32):
    """The reference's (direct [N, 3], display [H, W, 3] uint8, reservoir
    fields) of the call ``snap`` followed from the port's reservoir."""
    from reference import gbuffer as rgb
    from reference import precision
    from reference import restir as rrs

    reuse, size, clamp = _reuse(inputs)
    with precision.computed_in(dtype):
        ds, cam0, _ = _reference_scene(inputs, device, dtype)
        w, h = inputs["resolution"]
        cam = _camera_at(cam0, snap.cam_time, inputs["cam_radius"])
        last_cam = _camera_at(cam0, snap.cam_time_before, inputs["cam_radius"])
        gbuf_last = rgb.render_gbuffer(ds, last_cam, last_cam).frame
        res = rrs.DirectReservoir(**{k: v.to(device=device, dtype=dtype)
                                     for k, v in snap.before.items()})
        gbuf = rgb.render_gbuffer(ds, cam, last_cam)
        d, res = rrs.restir_direct(ds, cam, torch.tensor(snap.looper, device=device), gbuf,
                                   gbuf_last, res, False, reuse, size, clamp)
        return _restir_outputs(d, res, w, h)


def _reservoir_err(prog: dict, ref: dict) -> float:
    """Mean over pixels of the largest relative error of a reservoir's
    fields, each pixel's capped at 1 (a pixel that kept another sample)."""
    cols = []
    for k in ("li", "wi", "dist", "num", "weight"):
        a, b = prog[k].double(), ref[k].double()
        if a.dim() == 1:
            a, b = a[:, None], b[:, None]
        cols.append(((a - b).abs() / b.abs().clamp(min=1e-3)).amax(-1))
    return float(torch.stack(cols, -1).amax(-1).clamp(max=1.0).mean())


def _restir_numbers(got, ref) -> dict:
    (direct, disp, res), (ref_direct, ref_disp, ref_res) = got, ref
    nums = errors(direct, ref_direct)
    nums["reservoir_err"] = _reservoir_err(res, ref_res)
    diff = (disp.int() - ref_disp.int()).abs().amax(-1)
    nums["display_share"] = float((diff > 1).double().mean())
    return nums


def readings(inputs: dict, device, control: bool = False) -> dict:
    """The numbers compared: the port's outputs (``control``: the
    reference's own in bfloat16, in the port's place) against the
    reference's in float32.  For ReSTIR, the larger of each number over
    the calls compared."""
    if inputs["reference"] == "pt":
        ref_d, ref_i = pt_reference(inputs, device)
        if control:
            got_d, got_i = pt_reference(inputs, device, torch.bfloat16)
        else:
            got_d, got_i = inputs["direct"], inputs["indirect"]
        return errors(torch.cat([got_d, got_i], -1), torch.cat([ref_d, ref_i], -1))

    def port(snap):
        a = snap.after
        return a["direct"], a["display"], a["reservoir"]

    pairs = []
    chain = [s for s in inputs["snapshots"] if s.chain]
    refs = restir_chain_reference(inputs, chain, device)
    gots = (restir_chain_reference(inputs, chain, device, torch.bfloat16) if control
            else [port(s) for s in chain])
    pairs += zip(gots, refs)
    for snap in inputs["snapshots"]:
        if snap.before is None:
            continue
        ref = restir_reference(inputs, snap, device)
        got = restir_reference(inputs, snap, device, torch.bfloat16) if control else port(snap)
        pairs.append((got, ref))
    out: dict = {}
    for got, ref in pairs:
        for k, v in _restir_numbers(got, ref).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(nums: dict, reference: str) -> list:
    """[(name, value, limit)] of every number compared, in a fixed order."""
    lim = LIMITS[reference]
    return [(k, float(nums[k]), lim[k]) for k in lim]


def failures(judged: list) -> int:
    """How many numbers are not within their limit (a NaN is not)."""
    return sum(not v <= lim for _, v, lim in judged)
