"""Reference stage ``restir``: ReSTIR DI.  The display image, the
accumulated frame and the reservoir of calls of two kinds.  A chain: the
first ``chain_calls`` calls, from set-up's first, which starts from empty
state; the reference follows them with its own state (its own reservoirs
and G-buffers), so these owe nothing to the port's.  And a call inside the
window drawn from the seed, which the reference follows from the reservoir
the port held before it (each frame's reservoir descends from every frame
before it, so the reference takes that one state; it works out the
G-buffers of both cameras itself).

Traffic keys: ``check.chain_calls`` and ``check.follow_call`` ([lo, hi],
the followed call drawn between them)."""

from __future__ import annotations

import torch

from harness import check

# the limit of each number compared, set between the port's largest
# reading over a dozen seeds and the control's least (PERF.md, section 2)
LIMITS = {"p90_err": 1e-3, "mean_err": 1e-3, "bias": 3e-3, "reservoir_err": 0.05,
          "display_share": 0.05}
# the traffic keys the CPU tests replace at a tiny size
TINY_TRAFFIC = {"check": {"reference": "restir", "chain_calls": 2, "follow_call": [1, 1]},
                "trace_frames": 4}
FIELDS = ("li", "wi", "dist", "num", "weight")


def draw(sess):
    return None


def _reservoir(r) -> dict:
    res = r.reservoir
    return {k: getattr(res, k).clone() for k in FIELDS}


def before(r) -> dict:
    """The reservoir the followed call starts from."""
    return _reservoir(r)


def after(r, display) -> dict:
    return {"direct": r.direct.clone(), "display": display.clone(), "reservoir": _reservoir(r)}


def at_end(sess) -> dict:
    return {}


def problems(inputs: dict) -> list:
    return []


def _reuse(inputs: dict) -> tuple:
    """(reuse, reservoir size, temporal clamp) of the mix's settings."""
    from reference import restir as rrs

    st = inputs["settings"]
    return (getattr(rrs.ReservoirReuse, st["reservoir_reuse"].split(".", 1)[1]),
            int(st["reservoir_size"]), int(st["temporal_clamp"]))


def _outputs(d, res, w: int, h: int):
    from reference import pathtrace as rpt
    from reference import post as rpost

    direct = rpt.accumulate(torch.zeros_like(d), rpt.scrub_and_compress(d), 0)
    disp = rpost.to_display(direct.reshape(h, w, 3), tone_mapping=rpost.ToneMapping.ACES)
    fields = {k: getattr(res, k).float().cpu() for k in FIELDS}
    return direct.float().cpu(), disp.cpu(), fields


def chain_reference(inputs: dict, snaps: list, device, dtype=torch.float32):
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
        ds, cam0, _ = check.reference_scene(inputs, device, dtype)
        w, h = inputs["resolution"]
        n = w * h
        gbuf_last = rgb.empty_frame(n, device=device)
        res = rrs.empty_reservoir(n, device=device)
        last_cam = cam0
        for k, snap in enumerate(snaps):
            if snap.call != k:
                raise ValueError("the chain's calls are not consecutive from the first")
            cam = check.camera_at(cam0, snap.cam_time, inputs["cam_radius"])
            gbuf = rgb.render_gbuffer(ds, cam, last_cam)
            d, res = rrs.restir_direct(ds, cam, torch.tensor(snap.looper, device=device), gbuf,
                                       gbuf_last, res, k == 0, reuse, size, clamp)
            outs.append(_outputs(d, res, w, h))
            gbuf_last, last_cam = gbuf.frame, cam
    return outs


def followed_reference(inputs: dict, snap, device, dtype=torch.float32):
    """The reference's (direct [N, 3], display [H, W, 3] uint8, reservoir
    fields) of the call ``snap`` followed from the port's reservoir."""
    from reference import gbuffer as rgb
    from reference import precision
    from reference import restir as rrs

    reuse, size, clamp = _reuse(inputs)
    with precision.computed_in(dtype):
        ds, cam0, _ = check.reference_scene(inputs, device, dtype)
        w, h = inputs["resolution"]
        cam = check.camera_at(cam0, snap.cam_time, inputs["cam_radius"])
        last_cam = check.camera_at(cam0, snap.cam_time_before, inputs["cam_radius"])
        gbuf_last = rgb.render_gbuffer(ds, last_cam, last_cam).frame
        res = rrs.DirectReservoir(**{k: v.to(device=device, dtype=dtype)
                                     for k, v in snap.before.items()})
        gbuf = rgb.render_gbuffer(ds, cam, last_cam)
        d, res = rrs.restir_direct(ds, cam, torch.tensor(snap.looper, device=device), gbuf,
                                   gbuf_last, res, False, reuse, size, clamp)
        return _outputs(d, res, w, h)


def _reservoir_err(prog: dict, ref: dict) -> float:
    """Mean over pixels of the largest relative error of a reservoir's
    fields, each pixel's capped at 1 (a pixel that kept another sample)."""
    cols = []
    for k in FIELDS:
        a, b = prog[k].double(), ref[k].double()
        if a.dim() == 1:
            a, b = a[:, None], b[:, None]
        cols.append(((a - b).abs() / b.abs().clamp(min=1e-3)).amax(-1))
    return float(torch.stack(cols, -1).amax(-1).clamp(max=1.0).mean())


def _numbers(got, ref) -> dict:
    (direct, disp, res), (ref_direct, ref_disp, ref_res) = got, ref
    nums = check.errors(direct, ref_direct)
    nums["reservoir_err"] = _reservoir_err(res, ref_res)
    diff = (disp.int() - ref_disp.int()).abs().amax(-1)
    nums["display_share"] = float((diff > 1).double().mean())
    return nums


def readings(inputs: dict, device, control: bool = False) -> dict:
    """The larger of each number over the calls compared."""
    def port(snap):
        a = snap.after
        return a["direct"], a["display"], a["reservoir"]

    pairs = []
    chain = [s for s in inputs["snapshots"] if s.chain]
    refs = chain_reference(inputs, chain, device)
    gots = (chain_reference(inputs, chain, device, torch.bfloat16) if control
            else [port(s) for s in chain])
    pairs += zip(gots, refs)
    for snap in inputs["snapshots"]:
        if snap.before is None:
            continue
        ref = followed_reference(inputs, snap, device)
        got = followed_reference(inputs, snap, device, torch.bfloat16) if control else port(snap)
        pairs.append((got, ref))
    out: dict = {}
    for got, ref in pairs:
        for k, v in _numbers(got, ref).items():
            out[k] = max(out.get(k, 0.0), v)
    return out
