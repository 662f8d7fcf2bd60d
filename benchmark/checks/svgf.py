"""Reference stage ``svgf``: ReSTIR DI under the SVGF denoiser.  What the
``restir`` stage compares (the accumulated frame and the reservoir), and
besides the denoised image, its display and the history the filter hands
the next call, against the plain SVGF of ``reference/denoise.py``.

Calls of two kinds, as ``restir`` follows them.  A chain: the first
``chain_calls`` calls from set-up's first, which starts from empty state;
the reference follows them with its own reservoirs, G-buffers and SVGF
history, so these owe nothing to the port's state.  And a call inside the
window drawn from the seed, which the reference follows from the reservoir
and the SVGF history the port held before it; it works out the G-buffers of
both cameras itself.

Traffic keys: ``check.chain_calls`` and ``check.follow_call`` ([lo, hi]);
the filter's levels and sigmas are the mix's ``settings`` (the port's
``Settings`` defaults where they are left out: 5 levels, 4 / 128 / 1)."""

from __future__ import annotations

import torch

from harness import check, spec

restir = spec.stage("restir")

# the limit of each number compared, set between the port's largest
# reading over a dozen seeds and the control's least, and the denoiser's
# below what a frame before overwritten by the block's own reads at the
# cell's size (PERF.md, section 2)
LIMITS = {"p90_err": 1e-3, "mean_err": 1e-3, "bias": 3e-3, "reservoir_err": 0.05,
          "svgf_p90_err": 1e-4, "svgf_mean_err": 1e-4, "svgf_bias": 3e-4,
          "history_err": 5e-3, "display_share": 2e-3}
# the traffic keys the CPU tests replace at a tiny size
TINY_TRAFFIC = {"check": {"reference": "svgf", "chain_calls": 2, "follow_call": [1, 1]},
                "trace_frames": 4}
# the filter's settings and their values where the mix leaves them out
# (the sigmas of denoiser.cu:443)
FILTER = {"svgf_levels": 5, "svgf_sig_depth": 4.0, "svgf_sig_normal": 128.0,
          "svgf_sig_luminance": 1.0}


def draw(sess):
    return None


def _history(r) -> dict:
    h = r.svgf_direct
    return {"color": h.accum_color.clone(), "moment": h.accum_moment.clone()}


def before(r) -> dict:
    """The reservoir and the SVGF history the followed call starts from."""
    return {"reservoir": restir.before(r), "history": _history(r)}


def after(r, display) -> dict:
    """``restir``'s copies (the accumulation, the display, which is the
    denoised one here, the reservoir), the denoised image and the history
    handed on."""
    return {**restir.after(r, display), "image": r._last_image.clone(),
            "history": _history(r)}


def at_end(sess) -> dict:
    return {}


def problems(inputs: dict) -> list:
    return []


def _filter_args(inputs: dict) -> dict:
    st = inputs["settings"]
    k = {key: st.get(key, v) for key, v in FILTER.items()}
    return {"levels": int(k["svgf_levels"]), "sig_depth": float(k["svgf_sig_depth"]),
            "sig_normal": float(k["svgf_sig_normal"]),
            "sig_luminance": float(k["svgf_sig_luminance"])}


def _denoised(inputs, d, res, gbuf, last, hist, cam, first, device, dtype):
    """The call's outputs from its ReSTIR frame ``d``: (the accumulation,
    the reservoir's fields, the denoised image, its display, the history
    handed on), on the CPU in float32 (the display uint8), and the history
    on ``device`` for the next call."""
    from reference import denoise as rdn
    from reference import post as rpost

    w, h = inputs["resolution"]
    direct, _, fields = restir._outputs(d, res, w, h)
    image, hist = rdn.svgf_filter(direct.to(device=device, dtype=dtype), hist, gbuf, last, cam,
                                  first, **_filter_args(inputs))
    disp = rpost.to_display(image.reshape(h, w, 3), tone_mapping=rpost.ToneMapping.ACES)
    kept = {"color": hist.color.float().cpu(), "moment": hist.moment.float().cpu()}
    return (direct, fields, image.float().cpu(), disp.cpu(), kept), hist


def chain_reference(inputs: dict, snaps: list, device, dtype=torch.float32):
    """The reference's outputs (:func:`_denoised`) of each of the
    consecutive calls ``snaps``, from set-up's first call on, each from the
    reference's own state: the reservoir, the G-buffer and the SVGF history
    its previous call left."""
    from reference import denoise as rdn
    from reference import gbuffer as rgb
    from reference import precision
    from reference import restir as rrs

    reuse, size, clamp = restir._reuse(inputs)
    outs = []
    with precision.computed_in(dtype):
        ds, cam0, _ = check.reference_scene(inputs, device, dtype)
        w, h = inputs["resolution"]
        n = w * h
        gbuf_last = rgb.empty_frame(n, device=device)
        res = rrs.empty_reservoir(n, device=device)
        hist = rdn.empty_history(n, device=device)
        last_cam = cam0
        for k, snap in enumerate(snaps):
            if snap.call != k:
                raise ValueError("the chain's calls are not consecutive from the first")
            cam = check.camera_at(cam0, snap.cam_time, inputs["cam_radius"])
            gbuf = rgb.render_gbuffer(ds, cam, last_cam)
            d, res = rrs.restir_direct(ds, cam, torch.tensor(snap.looper, device=device), gbuf,
                                       gbuf_last, res, k == 0, reuse, size, clamp)
            out, hist = _denoised(inputs, d, res, gbuf, gbuf_last, hist, cam, k == 0, device,
                                  dtype)
            outs.append(out)
            gbuf_last, last_cam = gbuf.frame, cam
    return outs


def followed_reference(inputs: dict, snap, device, dtype=torch.float32):
    """The reference's outputs (:func:`_denoised`) of the call ``snap``
    followed from the port's reservoir and SVGF history."""
    from reference import denoise as rdn
    from reference import gbuffer as rgb
    from reference import precision
    from reference import restir as rrs

    reuse, size, clamp = restir._reuse(inputs)
    with precision.computed_in(dtype):
        ds, cam0, _ = check.reference_scene(inputs, device, dtype)
        cam = check.camera_at(cam0, snap.cam_time, inputs["cam_radius"])
        last_cam = check.camera_at(cam0, snap.cam_time_before, inputs["cam_radius"])
        gbuf_last = rgb.render_gbuffer(ds, last_cam, last_cam).frame
        res = rrs.DirectReservoir(**{k: v.to(device=device, dtype=dtype)
                                     for k, v in snap.before["reservoir"].items()})
        hist = rdn.History(**{k: v.to(device=device, dtype=dtype)
                              for k, v in snap.before["history"].items()})
        gbuf = rgb.render_gbuffer(ds, cam, last_cam)
        d, res = rrs.restir_direct(ds, cam, torch.tensor(snap.looper, device=device), gbuf,
                                   gbuf_last, res, False, reuse, size, clamp)
        return _denoised(inputs, d, res, gbuf, gbuf_last, hist, cam, False, device, dtype)[0]


def _history_err(prog: dict, ref: dict) -> float:
    """Mean over pixels of the largest relative error of the history's
    colour and moments, each pixel's capped at 1."""
    a = torch.cat([prog["color"], prog["moment"]], -1).double()
    b = torch.cat([ref["color"], ref["moment"]], -1).double()
    rel = ((a - b).abs() / b.abs().clamp(min=1e-3)).amax(-1)
    return float(rel.clamp(max=1.0).mean())


def _numbers(got, ref) -> dict:
    (direct, res, image, disp, hist), (r_direct, r_res, r_image, r_disp, r_hist) = got, ref
    nums = check.errors(direct, r_direct)
    nums["reservoir_err"] = restir._reservoir_err(res, r_res)
    nums.update({f"svgf_{k}": v for k, v in check.errors(image, r_image).items()})
    nums["history_err"] = _history_err(hist, r_hist)
    diff = (disp.int() - r_disp.int()).abs().amax(-1)
    nums["display_share"] = float((diff > 1).double().mean())
    return nums


def readings(inputs: dict, device, control: bool = False) -> dict:
    """The larger of each number over the calls compared."""
    def port(snap):
        a = snap.after
        return a["direct"], a["reservoir"], a["image"], a["display"], a["history"]

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
