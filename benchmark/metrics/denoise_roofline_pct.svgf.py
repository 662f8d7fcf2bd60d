"""SVGF's share of its roofline, in percent: the least time its work can
take on one H100 (the larger of its bytes over 3.35 TB/s and its float32
operations over 67 TFLOP/s), over the device ms of one pass of the
denoiser (``denoise_ms.svgf``'s stretch, over its passes).  The work is the
algorithm's (denoiser.cu:92-173, 208-328), whatever implements it, each
input read once and each output written once: per pixel

* the temporal blend: the colour in, the motion, this frame's normal and
  id, the history's colour and moments and the last frame's normal and id
  at the motion, the blended colour and moments out: 96 B;
* the variance estimate: the moments in, the variance out: 16 B;
* each guided level: the variance prefilter in and out, then the colour,
  variance, filtered variance, depth, normal and id in, the colour and
  variance out: 64 B;

and 25 taps a level of ~40 operations each (the depth, normal and
luminance weights with their exp and pow counted one each, the weighted
sums): 1,000 a pixel a level, besides ~60 for the blend and 40 for the
variance.  The size is the run's own, from the port's counters inside its
span ``frame.denoise``: ``denoise.svgf_pixels`` (the pixels of each image
filtered) and ``denoise.svgf_level`` over ``denoise.svgf`` (the guided
levels an image).  None where ``denoise_ms.svgf`` reads nothing or SVGF
counted no pixel."""

from harness import spec, stages

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12
TEMPORAL_B, VARIANCE_B, LEVEL_B = 96, 16, 64
TEMPORAL_OPS, VARIANCE_OPS, LEVEL_OPS = 60, 40, 25 * 40


def bound_ms(pixels: float, levels: float) -> float:
    """The least ms SVGF's work takes over ``pixels`` pixels (all images of
    a pass) at ``levels`` guided levels an image."""
    b = pixels * (TEMPORAL_B + VARIANCE_B + levels * LEVEL_B)
    ops = pixels * (TEMPORAL_OPS + VARIANCE_OPS + levels * LEVEL_OPS)
    return 1e3 * max(b / PEAK_BYTES_S, ops / PEAK_FLOPS)


def read(rec):
    ms = spec.metric_reader("denoise_ms.svgf")(rec, per_pass=True)
    snap = stages.port_snapshot()
    entry = snap and snap["unprofiled"].get("frame.denoise")
    counts = entry["counts"] if entry else {}
    if not ms or not counts.get("denoise.svgf_pixels"):
        return None
    pixels = counts["denoise.svgf_pixels"] / entry["count"]
    levels = counts.get("denoise.svgf_level", 0) / counts["denoise.svgf"]
    return 100.0 * bound_ms(pixels, levels) / ms
