"""Host ms a call in the port's span ``frame.denoise``: the launching of the
denoiser's operations, in the unprofiled calls (set-up's first and the
window's; harness/stages.py).  None where the traced stretch has no
denoiser between its marks (``denoise_ms.svgf`` reads nothing): a cell
without a denoiser, or a port without the marks."""

from harness import spec, stages


def read(rec):
    if spec.metric_reader("denoise_ms.svgf")(rec) is None:
        return None
    return stages.span_ms_per_call("frame.denoise")
