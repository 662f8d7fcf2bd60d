"""Device operations a traced frame in the denoiser (kernels, copies,
fills): those from each ``stage_mark_denoise`` to the next
``stage_mark_denoise_end``, the marks left out.  None where the trace has
no such pair: a cell without a denoiser, or a port without the marks."""

from harness import spec


def read(rec):
    return spec.metric_reader("denoise_ms.svgf")(rec, count=True)
