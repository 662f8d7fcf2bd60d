"""Device ms a traced frame in SVGF's guided levels: the device operations
from each ``stage_mark_svgf_levels`` (before the first variance prefilter)
to the next ``stage_mark_denoise_end``, the marks' own time left out.
``denoise_ms.svgf`` less this is the temporal blend, the geometry and the
variance estimate.  None where the trace has no such pair: a cell without
SVGF, or a port without the marks."""

from harness import spec


def read(rec):
    return spec.metric_reader("denoise_ms.svgf")(rec, start="svgf_levels")
