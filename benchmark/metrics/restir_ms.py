"""Device ms a traced frame outside the intersection kernels: the
G-buffer, RIS, reuse, shading, accumulation and display."""

from harness import readers


def read(rec):
    return readers.device_ms_per_frame(rec, isect=False)
