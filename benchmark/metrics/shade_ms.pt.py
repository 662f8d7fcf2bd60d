"""Device ms a traced frame outside the intersection kernels: the path
tracer's shading, sampling, sorting and accumulation."""

from harness import readers


def read(rec):
    return readers.device_ms_per_frame(rec, isect=False)
