"""Device ms a traced frame in the port's hand-written intersection
kernels, named in ``metrics/isect_kernels.txt``."""

from harness import readers


def read(rec):
    return readers.device_ms_per_frame(rec, isect=True)
