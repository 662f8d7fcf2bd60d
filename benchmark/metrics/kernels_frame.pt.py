"""Device operations a traced frame (kernels, copies, fills)."""

from harness import readers


def read(rec):
    return readers.ops_per_frame(rec)
