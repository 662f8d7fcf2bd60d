"""Device ms a traced frame in the stage marks' own empty kernels: the
device cost of the port's stage tracing (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "marks")
