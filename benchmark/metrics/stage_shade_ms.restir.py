"""Device ms a traced frame in the stage "shade": shading the reservoir's
sample (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "shade")
