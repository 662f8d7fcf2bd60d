"""Device ms a traced frame in the stage "temporal": temporal reuse (last
frame's packed reservoir rows gathered and merged) (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "temporal")
