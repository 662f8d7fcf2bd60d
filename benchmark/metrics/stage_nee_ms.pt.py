"""Device ms a traced frame in the stage "nee": next-event estimation at a
vertex (the shadow sweep included) (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "nee")
