"""Device ms a traced frame in the stage "extend": the extension rays' sorted
sweep (sort key, sort, closest hit) (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "extend")
