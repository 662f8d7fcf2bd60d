"""Device ms a traced frame in the stage "primary": the primaries, their first
hit and material (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "primary")
