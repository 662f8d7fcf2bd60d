"""Device ms a traced frame in the stage "shadow": the winner's shadow test
(harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "shadow")
