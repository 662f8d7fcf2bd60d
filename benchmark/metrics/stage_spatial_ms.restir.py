"""Device ms a traced frame in the stage "spatial": spatial reuse over the
completed post-temporal image (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "spatial")
