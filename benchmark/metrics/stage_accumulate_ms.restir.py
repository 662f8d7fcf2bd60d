"""Device ms a traced frame in the stage "accumulate": scrub, range
compression and the running mean (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "accumulate")
