"""Device ms a traced frame in the stage "ris": candidate RIS over the
reservoir's light samples (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "ris")
