"""Device ms a traced frame in the stage "gbuffer": the G-buffer (pinhole
primaries, first hit, material, motion), once a block (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "gbuffer")
