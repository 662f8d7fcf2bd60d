"""Device ms a traced frame outside every stage: from a block's end mark to
the next call's first mark, the eager work between graph replays
(harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "unstaged")
