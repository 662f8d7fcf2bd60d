"""Device ms a traced frame in the stage "hit": the hit's accounting (env and
emissive MIS, material, shading normal) (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "hit")
