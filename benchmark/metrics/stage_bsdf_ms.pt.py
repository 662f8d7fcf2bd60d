"""Device ms a traced frame in the stage "bsdf": the BSDF sample and
throughput update (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.stage_ms_per_frame(rec, "bsdf")
