"""Seconds in the port's span ``graph.build``: the first call's eager
warm-up block on a side stream and the block's CUDA graph capture
(harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.span_total_s("graph.build")
