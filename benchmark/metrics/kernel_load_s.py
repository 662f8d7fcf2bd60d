"""Seconds in the port's set-up span ``setup.kernel_libs``: its CUDA
libraries built (a checkout's first run) or found, and loaded
(harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.span_total_s("setup.kernel_libs")
