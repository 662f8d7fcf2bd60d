"""The device's idle share of the unprofiled window, in percent: the
device's busy time a frame from the traced stretch over the window's wall
time a frame (``harness.readers.idle_pct``)."""

from harness import readers


def read(rec):
    return readers.idle_pct(rec)
