"""Host ms a frame inside the calls into the port during the window (no
sync inside): the frame loop's own cost on the host."""

from harness import readers


def read(rec):
    return readers.host_ms_per_frame(rec)
