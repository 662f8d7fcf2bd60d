"""pt_frame_ms: wall time of the whole window over the 1-spp frames
completed in it (the window ends in a sync)."""

from harness import readers


def read(rec):
    return readers.frame_ms(rec)
