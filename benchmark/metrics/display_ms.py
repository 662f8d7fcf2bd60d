"""display_ms: wall time of the whole window over the images displayed in
it (one a call of the entry)."""

from harness import readers


def read(rec):
    return readers.frame_ms(rec, per_call=True)
