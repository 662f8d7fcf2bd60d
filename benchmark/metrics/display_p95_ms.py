"""display_p95_ms: the 95th percentile, over every displayed image of the
window, of the interval between consecutive images being ready (CUDA
events recorded after each call, read at the window's end)."""

from harness import readers


def read(rec):
    return readers.interval_p95_ms(rec)
