"""Host ms a call in the port's span ``frame.camera``: the orbit step, the
new eye's copy to the card (where the host waits for the card) and the
view basis, in the unprofiled calls (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.span_ms_per_call("frame.camera")
