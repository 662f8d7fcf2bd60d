"""Device ms a traced frame in the denoiser: the device operations from
each ``stage_mark_denoise`` to the next ``stage_mark_denoise_end`` (the
port's inner marks at the start and the end of its denoiser), the marks'
own time left out.  The stage readers count the same operations, and these
marks, as unstaged: the denoiser runs after the block's ``stage_mark_end``.
None where the trace has no such pair: a cell without a denoiser, or a port
without the marks.

``read`` also gives ``svgf_levels_ms.svgf`` (from ``stage_mark_svgf_levels``),
with ``count`` ``kernels_denoise.svgf`` (operations, not ms), and with
``per_pass`` the device ms of one pass of the denoiser (over the pairs of
marks, not the traced frames; ``denoise_roofline_pct.svgf``)."""

from harness import stages

MARKS = ("stage_mark_denoise", "stage_mark_svgf_levels", "stage_mark_denoise_end")


def read(rec, start: str = "denoise", count: bool = False, per_pass: bool = False):
    tr = rec.get("trace")
    if not tr or not tr["ops"]:
        return None
    total = pending = 0.0
    inside, passes = False, 0
    for name, s, e in sorted(tr["ops"], key=lambda op: (op[1], op[2])):
        mark = stages.stage_of(name, MARKS)
        if mark is None:
            pending += (1 if count else e - s) if inside else 0
        elif mark == start:
            inside, pending = True, 0.0
        elif mark == "denoise_end" and inside:
            total, inside, passes = total + pending, False, passes + 1
    if not passes:
        return None
    per = passes if per_pass else tr["frames"]
    return total / per if count else total / 1e3 / per
