"""Device ms a traced frame in the sorted sweeps' wavefront reordering: the
device operations from each ``stage_mark_reorder`` to the next
``stage_mark_reorder_end`` (the port's inner marks around the signature key,
the sort and the gathers into key order, and around the scatter back to lane
order), the marks' own time left out.  The stage readers count the same
operations, and these marks, in the enclosing stage (``extend``, ``nee``,
``primary``).  None where the trace has no reorder mark: a scene without
clusters, or a port without the marks."""

from harness import stages

MARKS = ("stage_mark_reorder", "stage_mark_reorder_end")


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["ops"]:
        return None
    us, inside, seen = 0.0, False, False
    for name, s, e in sorted(tr["ops"], key=lambda op: (op[1], op[2])):
        mark = stages.stage_of(name, MARKS)
        if mark is not None:
            inside, seen = mark == "reorder", True
        elif inside:
            us += e - s
    return us / 1e3 / tr["frames"] if seen else None
