"""Host syncs a call: the port's ``host_syncs`` counter inside its
unprofiled ``call.step_batched_restir`` spans, over those calls (harness/stages.py)."""

from harness import stages


def read(rec):
    return stages.count_per_call("host_syncs", "call.step_batched_restir")
