"""Percent of the traced block's Stage-1 steps in which none of their
device operations ran: 1 - the union of the device intervals of the
operations launched inside ``stage1.step`` spans over their extent."""

from portbench.metrics._program import traced


def read(facts):
    d = traced(facts, "edit", "stage1.step")
    if d is None or not d["extent_s"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["extent_s"])
