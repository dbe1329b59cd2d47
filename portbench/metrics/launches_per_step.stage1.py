"""Device operations launched inside the traced block's ``stage1.step``
spans, per step."""

from portbench.metrics._program import traced


def read(facts):
    d = traced(facts, "edit", "stage1.step")
    return None if d is None else d["launches"] / d["spans"]
