"""Device operations launched inside the traced batch's ``sampler.step``
spans, per step."""

from portbench.metrics._program import traced


def read(facts):
    d = traced(facts, "gen", "sampler.step")
    return None if d is None else d["launches"] / d["spans"]
