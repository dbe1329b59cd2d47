"""Milliseconds the host takes to issue one Stage-1 step: the median host-
clock length of the untraced block's ``stage1.step`` spans.  Near
``stage1_step_ms``, the host sets the pace."""

from portbench.metrics._program import median_ms


def read(facts):
    return median_ms(facts, "edit", "stage1.step", "host_s")
