"""Milliseconds of one Stage-1 step on the device's clock: the median,
over the untraced block's ``stage1.step`` spans, of the time between the
CUDA events at the span's edges."""

from portbench.metrics._program import median_ms


def read(facts):
    return median_ms(facts, "edit", "stage1.step", "device_s")
