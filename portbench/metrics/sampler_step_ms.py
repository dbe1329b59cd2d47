"""Milliseconds of one sampler step (a UNet evaluation at the CFG batch
and its transfer) on the device's clock: the median over the untraced
batch's ``sampler.step`` spans."""

from portbench.metrics._program import median_ms


def read(facts):
    return median_ms(facts, "gen", "sampler.step", "device_s")
