"""Percent of SDXL's Stage-1 step time in the dest forwards: the summed
device-clock seconds of the untraced block's ``stage1.dest`` spans (the
no-grad UNet forward of each concept's dest prompts, made at every step)
over those of its ``stage1.step`` spans."""

from portbench.metrics._program import lengths


def read(facts):
    dest = lengths(facts, "edit", "stage1.dest", "device_s")
    steps = lengths(facts, "edit", "stage1.step", "device_s")
    if dest is None or steps is None:
        return None
    return 100.0 * sum(dest) / sum(steps)
