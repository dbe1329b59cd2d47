"""Seconds per block of the eps_dest pool's K forwards: the device-clock
length of the untraced block's ``stage1.pool`` span (one a block)."""

import statistics

from portbench.metrics._program import lengths


def read(facts):
    v = lengths(facts, "edit", "stage1.pool", "device_s")
    return None if v is None else statistics.mean(v)
