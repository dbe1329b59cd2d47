"""The attention kernels' (K1, K4) share of their least time in the traced batch, percent."""

from portbench.metrics._read import roofline


def read(facts):
    return roofline(facts, "gen")
