"""Seconds per edit block loading the covariances (apply_emcid's covariances phase)."""

from portbench.metrics._read import phase_per_block


def read(facts):
    return phase_per_block(facts, "covariances")
