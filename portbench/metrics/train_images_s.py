"""Seconds per edit block generating the training images (apply_emcid's generation phase)."""

from portbench.metrics._read import phase_per_block


def read(facts):
    return phase_per_block(facts, "generation")
