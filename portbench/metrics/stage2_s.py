"""Seconds per edit block in Stage 2 (apply_emcid's stage2 phase)."""

from portbench.metrics._read import phase_per_block


def read(facts):
    return phase_per_block(facts, "stage2")
