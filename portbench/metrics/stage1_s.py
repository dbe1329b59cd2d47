"""Seconds per edit block in Stage 1 (apply_emcid's stage1 phase)."""

from portbench.metrics._read import phase_per_block


def read(facts):
    return phase_per_block(facts, "stage1")
