"""Seconds per edit block in T5 (the SD3 edit's ``edit.t5`` phase: one
forward over the block's source, dest and empty prompts)."""

from portbench.metrics._read import phase_per_block


def read(facts):
    return phase_per_block(facts, "t5")
