"""Percent of the traced batch in which no device operation ran."""

from portbench.metrics._read import idle


def read(facts):
    return idle(facts, "gen")
