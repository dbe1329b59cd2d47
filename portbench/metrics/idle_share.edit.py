"""Percent of the traced edit block in which no device operation ran."""

from portbench.metrics._read import idle


def read(facts):
    return idle(facts, "edit")
