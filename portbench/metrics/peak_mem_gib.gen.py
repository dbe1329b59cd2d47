"""Peak device memory allocated over the generation window, GiB."""

from portbench.metrics._read import peak_gib


def read(facts):
    return peak_gib(facts, "gen")
