"""Peak device memory allocated over the edit window, GiB."""

from portbench.metrics._read import peak_gib


def read(facts):
    return peak_gib(facts, "edit")
