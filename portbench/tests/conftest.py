"""The benchmark tests' tiny stand-ins of the SD3 cell: ``tiny.config_for``
and ``tiny.traffic`` answer for it through ``tiny_sd3``."""

import pytest


@pytest.fixture(autouse=True)
def _tiny_sd3(monkeypatch):
    from portbench.tests import tiny, tiny_sd3

    monkeypatch.setattr(tiny, "config_for", tiny_sd3.config_for)
    monkeypatch.setattr(tiny, "traffic", tiny_sd3.traffic)
