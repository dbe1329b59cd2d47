"""pytest settings of the benchmark's own tests (``pytest portbench/tests``).

``card``: a test that needs a CUDA device.  Whether one is present is
decided inside the ``card`` fixture, at run time, never at import."""

import os
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("USE_TF", "0")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch, tmp_path):
    import torch

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
