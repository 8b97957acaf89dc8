"""The benchmark's own tests (not collected by the repo's `pytest tests/`):

    python -m pytest portbench/tests -q

They run on the CPU at tiny sizes. Tests marked `card` need a CUDA card,
decide inside the test whether there is one, and skip without it."""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
for p in (str(ROOT), str(Path(__file__).resolve().parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _program_on_cpu(monkeypatch):
    """The program's entry points run on the CPU here."""
    monkeypatch.setenv("VIREO_PLATFORM", "cpu")


@pytest.fixture
def card():
    """The CUDA device, or a skip when this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
