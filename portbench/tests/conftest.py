"""The benchmark's tests.  ``card`` marks a test that needs a CUDA card;
the ``card`` fixture skips it elsewhere, deciding when the test runs."""

import json
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped on the CPU")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda")


def tiny_config(name: str) -> dict:
    cfg = json.loads((DATA / f"{name}.json").read_text())
    cfg.pop("meta")
    return cfg
