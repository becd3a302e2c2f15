import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(PORTBENCH))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips where there is none")


@pytest.fixture
def card():
    """The card's name; skips where torch sees no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.cuda.get_device_name(0)
