"""The benchmark's own tests: ``python -m pytest portbench/tests -q``
from the checkout's root.  Tests that need the card carry the ``card``
marker and skip inside the ``card`` fixture where there is none; on the
card: ``python -m pytest portbench/tests -q -m card``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell runs only on the card")
    return torch.cuda.get_device_name(0)
