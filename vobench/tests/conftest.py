"""The benchmark's own tests (``python -m pytest vobench/tests``).  They
run on the CPU at small sizes; a test that needs the card takes the
``card`` fixture, which decides inside the test whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with python -m pytest vobench/tests")
    return torch.device("cuda")
