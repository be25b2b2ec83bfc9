"""pytest settings of the benchmark's tests (``python -m pytest benchmark``):
the ``card`` marker for tests that need an NVIDIA GPU, and the fixture that
skips them where torch sees none."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips where torch sees none)")


@pytest.fixture
def card():
    """Skip the test unless torch sees a CUDA card (decided when it runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    return "cuda"


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    torch.set_num_threads(2)
