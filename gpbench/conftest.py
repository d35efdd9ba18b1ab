"""pytest settings of the benchmark's own tests (`python -m pytest gpbench/tests`):
the `card` marker, and the fixture that decides, when a test runs, whether
there is a card."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips with its reason on a machine without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")
