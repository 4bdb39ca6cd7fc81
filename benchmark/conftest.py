"""pytest settings of the benchmark's own tests (benchmark/tests).

Tests marked `card` need CUDA; whether there is a card is decided inside
the `card` fixture when such a test runs, never while a module is imported.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
