"""Tests that need a CUDA card, outside the CPU suite under tests/ (whose
conftest imports jax, which the card's machine lacks): on the card,
`python -m pytest chip_tests -q -m chip`. The marker is registered here;
whether a card is there is decided inside the `chip` fixture, never while
a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def chip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda:0")
