"""The benchmark's own tests: `python -m pytest benchmark/tests -q` runs the
CPU tests; on the card, `python -m pytest benchmark/tests -q -m chip` runs
those that need it. The marker is registered here; whether a card is there
is decided inside the `chip` fixture, never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def chip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda:0")
