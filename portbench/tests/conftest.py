"""CPU tests of the benchmark (``python -m pytest portbench/tests`` from
the root of the checkout). Tests that need the card carry the ``chip``
marker and decide inside the test."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the TF32 control runs only there)")
    return torch.device("cuda")
