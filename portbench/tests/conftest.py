"""Test set-up of the port's benchmark: the ``card`` marker and the
fixtures (the shared pieces are in ``portbench_helpers.py``)."""
import pytest

from portbench_helpers import write_checkout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; run on the chip with "
        "`python -m pytest -m card portbench/tests`")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is found."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path):
    return write_checkout(tmp_path)
