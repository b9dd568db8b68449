"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests -q``): the ``card`` marker for tests that need a CUDA card,
and the fixture that decides, while the test runs, whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def one_thread():
    """Torch on one intra-op thread for the body (steady CPU timings beside
    other test processes), the caller's count back after it."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
