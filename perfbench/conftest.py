"""pytest settings of the benchmark's own tests: the card's marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where CUDA is missing")


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """The benchmark's tests run tiny models on the CPU: one intra-op thread
    each, so that several test workers do not oversubscribe the cores."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)
