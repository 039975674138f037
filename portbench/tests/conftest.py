"""The benchmark's CPU tests: `python -m pytest portbench/tests -q` from the
repository's root (`-m cuda` on a card runs the ones that need it)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The first card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
