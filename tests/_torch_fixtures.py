"""Fixtures shared by the ``test_torch_*`` files."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Test files run in parallel worker processes; torch's intra-op threads
    then oversubscribe the cores and the many small element-wise passes of
    the plain pipelines crawl. One thread costs nothing at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, for tests of code that runs only there (a CUDA kernel has
    no CPU mode); skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")
