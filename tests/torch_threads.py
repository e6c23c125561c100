"""The test modules' one PyTorch intra-op thread: the suite runs several
workers on a few cores, and PyTorch's thread pool in each would
oversubscribe them (six workers on eight cores took a torch-heavy file up
to 40 times longer).  A module takes it by binding the fixture at its top
level: ``one_thread = torch_threads.one_thread``."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
