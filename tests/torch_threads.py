"""An autouse fixture that runs a test module on one torch intra-op thread.

The port's CPU tests run many small tensor ops, which gain little from
torch's intra-op threads, and the suite runs several worker processes on
the machine's cores, where more threads only contend for them. A module
imports ``one_torch_thread`` to take it; the thread count is restored when
the module's tests end.
"""
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
