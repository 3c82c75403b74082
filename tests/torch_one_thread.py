"""One torch intra-op thread for a port test module.

The tier-1 run puts several test workers on one machine, and torch gives
each as many intra-op threads as the machine has cores: the workers' small
ops then contend for the cores and run many times slower than alone.  A
module imports the fixture to run on one thread and restore the count after:

    from torch_one_thread import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
