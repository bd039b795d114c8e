"""One PyTorch intra-op thread for a test module of the port.

The tier-1 run starts several pytest workers on one host, and PyTorch
gives each as many intra-op threads as the host has cores.  The workers'
threads then contend for the cores, and a test of small CPU kernels runs
tens of times slower than with one thread (the lockstep floor-stop test:
1.2 s alone, 170 s in such a run).  A test module that imports
:func:`one_torch_thread` runs with one thread and gets the count back
after its last test.  What the tests compare does not depend on it: both
sides of a bitwise comparison run in the module, and the comparisons
against the JAX package hold at their stated tolerances.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
