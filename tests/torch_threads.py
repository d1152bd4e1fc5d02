"""One intra-op thread for each of the port's test modules.

The suite runs several workers on the machine's cores at once. A torch
process that splits its ops over several threads then waits on them, and
their idle threads spin on cores the other workers need. A test module
takes this fixture by importing it (`from torch_threads import
one_torch_thread`); the thread count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
