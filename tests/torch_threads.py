"""One intra-op thread for the port's CPU tests.

The suite runs its test files in several worker processes (xdist). A
torch process starts one OpenMP thread per core, and those threads spin
between the many small ops of a tiny model, so a handful of workers each
with a full team oversubscribe the cores many times over: a test that
takes 3 s alone took 156 s under six workers. Each port test module
imports `one_torch_thread`, an autouse module fixture, which runs its
tests on one torch thread and restores the count after.

`default_torch_threads` gives one test back torch's own count: a test whose
margin was set by the summation order of torch's CPU kernels at that count
(the order follows the thread count) asks for it.
"""

import pytest
import torch

DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def default_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(n)
