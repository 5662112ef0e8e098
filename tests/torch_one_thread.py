"""One intra-op torch thread for the port's CPU tests.

The suite runs several test processes at once on the CPU's cores; each
torch process would otherwise start an OpenMP thread per core, and their
threads spinning between ops take the cores from one another (the port's
tests took twice as long that way).  A test module imports the fixture::

    from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

and a test that starts torch worker processes gives them :data:`ENV`, so
a worker and an in-process replay of its steps use the same thread count
(CPU convolutions may sum in another order with another count).
"""

import pytest
import torch

#: the environment of a worker process: one OpenMP thread
ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
