"""One intra-op torch thread for the port's CPU tests.

The suite runs several test processes at once on the CPU's cores; each
torch process would otherwise start an OpenMP thread per core, and their
threads spinning between ops take the cores from one another (the port's
tests took twice as long that way).  A test module imports the fixture::

    from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

and a test that starts torch worker processes gives them :data:`ENV`, so
a worker and an in-process replay of its steps use the same thread count
(CPU convolutions may sum in another order with another count).

A port module also runs with SIGTERM at its default disposition, restored
to the one before after the module: a Python SIGTERM handler that an
earlier module left installed in the test process (the JAX package's
drain tests arm one) is inherited by every process a port test forks,
and a forked child that deadlocked at the fork (a lock another thread of
this multi-threaded process held) cannot run a Python handler, so it
would outlive ``Pool.terminate`` and the interpreter's exit, and hold the
test process open.
"""

import signal

import pytest
import torch

#: the environment of a worker process: one OpenMP thread
ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    term = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    yield
    signal.signal(signal.SIGTERM, term)
    torch.set_num_threads(n)
