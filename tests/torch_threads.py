"""One torch intra-op thread for the port's CPU tests.

The tier-1 run puts six pytest workers on the host's cores. With torch's
default of one intra-op thread per core in each of them, every small
operation's parallel section waits for threads that the other workers
keep busy: six processes running the same 1536-point SfM reconstruction
at once took 451 s on an 8-core host with the default, 19 s with one
thread each (each alone: 6.0 s and 9.4 s). The results do not depend on
it: every ``test_torch_*`` file passes either way. A test module turns it
on by importing the fixture::

    from torch_threads import one_torch_thread  # noqa: F401

It is module-scoped, so that the module's own module-scoped fixtures run
under it too; the gloo ranks set one thread themselves
(``torch_parallel_workers.run``)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
