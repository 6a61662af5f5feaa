"""One PyTorch intra-op thread for a test module of the port.

Each ``tests/test_torch_*.py`` imports :func:`one_torch_thread`, an autouse
module fixture.  The suite runs under pytest-xdist, six workers on the
host's cores; a PyTorch CPU op left at its default spreads over every core
and fights the other workers for them, which made the port's files take
about twice as long as on one thread each.  numpy's BLAS and JAX's own
thread pool are left as they are.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's intra-op threads at 1 for the module, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
