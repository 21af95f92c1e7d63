"""`one_torch_thread`, a fixture for the port's CPU tests: import it into a
test module (`from _torch_threads import one_torch_thread  # noqa: F401`)
and every test there runs with one torch intra-op thread. Their tensors
are small, and where the test workers share the CPU, the threads of each
worker's pool wait on one another: in a run of the whole suite on 6
workers, the FixMatch-CTA CLI test took 78 s with a pool per worker
against 0.3 s alone."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
