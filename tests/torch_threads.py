"""Share the host's cores between test workers.

PyTorch's CPU ops start one thread per core in every process; with several
pytest-xdist workers on one host the threads oversubscribe the cores and
spin against each other and against the JAX tests.  Importing this
module's fixture into a test module caps PyTorch's threads at the cores
per worker for that module's tests (all of them without xdist)."""
import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
