"""Torch's CPU threads for tests run in parallel worker processes.

Under pytest-xdist every worker process would start one OpenMP thread
per core, so N workers oversubscribe the cores N times over, and OpenMP
threads spinning at their barriers then slow torch's CPU ops by an
order of magnitude. Modules that import :func:`torch_threads_per_worker`
run their tests with each worker's share of the cores (all of them in a
single process) and restore the thread count afterwards.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
