"""A cap on torch's CPU threads for the port's test files.

The driver runs the tests on several pytest-xdist workers, and each
worker's torch thread pool takes every core: the pools fight, and a file
takes several times its serial time. A test module that imports
``capped_threads`` runs its tests with torch's intra-op threads capped
at the cores per worker (``os.cpu_count()`` over
``PYTEST_XDIST_WORKER_COUNT``; unchanged in one process) and restores
the count after the module. Comparisons inside one process run at one
thread count on both sides.
"""
import os

import pytest
import torch


def _cap() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(workers, 1))


@pytest.fixture(scope="module", autouse=True)
def capped_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, _cap()))
    yield
    torch.set_num_threads(before)
