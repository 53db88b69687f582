"""Autouse fixtures that give a test file's torch its share of the cores
when pytest-xdist runs several workers. torch's default of one thread a
core, in every worker and in the fit processes a test starts,
oversubscribes the machine several times over and slows each of them
many times; alone, a file keeps torch's default. `cores_per_worker`
holds for each test; `module_cores_per_worker` for a whole file, so that
its module-scoped fixtures run with the share too."""
import contextlib
import os

import pytest
import torch


@contextlib.contextmanager
def _worker_share():
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
    if workers <= 1:
        yield
        return
    share = max(1, (os.cpu_count() or 1) // workers)
    before = torch.get_num_threads()
    torch.set_num_threads(share)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv('OMP_NUM_THREADS', str(share))
            yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def cores_per_worker():
    with _worker_share():
        yield


@pytest.fixture(scope='module', autouse=True)
def module_cores_per_worker():
    with _worker_share():
        yield
