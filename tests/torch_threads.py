"""A module fixture for the port's CPU tests: one torch thread.

The tests' models are tiny, so torch's intra-op thread pool buys nothing on
them, and under ``pytest -n 6`` six workers, each with a pool of every core,
oversubscribe the host and the tiny models' steps slow down many times
over. A test module imports :func:`one_torch_thread` to run its tests on one
thread and hand the setting back after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
