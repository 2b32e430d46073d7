"""Fixtures that every tests/test_torch_*.py module shares; this module
holds no tests.

A module takes a fixture by importing it:
    from test_torch_fixtures import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's many small torch ops on one intra-op thread.  On
    torch's default of one thread per core the suite's six pytest workers
    oversubscribe the cores: tests/test_torch_volume_tiled.py's emulation
    took 68 s against 38 s on one thread even alone, and one of its cases
    took 1046 s among the workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
