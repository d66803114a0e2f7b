"""One torch intra-op thread for a test module's duration.

Each pytest-xdist worker is a process with its own pool of torch intra-op
threads, one a core by default, so several workers together oversubscribe
the cores, and tests made of many small ops (the sharded LM's, eight mesh
coordinates run in turn) slow down by tens of times. A test module that
computes on the CPU takes ``one_thread`` (``from _threads import
one_thread``: an autouse fixture of module scope), which runs torch on one
intra-op thread and restores the count after the module.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
