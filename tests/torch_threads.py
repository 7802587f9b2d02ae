"""The port's thread rule for its CPU tests, in one place: PyTorch on one
thread for the whole of each tests/test_torch_*.py module.

Why one thread:
- bit-for-bit comparisons repeat: PyTorch's CPU ops split a batch across
  threads, the order of a float sum then depends on the split, and the
  exp/log of tests/test_torch_obs_fused.py's batches once came out an ulp
  apart between two calls on the same input, in about one run of that
  file in ten under pytest-xdist;
- under pytest-xdist six workers each spreading PyTorch over every core
  oversubscribe the cores, and their threads' waits multiplied the drill
  tests' time five- to tenfold.

Every tests/test_torch_*.py imports the fixture in one line:

    from torch_threads import one_thread  # noqa: F401 (fixture)

It restores the count it found when the module ends, so that no count
leaks into the next file an xdist worker runs. No port test sets the
count itself; a run that needs another count takes it from `threads`,
which restores it too, and says why where it does.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def threads(n: int):
    """PyTorch on `n` threads inside the block, then the count it found."""
    found = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(found)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with threads(1):
        yield
