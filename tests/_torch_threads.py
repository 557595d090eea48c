"""PyTorch CPU threads for the port's tests under a parallel run.

Each pytest-xdist worker is its own process, and PyTorch gives each one
a thread per core by default: six workers on eight cores then run 48
threads that spin against each other.  :func:`share_cores` gives a
module the worker's share of the cores (all of them in a run of one
process) and restores the count after it.
"""
import os

import torch


def share_cores():
    """Generator body for a module-scoped autouse fixture."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    cores = len(os.sched_getaffinity(0))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, cores // max(workers, 1)))
    yield
    torch.set_num_threads(before)
