"""Torch's intra-op threads when pytest-xdist runs the suite.

Importing this module is what sets the thread count for the whole xdist
worker, every other test module's tests included: pytest-xdist imports
every test module in every worker while it collects, before any test
runs, and the import calls `torch.set_num_threads(cores // workers)`. A
reader of another test file sees no call: it is here. The workers share
this machine's cores; with torch's default, one thread per core in each
of several workers, the port's tiny-model tests ran 10-20 times slower
than alone (the OpenMP threads of the workers wait on each other). A run
without xdist keeps torch's default. The pytest settings would be a
more visible home for this switch."""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
CORES = len(os.sched_getaffinity(0))
if WORKERS > 1:
    torch.set_num_threads(max(1, CORES // WORKERS))


def test_torch_threads_fit_the_workers():
    if WORKERS > 1:
        assert torch.get_num_threads() * WORKERS <= max(CORES, WORKERS)
    else:
        assert torch.get_num_threads() >= 1
