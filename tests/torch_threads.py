"""Torch's intra-op threads for the port's CPU tests under pytest-xdist.

Every ``tests/test_torch_*.py`` imports this module first. Each xdist
worker would otherwise start torch with one thread per core of the machine,
so n workers oversubscribe the CPU n times over: a ResNet-50 CPU job (b 2,
32², 5 steps) beside five busy 8-thread torch processes on an 8-core host
ran past 120 s at 8 threads and took 11.5 s at one. Under xdist
(``PYTEST_XDIST_WORKER_COUNT`` workers) each worker takes ``cpu_count //
n`` threads, at least one; without xdist torch keeps its default. The
spawned gloo ranks set their own (``torch_mesh_ranks.py``). This file
imports torch only.
"""

import os
from typing import Optional

import torch


def worker_threads() -> Optional[int]:
    """The intra-op threads of one xdist worker, or None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


THREADS = worker_threads()
if THREADS is not None:
    torch.set_num_threads(THREADS)
