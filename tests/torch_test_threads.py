"""Give each test process its share of the CPU's cores for PyTorch.

PyTorch starts one intra-op thread per core in every process.  Under
pytest-xdist every worker does so, and ``-n 6`` on eight cores then runs six
times as many busy threads as there are cores whenever the workers multiply
large tensors together: each such worker slows every test that runs beside it,
the timed benchmark tests most of all.  The port's test files import this
module, which sets PyTorch's intra-op threads to the cores divided by the
workers (all the cores when pytest runs in one process).
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // WORKERS))
