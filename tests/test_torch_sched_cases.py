"""The scheduling bursts that the kernel tests share: the CPU tests of
``test_torch_sched.py`` hold the plain versions against JAX on them, and the
``gpu``-marked tests of ``test_torch_gpu.py`` hold the kernels against the
plain versions.  Helpers only, no tests; imports neither JAX nor the JAX
package, so the card's tests can use it where only PyTorch is installed.
"""

import numpy as np
import torch


def burst(R, F, W, seed):
    """A random burst (kinds, funcs, workers, idle, conns) as int32 tensors
    on the CPU."""
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 3, R)
    funcs = rng.integers(0, F, R)
    workers = np.where(kinds == 0, -1, rng.integers(0, W, R))
    idle = rng.integers(0, 3, (F, W))
    conns = rng.integers(0, 5, W)
    return [torch.from_numpy(np.asarray(a, np.int32)) for a in (kinds, funcs, workers, idle, conns)]


def sched_case(case, R, F, W, seed):
    """A burst (kinds, funcs, workers, idle, conns) as int32 tensors on the
    CPU.  ``random`` is ``burst``; the others aim at the kernel's edges:
    ``sat300``/``sat70000``: one cell (1, 7) holds that many idle instances,
    the only live one in its row, and the burst evicts, refills and pulls it
    down to 0 across the 255 edge of the on-chip byte counts; ``empty``: no
    idle instance and no FINISH, so every ARRIVAL falls back; ``ties``: all
    conns equal and every cell live; ``pad``: kinds 0-5 (>= 3 are no-ops);
    ``bigconns``: conns up to 3,000,000, too large for the on-chip keys, so
    the kernel takes its block-wide path.  ``R`` is the length of the tail of
    random events after the ``sat`` prefix."""
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 6 if case == "pad" else 3, R)
    funcs = rng.integers(0, F, R)
    workers = np.where(kinds == 0, -1, rng.integers(0, W, R))
    idle = rng.integers(0, 3, (F, W))
    conns = rng.integers(0, 5, W)
    if case.startswith("sat"):
        n = int(case[3:])
        idle[1] = 0
        idle[1, 7] = n
        conns[7] = 100  # so that no FINISH on the cell is lost to the clamp at 0
        pre = ([(2, 1, 7)] * (n - 200) + [(1, 1, 7)] * 60 + [(0, 1, -1)] * 262
               + [(2, 1, 7), (1, 1, 7), (0, 1, -1)])
        pre = np.array(pre).T
        kinds, funcs, workers = (np.concatenate([p, a])
                                 for p, a in zip(pre, (kinds, funcs, workers)))
    elif case == "empty":
        kinds = np.where(kinds == 1, 0, kinds)
        workers = np.where(kinds == 0, -1, workers)
        idle[:] = 0
    elif case == "ties":
        idle[:] = 1
        conns[:] = 3
    elif case == "bigconns":
        conns = rng.integers(0, 3_000_000, W)
    return [torch.from_numpy(np.asarray(a, np.int32)) for a in (kinds, funcs, workers, idle, conns)]
