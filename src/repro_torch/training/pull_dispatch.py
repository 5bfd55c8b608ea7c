"""Pull-based microbatch dispatch — the paper's JIQ idea applied to training.

Beyond-paper transfer (DESIGN.md §2): in large data-parallel runs, per-step
straggling (bad host, thermal throttle, preemption neighbor) makes static
"every replica gets M/R microbatches" dispatch run at the pace of the slowest
replica.  Treating gradient microbatches as FaaS requests and DP replicas as
workers, the Join-Idle-Queue discipline applies verbatim: a replica that
finishes its microbatch *pulls* the next one from the step's queue.

``simulate_dispatch`` quantifies the makespan win (bench_pull_dispatch);
``pull_schedule`` returns the per-replica assignment realized by the pull
discipline so a gradient-accumulation loop can weight contributions
correctly (sum of per-microbatch grads is order-invariant).

A copy of the JAX package's ``training/pull_dispatch.py``, which is numpy.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class DispatchResult:
    makespan: float
    per_replica_counts: np.ndarray
    assignment: List[int]  # microbatch -> replica


def static_dispatch(step_cost: np.ndarray) -> DispatchResult:
    """Pre-assigned equal split: replica r runs microbatches r*M/R..(r+1)*M/R."""
    M, R = step_cost.shape
    per = M // R
    times = np.zeros(R)
    assignment = []
    for r in range(R):
        for m in range(r * per, (r + 1) * per):
            times[r] += step_cost[m, r]
            assignment.append(r)
    return DispatchResult(float(times.max()), np.full(R, per), assignment)


def pull_dispatch(step_cost: np.ndarray) -> DispatchResult:
    """JIQ: idle replicas pull the next microbatch from the queue."""
    M, R = step_cost.shape
    heap = [(0.0, r) for r in range(R)]  # (available_at, replica)
    heapq.heapify(heap)
    counts = np.zeros(R, int)
    assignment = []
    finish = 0.0
    for m in range(M):
        t, r = heapq.heappop(heap)
        t2 = t + step_cost[m, r]
        counts[r] += 1
        assignment.append(r)
        finish = max(finish, t2)
        heapq.heappush(heap, (t2, r))
    return DispatchResult(float(finish), counts, assignment)


def straggler_cost_matrix(
    n_micro: int,
    n_replicas: int,
    base_s: float = 1.0,
    straggler_frac: float = 0.1,
    slowdown: float = 3.0,
    jitter: float = 0.05,
    seed: int = 0,
) -> np.ndarray:
    """(M, R) per-microbatch step costs with a slow tail of replicas."""
    rng = np.random.default_rng(seed)
    speed = np.ones(n_replicas)
    n_slow = max(1, int(straggler_frac * n_replicas)) if straggler_frac > 0 else 0
    if n_slow:
        speed[rng.choice(n_replicas, n_slow, replace=False)] = slowdown
    noise = rng.lognormal(0, jitter, size=(n_micro, n_replicas))
    return base_s * speed[None, :] * noise


def simulate_dispatch(
    n_micro: int = 128, n_replicas: int = 16, **kw
) -> Tuple[DispatchResult, DispatchResult]:
    cost = straggler_cost_matrix(n_micro, n_replicas, **kw)
    return static_dispatch(cost), pull_dispatch(cost)
