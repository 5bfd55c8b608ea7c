"""The plain reference of the serving cluster's decisions: Hiku's pull-based
placement (Algorithm 1 of the paper), its least-connections fallback with a
seeded random tie-break, and each worker's memory pool with LRU eviction
and the eviction notification.  Written from the paper's rules, with no
code of the program under test.

The cluster serves requests one at a time, as the engine under test does:
a request is assigned (its worker's connection count goes up), executed
(cold if the worker holds no idle instance of the function: it evicts its
least recently used idle instances until the new one fits, notifying the
scheduler of each, then builds one; warm otherwise: it takes an idle one),
and finished (the count goes down and the worker enqueues itself on the
function's queue ``PQ_f``, once for the instance it now holds idle).
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple


class HikuCluster:
    """``n_workers`` workers with pools of ``pool_bytes``; each instance of a
    function takes ``instance_bytes``.  ``seed`` seeds the fallback's
    tie-break: one ``random.Random(seed).choice`` over the tied workers in
    ascending id order per fallback decision."""

    def __init__(self, n_workers: int, pool_bytes: int, instance_bytes: int, seed: int):
        self.rng = random.Random(seed)
        self.conns = [0] * n_workers
        self.pool_bytes = pool_bytes
        self.instance_bytes = instance_bytes
        self.queues: Dict[str, Dict[int, int]] = {}  # PQ_f: worker -> enqueued count
        # idle instances per worker: [function, last use], in the order they
        # became idle
        self.idle: List[List[List]] = [[] for _ in range(n_workers)]
        self.used = [0] * n_workers
        self.clock = 0

    def _select(self, func: str) -> int:
        q = self.queues.get(func)
        if q:
            w = min(q, key=lambda w: (self.conns[w], w))  # pull: least-loaded enqueued
            q[w] -= 1
            if not q[w]:
                del q[w]
            return w
        low = min(self.conns)
        return self.rng.choice([w for w, c in enumerate(self.conns) if c == low])

    def _evict_lru(self, w: int) -> bool:
        idle = self.idle[w]
        if not idle:
            return False
        i = min(range(len(idle)), key=lambda i: idle[i][1])
        func, _ = idle.pop(i)
        self.used[w] -= self.instance_bytes
        q = self.queues.get(func)
        if q and w in q:  # the notification: drop one occurrence of w from PQ_f
            q[w] -= 1
            if not q[w]:
                del q[w]
        return True

    def serve(self, func: str) -> Tuple[int, bool]:
        """Place and run one request; returns (worker, cold)."""
        w = self._select(func)
        self.conns[w] += 1
        idle = self.idle[w]
        mine = [i for i, (f, _) in enumerate(idle) if f == func]
        cold = not mine
        if cold:
            while self.used[w] + self.instance_bytes > self.pool_bytes and self._evict_lru(w):
                pass
            self.used[w] += self.instance_bytes
        else:
            idle.pop(mine[-1])
        self.clock += 1
        idle.append([func, self.clock])
        self.conns[w] = max(self.conns[w] - 1, 0)
        q = self.queues.setdefault(func, {})
        q[w] = q.get(w, 0) + 1
        return w, cold

    def holders(self) -> List[List[str]]:
        """The functions each worker holds idle instances of."""
        return [[f for f, _ in idle] for idle in self.idle]
