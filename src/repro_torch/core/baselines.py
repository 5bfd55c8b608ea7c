"""Baseline schedulers evaluated in the paper (Section V) plus RJ-CH.

A copy of the JAX package's ``core/baselines.py`` (pure Python, no JAX).

* ``random``             — uniform random worker.
* ``least_connections``  — min active connections, random tie-break.
* ``ch``                 — consistent hashing on a ring with virtual nodes
                           (Section II-C, Figure 3).
* ``ch_bl``              — consistent hashing with bounded loads
                           [Mirrokni et al.], load threshold c = 1.25 as
                           recommended and used by the paper.
* ``rj_ch``              — random-jump consistent hashing [Chen et al.]:
                           jump to a random non-overloaded worker instead of
                           walking the ring (avoids cascaded overflows).

The ring uses a salted stable hash (blake2b) so experiments are reproducible
across processes (Python's builtin ``hash`` is randomized per process).
"""

from __future__ import annotations

import bisect
import hashlib
import math
from typing import List, Tuple

from .scheduler import Scheduler, register


def _stable_hash(key: str) -> int:
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


@register("random")
class RandomScheduler(Scheduler):
    def select(self, func: str) -> int:
        return self.rng.choice(self.workers)


@register("least_connections")
class LeastConnectionsScheduler(Scheduler):
    def select(self, func: str) -> int:
        return self._least_connections()


class _HashRing:
    """Consistent-hash ring with virtual nodes."""

    def __init__(self, workers: List[int], vnodes: int = 100):
        self.vnodes = vnodes
        self._ring: List[Tuple[int, int]] = []  # (point, worker)
        for w in workers:
            self.add(w)

    def add(self, worker: int) -> None:
        for v in range(self.vnodes):
            point = _stable_hash(f"worker-{worker}-vnode-{v}")
            bisect.insort(self._ring, (point, worker))

    def remove(self, worker: int) -> None:
        self._ring = [(p, w) for (p, w) in self._ring if w != worker]

    def walk(self, key: str):
        """Yield workers clockwise from the key's position (with wrap)."""
        point = _stable_hash(key)
        i = bisect.bisect_right(self._ring, (point, -1))
        n = len(self._ring)
        for k in range(n):
            yield self._ring[(i + k) % n][1]

    def lookup(self, key: str) -> int:
        return next(self.walk(key))


@register("ch")
class ConsistentHashingScheduler(Scheduler):
    """Plain consistent hashing: next clockwise worker on the ring."""

    def __init__(self, n_workers: int, seed: int = 0, vnodes: int = 100):
        super().__init__(n_workers, seed)
        self.ring = _HashRing(self.workers, vnodes)

    def select(self, func: str) -> int:
        return self.ring.lookup(func)

    def on_worker_added(self, worker: int) -> None:
        super().on_worker_added(worker)
        self.ring.add(worker)

    def on_worker_removed(self, worker: int) -> None:
        super().on_worker_removed(worker)
        self.ring.remove(worker)


class _BoundedLoadMixin:
    """Shared overload predicate for CH-BL / RJ-CH.

    A worker is *overloaded* when accepting one more request would push its
    active-connection count above ``ceil(c * mean_load)`` with c = 1.25
    (the bounded-loads capacity rule of Mirrokni et al. applied to the
    active-request load measure used by the OpenLambda scheduler).
    """

    threshold: float

    def _capacity(self) -> float:
        # total_conns == sum(conns over live workers); +1 incl. the new req
        total = self.total_conns + 1
        return math.ceil(self.threshold * total / max(1, len(self.workers)))

    def _overloaded(self, worker: int, cap: float) -> bool:
        return self.conns[worker] + 1 > cap


@register("ch_bl")
class CHBLScheduler(ConsistentHashingScheduler, _BoundedLoadMixin):
    """Consistent hashing with bounded loads (threshold 1.25)."""

    def __init__(self, n_workers: int, seed: int = 0, vnodes: int = 100, threshold: float = 1.25):
        super().__init__(n_workers, seed, vnodes)
        self.threshold = threshold

    def select(self, func: str) -> int:
        cap = self._capacity()
        first = None
        for w in self.ring.walk(func):
            if first is None:
                first = w
            if not self._overloaded(w, cap):
                return w
        return first  # everyone overloaded: fall back to hash target

    # NOTE: cascaded overflows (Section II-C) are inherent: the clockwise
    # successor of a hot worker absorbs its spill and overloads next.


@register("rj_ch")
class RJCHScheduler(ConsistentHashingScheduler, _BoundedLoadMixin):
    """Random-jump consistent hashing: random non-overloaded worker on spill."""

    def __init__(self, n_workers: int, seed: int = 0, vnodes: int = 100, threshold: float = 1.25):
        super().__init__(n_workers, seed, vnodes)
        self.threshold = threshold

    def select(self, func: str) -> int:
        cap = self._capacity()
        target = self.ring.lookup(func)
        if not self._overloaded(target, cap):
            return target
        ok = [w for w in self.workers if not self._overloaded(w, cap) and w != target]
        return self.rng.choice(ok) if ok else target
