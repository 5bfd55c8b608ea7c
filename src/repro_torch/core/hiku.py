"""Hiku: pull-based scheduling (Algorithm 1 of the paper).

A copy of the JAX package's ``core/hiku.py`` (pure Python, no JAX).

Key idea: decouple worker selection from task assignment.  After a worker
finishes executing a function of type ``f`` it *proactively enqueues itself*
in the idle priority queue ``PQ_f`` (the pull mechanism).  An incoming request
for ``f`` dequeues the least-loaded enqueued worker — a guaranteed-warm
assignment.  If ``PQ_f`` is empty the fallback mechanism (least connections,
random tie-break) assigns the request.

``PQ_f`` is *sorted by the number of active connections* (Algorithm 1, note at
l.21).  A worker appears once per idle instance it has enqueued (it may appear
in several queues, and several times in one queue); ``on_evict`` removes one
occurrence (Algorithm 1 l.17-20).

Representation (PR 1 hot-path refactor; decisions are bit-identical to the
seed list-scan implementation, proven by tests/test_equivalence.py):

* ``idle_counts[f]`` is the queue *multiset* as ``{worker: count}`` — the
  seed engine's list with duplicates, collapsed.  Dequeue-min needs only
  multiset membership because the priority ``(conns[w], w)`` is a total
  order over distinct workers.
* ``_heaps[f]`` is a lazy-deletion binary heap of ``(conns-at-push, worker)``
  entries over that multiset, making dequeue O(log n) instead of an O(queue)
  scan per request.  Since connection counts drift after entries are pushed,
  every pop re-validates the entry against the live ``conns``: dead entries
  (evicted or failed workers) are dropped, stale priorities are refreshed in
  place.  On every conns *decrease* (``on_finish``/``on_cancel``) an accurate
  entry is pushed for each queue holding the worker, so a queue member can
  never be hidden behind a stale-high priority — which is exactly the
  invariant that makes the popped minimum equal the seed engine's fresh scan
  ``min((conns[w], w) for w in PQ_f)``.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Set, Tuple

from .scheduler import Scheduler, register


@register("hiku")
class HikuScheduler(Scheduler):
    """Pull-based scheduler (the paper's contribution; see module docstring).

    Args:
        n_workers: initial worker count (ids 0..n-1; elastic add/remove via
            the worker callbacks).
        seed: tie-break RNG seed for the fallback path — part of the replay
            identity the equivalence suite pins.
        fallback: assignment when ``PQ_f`` is empty — ``"least_connections"``
            (Algorithm 1) or ``"random"``.

    Bound by the decision-equivalence contract: every ``select`` returns the
    worker the seed engine's list-scan implementation would have picked
    (tests/test_equivalence.py)."""

    def __init__(self, n_workers: int, seed: int = 0, fallback: str = "least_connections"):
        super().__init__(n_workers, seed)
        # PQ_f multiset + lazy-deletion heap (see module docstring).
        self.idle_counts: Dict[str, Dict[int, int]] = {}
        self._heaps: Dict[str, List[Tuple[int, int]]] = {}
        self._totals: Dict[str, int] = {}
        self._worker_funcs: Dict[int, Set[str]] = {}  # funcs holding the worker
        self.fallback = fallback
        # telemetry
        self.pull_hits = 0
        self.fallback_assigns = 0

    # ------------------------------------------------------------ schedule
    def select(self, func: str) -> int:
        if self._totals.get(func):
            # Pull mechanism: dequeue least-loaded enqueued worker.
            self.pull_hits += 1
            return self._dequeue_min(func)
        # Fallback mechanism (least connections, random tie-break).
        self.fallback_assigns += 1
        if self.fallback == "random":
            return self.rng.choice(self.workers)
        return self._least_connections()

    def _dequeue_min(self, func: str) -> int:
        # priority = (active connections, worker id): deterministic tie-break
        # by lowest id keeps this object semantically identical to the array
        # formulation in core/sched.py (tie order is unspecified in the paper).
        heap = self._heaps[func]
        counts = self.idle_counts[func]
        conns = self.conns
        if len(heap) > 64 and len(heap) > 8 * len(counts):
            # too many stale/duplicate entries: rebuild from the live
            # multiset (exact priorities, one entry per enqueued instance
            # so multi-enqueued workers keep their multiplicity)
            heap = [(conns[w], w) for w, n in counts.items() for _ in range(n)]
            heapq.heapify(heap)
            self._heaps[func] = heap
        while True:
            c, w = heap[0]
            cw = conns.get(w)
            if cw is None or w not in counts:
                heapq.heappop(heap)  # worker left the queue/cluster: discard
            elif c != cw:
                heapq.heapreplace(heap, (cw, w))  # stale priority: refresh
            else:
                heapq.heappop(heap)
                n = counts[w] - 1
                if n:
                    counts[w] = n
                else:
                    del counts[w]
                    self._worker_funcs[w].discard(func)
                self._totals[func] -= 1
                return w

    # ------------------------------------------------------------ callbacks
    def on_finish(self, worker: int, func: str) -> None:
        # Scheduler._release inlined (hottest callback in the simulator)
        conns = self.conns
        old = conns.get(worker, 0)
        cw = old - 1 if old > 0 else 0
        conns[worker] = cw
        self.total_conns += cw - old
        if worker < len(self._conns_arr):
            self._conns_arr[worker] = cw
        self._lc_move(worker, cw)
        # decrease-key: re-post an accurate entry in every queue holding the
        # worker, so the lowered priority is visible to future dequeues
        # (func itself is covered by the unconditional enqueue push below)
        heaps = self._heaps
        push = heapq.heappush
        wf = self._worker_funcs.get(worker)
        entry = (cw, worker)
        if wf:
            for f in wf:
                if f != func:
                    push(heaps[f], entry)
            wf.add(func)
        else:
            self._worker_funcs[worker] = {func}
        # Pull: worker signals readiness for another request of this type.
        counts = self.idle_counts.get(func)
        if counts is None:
            counts = self.idle_counts[func] = {}
            heaps[func] = []
            self._totals[func] = 0
        counts[worker] = counts.get(worker, 0) + 1
        self._totals[func] += 1
        push(heaps[func], entry)

    def on_cancel(self, worker: int, func: str) -> None:
        super().on_cancel(worker, func)
        cw = self.conns.get(worker)
        if cw is not None:
            for f in self._worker_funcs.get(worker, ()):
                heapq.heappush(self._heaps[f], (cw, worker))

    def on_evict(self, worker: int, func: str) -> None:
        # Notification mechanism: drop one occurrence of worker from PQ_f.
        counts = self.idle_counts.get(func)
        if counts and worker in counts:
            n = counts[worker] - 1
            if n:
                counts[worker] = n
            else:
                del counts[worker]
                self._worker_funcs[worker].discard(func)
            self._totals[func] -= 1
            # the heap entry is lazily discarded at dequeue time

    def on_worker_removed(self, worker: int) -> None:
        super().on_worker_removed(worker)
        # Failure/scale-down: purge every queue entry of the worker.
        for f in self._worker_funcs.pop(worker, ()):
            counts = self.idle_counts.get(f)
            if counts is not None:
                self._totals[f] -= counts.pop(worker, 0)

    # ------------------------------------------------------------ telemetry
    def queue_depth(self, func: Optional[str] = None) -> int:
        if func is not None:
            return self._totals.get(func, 0)
        return sum(self._totals.values())
