"""Dirty-shard coordination: change-driven cluster state for the tick path.

A copy of the JAX package's ``core/coord.py`` (pure Python and numpy, no
JAX): the port keeps its own so that it imports nothing from ``repro``.

The admission tier's original tick loop pays O(K) per tick no matter what
the cluster is doing: it re-reads every shard's ``pressure()``, re-scans for
dead shards, and rebuilds the admission heap from scratch — even when not a
single event fired since the last tick.  At the 100k-worker/1M-VU anchor
that coordination cost dominates the run.

:class:`ShardCoordinator` inverts the flow.  Every shard engine publishes a
compact *dirty flag* into a shared sink the moment its admission-visible
state may have changed (``Simulator.attach_dirty`` / ``_mark_dirty`` — the
publication points are normative in docs/ARCHITECTURE.md §13), and the
coordinator re-reads **only the dirty shards** once per tick
(:meth:`refresh`).  Everything downstream consumes the cached deltas:

* the admission pressure heap is *persistent* across ticks with lazy-
  deletion repair keyed on a per-shard version counter — a refreshed shard
  pushes a superseding entry instead of forcing a rebuild;
* ``steal_tick`` / ``drain_tick`` take the cached pressure vector and dead
  set instead of re-polling engines;
* a lazy max-heap answers "could any shard be a steal victim?" in O(dirty)
  amortized, so the steal round is skipped entirely while the cluster is
  below the steal watermark.

Byte-identity argument (pinned by ``tests/test_coord.py`` against
``Simulator._pressure_ref`` and the frozen legacy engine): within a tick,
live pressure only changes at ``steal_queued`` and ``step_until`` — both
*after* every pressure read of the tick — so one cached read per dirty
shard per tick observes exactly the values the O(K) loop would.  The heap
pops identically because ``(pressure, shard_index)`` is a unique total
order: any heap holding the same valid-entry multiset yields the same pop
sequence, stale entries are discarded without effect, and the engine marks
conservatively (a spurious dirty flag costs one cached re-read, never a
decision).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Set, Tuple

__all__ = ["ShardCoordinator"]


class ShardCoordinator:
    """Cached, change-driven view of a shard cluster for one admission run.

    Construction attaches every shard's dirty flag to a shared sink (all
    shards start dirty) and performs the first :meth:`refresh`.  The
    admission loop calls :meth:`refresh` once at the top of each tick;
    between refreshes, :attr:`pressure`, :attr:`dead` and the persistent
    admission heap are the tick's source of truth.

    Attributes:
        pressure: cached ``Simulator.pressure()`` per shard, valid as of the
            last refresh (``inf`` for a dead shard).
        dead: indices of shards with no live workers, as of the last
            refresh.  Iterate ``sorted(dead)`` to preserve shard-index
            order (the drain contract).
        refreshes: total dirty-shard re-reads performed — the coordination
            work actually done; an idle cluster accrues ~0 per tick while
            the O(K) loop would accrue K.
    """

    __slots__ = (
        "sims",
        "dirty",
        "pressure",
        "dead",
        "refreshes",
        "_heap",
        "_entry_ver",
        "_ver",
        "_pmax",
        "_pmax_ver",
        "_compact_at",
    )

    def __init__(self, sims: Sequence) -> None:
        K = len(sims)
        self.sims = list(sims)
        self.dirty: Set[int] = set()
        self.pressure: List[float] = [0.0] * K
        self.dead: Set[int] = set()
        self.refreshes = 0
        # persistent admission heap: (key, shard, ver) valid iff
        # ver == _entry_ver[shard]; _ver is the shard's monotone counter
        self._heap: List[Tuple[float, int, int]] = []
        self._entry_ver: List[int] = [-1] * K
        self._ver: List[int] = [0] * K
        # lazy max-heap over cached pressures: (-pressure, shard, ver)
        # valid iff ver == _pmax_ver[shard]; refreshed entries supersede
        self._pmax: List[Tuple[float, int, int]] = []
        self._pmax_ver: List[int] = [0] * K
        self._compact_at = max(64, 4 * K)
        for k, sim in enumerate(self.sims):
            sim.attach_dirty(self.dirty, k)  # marks every shard dirty now
        self.refresh()

    # ------------------------------------------------------------- refresh
    def refresh(self) -> int:
        """Re-read every dirty shard; returns the number refreshed.

        Per dirty shard: recompute the cached pressure (O(1) — the engine
        keeps incremental queued/busy counters), update the dead set, and
        push superseding entries onto both lazy heaps.  Clean shards are
        untouched, so an idle tick costs O(1).
        """
        d = self.dirty
        if not d:
            return 0
        n = len(d)
        heap, pmax = self._heap, self._pmax
        ver, entry_ver, pmax_ver = self._ver, self._entry_ver, self._pmax_ver
        for k in d:
            sim = self.sims[k]
            p = sim.pressure()
            self.pressure[k] = p
            if sim.workers:
                self.dead.discard(k)
            else:
                self.dead.add(k)
            v = ver[k] + 1
            ver[k] = v
            entry_ver[k] = v
            heapq.heappush(heap, (p, k, v))
            vm = pmax_ver[k] + 1
            pmax_ver[k] = vm
            heapq.heappush(pmax, (-p, k, vm))
        d.clear()
        self.refreshes += n
        if len(heap) > self._compact_at or len(pmax) > self._compact_at:
            self._compact()
        return n

    def _compact(self) -> None:
        """Drop stale entries and re-heapify.  The valid-entry multiset is
        unchanged, so pop order — and every admission decision — is too."""
        ev, mv = self._entry_ver, self._pmax_ver
        self._heap = [e for e in self._heap if ev[e[1]] == e[2]]
        heapq.heapify(self._heap)
        self._pmax = [e for e in self._pmax if mv[e[1]] == e[2]]
        heapq.heapify(self._pmax)

    # ------------------------------------------- persistent admission heap
    def peek(self) -> Optional[Tuple[float, int]]:
        """``(key, shard)`` of the minimum *valid* heap entry, or ``None``
        when every shard's entry has been popped this tick.  Discards stale
        entries from the top as a side effect (lazy repair)."""
        heap, ev = self._heap, self._entry_ver
        while heap:
            key, k, v = heap[0]
            if ev[k] == v:
                return key, k
            heapq.heappop(heap)
        return None

    def pop(self) -> Tuple[float, int]:
        """Pop the minimum *valid* entry (stale entries are discarded on the
        way, like :meth:`peek`); the shard is left with no valid entry until
        the next :meth:`push` or :meth:`refresh`.  Raises ``IndexError``
        when no valid entry remains."""
        heap, ev = self._heap, self._entry_ver
        while True:
            key, k, v = heapq.heappop(heap)
            if ev[k] == v:
                ev[k] = -1
                return key, k

    def push(self, key: float, k: int) -> None:
        """Give shard ``k`` a fresh valid entry at ``key`` (superseding any
        existing one via the version counter)."""
        v = self._ver[k] + 1
        self._ver[k] = v
        self._entry_ver[k] = v
        heapq.heappush(self._heap, (key, k, v))

    # ------------------------------------------------------ steal/drain view
    def pressure_max(self) -> float:
        """Maximum cached pressure across shards (lazy max-heap; O(dirty)
        amortized).  ``steal_tick`` is a guaranteed no-op when this is at
        or below the steal watermark — no shard qualifies as victim."""
        pmax, mv = self._pmax, self._pmax_ver
        while pmax:
            negp, k, v = pmax[0]
            if mv[k] == v:
                return -negp
            heapq.heappop(pmax)
        return float("-inf")
