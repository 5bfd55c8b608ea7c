"""Scheduler interface for the serverless control plane.

A copy of the JAX package's ``core/scheduler.py`` (pure Python, no JAX):
the port keeps its own so that it imports nothing from ``repro``.

The scheduler maps an incoming request for a function type to a worker id
(Section III-A of the paper: ``S(r_i) = (w_j, t_exec)``; the execution time is
decided by the worker/simulator, the scheduler only picks ``w_j``).

Schedulers keep their *own view* of cluster state, fed exclusively through the
callbacks below — exactly like the OpenLambda scheduler proxy the paper extends:

* ``on_assign(w, f)``   — request dispatched to ``w`` (active connection opens).
* ``on_finish(w, f)``   — worker reports completion (connection closes).  For
  Hiku this is the *pull* signal: the worker enqueues itself in ``PQ_f``.
* ``on_evict(w, f)``    — worker evicted an idle instance of ``f`` (keep-alive
  timeout or memory pressure) and *notifies* the scheduler (Section IV-A,
  notification mechanism).
* ``on_worker_added/on_worker_removed`` — elastic scaling / failure events.
"""

from __future__ import annotations

import abc
import random
from typing import Callable, Dict, List, Optional

import numpy as np


# Least-connections tie bitmaps: 64 ids per word, 16 words (1024 ids) per
# popcount block — block counts let a tie select skip most of the bitmap.
_LC_BLOCK_WORDS = 16


class Scheduler(abc.ABC):
    """Base class; concrete schedulers implement ``select``."""

    name: str = "base"

    def __init__(self, n_workers: int, seed: int = 0):
        self.n_workers = n_workers
        self.workers: List[int] = list(range(n_workers))
        self.rng = random.Random(seed)
        # Scheduler-view active connections per worker (LC fallback et al.).
        # Managed via the callbacks; total_conns mirrors the sum over live
        # workers so bounded-load baselines avoid an O(workers) sum per
        # request.
        self.conns: Dict[int, int] = {w: 0 for w in self.workers}
        self.total_conns = 0
        # Dense mirror of ``conns`` for the least-connections scan: C-speed
        # argmin over 100s of workers instead of a Python listcomp.  Only
        # valid while worker ids are ascending (so id order == workers-list
        # order and the tie set comes out in the seed engine's order);
        # otherwise _least_connections falls back to the exact scan.
        self._conns_arr = np.zeros(max(n_workers, 1), np.int64)
        self._live_ids: Optional[np.ndarray] = None  # rebuilt lazily
        self._ids_ascending = True
        # Incremental least-connections tracker: per-conns-value tie counts
        # plus a two-level id bitmap over the *live* workers — a list of
        # 64-bit words and per-16-word block popcounts.  Every conns change
        # touches one word and one block counter (O(1), no wide-int
        # copies), and a tie select walks blocks -> words -> bytes, so the
        # fallback needs no O(workers) pass per call at 10k+ worker shards
        # (byte-identical to the full scan — see _least_connections /
        # _least_connections_ref).
        self._lc_val: Dict[int, int] = {w: 0 for w in self.workers}
        self._lc_cnt: Dict[int, int] = {0: n_workers} if n_workers else {}
        self._lc_nwords = (max(n_workers, 1) + 63) >> 6
        words, blocks = self._lc_new_rows()
        full, rem = divmod(n_workers, 64)
        for wi in range(full):
            words[wi] = 0xFFFFFFFFFFFFFFFF
            blocks[wi >> 4] += 64
        if rem:
            words[full] = (1 << rem) - 1
            blocks[full >> 4] += rem
        self._lc_bm: Dict[int, List[int]] = {0: words} if n_workers else {}
        self._lc_blk: Dict[int, List[int]] = {0: blocks} if n_workers else {}
        self._lc_min = 0

    # ------------------------------------------------------------------ API
    @abc.abstractmethod
    def select(self, func: str) -> int:
        """Pick a worker for a request of function type ``func``."""

    def schedule(self, func: str) -> int:
        w = self.select(func)
        self.on_assign(w, func)
        return w

    # ------------------------------------------------ conns-bucket tracker
    def _lc_new_rows(self):
        """Fresh (words, block-popcounts) rows at current capacity."""
        nw = self._lc_nwords
        return [0] * nw, [0] * ((nw + _LC_BLOCK_WORDS - 1) // _LC_BLOCK_WORDS)

    def _lc_grow(self, nwords: int) -> None:
        """Extend every value's rows to hold ids up to ``nwords * 64``."""
        nwords = max(nwords, 2 * self._lc_nwords)
        self._lc_nwords = nwords
        nblocks = (nwords + _LC_BLOCK_WORDS - 1) // _LC_BLOCK_WORDS
        for v, row in self._lc_bm.items():
            row.extend([0] * (nwords - len(row)))
            blk = self._lc_blk[v]
            blk.extend([0] * (nblocks - len(blk)))

    def _lc_move(self, worker: int, new: int) -> None:
        """Move a *live* worker between conns buckets (no-op for phantom
        ids — conns entries whose worker left the cluster stay out of the
        tie sets, exactly like the scan over ``self.workers``)."""
        val = self._lc_val
        old = val.get(worker)
        if old is None or old == new:
            return
        val[worker] = new
        cnt, bm, blk = self._lc_cnt, self._lc_bm, self._lc_blk
        wi = worker >> 6
        bit = 1 << (worker & 63)
        bm[old][wi] &= ~bit
        blk[old][wi >> 4] -= 1
        c = cnt[old] - 1
        if c:
            cnt[old] = c
        else:
            del cnt[old]
        if new in cnt:
            cnt[new] += 1
        else:
            cnt[new] = 1
            if new not in bm:
                bm[new], blk[new] = self._lc_new_rows()
        bm[new][wi] |= bit
        blk[new][wi >> 4] += 1
        if new < self._lc_min:
            self._lc_min = new
        elif old == self._lc_min and old not in cnt:
            m = old
            while m not in cnt:  # conns move by +-1: terminates by ``new``
                m += 1
            self._lc_min = m

    def _lc_add(self, worker: int) -> None:
        """Track a newly live worker (conns 0)."""
        wi = worker >> 6
        if wi >= self._lc_nwords:
            self._lc_grow(wi + 1)
        self._lc_val[worker] = 0
        self._lc_cnt[0] = self._lc_cnt.get(0, 0) + 1
        if 0 not in self._lc_bm:
            self._lc_bm[0], self._lc_blk[0] = self._lc_new_rows()
        self._lc_bm[0][wi] |= 1 << (worker & 63)
        self._lc_blk[0][wi >> 4] += 1
        self._lc_min = 0

    def _lc_drop(self, worker: int) -> None:
        """Stop tracking a removed worker."""
        old = self._lc_val.pop(worker, None)
        if old is None:
            return
        cnt = self._lc_cnt
        self._lc_bm[old][worker >> 6] &= ~(1 << (worker & 63))
        self._lc_blk[old][worker >> 10] -= 1
        c = cnt[old] - 1
        if c:
            cnt[old] = c
        else:
            del cnt[old]
            if old == self._lc_min:
                self._lc_min = min(cnt) if cnt else 0

    # ------------------------------------------------------------ callbacks
    def on_assign(self, worker: int, func: str) -> None:
        new = self.conns.get(worker, 0) + 1
        self.conns[worker] = new
        self.total_conns += 1
        if worker < len(self._conns_arr):
            self._conns_arr[worker] = new
        self._lc_move(worker, new)

    def _release(self, worker: int) -> int:
        """Clamped connection decrement + total/dense-mirror bookkeeping.

        Shared by on_finish/on_cancel (HikuScheduler.on_finish inlines the
        same sequence for hot-path speed — keep them in sync).
        """
        old = self.conns.get(worker, 0)
        new = old - 1 if old > 0 else 0
        self.conns[worker] = new
        self.total_conns += new - old
        if worker < len(self._conns_arr):
            self._conns_arr[worker] = new
        self._lc_move(worker, new)
        return new

    def on_finish(self, worker: int, func: str) -> None:
        self._release(worker)

    def on_cancel(self, worker: int, func: str) -> None:
        """Undo an assignment that never executed (failure race).

        Unlike ``on_finish`` this must NOT signal idle capacity (no pull
        enqueue in Hiku) — it only releases the connection count.
        """
        self._release(worker)

    def on_evict(self, worker: int, func: str) -> None:  # noqa: B027
        """Sandbox-destruction notification; default: ignored."""

    def on_worker_added(self, worker: int) -> None:
        if worker not in self.conns:
            if self.workers and worker < self.workers[-1]:
                self._ids_ascending = False  # id order != list order
            self.workers.append(worker)
            self.conns[worker] = 0
            self.n_workers = len(self.workers)
            if worker >= len(self._conns_arr):
                grown = np.zeros(max(worker + 1, 2 * len(self._conns_arr)), np.int64)
                grown[: len(self._conns_arr)] = self._conns_arr
                self._conns_arr = grown
            self._conns_arr[worker] = 0
            self._live_ids = None
            self._lc_add(worker)

    def on_worker_removed(self, worker: int) -> None:
        if worker in self.conns:
            self.workers.remove(worker)
            self.total_conns -= self.conns.pop(worker)
            self.n_workers = len(self.workers)
            self._live_ids = None
            self._lc_drop(worker)

    # ------------------------------------------------------------- helpers
    def _least_connections(self) -> int:
        """Least-connections with random tie-breaking (Algorithm 1 l.8-10).

        Fed by the incremental conns tracker: the minimum, its tie count
        and its tie *bitmap* are already maintained, so a call is one RNG
        draw plus a k-th-set-bit select over the two-level bitmap (block
        popcounts -> words -> bytes) — no O(workers) pass at any tie size
        (at mega shards the tie set is routinely half the cluster).

        Byte-identity with :meth:`_least_connections_ref`: the reference
        draws ``rng.choice(tied)`` over the ascending tie array, which
        consumes exactly one ``_randbelow(len(tied))`` — the same single
        draw as ``rng.randrange(t)`` — and returns the ``k``-th entry,
        i.e. the ``k``-th smallest tied id, i.e. the ``k``-th set bit of
        the tie bitmap.  Pinned live by tests/test_scheduler.py.  The
        reference remains the exact path for non-ascending worker ids
        (out-of-order elastic joins), where tie order follows the workers
        *list*, not sorted ids.
        """
        if not self._ids_ascending:
            return self._least_connections_ref()
        m = self._lc_min
        t = self._lc_cnt.get(m)
        if not t:
            return self._least_connections_ref()
        k = self.rng.randrange(t)
        blocks = self._lc_blk[m]
        bi = 0
        c = blocks[0]
        while k >= c:
            k -= c
            bi += 1
            c = blocks[bi]
        words = self._lc_bm[m]
        wi = bi << 4
        c = words[wi].bit_count()
        while k >= c:
            k -= c
            wi += 1
            c = words[wi].bit_count()
        w = words[wi]
        base = wi << 6
        c = (w & 0xFF).bit_count()
        while k >= c:
            k -= c
            base += 8
            w >>= 8
            c = (w & 0xFF).bit_count()
        b = w & 0xFF
        for _ in range(k):
            b &= b - 1
        return base + (b & -b).bit_length() - 1

    def _least_connections_ref(self) -> int:
        """The full-scan form (the seed engine's): retained as the byte-
        identity oracle for the tracker-fed fast path, as the exact path
        for non-ascending worker ids, and as the forced-legacy mode of
        ``benchmarks/bench_shard_scale.py``."""
        if not self._ids_ascending:
            conns = self.conns
            cs = [conns[w] for w in self.workers]
            lmin = min(cs)
            tied = [w for w, c in zip(self.workers, cs) if c == lmin]
            return self.rng.choice(tied)
        ids = self._live_ids
        if ids is None:
            ids = self._live_ids = np.array(self.workers, np.int64)
        sub = self._conns_arr[ids]
        tied = ids[sub == sub.min()]
        return int(self.rng.choice(tied))


# Registry -----------------------------------------------------------------
_REGISTRY: Dict[str, Callable[..., Scheduler]] = {}


def register(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def make_scheduler(name: str, n_workers: int, seed: int = 0, **kw) -> Scheduler:
    """Instantiate a registered scheduler by name (``"hiku"``, ``"ch_bl"``,
    ``"least_connections"``, ``"random"``, ...).

    ``seed`` feeds the scheduler's private tie-break RNG only — workload
    randomness lives in the simulator — and is part of the replay identity
    the equivalence suite pins.  Extra kwargs go to the concrete class
    (e.g. ``fallback=`` for hiku, ``threshold=`` for CH-BL)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](n_workers, seed=seed, **kw)


def available_schedulers() -> List[str]:
    """Sorted names accepted by :func:`make_scheduler`."""
    return sorted(_REGISTRY)
