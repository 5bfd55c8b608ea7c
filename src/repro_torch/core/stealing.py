"""Cross-shard work stealing: pull-based balancing *after* admission binds.

A copy of the JAX package's ``core/stealing.py`` (pure Python and numpy, no
JAX): the port keeps its own so that it imports nothing from ``repro``.

The global admission tier (``core.admission``) applies Hiku's pull principle
at arrival time: the least-pressured shard pulls the next VU.  That decision
is made once — if a shard turns hot later (its VUs ramp up, its memory pool
thrashes cold starts), the queue that builds behind it can never drain on an
idle neighbor.  This is exactly the late-binding gap the serverless
scheduling literature pins on static placement (Kaffes et al.'s core-granular
migration, NOAH's job-migration view): tail latency is dominated by work
stuck behind the wrong queue.

``steal_tick`` closes the gap with the admission tier's own mechanism run in
**both directions**: each tick, one pressure-keyed heap of *victims* (shards
above ``steal_watermark``) and one of *thieves* (shards below the pull
watermark).  While both heaps are non-empty, the most-pressured victim
exports one queued task (``Simulator.steal_queued``) and the least-pressured
thief re-injects it (``Simulator.receive_task``); each move adjusts both
shards' effective pressure by ``1/n_workers`` — the same accounting the
admission tier applies per pull — so a single tick cannot flood a thief or
drain a victim past the watermarks.

Contracts (stated normatively in docs/ARCHITECTURE.md §8):

* only *pending* tasks migrate (admitted, waiting for sandbox memory: no
  work done, no memory held) and the closed-loop VU migrates with its task;
* the migrated VU's service-fluctuation identity ``(origin_seed, origin_vu)``
  travels with it, so every replayed draw is bit-exact under migration;
* a dead shard (all workers failed, pressure ``inf``) can never be a thief,
  and has nothing stealable as a victim;
* with stealing off nothing here runs: the static partition and the pull
  tier stay byte/stream-identical to their pre-stealing behavior.

Determinism: heap order is a total order ``(pressure, shard index)``, victim
selection inside a shard is deterministic (``steal_queued``), so a steal
schedule is a pure function of the co-run state.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple

from .simulator import SalvagedVU, Simulator, StolenTask

__all__ = ["Migration", "Salvage", "drain_tick", "steal_tick"]


@dataclasses.dataclass(frozen=True)
class Migration:
    """One completed task migration (telemetry row on ``AdmissionRun``).

    ``src_vu``/``dst_vu`` are shard-local VU ids (the victim's id at steal
    time and the fresh id the destination registered); the admission tier
    resolves ``src_vu`` through its admission table to a global VU id.
    """

    t: float
    src: int
    dst: int
    src_vu: int
    dst_vu: int
    func: int
    ev_idx: int


def steal_tick(
    sims: Sequence[Simulator],
    steal_watermark: float,
    pull_watermark: float,
    inv_workers: Sequence[float],
    t: Optional[float] = None,
    max_moves: Optional[int] = None,
    prefer_warm: bool = False,
    pressures: Optional[Sequence[float]] = None,
) -> List[Migration]:
    """One stealing round over co-run shards; returns the moves it made.

    Args:
        sims: the K shard simulators (co-run via ``begin``/``step_until``).
        steal_watermark: pressure above which a shard is a victim; must sit
            at or above ``pull_watermark`` or a shard could be both sides of
            the same move.
        pull_watermark: pressure below which a shard may receive (the
            admission tier's pull watermark — stealing is admission's
            mirror image).  The admission loop sources this pair from
            ``AdmissionPolicy.steal_params()`` each tick, so learned
            policies (``bandit+steal``) may retune the band per reward
            window — the invariant above must hold for every value the
            policy can return.
        inv_workers: per-shard ``1 / n_workers`` pressure increments.
        t: simulated re-injection time (default: each receiver's clock).
        max_moves: optional hard cap on migrations this tick.
        prefer_warm: warm-locality stealing (``AdmissionPolicy
            .steal_affinity``): each move passes the thief's warm-digest
            function set (``Simulator.warm_digest`` keys, computed once per
            thief per tick) to ``steal_queued(prefer=...)``, so within the
            victim's chosen queue the newest *warm-servable* task is
            exported instead of the plain newest.  Victim/thief heap order
            is untouched, and ``False`` (the default) is byte-identical to
            the pre-digest tier — the ARCHITECTURE §11 off-path guarantee.
        pressures: the tick's per-shard pressure vector, when the caller
            already holds one — the admission loop passes its
            ``ShardCoordinator``'s cached vector (docs/ARCHITECTURE.md
            §13), which equals the live reads at this point in the tick
            (live pressure cannot change between the tick-top refresh and
            the steal round).  Default ``None``: read live.

    The two heaps are rebuilt from the tick's pressure vector each round;
    within the tick, moves adjust effective pressures exactly like admission
    pulls do, so staleness is bounded by the tick period either way.
    """
    if steal_watermark < pull_watermark:
        raise ValueError(
            f"steal_watermark {steal_watermark} must be >= pull watermark "
            f"{pull_watermark} (a shard must never be victim and thief at once)"
        )
    if pressures is None:
        pressures = [sim.pressure() for sim in sims]
    # max-heap of victims, min-heap of thieves — the same pressure-keyed
    # heap the admission tier runs, here in both directions at once.
    victims = [(-p, k) for k, p in enumerate(pressures) if p > steal_watermark]
    thieves = [(p, k) for k, p in enumerate(pressures) if p < pull_watermark]
    heapq.heapify(victims)
    heapq.heapify(thieves)
    moves: List[Migration] = []
    # per-thief warm-function sets, computed lazily once per tick: a steal
    # moves only *pending* tasks, which never touch any shard's idle set,
    # so the digests cannot change mid-tick
    warm_sets: dict = {}
    while victims and thieves and (max_moves is None or len(moves) < max_moves):
        neg_pv, v = victims[0]
        pt, th = thieves[0]
        if -neg_pv <= steal_watermark or pt >= pull_watermark:
            break  # both frontiers inside the watermark band: balanced enough
        if prefer_warm:
            prefer = warm_sets.get(th)
            if prefer is None:
                prefer = warm_sets[th] = frozenset(sims[th].warm_digest())
            got = sims[v].steal_queued(1, prefer=prefer)
        else:
            got = sims[v].steal_queued(1)
        if not got:
            heapq.heappop(victims)  # pressured but nothing queued is stealable
            continue
        stolen: StolenTask = got[0]
        # never before the receiver's clock: unevenly stepped sims would
        # otherwise reject the receive AFTER the victim was already mutated,
        # losing the task (exactly-once would break)
        when = sims[th].t if t is None else max(t, sims[th].t)
        dst_vu = sims[th].receive_task(stolen, t=when)
        moves.append(
            Migration(
                t=when,
                src=v,
                dst=th,
                src_vu=stolen.src_vu,
                dst_vu=dst_vu,
                func=stolen.func,
                ev_idx=stolen.ev_idx,
            )
        )
        heapq.heapreplace(victims, (neg_pv + inv_workers[v], v))
        heapq.heapreplace(thieves, (pt + inv_workers[th], th))
    return moves


@dataclasses.dataclass(frozen=True)
class Salvage:
    """One VU re-homed off a dead shard (telemetry row on ``AdmissionRun``).

    Shape-compatible with :class:`Migration` (same local-id semantics, same
    admission-table resolution of ``src_vu``), plus ``in_flight``: ``True``
    when the salvaged VU carried a lost request that re-dispatches on the
    destination (its completion is flagged ``migrated``), ``False`` for a
    mid-think VU that merely resumes its program there.  ``func``/``ev_idx``
    identify the in-flight request, or the VU's next program position.
    """

    t: float
    src: int
    dst: int
    src_vu: int
    dst_vu: int
    func: int
    ev_idx: int
    in_flight: bool


def drain_tick(
    sims: Sequence[Simulator],
    inv_workers: Sequence[float],
    t: float,
    pending: Optional[List[Tuple[int, SalvagedVU]]] = None,
    dead: Optional[Sequence[int]] = None,
    pressures: Optional[Sequence[float]] = None,
) -> Tuple[List[Salvage], List[Tuple[int, SalvagedVU]]]:
    """One dead-shard drain round: salvage every fully-dead shard's live VUs
    onto live shards.  Returns ``(moves, leftovers)``.

    The recovery half of the §10 failure contract (docs/ARCHITECTURE.md):
    when a shard's last worker dies, its queued work must re-enter the
    global pool instead of stranding.  Each dead shard (no live workers —
    pressure ``inf``) is drained via ``Simulator.salvage_queued``; exports
    are placed on live shards through the same pressure-keyed min-heap and
    ``1/n_workers`` effective-pressure accounting as admission pulls and
    steals.  Unlike stealing there is no watermark gate: salvaged work is
    *survival* traffic and must land somewhere even if every live shard is
    above the pull watermark.

    ``pending`` carries exports buffered from earlier ticks when the whole
    cluster was dark; they are placed first (oldest outage first).  When no
    live shard exists this tick, all exports come back as ``leftovers`` for
    the caller to retry after a revival (``inject_worker``) — exactly-once
    either way: a salvaged VU is re-homed once or still owned by the buffer.

    Determinism: dead shards drain in index order, ``salvage_queued``'s
    export order is the victim heap order, and placement is the
    ``(pressure, index)`` total order — a pure function of the co-run state.

    ``dead`` and ``pressures`` let a caller holding a ``ShardCoordinator``
    view (docs/ARCHITECTURE.md §13) skip the O(K) dead-scan and the live
    pressure reads: ``dead`` is the coordinator's dead-shard set (iterated
    sorted, preserving the index-order drain contract), ``pressures`` its
    cached vector — both equal to the live reads at this point in the tick.
    """
    exports: List[Tuple[int, SalvagedVU]] = list(pending or ())
    if dead is None:
        dead_idx = [k for k, sim in enumerate(sims) if not sim.workers]
    else:
        dead_idx = sorted(dead)
    for k in dead_idx:
        for sv in sims[k].salvage_queued():
            exports.append((k, sv))
    if not exports:
        return [], []
    thieves = [
        ((sim.pressure() if pressures is None else pressures[k]), k)
        for k, sim in enumerate(sims)
        if sim.workers
    ]
    if not thieves:
        return [], exports  # cluster fully dark: buffer until a revival
    heapq.heapify(thieves)
    moves: List[Salvage] = []
    for src, sv in exports:
        p, th = thieves[0]
        # never before the receiver's clock (the steal_tick rule: the victim
        # is already mutated, so a rejected receive would lose the task)
        when = max(t, sims[th].t)
        dst_vu = sims[th].receive_salvaged(sv, t=when)
        moves.append(
            Salvage(
                t=when,
                src=src,
                dst=th,
                src_vu=sv.stolen.src_vu,
                dst_vu=dst_vu,
                func=sv.stolen.func,
                ev_idx=sv.stolen.ev_idx,
                in_flight=sv.in_flight,
            )
        )
        heapq.heapreplace(thieves, (p + inv_workers[th], th))
    return moves, []
