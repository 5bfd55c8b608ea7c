"""Declarative fault plans: correlated churn compiled onto the inject hooks.

A copy of the JAX package's ``core/chaos.py`` (pure Python and numpy, no
JAX): the port keeps its own so that it imports nothing from ``repro``.

The engine's fault surface is two hooks — ``inject_failure(t, worker)`` and
``inject_worker(t, worker)`` — one event at a time.  That is the right
*mechanism* (one worker dies, one worker joins), but the failure modes that
actually stress a scheduler are *patterns*: a whole shard's workers dying
together, a spot-preemption wave with a notice window, a rolling restart
marching through the fleet, flappy workers cycling between crash and repair.
They are first-class scenario bundles; the NOAH
framing (PAPERS.md) is that lost work must be *re-queued, not dropped* —
which is exactly what the dead-shard drain + retry/backoff machinery this
module drives was built to guarantee.

A :class:`FaultPlan` is a named, immutable, time-sorted sequence of
:class:`FaultEvent`s over *global* worker ids.  Generators compile the
high-level patterns above into plans, bit-exactly seeded with the same
discipline as ``core.workloads``: every random draw comes from
``numpy.random.default_rng((seed, entity, TAG))`` — a pure function of the
arguments, so a plan is as replayable as the workload it runs against.

``FaultPlan.apply(target)`` walks the events onto any object exposing the
inject hooks — a single ``Simulator``, the sharded driver, or the admission
tier (``AdmissionSimulator`` additionally understands ``notice`` events:
policies see doomed-but-alive workers through ``ShardState.doomed_workers``
before the kill lands).  Validation stays where it lives: the engine's
``begin()`` rejects events past the run deadline or failures of workers
that never exist, so a plan that doesn't fit its run fails loudly.

What happens *after* the plan fires is the failure/recovery contract of
docs/ARCHITECTURE.md §10: capped-backoff retries with a per-task budget
(``SimConfig.retry_backoff`` / ``retry_max_delay_s`` / ``retry_budget``),
dead-shard salvage with exactly-once conservation
(``core.stealing.drain_tick``), and the failure telemetry columns on
``RunMetrics`` (``benchmarks/bench_chaos.py`` scores every registered
admission policy under these plans).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .shard import split_even

__all__ = [
    "FaultEvent",
    "FaultPlan",
    "flappy_workers",
    "rolling_restart",
    "shard_kill_wave",
    "spot_preemption",
]

# per-generator RNG stream tags (the workloads.py discipline: every stream
# is default_rng((seed, entity, TAG)) — disjoint across generators)
_KILL_TAG = 0xFA11
_SPOT_TAG = 0x5B07
_FLAP_TAG = 0xF1A9

#: event-kind ordering at equal time: a notice precedes the kill it warns
#: about, and an add at the same instant as a fail is processed after it
#: (revival semantics — the engine heap breaks ties by push order, and
#: ``apply`` pushes in plan order)
_KIND_ORDER = {"notice": 0, "fail": 1, "add": 2}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault-plan event on a *global* worker id.

    ``kind`` is one of:

    * ``"fail"`` — the worker dies at ``t`` (``inject_failure``);
    * ``"add"`` — a worker with this id joins (or rejoins) at ``t``
      (``inject_worker``);
    * ``"notice"`` — a preemption warning: the worker is still alive but
      will be killed at ``until`` (spot semantics).  Targets without a
      ``inject_notice`` hook ignore notices — they are advisory signal for
      admission policies, never load-bearing for correctness.
    """

    t: float
    kind: str
    worker: int
    until: Optional[float] = None  # notice only: the scheduled kill time

    def __post_init__(self):
        if self.kind not in _KIND_ORDER:
            raise ValueError(
                f"unknown FaultEvent kind {self.kind!r}; expected one of "
                f"{sorted(_KIND_ORDER)}"
            )
        if self.t < 0:
            raise ValueError(f"FaultEvent.t must be >= 0, got {self.t}")
        if self.worker < 0:
            raise ValueError(f"FaultEvent.worker must be >= 0, got {self.worker}")
        if self.kind == "notice" and (self.until is None or self.until < self.t):
            raise ValueError(
                f"notice events need until >= t, got t={self.t} until={self.until}"
            )


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A named, immutable, time-sorted schedule of :class:`FaultEvent`s.

    Construction sorts events by ``(t, kind order, worker)`` — notice before
    fail before add at equal times — so two plans built from the same events
    in any order are equal and apply identically.  Plans compose with ``+``
    (events merged, re-sorted).
    """

    name: str
    events: Tuple[FaultEvent, ...]

    def __init__(self, name: str, events: Iterable[FaultEvent]):
        object.__setattr__(self, "name", str(name))
        ordered = tuple(
            sorted(events, key=lambda e: (e.t, _KIND_ORDER[e.kind], e.worker))
        )
        object.__setattr__(self, "events", ordered)

    def __len__(self) -> int:
        return len(self.events)

    def __add__(self, other: "FaultPlan") -> "FaultPlan":
        return FaultPlan(f"{self.name}+{other.name}", self.events + other.events)

    @property
    def horizon(self) -> float:
        """Latest event time (0.0 for an empty plan) — the plan must fit
        inside the run deadline or the engine's ``begin()`` rejects it."""
        out = 0.0
        for e in self.events:
            tt = e.t if e.until is None else e.until
            if tt > out:
                out = tt
        return out

    def apply(self, target) -> "FaultPlan":
        """Walk the plan onto ``target``'s inject hooks and return ``self``.

        ``target`` is anything with ``inject_failure``/``inject_worker``
        (``Simulator``, ``ShardedSimulator``, ``AdmissionSimulator``);
        ``notice`` events go to ``inject_notice(t, worker, until)`` when the
        target has it and are dropped otherwise (advisory only).
        """
        notice = getattr(target, "inject_notice", None)
        for e in self.events:
            if e.kind == "fail":
                target.inject_failure(e.t, e.worker)
            elif e.kind == "add":
                target.inject_worker(e.t, e.worker)
            elif notice is not None:
                notice(e.t, e.worker, e.until)
        return self


def _shard_workers(n_shards: int, n_workers: int, shard: int) -> range:
    """Global worker ids of shard ``shard`` under the even partition the
    sharded driver and admission tier both use (``split_even``)."""
    split = split_even(n_workers, n_shards)
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} out of range [0, {n_shards})")
    lo = sum(split[:shard])
    return range(lo, lo + split[shard])


def shard_kill_wave(
    n_shards: int,
    n_workers: int,
    shards: Sequence[int],
    t_kill: float,
    stagger_s: float = 0.0,
    jitter_s: float = 0.0,
    seed: int = 0,
) -> FaultPlan:
    """Correlated shard failure: every worker of each listed shard dies.

    The canonical "rack loses power" pattern — the one that strands queued
    work without dead-shard salvage.  Shard ``shards[i]``'s workers all die
    at ``t_kill + i * stagger_s``, each perturbed by an independent
    ``uniform(0, jitter_s)`` drawn from ``default_rng((seed, shard, worker,
    _KILL_TAG))`` (0 jitter: a perfectly correlated instant).  Workers are
    mapped through the same even partition the admission tier uses, so
    "shard k" here is shard k of an ``AdmissionSimulator(n_shards,
    n_workers)``.
    """
    if t_kill < 0 or stagger_s < 0 or jitter_s < 0:
        raise ValueError("t_kill, stagger_s and jitter_s must be >= 0")
    events: List[FaultEvent] = []
    for i, k in enumerate(shards):
        base = t_kill + i * stagger_s
        for w in _shard_workers(n_shards, n_workers, k):
            t = base
            if jitter_s > 0:
                rng = np.random.default_rng((seed, k, w, _KILL_TAG))
                t = base + float(rng.uniform(0.0, jitter_s))
            events.append(FaultEvent(t=t, kind="fail", worker=w))
    return FaultPlan(f"shard_kill_wave[{','.join(map(str, shards))}]", events)


def spot_preemption(
    n_workers: int,
    n_waves: int,
    wave_size: int,
    t0: float,
    t1: float,
    notice_s: float = 2.0,
    replace_after_s: Optional[float] = None,
    seed: int = 0,
) -> FaultPlan:
    """Spot-instance preemption waves with a notice window.

    ``n_waves`` waves land at times drawn ``uniform(t0, t1)`` from
    ``default_rng((seed, wave, _SPOT_TAG))``; each wave preempts
    ``wave_size`` distinct workers sampled without replacement from the
    fleet.  Every victim gets a ``notice`` event ``notice_s`` before its
    kill (the cloud's two-minute warning, scaled) — admission policies see
    it as ``ShardState.doomed_workers`` — then the ``fail``.  With
    ``replace_after_s`` set, a replacement with the same id joins that many
    seconds after the kill (the autoscaler refilling capacity).
    """
    if not 0 <= t0 <= t1:
        raise ValueError(f"need 0 <= t0 <= t1, got t0={t0} t1={t1}")
    if wave_size < 1 or wave_size > n_workers:
        raise ValueError(f"wave_size must be in [1, {n_workers}], got {wave_size}")
    if notice_s < 0:
        raise ValueError("notice_s must be >= 0")
    events: List[FaultEvent] = []
    for wave in range(n_waves):
        rng = np.random.default_rng((seed, wave, _SPOT_TAG))
        t_hit = float(rng.uniform(t0, t1))
        victims = rng.choice(n_workers, size=wave_size, replace=False)
        t_notice = max(0.0, t_hit - notice_s)
        for w in sorted(int(v) for v in victims):
            events.append(FaultEvent(t=t_notice, kind="notice", worker=w, until=t_hit))
            events.append(FaultEvent(t=t_hit, kind="fail", worker=w))
            if replace_after_s is not None:
                events.append(
                    FaultEvent(t=t_hit + replace_after_s, kind="add", worker=w)
                )
    return FaultPlan(f"spot_preemption[{n_waves}x{wave_size}]", events)


def rolling_restart(
    n_workers: int,
    t0: float,
    downtime_s: float,
    stagger_s: float,
    batch: int = 1,
) -> FaultPlan:
    """Deterministic rolling restart: batches of workers cycle down and up.

    Worker ``w`` fails at ``t0 + (w // batch) * stagger_s`` and rejoins
    ``downtime_s`` later — the deploy pattern where capacity dips by
    ``batch`` workers at a time and every task on a restarting worker takes
    the retry path.  No randomness: a restart schedule is operator-chosen,
    not stochastic.
    """
    if downtime_s <= 0 or stagger_s < 0 or batch < 1 or t0 < 0:
        raise ValueError(
            "need downtime_s > 0, stagger_s >= 0, batch >= 1, t0 >= 0"
        )
    events: List[FaultEvent] = []
    for w in range(n_workers):
        t_down = t0 + (w // batch) * stagger_s
        events.append(FaultEvent(t=t_down, kind="fail", worker=w))
        events.append(FaultEvent(t=t_down + downtime_s, kind="add", worker=w))
    return FaultPlan(f"rolling_restart[b{batch}]", events)


def flappy_workers(
    workers: Sequence[int],
    duration_s: float,
    mtbf_s: float,
    mttr_s: float,
    t0: float = 0.0,
    seed: int = 0,
) -> FaultPlan:
    """Flappy workers: independent crash/repair renewal processes.

    Each listed worker alternates alive/dead phases with exponential
    durations — mean ``mtbf_s`` up, mean ``mttr_s`` down — drawn in
    sequence from its own stream ``default_rng((seed, worker, _FLAP_TAG))``,
    truncated at ``duration_s``.  The classic gray-failure workload: no
    shard ever dies outright, but retries and scheduler-view churn never
    stop either.
    """
    if mtbf_s <= 0 or mttr_s <= 0:
        raise ValueError("mtbf_s and mttr_s must be > 0")
    if t0 < 0 or duration_s <= t0:
        raise ValueError(f"need 0 <= t0 < duration_s, got t0={t0}")
    events: List[FaultEvent] = []
    for w in workers:
        rng = np.random.default_rng((seed, int(w), _FLAP_TAG))
        t = t0
        while True:
            t += float(rng.exponential(mtbf_s))
            if t >= duration_s:
                break
            events.append(FaultEvent(t=t, kind="fail", worker=int(w)))
            t += float(rng.exponential(mttr_s))
            if t >= duration_s:
                break
            events.append(FaultEvent(t=t, kind="add", worker=int(w)))
    return FaultPlan(f"flappy[{len(list(workers))}]", events)
