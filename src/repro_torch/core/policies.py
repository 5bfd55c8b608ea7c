"""Pluggable admission-policy registry: "add a policy" as a registry entry.

A copy of the JAX package's ``core/policies.py`` (pure Python and numpy, no
JAX): the port keeps its own so that it imports nothing from ``repro``.

The global admission tier (``core.admission``) started life with one
hard-wired behavior — watermark pull — and two literals bolted beside it
(``round_robin``, ``pull+steal``).  This module turns the policy choice into
a first-class extension point:

* :class:`AdmissionPolicy` is the author-facing protocol: a policy sees the
  co-run only through :class:`ShardState` snapshots and the
  :class:`PolicyContext` mediator, and decides **which shard pulls next**
  (``rank_shards``), **whether a shard may pull right now** (``want_pull``),
  and — optionally — **which queued VU is admitted first**
  (``orders_queue`` + ``queue_key``).
* :func:`register_policy` / :func:`unregister_policy` /
  :func:`available_policies` / :func:`make_policy` are the registry.
  ``AdmissionConfig`` validates its ``policy`` field against it, so a typo
  fails at config construction with the available list in the message.

The three pre-registry behaviors are ported onto the protocol **byte
identically** (``pull``, ``round_robin``, ``pull+steal`` — the admission and
stealing suites pass unmodified), and three new policies ship against it:

* ``deadline`` — EDF: the global queue is ordered by absolute deadline
  (arrival + per-VU relative deadline from the workload metadata), so during
  a backlog the most urgent VUs are admitted first, while shard selection
  stays pressure-ordered.  Kaffes et al. (*Practical Scheduling for
  Real-World Serverless Computing*) motivate deadline-awareness under
  realistic arrival mixes; ``RunMetrics.deadline_miss_rate`` scores it.
* ``cost`` — cold-start-cost-aware pull: each shard's pressure is inflated
  by its *lack* of warm capacity (``Simulator.warm_capacity``), so shards
  whose sandbox pools are pinned by running work — the ones that would
  cold-start or queue a new VU — pull less, and warm shards soak up
  arrivals first.
* ``predictive`` — a cheap MPC-flavored baseline (Nguyen et al., *Taming
  Cold Starts with Model Predictive Control*): an EWMA forecast of the
  arrival rate modulates the pull watermark, so shards pre-drain the queue
  ahead of a building burst instead of reacting one tick late.
* ``affinity`` / ``affinity+steal`` — warm-locality routing: shards are
  scored by expected warm-hit probability × pressure against their
  per-function warm-set digest (``Simulator.warm_digest`` via
  ``ShardState.warm_digest``), the KV-router analog; the ``+steal`` variant
  also runs the steal round warm-locality-aware (thieves prefer tasks they
  can serve warm).

Three **learned** policies carry online state fed
exclusively through :meth:`AdmissionPolicy.observe` (``core.estimators``
holds the state machinery; :class:`LearnedPolicy` the windowed
fold/record/replay discipline):

* ``sjf`` — shortest-predicted-job-first: the global queue is ordered by
  each VU's predicted total service time from an online per-function
  Welford duration estimator (Przybylski et al.'s execution-time-aware
  scheduling, learned on the fly).
* ``bandit`` / ``bandit+steal`` — a bandit meta-policy (UCB1 or seeded
  epsilon-greedy) tuning the pull watermark — and, in the ``+steal``
  variant, the (steal, pull) watermark pair — per scenario from a windowed
  reward blending window p99 and cold rate (Nguyen et al.'s adaptive
  thresholds, model-free).

Determinism contract (normative; docs/POLICIES.md is the author guide):
policy decisions must be a pure function of the visible state — the
:class:`ShardState` fields, the policy's own config, and what it has
observed through :meth:`AdmissionPolicy.observe`.  No wall clock, no global
RNG: two runs with identical inputs must admit identical sequences
(``tests/test_policies.py`` pins determinism for every registered policy).
"""

from __future__ import annotations

import dataclasses
import heapq
import inspect
import types
from collections import deque
from typing import (
    Dict,
    List,
    Mapping,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
    Type,
)

from .estimators import BanditTuner, DurationEstimator

__all__ = [
    "AdmissionPolicy",
    "AffinityPolicy",
    "AffinityStealPolicy",
    "BanditPolicy",
    "BanditStealPolicy",
    "Completion",
    "CostPolicy",
    "DeadlinePolicy",
    "LearnedPolicy",
    "PolicyContext",
    "PredictivePolicy",
    "PullPolicy",
    "PullStealPolicy",
    "RoundRobinPolicy",
    "ShardState",
    "SjfPolicy",
    "available_policies",
    "make_policy",
    "policy_knobs",
    "register_policy",
    "unregister_policy",
]


class Completion(NamedTuple):
    """One completed request, as seen by the policy-facing completion feed
    (:meth:`PolicyContext.new_completions`).

    ``duration_ms`` is the externally observable request latency
    (``(t_done - t_submit) * 1e3`` — the same arithmetic the metrics layer
    uses), ``gid`` the global VU id, ``shard`` the shard it completed on.
    """

    gid: int
    func: int
    duration_ms: float
    cold: bool
    shard: int


@dataclasses.dataclass(frozen=True)
class ShardState:
    """The per-shard snapshot a policy may read — nothing else.

    Policies never touch ``Simulator`` objects directly: the admission tier
    builds these snapshots each tick, which is what keeps a policy's
    decision surface explicit, serializable, and stable across engine
    refactors (the policy-author contract in docs/POLICIES.md).

    Attributes:
        index: shard index in ``[0, n_shards)``.
        pressure: the shard's *effective* pressure — ``Simulator.pressure()``
            at tick start plus ``inv_workers`` per VU already bound this tick
            (``inf`` for a dead shard: all workers failed).
        n_workers: the shard's planned worker count (the partition's split,
            not the live count).
        inv_workers: ``1 / n_workers`` — the effective-pressure increment
            one admitted VU costs.
        warm_capacity: fraction of the shard's sandbox-pool memory not
            pinned by running tasks, in ``[0, 1]`` (``Simulator
            .warm_capacity()``); 0.0 for a dead shard.  High values mean new
            work can start warm or cold-start without queueing.  Populated
            by the default ``admit_tick`` only when the policy sets
            ``uses_warm_capacity = True`` (it costs an O(workers) scan per
            shard per tick); otherwise ``nan`` — reading it without the
            flag makes every comparison False, so the mistake is loud
            (nothing admits) instead of silently wrong.
        tick_pulls: VUs this shard has already pulled in the current tick.
        t: simulated time of the tick, seconds.
        resubmits: failure-retry pushes this shard's engine has performed
            so far — the churn signal (0 on fault-free runs).  Cumulative,
            so policies that want a rate difference ticks themselves.
        lost_tasks: requests this shard has dropped after exhausting the
            retry budget (``SimConfig.retry_budget``), cumulative.
        doomed_workers: live workers under a preemption notice right now
            (``AdmissionSimulator.inject_notice`` /
            ``chaos.spot_preemption``): still serving, scheduled to die.
            Advisory — a policy may shed load from a doomed shard early,
            but correctness never depends on it.
        warm_digest: the shard's per-function warm-set digest — a read-only
            ``{func_index: warm_instance_count}`` mapping over live,
            un-doomed workers (``Simulator.warm_digest``; functions with no
            warm instance are absent).  Populated by the default
            ``admit_tick`` only when the policy sets ``uses_warm_digest =
            True``; otherwise ``None``, so an undeclared read fails loudly
            (``AttributeError``/``TypeError``) instead of silently scoring
            everything cold.  The digest contract is normative in
            docs/ARCHITECTURE.md §11.

    The three failure fields default to 0 and are documented normatively in
    docs/POLICIES.md §2 and docs/ARCHITECTURE.md §10.
    """

    index: int
    pressure: float
    n_workers: int
    inv_workers: float
    warm_capacity: float
    tick_pulls: int
    t: float
    resubmits: int = 0
    lost_tasks: int = 0
    doomed_workers: int = 0
    warm_digest: Optional[Mapping[int, int]] = None


class PolicyContext:
    """Mediator between the admission loop and a policy.

    Owns the global waiting queue (FIFO deque, or a priority heap when the
    policy sets ``orders_queue``) and performs the actual binding
    (:meth:`admit_next`) with the admission tier's bookkeeping — policies
    choose, the context executes.  Policies may call only the documented
    read methods and :meth:`admit_next`.
    """

    def __init__(
        self,
        sims: Sequence,
        programs: Sequence,
        worker_split: Sequence[int],
        inv_workers: Sequence[float],
        admitted: List[List[int]],
        admit_t: List[List[float]],
        pulls: List[int],
        policy: "AdmissionPolicy",
        arrivals=None,
        deadlines=None,
    ):
        self.sims = sims
        self.programs = programs
        self.worker_split = list(worker_split)
        self.inv_workers = list(inv_workers)
        self.admitted = admitted
        self.admit_t = admit_t
        self.pulls = pulls
        self.policy = policy
        self._arrivals = arrivals
        self._deadlines = deadlines
        self.total_workers = sum(self.worker_split)
        #: the run's ShardCoordinator (set by the admission loop).  When
        #: present, the default ``admit_tick`` consumes its persistent
        #: pressure heap instead of rebuilding one per tick — byte-identical
        #: decisions at O(dirty) coordination cost (docs/ARCHITECTURE.md
        #: §13).  ``None`` under direct PolicyContext construction (tests).
        self.coord = None
        # FIFO deque by default; a min-heap of (queue_key, arrival_seq, gid)
        # when the policy orders the queue (EDF et al.)
        self._ordered = bool(policy.orders_queue)
        self.waiting = [] if self._ordered else deque()
        self._seq = 0
        # per-shard doomed-worker counts (preemption notices); the admission
        # loop refreshes this each tick when a fault plan carries notices
        self.doomed: List[int] = [0] * len(sims)
        # per-VU function-frequency profiles, computed lazily (func_profile)
        self._profiles: Dict[int, Tuple[Tuple[int, float], ...]] = {}
        # completion-feed cursors: rows of each shard's record accumulator
        # already handed out through new_completions()
        self._rec_seen: List[int] = [0] * len(sims)

    # ------------------------------------------------------------- queue
    @property
    def n_shards(self) -> int:
        return len(self.sims)

    @property
    def waiting_n(self) -> int:
        """Eligible-but-unadmitted VUs currently in the global queue."""
        return len(self.waiting)

    def enqueue(self, gid: int) -> None:
        """Move an eligible arrival into the global queue (tier-internal)."""
        if self._ordered:
            heapq.heappush(
                self.waiting, (self.policy.queue_key(gid, self), self._seq, gid)
            )
            self._seq += 1
        else:
            self.waiting.append(gid)

    def peek_next(self) -> int:
        """Global VU id the next :meth:`admit_next` call would bind."""
        return self.waiting[0][2] if self._ordered else self.waiting[0]

    # ---------------------------------------------------- workload metadata
    def arrival_of(self, gid: int) -> float:
        """The VU's admission-eligibility time (seconds; 0.0 if untimed)."""
        return 0.0 if self._arrivals is None else float(self._arrivals[gid])

    def deadline_of(self, gid: int) -> float:
        """The VU's *relative* latency deadline (seconds; ``inf`` if none).

        Workloads without deadline metadata read ``inf`` for every VU, which
        makes deadline-ordered queues degrade to FIFO (arrival order breaks
        the tie) — a deadline policy on an unannotated workload behaves like
        plain pull.
        """
        if self._deadlines is None:
            return float("inf")
        return float(self._deadlines[gid])

    def func_profile(self, gid: int) -> Tuple[Tuple[int, float], ...]:
        """VU ``gid``'s function-call mix as ``((func_index, frequency),
        ...)`` sorted by function index, frequencies summing to 1.0.

        The locality key affinity scoring matches against a shard's
        ``warm_digest``.  Pure function of the workload (the VU's program),
        cached per VU, so repeated reads inside a tick are O(1); an empty
        program yields ``()``.
        """
        prof = self._profiles.get(gid)
        if prof is None:
            fi = self.programs[gid].func_idx
            n = len(fi)
            if n == 0:
                prof = ()
            else:
                counts: Dict[int, int] = {}
                for f in fi.tolist():
                    counts[f] = counts.get(f, 0) + 1
                prof = tuple(
                    (f, c / n) for f, c in sorted(counts.items())
                )
            self._profiles[gid] = prof
        return prof

    # ------------------------------------------------------ completion feed
    def new_completions(self) -> List[Completion]:
        """Requests completed since the last call, exactly once each, in
        canonical order (shard index, then per-shard completion order).

        This is the **only** sanctioned signal source for learned policy
        state (docs/POLICIES.md "Learned state"): the admission loop calls
        ``observe`` once per tick before admission, so a policy that drains
        this feed there sees every completion exactly once, in an order
        that is a pure function of the run — the property replay needs.
        Each record lives on exactly one shard's accumulator (a salvaged
        VU's later requests complete on its *new* shard, under a fresh
        local id already present in the admission table), so per-shard
        cursors cannot double-count across migrations or salvage.
        """
        out: List[Completion] = []
        for k, sim in enumerate(self.sims):
            acc = sim._rec  # the engine's columnar accumulator (mediator-only)
            n = len(acc)
            i = self._rec_seen[k]
            if n <= i:
                continue
            ts, td = acc.t_submit, acc.t_done
            fn, cold, vu = acc.func, acc.cold, acc.vu
            adm = self.admitted[k]
            for j in range(i, n):
                out.append(
                    Completion(
                        gid=adm[vu[j]],
                        func=fn[j],
                        duration_ms=(td[j] - ts[j]) * 1e3,
                        cold=cold[j],
                        shard=k,
                    )
                )
            self._rec_seen[k] = n
        return out

    # ------------------------------------------------------------- binding
    def admit_next(self, k: int, t: float) -> int:
        """Bind the queue head to shard ``k`` at time ``t``; returns the
        global VU id.  Performs the engine call (``admit_vu``) and all
        admission-table bookkeeping."""
        if self._ordered:
            gid = heapq.heappop(self.waiting)[2]
        else:
            gid = self.waiting.popleft()
        local = self.sims[k].admit_vu(self.programs[gid], t=t)
        assert local == len(self.admitted[k])
        self.admitted[k].append(gid)
        self.admit_t[k].append(t)
        self.pulls[k] += 1
        return gid

    # -------------------------------------------------------------- shards
    def shard_state(
        self, k: int, t: float, pressure: Optional[float] = None,
        warm: Optional[float] = None, tick_pulls: int = 0,
        digest: Optional[Mapping[int, int]] = None,
    ) -> ShardState:
        sim = self.sims[k]
        return ShardState(
            index=k,
            pressure=sim.pressure() if pressure is None else pressure,
            n_workers=self.worker_split[k],
            inv_workers=self.inv_workers[k],
            warm_capacity=(
                sim.warm_capacity() if warm is None else warm
            ),
            tick_pulls=tick_pulls,
            t=t,
            resubmits=getattr(sim, "resubmits", 0),
            lost_tasks=getattr(sim, "lost_tasks", 0),
            doomed_workers=self.doomed[k],
            # read-only view: the snapshot stays frozen end to end even
            # though the underlying digest is a plain dict
            warm_digest=(
                None if digest is None else types.MappingProxyType(digest)
            ),
        )


class AdmissionPolicy:
    """Base class / protocol for admission policies (the author contract).

    Subclass, set ``name``, override the hooks you need, and register:

    * :meth:`want_pull` — may this shard bind the next queued VU *right
      now*?  Called with the shard's live :class:`ShardState` before every
      single binding.  Default: effective pressure below the config
      watermark (the original pull behavior).
    * :meth:`rank_shards` — the tick's shard ordering, as ``(key, index)``
      min-heap entries; the lowest key pulls first, and every pull bumps
      the shard's key by ``inv_workers`` (the admission tier's
      effective-pressure accounting).  Default: pressure-ordered.
    * ``orders_queue`` + :meth:`queue_key` — opt into a priority-ordered
      global queue (lowest key admitted first; arrival order breaks ties).
      Default off: FIFO.
    * :meth:`observe` — per-tick telemetry feed (new-arrival count) for
      forecasting policies; called once per tick *before* admission.
    * ``steals`` — class flag: run ``core.stealing.steal_tick`` after
      admission each tick (the ``pull+steal`` composition).

    Policies are instantiated fresh per run (``make_policy``), so instance
    attributes are run-local state; determinism obligations are spelled out
    in docs/POLICIES.md.
    """

    #: registry key; subclasses must override.
    name: str = ""
    #: run cross-shard work stealing after each admission tick.
    steals: bool = False
    #: order the global queue by :meth:`queue_key` instead of FIFO.
    orders_queue: bool = False
    #: have ``admit_tick`` populate ``ShardState.warm_capacity`` (an extra
    #: O(workers) scan per shard per tick; without the flag the field is
    #: ``nan``).  Set it whenever a hook reads the warm-capacity signal.
    uses_warm_capacity: bool = False
    #: have ``admit_tick`` populate ``ShardState.warm_digest`` (one
    #: ``Simulator.warm_digest()`` snapshot per shard per tick; without the
    #: flag the field is ``None``).  Set it whenever a hook reads the
    #: per-function warm-set digest.
    uses_warm_digest: bool = False
    #: with ``steals``: run the per-tick steal round warm-locality-aware
    #: (``core.stealing.steal_tick(prefer_warm=True)`` — each thief prefers
    #: exporting tasks whose function is in its own warm digest).  Inert
    #: without ``steals``; off keeps steal schedules byte-identical to the
    #: pre-digest tier.
    steal_affinity: bool = False
    #: policy carries learned (observation-fed) state subject to the
    #: snapshot/replay contract in docs/POLICIES.md "Learned state".
    #: Set by :class:`LearnedPolicy`; informational for everything else.
    learned: bool = False

    def __init__(self, cfg, **kwargs):
        """``cfg`` is the run's ``AdmissionConfig``; extra ``kwargs`` come
        from ``AdmissionConfig.policy_args`` (policy-specific knobs)."""
        self.cfg = cfg
        if kwargs:
            bad = ", ".join(repr(k) for k in sorted(kwargs))
            accepted = policy_knobs(type(self))
            raise TypeError(
                f"{type(self).__name__} got unknown policy_args key(s) {bad}; "
                f"accepted knobs: {accepted if accepted else '(none)'}"
            )

    # ----------------------------------------------------------- the hooks
    def queue_key(self, gid: int, ctx: PolicyContext) -> float:
        """Priority of VU ``gid`` in the global queue (lower = sooner);
        only consulted when ``orders_queue`` is set."""
        return 0.0

    def want_pull(self, state: ShardState) -> bool:
        """May this shard bind the next queued VU right now?"""
        return state.pressure < self.cfg.watermark

    def rank_shards(self, states: Sequence[ShardState]) -> List[Tuple[float, int]]:
        """Min-heap entries ``(key, shard_index)``; lowest key pulls first."""
        return [(s.pressure, s.index) for s in states]

    def observe(self, t: float, n_new: int, ctx: PolicyContext) -> None:
        """Per-tick feed: ``n_new`` VUs became eligible at time ``t``.

        Called once per tick *before* admission; also the only hook from
        which learned state may be updated (drain
        :meth:`PolicyContext.new_completions` here — see
        :class:`LearnedPolicy` and docs/POLICIES.md "Learned state")."""

    def steal_params(self) -> Tuple[float, float]:
        """``(steal_watermark, pull_watermark)`` for this tick's steal round
        (consulted only when ``steals`` is set).  Default: the static
        config pair — byte-identical to the pre-hook tier.  Learned
        stealing policies (``bandit+steal``) override this to tune the
        hysteresis band per reward window; implementations must keep
        ``steal_watermark >= pull_watermark`` (the no victim-and-thief
        invariant ``AdmissionConfig`` enforces for the static pair)."""
        return (self.cfg.steal_watermark, self.cfg.watermark)

    # ------------------------------------------------------------ the tick
    def admit_tick(self, t: float, ctx: PolicyContext) -> None:
        """One admission round: bind queued VUs to shards until every shard
        declines (``want_pull``) or the queue / per-shard batch cap empties.

        The default is the admission tier's pressure-keyed heap — the
        cluster-level ``PQ_f`` — parameterized by :meth:`rank_shards` and
        :meth:`want_pull`, with the ``1/n_workers`` effective-pressure
        accounting per binding.  Policies that aren't heap-shaped
        (``round_robin``) override the whole tick.

        When the admission loop supplies a ``ShardCoordinator``
        (``ctx.coord``) and the policy keeps the default pressure ranking
        with no warm-signal snapshots, the tick runs against the
        coordinator's *persistent* lazy-deletion heap instead of rebuilding
        a K-entry heap from live engine reads — byte-identical decisions
        (the valid-entry multiset equals the rebuilt heap's; see
        docs/ARCHITECTURE.md §13) at O(dirty) coordination cost.
        """
        if (
            ctx.coord is not None
            and type(self).rank_shards is AdmissionPolicy.rank_shards
            and not self.uses_warm_capacity
            and not self.uses_warm_digest
        ):
            self._admit_tick_incremental(t, ctx)
            return
        cfg = self.cfg
        inv = ctx.inv_workers
        K = ctx.n_shards
        eff = [ctx.sims[k].pressure() for k in range(K)]
        if self.uses_warm_capacity:
            warm = [ctx.sims[k].warm_capacity() for k in range(K)]
        else:  # unrequested: nan, so an undeclared read fails loudly
            warm = [float("nan")] * K
        if self.uses_warm_digest:
            digests = [ctx.sims[k].warm_digest() for k in range(K)]
        else:  # unrequested: None, so an undeclared read fails loudly
            digests = [None] * K
        tick_pulls = [0] * K

        def state(k: int) -> ShardState:
            return ctx.shard_state(
                k, t, pressure=eff[k], warm=warm[k], tick_pulls=tick_pulls[k],
                digest=digests[k],
            )

        heap = self.rank_shards([state(k) for k in range(K)])
        for key, k in heap:
            if key != key:  # NaN: poisons every heap comparison silently
                raise ValueError(
                    f"{type(self).__name__}.rank_shards returned a NaN key "
                    f"for shard {k}. NaN compares False against everything, "
                    "so a NaN-keyed heap silently freezes admission. Most "
                    "likely the key reads ShardState.warm_capacity without "
                    "setting uses_warm_capacity = True (the field is nan "
                    "otherwise; see docs/POLICIES.md §2)."
                )
        heapq.heapify(heap)
        while ctx.waiting_n and heap:
            key, k = heap[0]
            if not self.want_pull(state(k)):
                heapq.heappop(heap)  # shard declines: done for this tick
                continue
            ctx.admit_next(k, t)
            eff[k] += inv[k]
            tick_pulls[k] += 1
            if cfg.batch_size is not None and tick_pulls[k] >= cfg.batch_size:
                heapq.heappop(heap)  # per-shard cap reached this tick
            else:
                heapq.heapreplace(heap, (key + inv[k], k))

    def _admit_tick_incremental(self, t: float, ctx: PolicyContext) -> None:
        """The default admission round against the coordinator's persistent
        heap (``ctx.coord``) — the O(dirty) twin of the rebuild loop above.

        Correspondence with the rebuild loop, entry by entry: at tick start
        every shard holds exactly one valid entry keyed at its cached
        pressure — the same multiset the rebuild heapifies, because a shard
        whose pressure changed was dirty and ``refresh()`` pushed a
        superseding entry.  An admission replaces the shard's entry at
        ``key + inv`` (the rebuild's ``heapreplace``); a decline or a
        batch-cap pop *parks* the shard — its entry is removed for the rest
        of the tick, exactly like the rebuild's ``heappop`` — and parked
        shards are re-posted at their cached base pressure when the tick
        ends, so next tick starts from the full multiset again.  (A parked
        shard that admitted this tick is dirty, so the re-post is
        superseded by the next ``refresh()`` before anyone reads it.)
        """
        cfg = self.cfg
        coord = ctx.coord
        inv = ctx.inv_workers
        tick_pulls: Dict[int, int] = {}
        nan = float("nan")  # warm signals unrequested on this path

        parked: List[int] = []
        try:
            while ctx.waiting_n:
                top = coord.peek()
                if top is None:
                    break  # every shard declined or capped this tick
                key, k = top
                state = ctx.shard_state(
                    k, t, pressure=key, warm=nan,
                    tick_pulls=tick_pulls.get(k, 0), digest=None,
                )
                if not self.want_pull(state):
                    coord.pop()  # shard declines: done for this tick
                    parked.append(k)
                    continue
                ctx.admit_next(k, t)
                pulls = tick_pulls.get(k, 0) + 1
                tick_pulls[k] = pulls
                coord.pop()
                if cfg.batch_size is not None and pulls >= cfg.batch_size:
                    parked.append(k)  # per-shard cap reached this tick
                else:
                    coord.push(key + inv[k], k)
        finally:
            for k in parked:
                coord.push(coord.pressure[k], k)


# --------------------------------------------------------------- registry
_REGISTRY: Dict[str, Type[AdmissionPolicy]] = {}


def register_policy(cls: Type[AdmissionPolicy]) -> Type[AdmissionPolicy]:
    """Register an :class:`AdmissionPolicy` subclass under ``cls.name``.

    Usable as a decorator.  Re-registering a taken name raises — call
    :func:`unregister_policy` first (tests do exactly this round-trip).
    """
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty `name`")
    if cls.name in _REGISTRY and _REGISTRY[cls.name] is not cls:
        raise ValueError(f"admission policy {cls.name!r} is already registered")
    _REGISTRY[cls.name] = cls
    return cls


def unregister_policy(name: str) -> Type[AdmissionPolicy]:
    """Remove (and return) a registered policy; unknown names raise."""
    try:
        return _REGISTRY.pop(name)
    except KeyError:
        raise ValueError(
            f"unknown admission policy {name!r}; registered: "
            f"{sorted(_REGISTRY)}"
        ) from None


def available_policies() -> List[str]:
    """Sorted names of every registered admission policy."""
    return sorted(_REGISTRY)


def get_policy_class(name: str) -> Type[AdmissionPolicy]:
    """Resolve a registered policy class by name (with suggestions)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown admission policy {name!r}; available: "
            f"{available_policies()}"
        ) from None


def make_policy(name: str, cfg, **kwargs) -> AdmissionPolicy:
    """Instantiate a fresh policy for one run (``kwargs`` are policy knobs,
    merged from ``AdmissionConfig.policy_args`` by the admission tier)."""
    return get_policy_class(name)(cfg, **kwargs)


def policy_knobs(cls: Type[AdmissionPolicy]) -> List[str]:
    """The ``policy_args`` keys ``cls`` accepts, sorted.

    Walks the MRO collecting every named ``__init__`` parameter (beyond
    ``self``/``cfg`` and the ``**kwargs`` pass-through), so knobs declared
    anywhere in an inheritance chain — e.g. ``BanditStealPolicy`` knobs
    split across :class:`BanditPolicy` and :class:`LearnedPolicy` — are all
    reported.  ``AdmissionConfig`` uses this to make unknown-knob errors
    name the alternatives."""
    knobs: List[str] = []
    for c in cls.__mro__:
        init = c.__dict__.get("__init__")
        if init is None:
            continue
        try:
            params = inspect.signature(init).parameters
        except (TypeError, ValueError):  # e.g. object.__init__ slot wrapper
            continue
        for name, prm in params.items():
            if name in ("self", "cfg"):
                continue
            if prm.kind in (prm.VAR_KEYWORD, prm.VAR_POSITIONAL):
                continue
            if name not in knobs:
                knobs.append(name)
    return sorted(knobs)


# ------------------------------------------------- the ported three
@register_policy
class PullPolicy(AdmissionPolicy):
    """Watermark pull — the original admission tier behavior, verbatim:
    pressure-ordered shard heap, pull while below ``cfg.watermark``."""

    name = "pull"


@register_policy
class PullStealPolicy(PullPolicy):
    """Pull admission plus per-tick cross-shard work stealing
    (``core.stealing.steal_tick`` runs after every admission round)."""

    name = "pull+steal"
    steals = True


@register_policy
class RoundRobinPolicy(AdmissionPolicy):
    """Bind each eligible arrival to the next shard in cyclic order
    immediately — the arrival-capable static baseline.  Ignores pressure
    entirely; ``batch_size`` still caps bindings per shard per tick."""

    name = "round_robin"

    def __init__(self, cfg, **kwargs):
        super().__init__(cfg, **kwargs)
        self._next = 0  # cyclic cursor, persistent across ticks

    def admit_tick(self, t: float, ctx: PolicyContext) -> None:
        cfg = self.cfg
        # consecutive cyclic slots, so a quota of batch_size * K gives every
        # shard at most batch_size this tick
        quota = (
            ctx.waiting_n if cfg.batch_size is None
            else cfg.batch_size * ctx.n_shards
        )
        while ctx.waiting_n and quota > 0:
            quota -= 1
            k = self._next % ctx.n_shards
            self._next += 1
            ctx.admit_next(k, t)


# ------------------------------------------------- the new three
@register_policy
class DeadlinePolicy(AdmissionPolicy):
    """Earliest-deadline-first admission.

    The global queue is ordered by *absolute* deadline — the VU's arrival
    time plus its relative deadline from the workload metadata
    (``AdmissionSimulator.run(deadlines=...)``; scenario generators in
    ``core.workloads`` produce them) — so during a backlog the most urgent
    VUs bind first, into the uncongested headroom, while slack-rich VUs
    absorb the congested drain.  Shard selection stays pressure-ordered.
    Without deadline metadata every key is ``inf`` and arrival order breaks
    the tie: plain pull.
    """

    name = "deadline"
    orders_queue = True

    def queue_key(self, gid: int, ctx: PolicyContext) -> float:
        return ctx.arrival_of(gid) + ctx.deadline_of(gid)


@register_policy
class CostPolicy(AdmissionPolicy):
    """Cold-start-cost-aware pull.

    Each shard's pull threshold is effectively scaled by its warm capacity:
    the ranking/gating key is ``pressure + cost_weight * (1 -
    warm_capacity)``, so a shard whose sandbox pool is pinned by running
    work — where a new VU would cold-start or queue for memory — looks more
    expensive and pulls less, while warm shards soak up arrivals first.

    ``policy_args``: ``cost_weight`` (pressure-units penalty at zero warm
    capacity; default 0.5).
    """

    name = "cost"
    uses_warm_capacity = True

    def __init__(self, cfg, cost_weight: float = 0.5, **kwargs):
        super().__init__(cfg, **kwargs)
        if cost_weight < 0:
            raise ValueError("cost_weight must be >= 0")
        self.cost_weight = float(cost_weight)

    def _cost(self, s: ShardState) -> float:
        return s.pressure + self.cost_weight * (1.0 - s.warm_capacity)

    def want_pull(self, state: ShardState) -> bool:
        return self._cost(state) < self.cfg.watermark

    def rank_shards(self, states: Sequence[ShardState]) -> List[Tuple[float, int]]:
        return [(self._cost(s), s.index) for s in states]


@register_policy
class AffinityPolicy(AdmissionPolicy):
    """Warm-locality affinity admission — the KV-router analog.

    Pressure-only ranking sends the next VU to the *emptiest* shard even
    when a slightly-busier neighbor already holds warm sandboxes for every
    function the VU calls — trading a queue-free cold start for the warm
    start Hiku's pull principle exists to harvest.  This policy scores each
    candidate shard by **expected warm-hit probability × pressure**, the way
    triton_distributed's KV router scores workers by cache-overlap cost:

    ``key(shard, vu) = pressure − affinity_weight · hit(vu, shard)``

    where ``hit`` blends two warmth signals against the shard's
    ``ShardState.warm_digest``: the fraction of the VU's whole function-call
    mix (``PolicyContext.func_profile``) with at least one warm instance,
    and — weighted by ``first_weight`` — whether the VU's *first* call can
    start warm right now (the one request whose cold/warm fate admission
    decides directly; later calls depend on keep-alive surviving the think
    times).  Lower key pulls first, so warmth is a *discount* on pressure: a
    shard ``affinity_weight`` pressure units busier still wins when it can
    serve the VU fully warm, while a stone-cold shard competes on pressure
    alone.  Because the key depends on *which* VU is at the queue head, the
    tick re-scores shards per binding (O(K) per VU) instead of using the
    per-tick heap; ``want_pull``'s watermark gate and the ``batch_size`` cap
    apply unchanged.

    After each binding the VU's first call optimistically claims one warm
    instance from the chosen shard's (tick-local) digest copy, so a burst
    admitted within one tick spreads over the warm capacity instead of
    dog-piling onto a single warm sandbox.

    ``policy_args``: ``affinity_weight`` (pressure-units discount at a 100%
    warm score; default 1.0) and ``first_weight`` (first-call share of the
    hit blend, in ``[0, 1]``; default 0.5).  The defaults are the
    ``bench_affinity`` acceptance operating point on the 4-shard
    ``heavy_tail``/``diurnal`` protocol.
    """

    name = "affinity"
    uses_warm_digest = True

    def __init__(self, cfg, affinity_weight: float = 1.0,
                 first_weight: float = 0.5, **kwargs):
        super().__init__(cfg, **kwargs)
        if affinity_weight < 0:
            raise ValueError("affinity_weight must be >= 0")
        if not 0.0 <= first_weight <= 1.0:
            raise ValueError("first_weight must be in [0, 1]")
        self.affinity_weight = float(affinity_weight)
        self.first_weight = float(first_weight)

    @staticmethod
    def warm_hit(profile: Sequence[Tuple[int, float]],
                 digest: Optional[Mapping[int, int]]) -> float:
        """Expected warm-hit probability of a VU profile against a shard
        digest: the summed call frequency of profile functions with >= 1
        warm instance, in ``[0, 1]``."""
        if not digest:
            return 0.0
        return sum(freq for f, freq in profile if digest.get(f, 0) > 0)

    def admit_tick(self, t: float, ctx: PolicyContext) -> None:
        cfg = self.cfg
        inv = ctx.inv_workers
        K = ctx.n_shards
        eff = [ctx.sims[k].pressure() for k in range(K)]
        # tick-local digest copies: optimistic claims below must not leak
        # into the engine's own counters
        digests = [dict(ctx.sims[k].warm_digest()) for k in range(K)]
        tick_pulls = [0] * K
        nan = float("nan")  # uses_warm_capacity is unset: field stays nan

        def state(k: int) -> ShardState:
            return ctx.shard_state(
                k, t, pressure=eff[k], warm=nan, tick_pulls=tick_pulls[k],
                digest=digests[k],
            )

        fw = self.first_weight
        while ctx.waiting_n:
            gid = ctx.peek_next()
            prof = ctx.func_profile(gid)
            fi = ctx.programs[gid].func_idx
            f0 = int(fi[0]) if len(fi) else -1
            best_key = best_k = None
            for k in range(K):
                if cfg.batch_size is not None and tick_pulls[k] >= cfg.batch_size:
                    continue
                s = state(k)
                if not self.want_pull(s):
                    continue
                d = digests[k]
                hit = (1.0 - fw) * self.warm_hit(prof, d)
                if fw and d.get(f0, 0) > 0:
                    hit += fw
                key = s.pressure - self.affinity_weight * hit
                if best_key is None or key < best_key:
                    best_key, best_k = key, k
            if best_k is None:
                break  # every shard declined or hit its per-tick cap
            ctx.admit_next(best_k, t)
            eff[best_k] += inv[best_k]
            tick_pulls[best_k] += 1
            if f0 >= 0:  # claim the first call's warm instance, if any
                d = digests[best_k]
                c = d.get(f0, 0)
                if c > 1:
                    d[f0] = c - 1
                elif c:
                    del d[f0]


@register_policy
class AffinityStealPolicy(AffinityPolicy):
    """Affinity admission plus warm-locality work stealing: the per-tick
    steal round runs with ``prefer_warm=True``, so each thief exports the
    newest victim task *whose function it can serve warm* (falling back to
    the plain newest) — the same digest consumed at both tiers."""

    name = "affinity+steal"
    steals = True
    steal_affinity = True


@register_policy
class PredictivePolicy(AdmissionPolicy):
    """EWMA arrival-rate forecast modulating the watermark (cheap MPC).

    Each tick the policy folds the newly eligible arrival count into an
    exponentially weighted moving average; the forecast load — EWMA
    arrivals per tick spread across the cluster's workers, in pressure
    units — is added to the pull watermark.  While a burst builds, shards
    pull *ahead* of it (pre-draining the queue the way a one-step MPC
    controller would); in calm traffic the EWMA decays and the policy
    relaxes back to plain pull.

    ``policy_args``: ``alpha`` (EWMA smoothing in (0, 1]; default 0.3) and
    ``gain`` (forecast-to-watermark coupling; default 1.0).
    """

    name = "predictive"

    def __init__(self, cfg, alpha: float = 0.3, gain: float = 1.0, **kwargs):
        super().__init__(cfg, **kwargs)
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if gain < 0:
            raise ValueError("gain must be >= 0")
        self.alpha = float(alpha)
        self.gain = float(gain)
        self._rate = 0.0  # EWMA of new arrivals per tick
        self._watermark = cfg.watermark

    def observe(self, t: float, n_new: int, ctx: PolicyContext) -> None:
        self._rate += self.alpha * (n_new - self._rate)
        forecast_pressure = self._rate / max(ctx.total_workers, 1)
        self._watermark = self.cfg.watermark + self.gain * forecast_pressure

    def want_pull(self, state: ShardState) -> bool:
        return state.pressure < self._watermark


# ------------------------------------------------- the learned tier
class LearnedPolicy(AdmissionPolicy):
    """Shared machinery for policies with learned state.

    The windowed fold/record/replay discipline (normative in
    docs/POLICIES.md "Learned state"):

    * :meth:`observe` buffers the completion feed
      (:meth:`PolicyContext.new_completions`) every tick; learned state
      mutates **only at window boundaries** — every ``update_every``-th
      tick the buffered window is folded (:meth:`fold`), so between
      boundaries every decision reads a constant state.
    * with ``record_state=True`` the policy appends a full state snapshot
      (:meth:`state_snapshot` — pure JSON types) after each boundary;
      ``AdmissionSimulator.run`` surfaces the list as
      ``AdmissionRun.policy_state``.
    * with ``replay_from=<recorded snapshots>`` the policy **restores** the
      recorded snapshot at each boundary instead of folding.  Because a
      complete snapshot reproduces the recorded post-fold state exactly,
      a replayed run is byte-identical to its recording — which is
      precisely the test that snapshots capture *all* decision-relevant
      state (``tests/test_replay.py`` pins it).

    ``policy_args`` (shared by every learned policy): ``update_every``
    (ticks per window; default 8), ``record_state``, ``replay_from``.
    """

    learned = True

    def __init__(
        self,
        cfg,
        update_every: int = 8,
        record_state: bool = False,
        replay_from: Optional[Sequence[Mapping]] = None,
        **kwargs,
    ):
        super().__init__(cfg, **kwargs)
        if int(update_every) < 1:
            raise ValueError("update_every must be >= 1")
        self.update_every = int(update_every)
        self.record_state = bool(record_state)
        self._replay = None if replay_from is None else list(replay_from)
        #: post-boundary state snapshots (filled when ``record_state``)
        self.snapshots: List[dict] = []
        self._pending: List[Completion] = []
        self._ticks = 0
        self._windows = 0

    def observe(self, t: float, n_new: int, ctx: PolicyContext) -> None:
        self._pending.extend(ctx.new_completions())
        self._ticks += 1
        if self._ticks % self.update_every == 0:
            self._advance_window()

    def _advance_window(self) -> None:
        w = self._windows
        self._windows += 1
        if self._replay is not None:
            if w >= len(self._replay):
                raise IndexError(
                    f"replay_from carries {len(self._replay)} snapshots but "
                    f"the run reached window {w} — a replay must share the "
                    "recording's workload, duration and update_every"
                )
            self.restore_state(self._replay[w])
        else:
            self.fold(tuple(self._pending))
        self._pending.clear()
        if self.record_state:
            self.snapshots.append(self.state_snapshot())

    # ---------------------------------------------- subclass obligations
    def fold(self, completions: Tuple[Completion, ...]) -> None:
        """Fold one window of completions into the learned state."""
        raise NotImplementedError

    def state_snapshot(self) -> dict:
        """Full learned state as pure JSON types (the snapshot contract)."""
        raise NotImplementedError

    def restore_state(self, snap: Mapping) -> None:
        """Replace learned state with a recorded snapshot."""
        raise NotImplementedError


@register_policy
class SjfPolicy(LearnedPolicy):
    """Shortest-predicted-job-first admission (learned SJF).

    The global queue is ordered by each VU's **predicted total service
    time**: ``n_calls * sum(freq_f * predict_ms(f))`` over the VU's
    function-call mix (``PolicyContext.func_profile``), with predictions
    from an online per-function Welford duration estimator
    (``core.estimators.DurationEstimator``) fed by the completion stream.
    During a backlog the quick interactive VUs jump the long batch VUs —
    the mean-latency/SJF result Przybylski et al. obtain from per-function
    execution-time estimates — while shard selection stays
    pressure-ordered.  Before any observation the estimator predicts
    ``prior_ms`` for everything and the queue degrades to FIFO.

    Queue keys are computed at *enqueue* time (heap invariant), from the
    estimator state as of the last window boundary — constant between
    boundaries, so keys are replay-stable.

    ``policy_args``: ``prior_ms`` (pre-observation prediction, ms; default
    500 — the scale of a cold-started request, so early admissions aren't
    falsely scored short) plus the :class:`LearnedPolicy` knobs.
    """

    name = "sjf"
    orders_queue = True

    def __init__(self, cfg, prior_ms: float = 500.0, **kwargs):
        super().__init__(cfg, **kwargs)
        self.estimator = DurationEstimator(prior_ms=prior_ms)

    def fold(self, completions: Tuple[Completion, ...]) -> None:
        est = self.estimator
        for c in completions:
            est.update(c.func, c.duration_ms)

    def state_snapshot(self) -> dict:
        return {"estimator": self.estimator.snapshot()}

    def restore_state(self, snap: Mapping) -> None:
        self.estimator.restore(snap["estimator"])

    def queue_key(self, gid: int, ctx: PolicyContext) -> float:
        prof = ctx.func_profile(gid)
        n_calls = len(ctx.programs[gid].func_idx)
        predict = self.estimator.predict_ms
        return n_calls * sum(freq * predict(f) for f, freq in prof)


@register_policy
class BanditPolicy(LearnedPolicy):
    """Bandit-tuned pull watermark (model-free adaptive thresholds).

    Arms are watermark multipliers; each reward window (``update_every``
    ticks) scores the *current* arm by the requests that completed in the
    window — ``reward = -(p99_window_ms / 1e3 + cold_weight * cold_rate)``,
    the p99 + cold-rate blend — then a :class:`~repro_torch.core.estimators
    .BanditTuner` (UCB1, or seeded epsilon-greedy with counter-based
    draws) picks the next arm.  ``want_pull`` gates on ``cfg.watermark *
    current_arm``: low arms throttle admission (fewer cold starts, longer
    queue wait), high arms drain the queue eagerly — the bandit learns the
    trade per scenario instead of hand-tuning it (Nguyen et al.'s adaptive
    sizing, without the model).  Windows with no completions feed no
    reward (an empty window says nothing about the arm).

    Arms may also be ``(watermark_mult, steal_mult)`` pairs — scalars are
    normalized to ``(mult, 1.0)``; the steal member only matters under
    :class:`BanditStealPolicy`.

    ``policy_args``: ``arms`` (default ``(0.6, 1.0, 1.6, 2.4)``), ``mode``
    (``"ucb"``/``"egreedy"``), ``epsilon``, ``ucb_c``, ``bandit_seed``,
    ``cold_weight`` plus the :class:`LearnedPolicy` knobs.
    """

    name = "bandit"

    DEFAULT_ARMS: Tuple = (0.6, 1.0, 1.6, 2.4)

    def __init__(
        self,
        cfg,
        arms: Optional[Sequence] = None,
        mode: str = "ucb",
        epsilon: float = 0.1,
        ucb_c: float = 0.5,
        bandit_seed: int = 0,
        cold_weight: float = 1.0,
        **kwargs,
    ):
        super().__init__(cfg, **kwargs)
        if cold_weight < 0:
            raise ValueError("cold_weight must be >= 0")
        self.cold_weight = float(cold_weight)
        pairs = []
        for a in arms if arms is not None else self.DEFAULT_ARMS:
            if isinstance(a, (tuple, list)):
                wm, sm = (float(a[0]), float(a[1]))
            else:
                wm, sm = float(a), 1.0
            if wm <= 0 or sm <= 0:
                raise ValueError(f"arm multipliers must be > 0, got {a!r}")
            if self.steals and cfg.steal_watermark * sm < cfg.watermark * wm:
                raise ValueError(
                    f"arm {a!r} puts the effective steal watermark "
                    f"({cfg.steal_watermark * sm:g}) below the effective pull "
                    f"watermark ({cfg.watermark * wm:g}) — a shard must never "
                    "be steal victim and pull thief at once"
                )
            pairs.append((wm, sm))
        self.tuner = BanditTuner(
            tuple(pairs), mode=mode, epsilon=epsilon, ucb_c=ucb_c,
            seed=bandit_seed,
        )

    def fold(self, completions: Tuple[Completion, ...]) -> None:
        if not completions:
            return  # empty window: no evidence, no reward
        durs = sorted(c.duration_ms for c in completions)
        p99 = durs[min(len(durs) - 1, int(0.99 * len(durs)))]
        cold_rate = sum(1 for c in completions if c.cold) / len(completions)
        self.tuner.feed(-(p99 / 1e3 + self.cold_weight * cold_rate))

    def state_snapshot(self) -> dict:
        return {"tuner": self.tuner.snapshot()}

    def restore_state(self, snap: Mapping) -> None:
        self.tuner.restore(snap["tuner"])

    def want_pull(self, state: ShardState) -> bool:
        return state.pressure < self.cfg.watermark * self.tuner.current[0]


@register_policy
class BanditStealPolicy(BanditPolicy):
    """Bandit tuning the **(pull, steal) watermark pair** jointly.

    Same reward loop as ``bandit``, with stealing on and two-dimensional
    arms: each ``(watermark_mult, steal_mult)`` arm sets both the pull gate
    (``cfg.watermark * watermark_mult``) and the steal round's hysteresis
    band via :meth:`steal_params` (``cfg.steal_watermark * steal_mult``
    over the scaled pull watermark).  Construction rejects any arm whose
    effective steal watermark falls below its effective pull watermark, so
    the no victim-and-thief invariant holds on every arm.
    """

    name = "bandit+steal"
    steals = True

    DEFAULT_ARMS: Tuple = (
        (0.6, 1.0), (1.0, 1.0), (1.6, 1.2), (1.0, 0.7), (1.6, 1.6),
    )

    def steal_params(self) -> Tuple[float, float]:
        wm, sm = self.tuner.current
        return (self.cfg.steal_watermark * sm, self.cfg.watermark * wm)
