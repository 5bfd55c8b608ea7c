"""Global pull-based admission tier: the paper's pull principle, one level up.

A copy of the JAX package's ``core/admission.py`` (pure Python and numpy, no
JAX): the port keeps its own so that it imports nothing from ``repro``.

Hiku decouples worker selection from task assignment *inside* one cluster:
idle workers enqueue themselves in ``PQ_f`` and requests bind late to a
ready worker.  The sharded driver (``core.shard``) stops that idea at the
shard boundary — VUs are statically partitioned at plan time, so a bursty
shard queues while its neighbor idles, exactly the imbalance pull-based
scheduling eliminates within a cluster (the centralized-admission framing of
Hermes and NOAH).

This module closes the gap with a second, cluster-level instance of the pull
principle:

* all arrivals (closed-loop VUs, optionally with per-VU arrival times) enter
  ONE global admission queue instead of being split at plan time;
* each shard advertises its *local pressure* — queued arrivals per worker
  plus busy-worker fraction (``Simulator.pressure``) — and **pulls** the
  next arrival whenever its pressure sits below the admission watermark;
* the admission tier is itself a priority queue of shards keyed by pressure
  (``PQ_f`` at cluster granularity): the least-loaded shard pulls first,
  and every pull raises that shard's effective pressure by ``1/n_workers``
  until its event loop catches up, so one tick cannot flood a shard.

Execution co-runs the K shard simulators in simulated-time lockstep
(``Simulator.begin`` / ``step_until`` — the engine's backpressure hooks),
admitting between time slices via ``Simulator.admit_vu``.  The merged output
follows the shard merge contract: worker ids remapped by shard offsets,
VU local ids mapped through the admission-order table, streams stable-merged
by completion time with shard-index tie-break.

Admission binds a VU once.  ``policy="pull+steal"`` extends the pull loop
past that binding with cross-shard **work stealing** (``core.stealing``):
each tick, after admission pulls, queued tasks migrate from shards above
``steal_watermark`` to shards below the pull watermark — the same
pressure-keyed heap run in both directions.  Migrations carry the VU's
bit-exact service identity and are recorded in the ``migrated`` record
column and the run's ``migrations`` telemetry.

*Which* shard pulls, *when* it may, and *which* queued VU it receives are
policy decisions, dispatched through the pluggable registry in
``core.policies``: ``AdmissionConfig.policy`` names any registered
``AdmissionPolicy`` (``available_policies()`` lists them — ``pull``,
``round_robin``, ``pull+steal``, ``deadline``, ``cost``, ``predictive``,
``affinity``, ``affinity+steal`` plus the learned ``sjf``, ``bandit`` and
``bandit+steal`` ship built in), and the three original
behaviors run byte-identically through the same dispatch.  ``core.workloads`` generates the bursty
scenario suite (flash crowds, diurnal load, ON/OFF arrivals, heavy-tailed
service mixes) the policies are benchmarked on
(``benchmarks/bench_policies.py``).

The static partition (``ShardedSimulator``) remains the default and is
byte-identical to the frozen seed engine; the admission tier is a new
opt-in scenario with its own (still deterministic, still seeded) streams.
``benchmarks/bench_admission.py`` measures both on skewed/bursty arrival
populations the static partition cannot balance, and
``benchmarks/bench_stealing.py`` measures what stealing adds on
*post-admission* imbalance.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
import warnings
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .autoscale import AutoscaleActuator, Autoscaler
from .coord import ShardCoordinator
from .eventplane import CLUSTER_TOPIC, SHARD_TOPIC, EventPlane
from .metrics import RunMetrics, summarize
from .policies import PolicyContext, get_policy_class, make_policy, policy_knobs
from .records import RecordColumns
from .scheduler import make_scheduler
from .shard import merge_assignments, merge_window, shard_seed, split_even
from .simulator import SalvagedVU, SimConfig, Simulator
from .stealing import Migration, Salvage, drain_tick, steal_tick
from .trace import (
    FunctionSpec,
    VUProgram,
    default_n_events,
    make_functions,
    make_vu_programs,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionRun",
    "AdmissionShard",
    "AdmissionSimulator",
    "load_cv_across_shards",
    "make_skewed_programs",
    "make_sleeper_programs",
]


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission-tier control knobs.

    Attributes:
        watermark: pressure threshold below which a shard pulls
            (``Simulator.pressure`` units: 0 = idle, 1 = all workers busy,
            >1 = queueing).  Each pull within a tick raises the shard's
            effective pressure by ``1/n_workers``, so a single tick admits
            at most ``watermark * n_workers`` VUs into an idle shard.
        tick_s: admission-loop period in *simulated* seconds; shards are
            stepped in lockstep between pulls, so this bounds how stale the
            pressure signal can be.
        batch_size: optional hard cap on VUs bound per shard per tick,
            honored by every policy (None: ``pull`` is watermark-limited
            only; ``round_robin`` drains the eligible queue each tick).
        policy: name of a registered admission policy
            (``core.policies.available_policies()``).  Built in: ``"pull"``
            (pressure-ordered watermark admission), ``"pull+steal"`` (pull
            plus per-tick cross-shard work stealing — see ``core.stealing``),
            ``"round_robin"`` (cyclic binding on arrival — the
            arrival-capable static baseline), ``"deadline"`` (EDF-ordered
            global queue), ``"cost"`` (warm-capacity-scaled pull threshold),
            ``"predictive"`` (EWMA arrival-forecast-modulated watermark)
            and ``"affinity"``/``"affinity+steal"`` (warm-locality routing
            against the per-function warm-set digest; the ``+steal``
            variant also steals warm-first), plus the learned tier —
            ``"sjf"`` (queue ordered by predicted total service time from
            an online per-function duration estimator) and
            ``"bandit"``/``"bandit+steal"`` (bandit-tuned watermark /
            watermark-pair; see ``core.estimators``).  Unknown names raise
            at config construction with the available list.
        steal_watermark: pressure above which a shard's queued tasks may be
            stolen (stealing policies only).  Must be >= ``watermark`` so a
            shard can never be victim and thief in the same tick; the band
            between the two watermarks is the hysteresis that keeps
            near-balanced shards from churning migrations.
        steal_batch: optional hard cap on migrations per tick
            (stealing policies only; None: the two heaps limit the tick).
        policy_args: optional policy-specific knobs, passed as keyword
            arguments to the policy constructor (e.g. ``{"cost_weight":
            0.8}`` for ``cost``, ``{"alpha": 0.5, "gain": 2.0}`` for
            ``predictive``).
        salvage: run the dead-shard drain (``core.stealing.drain_tick``)
            each tick: when a shard's last worker dies, its queued tasks
            and mid-think VUs are salvaged back through the admission tier
            onto live shards instead of stranding (§10 failure contract).
            On by default — ``False`` is the no-salvage baseline
            ``benchmarks/bench_chaos.py`` scores against.  With no fault
            plan the drain never fires either way.
    """

    watermark: float = 0.75
    tick_s: float = 0.25
    batch_size: Optional[int] = None
    policy: str = "pull"
    steal_watermark: float = 1.5
    steal_batch: Optional[int] = None
    policy_args: Optional[Mapping[str, object]] = None
    salvage: bool = True

    def __post_init__(self):
        cls = get_policy_class(self.policy)  # unknown name -> available list
        if self.tick_s <= 0:
            raise ValueError("tick_s must be > 0")
        if self.batch_size is not None and self.batch_size < 1:
            raise ValueError("batch_size must be >= 1 (or None for uncapped)")
        if cls.steals:
            if self.steal_watermark < self.watermark:
                raise ValueError(
                    "steal_watermark must be >= watermark (a shard must never "
                    "be steal victim and pull thief at once)"
                )
            if self.steal_batch is not None and self.steal_batch < 1:
                raise ValueError("steal_batch must be >= 1 (or None for uncapped)")
        # surface bad policy knobs at config time, not mid-run — naming the
        # offending key(s) and the accepted knobs for the resolved class
        args = dict(self.policy_args or {})
        try:
            cls(self, **args)
        except TypeError as err:
            knobs = policy_knobs(cls)
            bad = sorted(k for k in args if k not in knobs)
            if not bad:
                raise  # a TypeError of the policy's own making
            raise TypeError(
                f"policy {self.policy!r} ({cls.__name__}) got unknown "
                f"policy_args key(s) {', '.join(map(repr, bad))}; accepted "
                f"knobs: {knobs if knobs else '(none)'}"
            ) from err


@dataclasses.dataclass
class AdmissionShard:
    """One shard's output under global admission (analog of ``ShardResult``).

    ``records``/``assign_w`` carry *shard-local* ids; ``admitted`` is the
    local->global VU id table (position = local id, value = global id, in
    admission order)."""

    index: int
    seed: int
    n_workers: int
    worker_offset: int
    admitted: np.ndarray  # global VU ids, admission order
    admit_t: np.ndarray  # admission times (s), parallel to ``admitted``
    pulls: int  # admission-tier pulls this shard performed
    records: RecordColumns
    assign_t: np.ndarray
    assign_w: np.ndarray
    n_events: int
    stolen_out: int = 0  # queued tasks other shards stole from this one
    stolen_in: int = 0  # stolen tasks this shard received and re-injected
    # failure telemetry (0 on fault-free runs; see ARCHITECTURE.md §10)
    resubmits: int = 0  # failure-retry pushes this shard performed
    lost_tasks: int = 0  # tasks dropped after exhausting the retry budget
    salvaged_out: int = 0  # VUs drained off this shard while it was dead
    salvaged_in: int = 0  # salvaged VUs re-homed onto this shard
    outstanding: int = 0  # submitted-but-unresolved requests at run end
    alive: bool = True  # any live worker left at run end? (dead => stranded)
    #: integral of the live worker count over [0, duration_s) — the
    #: provisioned-capacity cost an elastic pool is scored on (§14);
    #: a static shard reads n_workers * duration_s
    worker_seconds: float = 0.0


@dataclasses.dataclass
class AdmissionRun:
    """Merged output of a global-admission run (analog of ``MergedRun``)."""

    shards: List[AdmissionShard]
    records: RecordColumns  # global ids, stable-merged by completion time
    assign_t: np.ndarray
    assign_w: np.ndarray
    workers: List[int]
    n_events: int
    wall_s: float
    admitted: int  # VUs admitted across all shards
    unadmitted: int  # VUs still waiting (or never eligible) at the deadline
    queue_t: np.ndarray  # admission-queue depth telemetry: sample times (s)
    queue_depth: np.ndarray  # eligible-but-unadmitted VUs at each sample
    migrations: List[Migration] = dataclasses.field(default_factory=list)
    #: per-global-VU relative latency deadline (ms; None when the workload
    #: carries no deadline metadata) — feeds RunMetrics.deadline_miss_rate
    deadline_ms: Optional[np.ndarray] = None
    #: per-global-VU arrival times (s) — the miss clock starts here, so
    #: admission-queue wait is charged against the deadline
    arrival_s: Optional[np.ndarray] = None
    #: dead-shard drain moves (``AdmissionConfig.salvage``; empty without
    #: faults) — one row per re-homed VU, ``in_flight`` rows carried a
    #: lost request with them
    salvages: List[Salvage] = dataclasses.field(default_factory=list)
    #: in-flight requests of salvaged VUs that never found a live home (the
    #: whole cluster stayed dark through the deadline) — counted as lost
    unsalvaged: int = 0
    #: failed-request recovery latencies (first failure -> completion, s),
    #: concatenated across shards — RunMetrics recovery percentiles
    recovery_s: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )
    #: the learned policy's per-window state snapshots, when the run was
    #: recorded (``policy_args={"record_state": True}`` on a
    #: ``LearnedPolicy``); pure JSON types, feedable back through
    #: ``policy_args={"replay_from": ...}`` for a byte-identical replay.
    #: ``None`` for unrecorded or non-learned runs.
    policy_state: Optional[List[Mapping]] = None

    @property
    def n_migrations(self) -> int:
        """Cross-shard task migrations performed (``pull+steal`` only)."""
        return len(self.migrations)

    @property
    def worker_seconds(self) -> float:
        """Provisioned-capacity cost: live-worker-count integral summed
        over shards (``benchmarks/bench_autoscale.py``'s cost axis)."""
        return float(sum(s.worker_seconds for s in self.shards))

    @property
    def n_salvages(self) -> int:
        """VUs re-homed off dead shards by the drain."""
        return len(self.salvages)

    @property
    def lost_tasks(self) -> int:
        """Requests dropped for good: retry budgets exhausted on any shard,
        plus in-flight requests of VUs that never found a live home."""
        return sum(s.lost_tasks for s in self.shards) + self.unsalvaged

    @property
    def resubmits(self) -> int:
        """Failure-retry pushes across all shards."""
        return sum(s.resubmits for s in self.shards)

    @property
    def stranded(self) -> int:
        """Submitted-but-unresolved requests stuck on *dead* shards at run
        end — work that can never complete (the §10 acceptance signal:
        with salvage on this is 0; live shards' end-of-run in-flight work
        is normal and not counted)."""
        return sum(s.outstanding for s in self.shards if not s.alive)

    @property
    def shard_requests(self) -> np.ndarray:
        """Completed requests per shard — the cross-shard balance signal."""
        return np.asarray([len(s.records) for s in self.shards], np.int64)

    @property
    def shard_load_cv(self) -> float:
        """CV of completed requests across shards (0 = perfectly balanced)."""
        return load_cv_across_shards(self.shard_requests)

    def summarize(self, duration_s: float) -> RunMetrics:
        return summarize(
            self.records, (self.assign_t, self.assign_w), self.workers, duration_s,
            deadline_ms=self.deadline_ms, arrival_s=self.arrival_s,
            resubmits=self.resubmits, lost_tasks=self.lost_tasks,
            recovery_s=self.recovery_s,
        )


def load_cv_across_shards(counts: Sequence[float]) -> float:
    """Coefficient of variation of per-shard load (std/mean; 0 = balanced)."""
    c = np.asarray(counts, np.float64)
    if c.size == 0 or c.mean() <= 0:
        return 0.0
    return float(c.std() / c.mean())


def make_skewed_programs(
    funcs: Sequence[FunctionSpec],
    n_vus: int,
    n_events: int,
    seed: int,
    hot_frac: float = 0.25,
    hot_think: Tuple[float, float] = (0.05, 0.15),
    cold_think: Tuple[float, float] = (1.0, 3.0),
) -> List[VUProgram]:
    """A VU population with a contiguous *hot block* the static partition
    cannot balance.

    The first ``hot_frac`` of VUs are hot: near-zero think time and calls
    drawn only from the heavier half of the function population (by warm
    latency).  The rest are cold: long think times, Azure-weighted function
    choice.  Because the block is contiguous, ``ShardedSimulator``'s
    contiguous VU split lands (nearly) all hot VUs on the first shard(s),
    while pressure-based admission spreads them by live load.  Deterministic
    per ``(seed, vu)`` like ``make_vu_programs``.
    """
    warm = np.asarray([f.warm_ms for f in funcs])
    heavy = np.flatnonzero(warm >= np.median(warm))
    weights = np.asarray([f.weight for f in funcs])
    weights = weights / weights.sum()
    n_hot = int(round(hot_frac * n_vus))
    programs = []
    for vu in range(n_vus):
        rng = np.random.default_rng((seed, vu))
        if vu < n_hot:
            idx = heavy[rng.integers(0, len(heavy), size=n_events)]
            sleep = rng.uniform(*hot_think, size=n_events)
        else:
            idx = rng.choice(len(funcs), size=n_events, p=weights)
            sleep = rng.uniform(*cold_think, size=n_events)
        programs.append(VUProgram(np.asarray(idx), sleep))
    return programs


def make_sleeper_programs(
    funcs: Sequence[FunctionSpec],
    n_vus: int,
    n_events: int,
    seed: int,
    hot_frac: float = 0.25,
    quiet_s: Tuple[float, float] = (4.0, 6.0),
    hot_think: Tuple[float, float] = (0.02, 0.1),
    cold_think: Tuple[float, float] = (1.0, 3.0),
) -> List[VUProgram]:
    """A *post-admission* imbalance workload: sleepers that turn hot.

    The first ``hot_frac`` of VUs are **sleepers**: their first request is
    light and followed by a long ``quiet_s`` think, after which they hammer
    heavy functions with near-zero think time.  At admission time a sleeper
    is indistinguishable from a cold VU — it contributes almost nothing to
    ``Simulator.pressure`` — so pressure-keyed admission necessarily places
    them by *current* load, and whichever shards took more sleepers blow up
    only after binding.  That is exactly the imbalance admission-time pull
    cannot fix and cross-shard work stealing (``policy="pull+steal"``) can.
    Deterministic per ``(seed, vu)`` like the other generators.
    """
    warm = np.asarray([f.warm_ms for f in funcs])
    heavy = np.flatnonzero(warm >= np.median(warm))
    light = np.flatnonzero(warm <= np.median(warm))
    weights = np.asarray([f.weight for f in funcs])
    weights = weights / weights.sum()
    n_hot = int(round(hot_frac * n_vus))
    programs = []
    for vu in range(n_vus):
        rng = np.random.default_rng((seed, vu))
        if vu < n_hot:
            idx = heavy[rng.integers(0, len(heavy), size=n_events)]
            sleep = rng.uniform(*hot_think, size=n_events)
            idx[0] = light[rng.integers(0, len(light))]  # light first touch
            sleep[0] = rng.uniform(*quiet_s)  # ... then the long nap
        else:
            idx = rng.choice(len(funcs), size=n_events, p=weights)
            sleep = rng.uniform(*cold_think, size=n_events)
        programs.append(VUProgram(np.asarray(idx), sleep))
    return programs


class AdmissionSimulator:
    """K shard simulators behind ONE pull-based global admission queue.

    Same worker partition and per-shard seeding contract as
    ``ShardedSimulator`` (largest-remainder split, golden-ratio
    ``shard_seed`` stride), but the VU population is *not* partitioned at
    plan time: shards pull arrivals from the shared admission queue when
    their local pressure drops below the watermark.  All shards serve one
    shared function population (``make_functions(seed)``) so any VU can bind
    to any shard.

    Args:
        n_shards: shard (independent cluster) count, >= 1.
        n_workers: total workers, split evenly across shards.
        scheduler: intra-shard scheduler name (``make_scheduler``).
        cfg: per-shard config template; ``n_workers`` is rewritten per shard.
        seed: global workload seed; shard ``k`` runs with
            ``shard_seed(seed, k)``.
        admission: :class:`AdmissionConfig` knobs.
    """

    def __init__(
        self,
        n_shards: int,
        n_workers: int,
        scheduler: str = "hiku",
        cfg: Optional[SimConfig] = None,
        seed: int = 0,
        admission: Optional[AdmissionConfig] = None,
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if n_workers < n_shards:
            raise ValueError("need at least one worker per shard")
        self.n_shards = int(n_shards)
        self.n_workers = int(n_workers)
        self.scheduler = scheduler
        self.cfg = cfg or SimConfig()
        self.seed = int(seed)
        self.admission = admission or AdmissionConfig()
        # config values are validated by AdmissionConfig.__post_init__;
        # re-resolve the policy here so a name unregistered since the config
        # was built still fails fast, with the live available list
        self._policy_cls = get_policy_class(self.admission.policy)
        self.worker_split = split_even(self.n_workers, self.n_shards)
        self.worker_offsets = [0]
        for n in self.worker_split:
            self.worker_offsets.append(self.worker_offsets[-1] + n)
        # per-shard effective-pressure increment per admitted/stolen VU
        self.inv_workers = [1.0 / max(n, 1) for n in self.worker_split]
        self.funcs = make_functions(seed=self.seed)
        # fault schedule over GLOBAL worker ids (chaos.FaultPlan targets):
        # resolved to (shard, local) pairs when run() builds the shard sims
        self._failures: List[Tuple[float, int]] = []
        self._additions: List[Tuple[float, int]] = []
        self._notices: List[Tuple[float, int, float]] = []  # (t, gworker, until)

    # ------------------------------------------------------------- faults
    def _locate(self, worker: int, hook: str) -> Tuple[int, int]:
        """Global worker id -> (shard, local id) under the static partition.

        Ids outside ``[0, n_workers)`` are rejected — like the sharded
        driver, the admission tier's merge remaps by fixed shard offsets, so
        capacity beyond the partition would collide after the merge; revive
        failed ids instead of inventing new ones."""
        if not 0 <= worker < self.n_workers:
            raise ValueError(
                f"{hook}: global worker id {worker} out of range "
                f"[0, {self.n_workers}) — the admission tier's partition is "
                "static; inject_worker revives failed ids only"
            )
        k = bisect.bisect_right(self.worker_offsets, worker) - 1
        return k, worker - self.worker_offsets[k]

    def inject_failure(self, t: float, worker: int) -> None:
        """Schedule global worker ``worker`` to fail at time ``t`` (chaos
        hook; ``core.chaos.FaultPlan.apply`` drives this).  Validated
        against the partition here and against the run deadline by the
        owning shard's ``begin()``."""
        self._locate(worker, "inject_failure")
        self._failures.append((float(t), int(worker)))

    def inject_worker(self, t: float, worker: int) -> None:
        """Schedule global worker ``worker`` to (re)join at time ``t`` —
        the revival path that brings a dead shard back as an
        admission/steal candidate."""
        self._locate(worker, "inject_worker")
        self._additions.append((float(t), int(worker)))

    def inject_notice(self, t: float, worker: int, until: float) -> None:
        """Advisory preemption notice: ``worker`` will fail at ``until``.

        Never load-bearing — policies see it as ``ShardState
        .doomed_workers`` between ``t`` and ``until`` and may shed load
        early; the kill itself needs its own ``inject_failure`` (the
        ``spot_preemption`` plan emits both)."""
        self._locate(worker, "inject_notice")
        if until < t:
            raise ValueError(f"inject_notice: until={until} precedes t={t}")
        self._notices.append((float(t), int(worker), float(until)))

    # ----------------------------------------------------------------- run
    def run(
        self,
        n_vus: int = 20,
        duration_s: float = 100.0,
        programs: Optional[Sequence[VUProgram]] = None,
        arrivals: Optional[Sequence[float]] = None,
        deadlines: Optional[Sequence[float]] = None,
        faults: Optional["FaultPlan"] = None,  # noqa: F821 (core.chaos)
        bus: Optional[EventPlane] = None,
        autoscaler: Optional[Autoscaler] = None,
        metrics_window_s: Optional[float] = None,
    ) -> AdmissionRun:
        """Co-run the K shards under the global admission queue.

        Args:
            n_vus: global VU population size.
            duration_s: simulated experiment length, seconds.
            programs: explicit VU programs (len == ``n_vus``); default
                generates the seeded Azure-like workload over the shared
                function population.
            arrivals: per-VU admission-eligibility times, seconds (default:
                all eligible at t=0).  Admission happens only at tick
                boundaries ``i * tick_s`` strictly below ``duration_s``, and
                a VU is admissible at the first boundary at or after its
                arrival — so arrivals past the last such boundary (in
                particular any at or after ``duration_s``) are never
                admitted and count as unadmitted.  Shrink ``tick_s`` to
                shrink that end-of-run blind window.
            deadlines: per-VU *relative* latency deadlines, seconds
                (default: none; ``inf`` = that VU carries no SLO).
                Deadline-aware policies order the global queue by
                ``arrival + deadline`` (EDF), and
                ``AdmissionRun.summarize`` scores
                ``RunMetrics.deadline_miss_rate`` — the fraction of
                SLO-carrying VUs whose *first completion* landed after
                ``arrival + deadline`` (admission-queue wait is charged;
                a VU that never completes counts as missed; later
                requests are not scored).  Scenario generators in
                ``core.workloads`` produce these.
            faults: optional ``core.chaos.FaultPlan`` applied to this run —
                equivalent to calling :meth:`inject_failure` /
                :meth:`inject_worker` / :meth:`inject_notice` for each
                event before the run.  Scenario bundles carry one in
                ``Scenario.faults``.
            bus: optional :class:`~repro_torch.core.eventplane.EventPlane` the
                loop publishes window summaries onto — one ``("shard", k)``
                event per shard (ascending ``k``, the merge tie-break)
                then one ``("cluster",)`` event per completed metric
                window, plus a final partial-window flush after the loop
                drains.  Subscribers must be registered before this call
                (the bus is sealed as the loops arm, §14).
            autoscaler: optional :class:`~repro_torch.core.autoscale.Autoscaler`
                — subscribed to the bus (one is created when ``bus`` is
                None), bound to an actuator over this run's shards, and
                given the initial pool sizing before the loops arm.  Its
                decision window is ``autoscaler.cfg.window_s``.
            metrics_window_s: publish cadence when ``bus`` is given
                without an autoscaler (default 1.0).  Either way the
                window must be a positive multiple of ``tick_s``.

        Any VU still unadmitted at the deadline is reported on
        ``AdmissionRun.unadmitted`` and raises a ``RuntimeWarning`` — a
        silently shrunken population is a bug magnet in benchmarks.

        Deterministic for fixed inputs: the admission loop advances
        simulated time in ``tick_s`` slices, every registered policy's
        decisions are a pure function of the visible state (the
        ``core.policies`` determinism contract), and under stealing
        policies the steal schedule is equally a total order (see
        ``core.stealing``).
        """
        adm = self.admission
        policy = make_policy(adm.policy, adm, **dict(adm.policy_args or {}))
        if programs is None:
            programs = make_vu_programs(
                self.funcs, n_vus, default_n_events(duration_s), self.seed
            )
        programs = list(programs)
        if len(programs) != n_vus:
            raise ValueError(f"len(programs)={len(programs)} != n_vus={n_vus}")
        if arrivals is None:
            arr = np.zeros(n_vus)
        else:
            arr = np.asarray(arrivals, np.float64)
            if arr.shape != (n_vus,):
                raise ValueError(f"arrivals shape {arr.shape} != ({n_vus},)")
        if deadlines is None:
            dl = None
        else:
            dl = np.asarray(deadlines, np.float64)
            if dl.shape != (n_vus,):
                raise ValueError(f"deadlines shape {dl.shape} != ({n_vus},)")
        order = np.argsort(arr, kind="stable")  # admission-queue order
        if faults is not None:
            faults.apply(self)

        sims: List[Simulator] = []
        for k in range(self.n_shards):
            sk = shard_seed(self.seed, k)
            sched = make_scheduler(self.scheduler, self.worker_split[k], seed=sk)
            sim = Simulator(
                sched,
                funcs=self.funcs,
                cfg=dataclasses.replace(self.cfg, n_workers=self.worker_split[k]),
                seed=sk,
            )
            sims.append(sim)
        # route the fault schedule to the owning shards, then arm the loops
        # (begin() validates each shard's schedule against the deadline)
        for ft, gw in self._failures:
            k, local = self._locate(gw, "inject_failure")
            sims[k].inject_failure(ft, local)
        for ft, gw in self._additions:
            k, local = self._locate(gw, "inject_worker")
            sims[k].inject_worker(ft, local)
        notices = []  # (t_notice, shard, t_kill), doomed-worker signal
        for ft, gw, until in self._notices:
            k, local = self._locate(gw, "inject_notice")
            notices.append((ft, k, until))
            # forward to the owning engine too: inside the window the worker
            # drops out of warm_capacity()/warm_digest() (doomed capacity is
            # not headroom — the §11 bugfix), with zero event-loop effect
            sims[k].inject_notice(ft, local, until)

        # ---- live event plane + autoscaler (docs/ARCHITECTURE.md §14) ----
        # Publishing and sizing are opt-in: with neither a bus nor an
        # autoscaler this block is four no-op tests and the loop below is
        # byte-identical to the static form.
        actuator = None
        m_win = 0
        if autoscaler is not None:
            if bus is None:
                bus = EventPlane()
            win_s = autoscaler.cfg.window_s
        elif bus is not None:
            win_s = 1.0 if metrics_window_s is None else float(metrics_window_s)
        if bus is not None:
            m_win = round(win_s / adm.tick_s)
            if m_win < 1 or abs(m_win * adm.tick_s - win_s) > 1e-9:
                raise ValueError(
                    f"metric window {win_s}s must be a positive multiple of "
                    f"tick_s={adm.tick_s} — summaries publish on tick "
                    "boundaries only"
                )
        if autoscaler is not None:
            actuator = AutoscaleActuator(
                sims, self.worker_split, self.worker_offsets, notices,
                duration_s, autoscaler.cfg.notice_s,
            )
            autoscaler.attach(bus, actuator, self.worker_split)
            # initial pool: workers above each shard's initial target are
            # retired at t=0 through the same validated inject path the
            # chaos tier uses, so begin() checks the whole schedule at once
            for k, keep in enumerate(autoscaler.initial_split(self.worker_split)):
                for local in range(keep, self.worker_split[k]):
                    sims[k].inject_failure(0.0, local)
        if bus is not None:
            bus.seal()  # §14: subscribers register before the loops arm
        pub_seen = [0] * self.n_shards  # per-shard published-record cursors
        pub_widx = 0  # next metric-window index
        win_arrivals = 0  # VUs that became eligible this window

        for sim in sims:
            sim.begin(n_vus=0, duration_s=duration_s, programs=[])

        admitted: List[List[int]] = [[] for _ in range(self.n_shards)]
        admit_t: List[List[float]] = [[] for _ in range(self.n_shards)]
        pulls = [0] * self.n_shards
        migrations: List[Migration] = []
        ctx = PolicyContext(
            sims=sims,
            programs=programs,
            worker_split=self.worker_split,
            inv_workers=self.inv_workers,
            admitted=admitted,
            admit_t=admit_t,
            pulls=pulls,
            policy=policy,
            arrivals=arr,
            deadlines=dl,
        )
        # change-driven cluster view (docs/ARCHITECTURE.md §13): every shard
        # publishes a dirty flag on state change; refresh() below re-reads
        # only those shards, and the heap/steal/drain consumers run off the
        # cached deltas — byte-identical decisions at O(dirty) per tick
        coord = ShardCoordinator(sims)
        ctx.coord = coord
        qpos = 0
        queue_t: List[float] = []
        queue_depth: List[int] = []
        salvages: List[Salvage] = []
        salvage_buf: List[Tuple[int, SalvagedVU]] = []
        tick = 0
        t = 0.0
        t0 = time.perf_counter()
        while True:
            coord.refresh()  # drain the dirty set: the tick's cached view
            if m_win and tick and tick % m_win == 0:
                # a metric window just completed: every event with time <= t
                # has been processed, so the per-shard record accumulators
                # hold exactly the completions with t_done <= t.  Publish
                # (and let the autoscaler react) before this tick's
                # admissions — capacity decisions see last window's truth,
                # never a half-applied tick.
                self._publish_window(
                    bus, sims, coord, ctx, pub_seen, pub_widx,
                    t - win_s, t, win_arrivals,
                )
                pub_widx += 1
                win_arrivals = 0
            n_new = 0
            while qpos < n_vus and arr[order[qpos]] <= t:
                ctx.enqueue(int(order[qpos]))
                qpos += 1
                n_new += 1
            win_arrivals += n_new
            policy.observe(t, n_new, ctx)
            if notices:  # doomed-but-alive workers, per shard, right now
                doomed = [0] * self.n_shards
                for tn, k, until in notices:
                    if tn <= t < until:
                        doomed[k] += 1
                ctx.doomed = doomed
            if adm.salvage and t < duration_s and (coord.dead or salvage_buf):
                # dead-shard drain BEFORE fresh admissions: recovered work
                # re-enters the cluster ahead of new arrivals (§10 salvage
                # ordering), binding to the least-pressured live shards.
                # Skipped outright while no shard is dead and nothing is
                # buffered — the drain would scan and return empty anyway.
                moves, salvage_buf = drain_tick(
                    sims, self.inv_workers, t, pending=salvage_buf,
                    dead=coord.dead, pressures=coord.pressure,
                )
                for mv in moves:
                    gid = admitted[mv.src][mv.src_vu]
                    assert mv.dst_vu == len(admitted[mv.dst])
                    admitted[mv.dst].append(gid)
                    admit_t[mv.dst].append(mv.t)
                salvages.extend(moves)
            if t < duration_s and ctx.waiting_n:
                policy.admit_tick(t, ctx)
            if policy.steals and t < duration_s:
                # post-admission rebalance: the pull heap run in reverse too;
                # the watermark pair routes through the policy so learned
                # stealing policies (bandit+steal) can tune the band per
                # window (default: the static config pair, byte-identical)
                steal_wm, pull_wm = policy.steal_params()
                if steal_wm < pull_wm:  # the steal_tick invariant, kept
                    raise ValueError(  # loud even on skipped quiet ticks
                        f"steal_watermark {steal_wm} must be >= pull "
                        f"watermark {pull_wm} (a shard must never be victim "
                        "and thief at once)"
                    )
                # O(dirty) victim probe: with every cached pressure at or
                # below the steal watermark no shard qualifies as victim,
                # so the whole round is a guaranteed no-op — skip it.
                # (Admissions this tick never raise *live* pressure — they
                # only schedule submit events — so the cache is current.)
                if coord.pressure_max() > steal_wm:
                    moves = steal_tick(
                        sims,
                        steal_watermark=steal_wm,
                        pull_watermark=pull_wm,
                        inv_workers=self.inv_workers,
                        t=t,
                        max_moves=adm.steal_batch,
                        prefer_warm=policy.steal_affinity,
                        pressures=coord.pressure,
                    )
                else:
                    moves = []
                for mv in moves:
                    gid = admitted[mv.src][mv.src_vu]
                    assert mv.dst_vu == len(admitted[mv.dst])
                    admitted[mv.dst].append(gid)
                    admit_t[mv.dst].append(t)
                migrations.extend(moves)
            queue_t.append(t)
            queue_depth.append(ctx.waiting_n)
            if t >= duration_s and all(s.done for s in sims):
                break
            tick += 1
            t = tick * adm.tick_s  # drift-free, like _stream_windows
            for sim in sims:
                # frontier skip: a shard with nothing scheduled inside the
                # tick would pop no events (and never advance its clock), so
                # the call is a no-op — one O(1) peek instead
                if sim.next_event_time() <= t:
                    sim.step_until(t)
        if m_win and any(len(sim._rec) > s for sim, s in zip(sims, pub_seen)):
            # trailing completions past the last boundary: one final partial
            # window, so the published per-shard counts always sum to the
            # full record stream (pinned in tests/test_stream.py)
            self._publish_window(
                bus, sims, coord, ctx, pub_seen, pub_widx,
                pub_widx * win_s, t, win_arrivals,
            )
        wall_s = time.perf_counter() - t0
        run = self._merge(
            sims, admitted, admit_t, pulls, n_vus, wall_s, queue_t, queue_depth,
            migrations, dl, arr, salvages, salvage_buf,
        )
        for k, sim in enumerate(sims):
            run.shards[k].worker_seconds = sim.worker_seconds_until(duration_s)
        if getattr(policy, "record_state", False):
            run.policy_state = list(policy.snapshots)
        return run

    def _publish_window(
        self, bus, sims, coord, ctx, seen, widx, t_lo, t_hi, arrivals,
    ) -> None:
        """Publish one completed metric window: ``("shard", k)`` events in
        ascending shard order (the merge tie-break), then ``("cluster",)``
        — the §14 publish order.  ``seen`` holds per-shard record cursors
        (same exactly-once idiom as ``PolicyContext.new_completions``, on
        separate cursors so policies and subscribers never race)."""
        total = 0
        for k, sim in enumerate(sims):
            acc = sim._rec
            n = len(acc)
            i = seen[k]
            n_done = n - i
            sum_ms = 0.0
            n_cold = 0
            if n_done:
                ts, td, cold = acc.t_submit, acc.t_done, acc.cold
                for j in range(i, n):
                    sum_ms += (td[j] - ts[j]) * 1e3
                    n_cold += cold[j]
            seen[k] = n
            total += n_done
            bus.publish(
                (SHARD_TOPIC, k), widx, t_lo, t_hi,
                {
                    "n_done": n_done,
                    "sum_ms": sum_ms,
                    "n_cold": int(n_cold),
                    "load": sim._queued_n + sim._busy_n,
                    "alive": len(sim.workers),
                    "outstanding": sim.outstanding(),
                    "pressure": coord.pressure[k],
                },
            )
        bus.publish(
            (CLUSTER_TOPIC,), widx, t_lo, t_hi,
            {
                "n_done": total,
                "arrivals": arrivals,
                "queue_depth": ctx.waiting_n,
            },
        )

    def _merge(
        self, sims, admitted, admit_t, pulls, n_vus, wall_s, queue_t, queue_depth,
        migrations, deadlines=None, arrivals=None, salvages=None, salvage_buf=None,
    ) -> AdmissionRun:
        shards: List[AdmissionShard] = []
        parts: List[RecordColumns] = []
        ats, aws = [], []
        recovery: List[float] = []
        for k, sim in enumerate(sims):
            vu_map = np.asarray(admitted[k], np.int32)
            cols = sim.record_columns
            at, aw = sim.assignment_columns
            recovery.extend(sim.recovery_s)
            shards.append(
                AdmissionShard(
                    index=k,
                    seed=shard_seed(self.seed, k),
                    n_workers=self.worker_split[k],
                    worker_offset=self.worker_offsets[k],
                    admitted=vu_map,
                    admit_t=np.asarray(admit_t[k]),
                    pulls=pulls[k],
                    records=cols,
                    assign_t=at,
                    assign_w=aw,
                    n_events=sim.n_events,
                    stolen_out=sim.stolen_out,
                    stolen_in=sim.stolen_in,
                    resubmits=sim.resubmits,
                    lost_tasks=sim.lost_tasks,
                    salvaged_out=sim.salvaged_out,
                    salvaged_in=sim.salvaged_in,
                    outstanding=sim.outstanding(),
                    alive=bool(sim.workers),
                )
            )
            parts.append(cols.remap(worker_offset=self.worker_offsets[k]).remap_vus(vu_map))
            ats.append(at)
            aws.append(aw + self.worker_offsets[k])
        records = merge_window(parts)
        at, aw = merge_assignments(ats, aws)
        # a migrated VU appears in both the victim's and the receiver's
        # admission tables; the global population counts it once
        unique_admitted = len({g for a in admitted for g in a})
        unadmitted = n_vus - unique_admitted
        if unadmitted > 0:
            warnings.warn(
                f"{unadmitted} of {n_vus} VUs were never admitted (arrival in "
                "the end-of-run blind window, or watermark backpressure held "
                "them in the queue past the deadline); see "
                "AdmissionRun.unadmitted and the `arrivals` docs on "
                "AdmissionSimulator.run",
                RuntimeWarning,
                stacklevel=3,
            )
        return AdmissionRun(
            shards=shards,
            records=records,
            assign_t=at,
            assign_w=aw,
            workers=list(range(self.n_workers)),
            n_events=sum(s.n_events for s in sims),
            wall_s=wall_s,
            admitted=unique_admitted,
            unadmitted=unadmitted,
            queue_t=np.asarray(queue_t),
            queue_depth=np.asarray(queue_depth, np.int64),
            migrations=list(migrations),
            deadline_ms=None if deadlines is None else deadlines * 1e3,
            arrival_s=arrivals,
            salvages=list(salvages or ()),
            unsalvaged=sum(1 for _, sv in (salvage_buf or ()) if sv.in_flight),
            recovery_s=np.asarray(recovery, np.float64),
        )
