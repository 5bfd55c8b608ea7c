"""Discrete-event simulator of a FaaS cluster (reproduces the paper's §V).

A copy of the JAX package's ``core/simulator.py`` (pure numpy): the same
event loop, so its record streams and assignment traces are byte for byte
the reference's.  ``BurstDetector`` is the port's own (``core.sched``),
re-exported here under the reference's name.

Models the OpenLambda deployment of the paper: ``n_workers`` workers, each a
processor-sharing server with ``cores`` vCPUs and a finite sandbox memory
pool, a keep-alive evictor (Figure 2 lifecycle), and closed-loop virtual
users (k6) replaying seeded programs.  Any ``core.Scheduler`` plugs in; the
simulator feeds it the assign/finish/evict callbacks the real control plane
would.

Fidelity notes:
* scheduler<->worker notification latency is 0 (LAN RTT in the paper, ~µs);
* each sandbox executes one request at a time (OpenLambda semantics);
* cold start = instance initialization work added to the task (Table I
  cold-warm delta), executed under processor sharing like the paper's VMs;
* per-request service fluctuation is seeded by request identity so every
  scheduler replays identical stochastic demand (paper's fairness device).

Hot-path engineering: the event engine is bit-for-bit equivalent to
the seed implementation (tests/test_equivalence.py proves identical
``RequestRecord`` streams against the frozen copy in tests/legacy) but about
an order of magnitude faster at scale:

* service fluctuations are pre-generated in vectorized bands via
  ``trace.service_fluctuations`` (same ``(seed, vu, ev_idx)`` identity, same
  doubles) instead of constructing a ``default_rng`` per request;
* per-function idle lists are kept in ascending ``last_used`` order, so LRU
  eviction inspects one head per function and keep-alive sweeps stop at the
  first unexpired instance instead of rescanning every idle sandbox;
* each worker caches its running-set minimum remaining time, so scheduling
  the next completion no longer rescans all running tasks (processor sharing
  subtracts the same amount from every task, which preserves the minimum);
* the event loop dispatches on integer event kinds with pre-resolved
  function metadata (name/memory/latency arrays) instead of per-event
  getattr + dataclass attribute chases.

Columnar accumulation: records and assignments accumulate into
per-column buffers (``core.records``) instead of per-record Python objects.
``Simulator.records`` / ``Simulator.assignments`` remain list views
(materialized lazily, cached) so the legacy API — and the byte-for-byte
equivalence suite against tests/legacy — is unchanged, while
``record_columns`` / ``assignment_columns`` expose the stream as numpy
arrays for vectorized metrics, cheap IPC, and the sharded driver
(``core.shard``).  ``run_iter`` is the generator form of ``run`` used by
the sharded driver's interleaved backend.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .records import RecordAccumulator, RecordColumns, RequestRecord
from .sched import BurstDetector
from .scheduler import Scheduler
from .trace import (
    FunctionSpec,
    VUProgram,
    default_n_events,
    make_functions,
    make_vu_programs,
    service_fluctuations,
)


@dataclasses.dataclass
class SimConfig:
    """Cluster + experiment knobs for one :class:`Simulator` (the paper's §V
    OpenLambda deployment, parameterized).

    Changing any field changes the event stream, so configs are part of the
    replay identity: the byte-for-byte equivalence suite
    (tests/test_equivalence.py) always runs seed and refactored engines with
    the *same* ``SimConfig``.

    Attributes:
        n_workers: worker (OpenLambda node) count.  The sharded driver
            rewrites this per shard via ``dataclasses.replace``.
        cores_per_worker: vCPUs per worker; tasks share them processor-
            sharing style (rate = cores/n_running when oversubscribed).
        mem_pool_mb: sandbox memory pool per worker, MB.  Calibrated with
            ``keep_alive_s`` so the §V protocol lands at the paper's
            operating point (hiku cold rate ~20-30%, baselines 33-60%).
        keep_alive_s: idle-instance keep-alive before the sweeper evicts,
            seconds (Figure 2 lifecycle).
        sweep_every_s: keep-alive sweep period, seconds.
        exec_sigma: lognormal sigma of per-request service fluctuation
            (Figure 5); part of the fluctuation-band cache key.
        overhead_ms: scheduler decision overhead added to every request's
            completion time, milliseconds (the §V overhead experiment).
        retry_delay_s: control-plane resubmit delay after a request is lost
            to a worker failure, seconds — the *base* of the backoff
            schedule: attempt ``i`` (1-based) retries after
            ``min(retry_delay_s * retry_backoff**(i-1), retry_max_delay_s)``.
            Attempt 1 is always exactly ``retry_delay_s``, which is what
            keeps single-retry runs byte-identical to the flat-delay seed
            engine.
        retry_backoff: multiplicative backoff factor per retry attempt
            (>= 1; 1.0 reproduces the seed engine's flat delay exactly).
        retry_max_delay_s: cap on the backoff delay, seconds.
        retry_budget: per-task retry attempts before the request is
            *dropped* and counted in ``Simulator.lost_tasks`` /
            ``RunMetrics.lost_task_rate`` (its closed-loop VU halts).
            ``None`` retries forever — the seed engine's behavior, where a
            task on a fully-dead cluster loops until the deadline.
    """

    n_workers: int = 5
    cores_per_worker: float = 4.0
    # pool/keep-alive calibrated so the §V protocol lands at the paper's
    # operating point (hiku lowest cold rate ~20-30%, baselines 33-60%)
    mem_pool_mb: float = 2048.0
    keep_alive_s: float = 45.0
    sweep_every_s: float = 1.0
    exec_sigma: float = 0.25
    overhead_ms: float = 0.0  # scheduler decision overhead added to latency
    retry_delay_s: float = 0.05  # base resubmit delay after worker failure
    retry_backoff: float = 2.0  # exponential backoff factor per attempt
    retry_max_delay_s: float = 1.0  # backoff cap
    retry_budget: Optional[int] = 8  # attempts before the task counts lost

    def __post_init__(self):
        if self.retry_delay_s <= 0:
            raise ValueError(f"retry_delay_s must be > 0, got {self.retry_delay_s}")
        if self.retry_backoff < 1.0:
            raise ValueError(f"retry_backoff must be >= 1, got {self.retry_backoff}")
        if self.retry_max_delay_s < self.retry_delay_s:
            raise ValueError(
                f"retry_max_delay_s {self.retry_max_delay_s} must be >= "
                f"retry_delay_s {self.retry_delay_s}"
            )
        if self.retry_budget is not None and self.retry_budget < 1:
            raise ValueError(
                f"retry_budget must be >= 1 (or None for unlimited), "
                f"got {self.retry_budget}"
            )


# RequestRecord lives in core.records now; re-exported here for the legacy
# import path (``from repro_torch.core.simulator import RequestRecord``).
__all__ = [
    "BurstDetector",
    "RequestRecord",
    "SalvagedVU",
    "SimConfig",
    "Simulator",
    "StolenTask",
]


# integer event kinds; the *push order* (and with it the tie-breaking
# sequence number) is part of the replay contract with the seed engine
_SUBMIT, _COMPLETE, _RESUBMIT, _SWEEP, _FAIL, _ADD = 0, 1, 2, 3, 4, 5


class _Instance:
    __slots__ = ("func", "mem_mb", "last_used")

    def __init__(self, func: int, mem_mb: float, t: float):
        self.func = func
        self.mem_mb = mem_mb
        self.last_used = t


class _Task:
    __slots__ = (
        "func", "vu", "ev_idx", "t_submit", "work_s", "remaining_s", "cold",
        "worker", "migrated", "attempts", "fail_t",
    )

    def __init__(self, func: int, vu: int, ev_idx: int, t_submit: float):
        self.func = func
        self.vu = vu
        self.ev_idx = ev_idx
        self.t_submit = t_submit
        self.work_s = 0.0
        self.remaining_s = 0.0
        self.cold = False
        self.worker = -1
        self.migrated = False  # re-injected by cross-shard work stealing
        self.attempts = 0  # failure retries so far (backoff exponent)
        self.fail_t = -1.0  # first time a failure hit this task (<0: never)


class _Worker:
    """Processor-sharing server with a sandbox memory pool."""

    __slots__ = (
        "wid", "cores", "pool_mb", "running", "idle", "busy_mem_mb", "idle_mem_mb",
        "pending", "last_t", "version", "alive", "_min_rem", "_min_ok", "_sched_t",
    )

    def __init__(self, wid: int, cfg: SimConfig):
        self.wid = wid
        self.cores = cfg.cores_per_worker
        self.pool_mb = cfg.mem_pool_mb
        self.running: List[_Task] = []
        # func -> idle instances in ascending last_used order (append-newest /
        # evict-oldest-first keeps the invariant; see evict_lru)
        self.idle: Dict[int, List[_Instance]] = {}
        self.busy_mem_mb = 0.0
        self.idle_mem_mb = 0.0
        self.pending: List[_Task] = []  # waiting for memory
        self.last_t = 0.0
        self.version = 0  # invalidates stale completion events
        self.alive = True
        # cached min(task.remaining_s) over running; valid while _min_ok.
        # Advancing subtracts the identical dt*rate from every task, which
        # preserves both the argmin and (bitwise) the minimum value.
        self._min_rem = 0.0
        self._min_ok = True
        self._sched_t: Optional[float] = None  # time of the live completion event

    # ---------------------------------------------------------------- PS
    def advance(self, t: float) -> None:
        dt = t - self.last_t
        running = self.running
        if dt > 0 and running:
            n = len(running)
            cores = self.cores
            d = dt if cores >= n else dt * (cores / n)
            for task in running:
                task.remaining_s -= d
            if self._min_ok:
                self._min_rem -= d
        self.last_t = t

    def start(self, task: _Task) -> None:
        self.running.append(task)
        if self._min_ok:
            if len(self.running) == 1 or task.remaining_s < self._min_rem:
                self._min_rem = task.remaining_s

    def next_completion(self, t: float) -> Optional[float]:
        running = self.running
        if not running:
            return None
        if not self._min_ok:
            m = running[0].remaining_s
            for task in running:
                rs = task.remaining_s
                if rs < m:
                    m = rs
            self._min_rem = m
            self._min_ok = True
        m = self._min_rem
        if m <= 0.0:
            m = 0.0
        n = len(running)
        cores = self.cores
        return t + (m if cores >= n else m / (cores / n))

    # ------------------------------------------------------------- memory
    def mem_usage(self) -> float:
        return self.busy_mem_mb + self.idle_mem_mb

    def pop_idle(self, func: int) -> _Instance:
        lst = self.idle[func]
        inst = lst.pop()
        if not lst:
            del self.idle[func]
        self.idle_mem_mb -= inst.mem_mb
        return inst

    def evict_lru(self) -> Optional[_Instance]:
        """Evict the least-recently-used idle instance (force eviction).

        Each per-func list is ascending in ``last_used``, so the global LRU
        is the strictly smallest head across funcs — first such func in dict
        order, exactly the instance the seed engine's full scan selected.
        """
        best_func = -1
        best_last = None
        for func, lst in self.idle.items():
            h = lst[0].last_used
            if best_last is None or h < best_last:
                best_last = h
                best_func = func
        if best_last is None:
            return None
        lst = self.idle[best_func]
        inst = lst.pop(0)
        if not lst:
            del self.idle[best_func]
        self.idle_mem_mb -= inst.mem_mb
        return inst


# Shared fluctuation bands: (seed, n_vus, sigma) -> {"cols": int, "rows":
# list-of-lists, "pending": set-of-row-indices}.  Rows are grown in place, so
# the 4-scheduler benchmark matrix pays for each (seed, vu, ev) draw once, not
# once per scheduler.  "pending" rows were appended empty by ``admit_vu`` and
# are filled lazily in batch (``_flush_fluct``) — deterministic regardless of
# which sharing simulator flushes, because every row's fill is a pure function
# of its (seed, vu) identity and the shared cache key fixes the seed.
_FLUCT_CACHE: Dict[Tuple[int, int, float], Dict] = {}


@dataclasses.dataclass(frozen=True)
class StolenTask:
    """One queued task exported by :meth:`Simulator.steal_queued` — the unit
    of cross-shard work stealing (see ``core.stealing``).

    Everything a destination shard needs to replay the request — and the
    migrated VU's whole future — bit-exactly travels with the task:

    * ``func``/``ev_idx``/``t_submit`` — the request itself; ``t_submit`` is
      the *original* submission time, so its latency keeps the queueing delay
      accrued on the victim shard plus the migration wait.
    * ``origin_seed``/``origin_vu`` — the service-fluctuation identity of the
      VU's *first* binding.  All of the VU's draws — this request and every
      later one — stay ``default_rng((origin_seed, origin_vu, ev))`` no
      matter how many times it migrates (the paper's fairness device is
      invariant under migration).
    * ``fluct_row`` — the draws materialized so far (destination fills any
      gap from the identity, bit-exact either way).
    * ``program``/``prog_funcs``/``prog_sleeps``/``next_pos`` — the closed
      loop: the VU resumes its program on the destination at ``next_pos``.
    * ``src_vu`` — the victim-shard-local VU id at steal time (coordinator
      bookkeeping: maps to the global id through the admission table).
    * ``attempts``/``fail_t`` — the task's failure-retry history (backoff
      exponent and first-failure time), carried so a salvaged task's
      recovery latency is charged on the shard that finally completes it.
    """

    func: int
    ev_idx: int
    t_submit: float
    origin_seed: int
    origin_vu: int
    fluct_row: List[float]
    program: VUProgram
    prog_funcs: List[int]
    prog_sleeps: List[float]
    next_pos: int
    src_vu: int
    attempts: int = 0
    fail_t: float = -1.0


@dataclasses.dataclass(frozen=True)
class SalvagedVU:
    """One live VU exported off a *dead* shard by
    :meth:`Simulator.salvage_queued` — the unit of dead-shard drain
    (``core.stealing.drain_tick``).

    ``stolen`` reuses the :class:`StolenTask` migration identity (program,
    resume position, bit-exact service-fluctuation identity), so re-homing a
    salvaged VU replays the same draws as a work-stealing migration would.
    ``in_flight`` distinguishes the two VU states a dead shard can hold:

    * ``True`` — the VU's single outstanding request was waiting for retry
      (a ``_RESUBMIT`` event); the receiver re-dispatches it immediately and
      the completion is flagged ``migrated``.
    * ``False`` — the VU was mid-think (a scheduled ``_SUBMIT``); the
      receiver resumes its program at ``resume_t`` (clamped to its clock),
      and ``stolen.func``/``ev_idx`` echo the *next* program position.

    ``resume_t`` is the dead shard's scheduled event time for the VU (the
    retry time or the end-of-think submit time).
    """

    stolen: StolenTask
    in_flight: bool
    resume_t: float


class Simulator:
    """Event-driven FaaS cluster; ``run()`` returns request records + stats.

    Entry points (all drive the ONE event loop, so the byte-for-byte replay
    contract against the frozen seed engine covers each of them):

    * :meth:`run` — batch: drain to the deadline, return the record list.
    * :meth:`run_iter` — cooperative: yields every ``yield_every`` events
      (the sharded driver's ``interleaved`` backend).
    * :meth:`begin` + :meth:`step_until` — externally clocked: the caller
      advances simulated time in slices and may inject arrivals between
      slices via :meth:`admit_vu` (streaming merge / admission tier).

    Args:
        scheduler: any ``core.Scheduler``; fed the assign/finish/evict
            callbacks the real control plane would issue.
        funcs: function population (default: the seeded 40-function
            Azure-like population from ``trace.make_functions``).
        cfg: cluster knobs (:class:`SimConfig`).
        seed: workload seed.  Seeds VU programs *and* the per-request
            service-fluctuation identity ``(seed, vu, ev)``; under the
            sharded driver this is ``shard_seed(seed, k)``.
    """

    def __init__(
        self,
        scheduler: Scheduler,
        funcs: Optional[Sequence[FunctionSpec]] = None,
        cfg: Optional[SimConfig] = None,
        seed: int = 0,
    ):
        self.cfg = cfg or SimConfig()
        self.sched = scheduler
        self.funcs = list(funcs) if funcs is not None else make_functions(seed=seed)
        self.seed = seed
        self.workers = {w: _Worker(w, self.cfg) for w in range(self.cfg.n_workers)}
        # incremental pressure counters: total pending tasks and workers with
        # at least one running task, maintained at every mutation site so
        # pressure() is O(1) instead of an O(workers) scan per call.  The
        # cluster tier polls pressure per shard per tick — at 100k workers
        # the scan was the coordination cost, not the event loop.
        self._queued_n = 0
        self._busy_n = 0
        # dirty-shard publication (core.coord): when a coordinator attaches a
        # sink, any state change that can move pressure / warm state / the
        # dead-or-alive status adds this shard's index to it.  None (the
        # default) costs one truth test on the marking paths and nothing in
        # the event loop itself — static runs are untouched.
        self._dirty_sink: Optional[set] = None
        self._dirty_idx = -1
        self._heap: List[Tuple[float, int, int, tuple]] = []
        self._seq = itertools.count()
        self.t = 0.0
        self._deadline = 0.0  # set by begin()/run_iter()
        # columnar accumulation; .records/.assignments are lazy list views
        self._rec = RecordAccumulator()
        self._rec_append = self._rec.append
        self._rec_list: Optional[List[RequestRecord]] = None
        self._asg_t: List[float] = []
        self._asg_w: List[int] = []
        self._asg_list: Optional[List[Tuple[float, int]]] = None
        self._failures: List[Tuple[float, int]] = []
        self._additions: List[Tuple[float, int]] = []
        self.n_events = 0  # heap events processed (bench_sim_speed)
        # cross-shard work stealing (core.stealing) telemetry + state:
        # _fluct_identity is None until the first foreign (stolen-in) VU
        # arrives; then it maps row index -> (seed, vu) fluctuation identity.
        self.stolen_out = 0
        self.stolen_in = 0
        self._fluct_identity: Optional[List[Tuple[int, int]]] = None
        # failure telemetry (core.chaos / RunMetrics failure columns):
        self.resubmits = 0  # retry pushes after a failure hit a task
        self.lost_tasks = 0  # tasks dropped after exhausting retry_budget
        self.salvaged_out = 0  # VUs exported off this (dead) shard
        self.salvaged_in = 0  # salvaged VUs re-homed onto this shard
        self.recovery_s: List[float] = []  # first-failure -> completion, s
        # advisory preemption notices: (t, worker, until) — see inject_notice
        self._notices: List[Tuple[float, int, float]] = []
        # elastic-pool cost accounting (core.autoscale): piecewise integral
        # of the live worker count over simulated time, accrued at the only
        # two places the count changes (_ev_fail / _ev_add_worker).  Pure
        # bookkeeping — no event is reordered, so byte-identity holds.
        self._ws_acc = 0.0
        self._ws_t = 0.0
        # per-function warm-set digest: func -> idle (warm) instance count
        # across live workers, maintained incrementally at every idle-set
        # mutation (complete / warm reuse / LRU evict / keep-alive sweep /
        # worker death).  Pure bookkeeping on existing transitions — no RNG,
        # no event reordering — so the byte-for-byte replay contract with
        # tests/legacy is untouched.  Read via warm_digest().
        self._warm: Dict[int, int] = {}
        # pre-resolved per-function metadata (hot-loop lookups)
        self._fnames = [f.name for f in self.funcs]
        self._fmem = [f.mem_mb for f in self.funcs]
        self._fcold = [f.cold_ms for f in self.funcs]
        self._fwarm = [f.warm_ms for f in self.funcs]

    # ------------------------------------------------------------ views
    @property
    def records(self) -> List[RequestRecord]:
        """Legacy list-of-``RequestRecord`` view (materialized, cached)."""
        if self._rec_list is None or len(self._rec_list) != len(self._rec):
            self._rec_list = self._rec.to_records()
        return self._rec_list

    @property
    def record_columns(self) -> RecordColumns:
        """The record stream as numpy columns (no per-record objects)."""
        return self._rec.columns()

    @property
    def assignments(self) -> List[Tuple[float, int]]:
        """Legacy ``[(t, worker), ...]`` view (materialized, cached)."""
        if self._asg_list is None or len(self._asg_list) != len(self._asg_t):
            self._asg_list = list(zip(self._asg_t, self._asg_w))
        return self._asg_list

    @property
    def assignment_columns(self) -> Tuple[np.ndarray, np.ndarray]:
        """Assignment trace as ``(t float64[], worker int64[])`` columns."""
        return (
            np.asarray(self._asg_t, np.float64),
            np.asarray(self._asg_w, np.int64),
        )

    # ------------------------------------------------------------- events
    def _push(self, t: float, kind: int, payload: tuple = ()) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def inject_failure(self, t: float, worker: int) -> None:
        """Schedule worker ``worker`` to fail at time ``t``.

        ``worker`` must be a nonnegative id that exists by time ``t`` —
        either in the initial ``[0, n_workers)`` range or scheduled via
        :meth:`inject_worker`; :meth:`begin` validates the full schedule
        (unknown ids and times past the run deadline raise ``ValueError``
        instead of silently never firing)."""
        if worker < 0:
            raise ValueError(f"inject_failure: worker id must be >= 0, got {worker}")
        if t < 0:
            raise ValueError(f"inject_failure: t must be >= 0, got {t}")
        self._failures.append((t, worker))

    def inject_worker(self, t: float, worker: int) -> None:
        """Schedule a worker with id ``worker`` to join at time ``t``.

        New ids beyond the initial range are the elastic scale-up path;
        re-adding a previously failed id revives it.  :meth:`begin`
        validates ``t`` against the run deadline (see
        :meth:`inject_failure`)."""
        if worker < 0:
            raise ValueError(f"inject_worker: worker id must be >= 0, got {worker}")
        if t < 0:
            raise ValueError(f"inject_worker: t must be >= 0, got {t}")
        self._additions.append((t, worker))

    def inject_notice(self, t: float, worker: int, until: float) -> None:
        """Advisory preemption notice: ``worker`` is scheduled to die at
        ``until`` (spot-preemption semantics; the kill needs its own
        :meth:`inject_failure`).

        While the notice window ``[t, until)`` is open, the worker is
        excluded from the :meth:`warm_capacity` headroom sum and its idle
        instances from the :meth:`warm_digest` counts — capacity about to be
        preempted is not headroom new work should be routed onto.  Purely
        advisory: the event loop, records, and replay identity are
        untouched (a static run with notices stays byte-identical to one
        without).  :meth:`begin` validates ids like :meth:`inject_failure`.
        """
        if worker < 0:
            raise ValueError(f"inject_notice: worker id must be >= 0, got {worker}")
        if t < 0:
            raise ValueError(f"inject_notice: t must be >= 0, got {t}")
        if until < t:
            raise ValueError(f"inject_notice: until={until} precedes t={t}")
        self._notices.append((t, worker, until))

    # ------------------------------------------- mid-run elasticity hooks
    # The inject_* schedule above is pre-run: begin() validates it in one
    # pass and seeds the heap.  The schedule_* forms below are the *live*
    # counterparts for an already-armed loop — the autoscaler actuator
    # (core.autoscale) calls them between step_until() slices.  Each one
    # validates eagerly (begin() has already run) and marks the shard dirty
    # immediately, so the ShardCoordinator contract (§13) covers every
    # autoscaler mutation the same tick it is scheduled.

    def _check_schedule(self, hook: str, t: float, worker: int) -> None:
        if worker < 0:
            raise ValueError(f"{hook}: worker id must be >= 0, got {worker}")
        if t < self.t:
            raise ValueError(
                f"{hook}: t={t} precedes the shard clock {self.t} — events "
                "cannot be scheduled into the past"
            )
        if t > self._deadline:
            raise ValueError(
                f"{hook}: t={t} is past the run deadline {self._deadline} "
                "and would never fire"
            )

    def schedule_worker_add(self, t: float, worker: int) -> None:
        """Mid-run :meth:`inject_worker`: worker ``worker`` (re)joins at
        ``t``.  Requires a prior :meth:`begin`; ``t`` must lie between the
        shard clock and the run deadline."""
        self._check_schedule("schedule_worker_add", t, worker)
        self._push(t, _ADD, (worker,))
        self._mark_dirty()

    def schedule_worker_fail(self, t: float, worker: int) -> None:
        """Mid-run :meth:`inject_failure`: worker ``worker`` dies at ``t``
        (same validation window as :meth:`schedule_worker_add`)."""
        self._check_schedule("schedule_worker_fail", t, worker)
        self._push(t, _FAIL, (worker,))
        self._mark_dirty()

    def schedule_notice(self, t: float, worker: int, until: float) -> None:
        """Mid-run :meth:`inject_notice`: open an advisory preemption
        window ``[t, until)`` on ``worker`` right now.  ``_doomed_now``
        reads the notice list live, so the warm-capacity/digest exclusion
        applies from the moment the window opens."""
        self._check_schedule("schedule_notice", t, worker)
        if until < t:
            raise ValueError(f"schedule_notice: until={until} precedes t={t}")
        self._notices.append((t, worker, until))
        self._mark_dirty()

    # ------------------------------------------------ worker-seconds cost
    def _ws_accrue(self) -> None:
        self._ws_acc += len(self.workers) * (self.t - self._ws_t)
        self._ws_t = self.t

    def worker_seconds_until(self, t: float) -> float:
        """Integral of the live worker count from the run start to ``t`` —
        the provisioned-capacity cost (worker-seconds) an elastic pool is
        scored on (``benchmarks/bench_autoscale.py``).  Non-mutating; a
        static run reads ``n_workers * duration``."""
        return self._ws_acc + len(self.workers) * max(t - self._ws_t, 0.0)

    # ------------------------------------------------------- fluctuations
    def _fluct_entry(self, n_vus: int) -> Dict:
        key = (self.seed, n_vus, self.cfg.exec_sigma)
        entry = _FLUCT_CACHE.get(key)
        if entry is None:
            if len(_FLUCT_CACHE) >= 8:
                _FLUCT_CACHE.clear()
            entry = _FLUCT_CACHE[key] = {
                "cols": 0,
                "rows": [[] for _ in range(n_vus)],
                "pending": set(),
            }
        return entry

    def _fluct_row_identity(self, v: int) -> Tuple[int, int]:
        """Row index -> the (seed, vu) its draws are seeded by.

        Native rows are ``(self.seed, v)``; rows received through work
        stealing keep their origin identity (``_fluct_identity``)."""
        ident = self._fluct_identity
        return ident[v] if ident is not None else (self.seed, v)

    @staticmethod
    def _identity_runs(idxs) -> Iterator[Tuple[int, int, List[int]]]:
        """Group ``(row_index, seed, vu)`` triples into maximal runs of the
        same seed and consecutive vus, so each run fills with ONE vectorized
        ``service_fluctuations`` call (bit-identical to per-row calls by the
        fastrng identity contract)."""
        run: List[int] = []
        run_seed = run_vu0 = 0
        for i, s, v in idxs:
            if run and s == run_seed and v == run_vu0 + len(run):
                run.append(i)
                continue
            if run:
                yield run_seed, run_vu0, run
            run, run_seed, run_vu0 = [i], s, v
        if run:
            yield run_seed, run_vu0, run

    def _flush_fluct(self) -> None:
        """Fill rows ``admit_vu`` appended lazily, batched per identity run.

        Deferring the fill to first use turns the admission tier's one
        kernel invocation *per admitted VU* into one per admission burst
        (same doubles: entry ``[i, j]`` is a pure function of the (seed, vu,
        ev) identity, so batched and per-VU grows are bit-identical)."""
        entry = self._fluct
        pending = entry["pending"]
        if not pending:
            return
        cols = entry["cols"]
        if cols:
            rows = entry["rows"]
            sigma = self.cfg.exec_sigma
            triples = sorted((i, *self._fluct_row_identity(i)) for i in pending)
            for seed, vu0, run in self._identity_runs(triples):
                band = service_fluctuations(seed, len(run), cols, sigma, vu_start=vu0)
                for i, extra in zip(run, band.tolist()):
                    rows[i].extend(extra)
        pending.clear()

    def _extend_fluct(self, upto: int) -> None:
        """Grow the fluctuation band to cover event index ``upto``."""
        self._flush_fluct()
        entry = self._fluct
        cols = entry["cols"]
        new_cols = max(upto + 1, cols * 2, 32)
        sigma = self.cfg.exec_sigma
        rows = entry["rows"]
        if self._fluct_identity is None:
            band = service_fluctuations(self.seed, len(rows), new_cols - cols, sigma, ev_start=cols)
            for row, extra in zip(rows, band.tolist()):
                row.extend(extra)
        else:
            triples = ((i, *self._fluct_identity[i]) for i in range(len(rows)))
            for seed, vu0, run in self._identity_runs(triples):
                band = service_fluctuations(
                    seed, len(run), new_cols - cols, sigma, ev_start=cols, vu_start=vu0
                )
                for i, extra in zip(run, band.tolist()):
                    rows[i].extend(extra)
        entry["cols"] = new_cols

    def _detach_fluct(self) -> None:
        """Give this simulator a private fluctuation table (copy-on-steal).

        Cache entries are shared by (seed, n_vus, sigma); foreign rows from
        stolen-in VUs are *not* a pure function of that key, so the first
        ``receive_task`` detaches from the shared cache before appending.
        With stealing off this never runs and the shared-band fast path is
        untouched."""
        if self._fluct_identity is not None:
            return
        entry = self._fluct
        self._fluct = {
            "cols": entry["cols"],
            "rows": [list(r) for r in entry["rows"]],
            "pending": set(entry["pending"]),
        }
        self._fluct_identity = [(self.seed, v) for v in range(len(entry["rows"]))]

    # --------------------------------------------------------------- run
    def run(
        self,
        n_vus: int = 20,
        duration_s: float = 100.0,
        programs: Optional[List[VUProgram]] = None,
        t_start: float = 0.0,
    ) -> List[RequestRecord]:
        """Run the full experiment and return the legacy record list.

        Args:
            n_vus: closed-loop virtual users (all start at ``t_start``).
            duration_s: simulated experiment length, seconds; events past
                ``t_start + duration_s`` are not processed.
            programs: explicit per-VU programs (len == ``n_vus``); default
                generates the seeded Azure-like workload.
            t_start: simulated start time, seconds.

        Bound by the byte-for-byte replay contract: the returned
        ``RequestRecord`` stream is identical to the frozen seed engine's
        for the same (scheduler, cfg, seed, workload).
        """
        for _ in self.run_iter(n_vus, duration_s, programs, t_start):
            pass
        return self.records

    def begin(
        self,
        n_vus: int = 20,
        duration_s: float = 100.0,
        programs: Optional[List[VUProgram]] = None,
        t_start: float = 0.0,
    ) -> None:
        """Arm the event loop without running it (the backpressure hook).

        Seeds the heap with the initial VU submits, the keep-alive sweep and
        any injected failure/addition events, exactly as :meth:`run_iter`
        does before its first pop.  Afterwards the caller drives the clock
        explicitly with :meth:`step_until` and may feed arrivals in with
        :meth:`admit_vu` — this is how the global admission tier
        (``core.admission``) co-runs K shard simulators in simulated-time
        lockstep.  ``begin(n_vus=0, programs=[])`` arms an *empty* cluster
        that only serves admitted VUs.
        """
        cfg = self.cfg
        if programs is None:
            programs = make_vu_programs(
                self.funcs, n_vus, default_n_events(duration_s), self.seed
            )
        self._programs = list(programs)
        self._prog_funcs = [p.func_idx.tolist() for p in programs]
        self._prog_sleeps = [p.sleep_s.tolist() for p in programs]
        self._vu_pos = [0] * n_vus
        self._deadline = t_start + duration_s
        self._ws_acc = 0.0
        self._ws_t = t_start
        self._fluct_identity = None  # fresh run: all rows native until a steal
        self._fluct = self._fluct_entry(n_vus)
        self._overhead_s = cfg.overhead_ms / 1e3

        # injection-schedule validation: an event past the deadline or a
        # failure of a worker that never exists would silently no-op — loud
        # ValueError instead (the chaos tier builds on these hooks)
        known = set(range(cfg.n_workers)) | {w for _, w in self._additions}
        for t, w in self._failures:
            if w not in known:
                raise ValueError(
                    f"inject_failure({t}, {w}): worker {w} is neither in the "
                    f"initial range [0, {cfg.n_workers}) nor scheduled by "
                    "inject_worker"
                )
            if t > self._deadline:
                raise ValueError(
                    f"inject_failure({t}, {w}): t is past the run deadline "
                    f"{self._deadline} and would never fire"
                )
        for t, w in self._additions:
            if t > self._deadline:
                raise ValueError(
                    f"inject_worker({t}, {w}): t is past the run deadline "
                    f"{self._deadline} and would never fire"
                )
        for t, w, until in self._notices:
            if w not in known:
                raise ValueError(
                    f"inject_notice({t}, {w}, {until}): worker {w} is neither "
                    f"in the initial range [0, {cfg.n_workers}) nor scheduled "
                    "by inject_worker"
                )

        for vu in range(n_vus):
            self._push(t_start, _SUBMIT, (vu,))
        self._push(t_start + cfg.sweep_every_s, _SWEEP)
        for t, w in self._failures:
            self._push(t, _FAIL, (w,))
        for t, w in self._additions:
            self._push(t, _ADD, (w,))

    def _step_event(self, kind: int, payload: tuple) -> None:
        # The one kind->handler dispatch, shared by run_iter and step_until
        # so the two clock forms cannot drift apart.
        if kind == _SUBMIT:
            self._ev_submit(payload[0])
        elif kind == _COMPLETE:
            self._ev_complete(payload[0], payload[1])
        elif kind == _RESUBMIT:
            self._dispatch(payload[0])
        elif kind == _SWEEP:
            self._ev_sweep()
        elif kind == _FAIL:
            self._ev_fail(payload[0])
        else:
            self._ev_add_worker(payload[0])

    def run_iter(
        self,
        n_vus: int = 20,
        duration_s: float = 100.0,
        programs: Optional[List[VUProgram]] = None,
        t_start: float = 0.0,
        yield_every: int = 4096,
    ) -> Iterator[int]:
        """Generator form of :meth:`run`: identical event semantics, but
        yields the running processed-event count every ``yield_every``
        events so multiple simulators can be interleaved cooperatively in
        one process (the sharded driver's ``interleaved`` backend).

        ``run`` is exactly ``drain(run_iter(...))`` — there is ONE event
        loop, so the byte-for-byte replay contract with tests/legacy covers
        both entry points.  (:meth:`begin` + :meth:`step_until` expose the
        same loop under external clock control; the pop/dispatch sequence,
        and therefore the record stream, is identical on every path.)
        """
        self.begin(n_vus, duration_s, programs, t_start)
        heap = self._heap
        pop = heapq.heappop
        step = self._step_event
        deadline = self._deadline
        n = 0
        try:
            while heap:
                t, _, kind, payload = pop(heap)
                if t > deadline:
                    break
                self.t = t
                n += 1
                step(kind, payload)
                if not n % yield_every:
                    yield n
        finally:
            # also runs on GeneratorExit, so a consumer that stops driving
            # the generator early still gets the processed events accounted
            self.n_events += n

    # ----------------------------------------------- stepped clock / admission
    def step_until(self, t_limit: float) -> int:
        """Process every pending event with time <= ``t_limit`` (seconds).

        The stepped form of the :meth:`run_iter` loop: same pop order, same
        handler dispatch, so driving a simulator with a monotone sequence of
        ``step_until`` calls up to the deadline reproduces the exact record
        stream ``run`` emits (events past the deadline are never processed
        on either path).  Requires a prior :meth:`begin`.  Returns the
        number of events processed this call.
        """
        heap = self._heap
        pop = heapq.heappop
        step = self._step_event
        deadline = self._deadline
        bound = t_limit if t_limit < deadline else deadline
        n = 0
        while heap and heap[0][0] <= bound:
            t, _, kind, payload = pop(heap)
            self.t = t
            n += 1
            step(kind, payload)
        self.n_events += n
        if n:
            self._mark_dirty()
        return n

    @property
    def done(self) -> bool:
        """True once no pending event falls inside the deadline."""
        return not self._heap or self._heap[0][0] > self._deadline

    def next_event_time(self) -> float:
        """Time of the earliest pending event (``inf`` on an empty heap).

        The event frontier the cluster tier uses to skip ``step_until`` on
        shards with nothing scheduled inside the tick — an O(1) peek, so an
        idle shard costs one comparison per tick instead of a call."""
        return self._heap[0][0] if self._heap else float("inf")

    def heap_density(self, horizon_s: float = 0.25) -> float:
        """Pending events per second inside the heap's near horizon.

        Counts events within ``horizon_s`` of the earliest pending event —
        the burst signal a :class:`BurstDetector` folds to pick dispatch
        chunk sizes.  One O(heap) pass; meant to be sampled per dispatch
        batch or per tick, never per event."""
        if horizon_s <= 0:
            raise ValueError(f"horizon_s must be > 0, got {horizon_s}")
        heap = self._heap
        if not heap:
            return 0.0
        hi = heap[0][0] + horizon_s
        n = 0
        for ev in heap:
            if ev[0] <= hi:
                n += 1
        return n / horizon_s

    def attach_dirty(self, sink: set, idx: int) -> None:
        """Publish this shard's state changes into ``sink`` as index ``idx``.

        The dirty-shard contract (docs/ARCHITECTURE.md §13): after any event
        processing or external mutation (admit / receive / steal / salvage)
        the shard adds ``idx`` to ``sink``; the coordinator drains the set
        each tick and re-reads only those shards.  Marking may over-approximate
        (a sweep that evicted nothing still marks) — that costs a cached
        re-read, never a stale decision.  Attaching marks immediately so the
        first refresh sees every shard."""
        self._dirty_sink = sink
        self._dirty_idx = idx
        sink.add(idx)

    def _mark_dirty(self) -> None:
        s = self._dirty_sink
        if s is not None:
            s.add(self._dirty_idx)

    def pressure(self) -> float:
        """Local load pressure: queued arrivals per worker + busy fraction.

        ``queued`` counts tasks parked on worker pending queues (admitted
        but waiting for sandbox memory); ``busy`` counts workers with at
        least one running task.  Both are normalized by the live worker
        count, so an idle cluster reads 0.0, a fully busy queue-free
        cluster reads 1.0, and queueing pushes the value above 1.  This is
        the watermark signal the global admission tier polls between
        :meth:`step_until` calls.

        O(1): both counts are maintained incrementally at every mutation
        site (:meth:`_pressure_ref` is the retired scan, kept as the
        invariant oracle for tests).  Same integers, same division — the
        value is bit-identical to the scan's.
        """
        alive = len(self.workers)
        if not alive:
            return float("inf")
        return (self._queued_n + self._busy_n) / alive

    def _pressure_ref(self) -> float:
        """The original O(workers) pressure scan — the oracle the counter
        invariant is pinned against (tests/test_coord.py)."""
        alive = busy = queued = 0
        for w in self.workers.values():
            alive += 1
            if w.running:
                busy += 1
            queued += len(w.pending)
        if not alive:
            return float("inf")
        return (queued + busy) / alive

    def _doomed_now(self) -> set:
        """Live worker ids currently inside a preemption-notice window
        (``tn <= now < until``; see :meth:`inject_notice`).  Empty set —
        and zero overhead beyond one truth test — when no notices exist."""
        if not self._notices:
            return set()
        now = self.t
        return {
            w for tn, w, until in self._notices
            if tn <= now < until and w in self.workers
        }

    def warm_capacity(self) -> float:
        """Fraction of sandbox-pool memory not pinned by running tasks.

        ``(free + idle) / pool`` summed over live workers, in ``[0, 1]``:
        idle memory is warm instances a new request can reuse, free memory
        can host a fresh sandbox without eviction — together they are the
        headroom to place new work without queueing behind the memory pool.
        0.0 for a dead cluster (no live workers).  This is the cold-start
        cost signal admission policies read (``core.policies.CostPolicy``)
        alongside :meth:`pressure`.

        Workers inside an open preemption-notice window
        (:meth:`inject_notice`) are excluded from the sum entirely: their
        pools are capacity about to be preempted, not headroom — counting
        them would route new work onto sandboxes scheduled to die.  A
        cluster whose every live worker is doomed reads 0.0.  The field's
        validity window for policies is documented in docs/POLICIES.md §2.
        """
        doomed = self._doomed_now()
        total = busy = 0.0
        for w in self.workers.values():
            if w.wid in doomed:
                continue
            total += w.pool_mb
            busy += w.busy_mem_mb
        if total <= 0.0:
            return 0.0
        return (total - busy) / total

    def warm_digest(self) -> Dict[int, int]:
        """Per-function warm-set digest: ``{func_index: warm_count}`` over
        live, un-doomed workers — the shard's locality signal.

        ``warm_count`` is the number of idle (keep-alive) instances of the
        function a new request could reuse right now.  The counts are
        maintained incrementally at every idle-set transition (completion
        adds, warm reuse / LRU eviction / keep-alive sweep / worker death
        remove), so the read is O(distinct warm functions) — a dict copy —
        not an O(workers × instances) scan.  Functions with zero warm
        instances are absent, which keeps the digest compact.

        Idle instances on workers inside an open preemption-notice window
        are subtracted (same rule as :meth:`warm_capacity`): warmth about
        to be preempted must not attract new placements.  The affinity
        admission policy (``core.policies.AffinityPolicy``) and the
        work-stealing tier (``core.stealing.steal_tick``) consume this via
        ``ShardState.warm_digest``; the contract is normative in
        docs/ARCHITECTURE.md §11.
        """
        digest = dict(self._warm)
        doomed = self._doomed_now()
        if doomed:
            for wid in doomed:
                for func, lst in self.workers[wid].idle.items():
                    c = digest.get(func, 0) - len(lst)
                    if c > 0:
                        digest[func] = c
                    else:
                        digest.pop(func, None)
        return digest

    def _warm_dec(self, func: int, n: int = 1) -> None:
        """Drop ``n`` warm instances of ``func`` from the digest counts."""
        w = self._warm
        c = w.get(func, 0) - n
        if c > 0:
            w[func] = c
        else:
            w.pop(func, None)

    def admit_vu(self, program: VUProgram, t: Optional[float] = None) -> int:
        """Admit one closed-loop VU mid-run (the admission tier's pull).

        Appends the program to the live population and schedules its first
        submit at time ``t`` (default: the current clock).  Returns the new
        VU's *local* id — callers that merge streams across simulators keep
        their own local->global id map.  The VU's service-fluctuation row is
        pre-filled to the band's current width so the (seed, vu, ev)
        identity seeding holds for admitted VUs exactly as for planned
        ones.  Requires a prior :meth:`begin`; ``t`` must not precede the
        current clock.

        The row itself is appended *empty* and marked pending: the fill to
        the band's current width happens lazily (``_flush_fluct``) at the
        VU's first dispatch, so a burst of admissions costs one vectorized
        kernel call instead of one per VU — with bit-identical draws.
        """
        t = self.t if t is None else float(t)
        if t < self.t:
            raise ValueError(f"cannot admit in the past: t={t} < now={self.t}")
        vu = len(self._prog_funcs)
        self._programs.append(program)
        self._prog_funcs.append(program.func_idx.tolist())
        self._prog_sleeps.append(program.sleep_s.tolist())
        self._vu_pos.append(0)
        entry = self._fluct
        rows = entry["rows"]
        cols = entry["cols"]
        while len(rows) <= vu:  # deterministic grow (entries may be shared)
            v = len(rows)
            rows.append([])
            if cols:
                entry["pending"].add(v)
            if self._fluct_identity is not None:
                self._fluct_identity.append((self.seed, v))
        self._push(t, _SUBMIT, (vu,))
        self._mark_dirty()
        return vu

    # ------------------------------------------------- cross-shard stealing
    def steal_queued(self, n: int, prefer=None) -> List[StolenTask]:
        """Export up to ``n`` tasks parked on worker pending queues (the
        work-stealing victim hook; see :class:`StolenTask` for what travels).

        Only *pending* tasks — admitted but still waiting for sandbox memory
        — are stealable: they hold no memory, have done no work, and are
        their closed-loop VU's single in-flight request, so exporting one
        migrates the VU's entire future with it (the VU is retired locally;
        no local events for it remain).  Victim order is deterministic:
        longest pending queue first (ties by registration order), newest
        task first.

        ``prefer`` (optional): a set of function indices the thief can serve
        warm (its ``warm_digest`` keys).  Victim-worker selection is
        unchanged, but within the chosen queue the newest task whose
        function is in ``prefer`` is exported instead of the plain newest —
        warm-locality stealing.  The fallback when nothing matches, and the
        ``prefer=None`` default, are byte-identical to the unparameterized
        form, so existing steal schedules are untouched.
        Each export releases the local scheduler's connection via
        ``on_cancel`` — the assignment never executed here.
        """
        out: List[StolenTask] = []
        while len(out) < n:
            victim = None
            best = 0
            for w in self.workers.values():
                if len(w.pending) > best:
                    best = len(w.pending)
                    victim = w
            if victim is None:
                break
            task = victim.pending.pop()
            if prefer and task.func not in prefer:
                # scan newest -> oldest for the first warm-servable task;
                # the already-popped newest is the fallback
                pend = victim.pending
                for i in range(len(pend) - 1, -1, -1):
                    if pend[i].func in prefer:
                        pend.append(task)  # put the fallback back (newest)
                        task = pend.pop(i)
                        break
            self._queued_n -= 1  # net one task left pending (swap is neutral)
            self.sched.on_cancel(task.worker, self._fnames[task.func])
            vu = task.vu
            self._flush_fluct()
            oseed, ovu = self._fluct_row_identity(vu)
            out.append(
                StolenTask(
                    func=task.func,
                    ev_idx=task.ev_idx,
                    t_submit=task.t_submit,
                    origin_seed=oseed,
                    origin_vu=ovu,
                    fluct_row=list(self._fluct["rows"][vu]),
                    program=self._programs[vu],
                    prog_funcs=self._prog_funcs[vu],
                    prog_sleeps=self._prog_sleeps[vu],
                    next_pos=self._vu_pos[vu],
                    src_vu=vu,
                    attempts=task.attempts,
                    fail_t=task.fail_t,
                )
            )
            self._vu_pos[vu] = len(self._prog_funcs[vu])  # retire the VU here
            self.stolen_out += 1
        if out:
            self._mark_dirty()
        return out

    def _export_vu(self, vu: int, func: int, ev_idx: int, t_submit: float,
                   attempts: int = 0, fail_t: float = -1.0) -> StolenTask:
        """Package VU ``vu``'s whole future as a :class:`StolenTask` and
        retire it locally (shared by :meth:`steal_queued` — inlined there for
        the hot path — and :meth:`salvage_queued`).  Caller supplies the
        in-flight request identity, or the *next* program position for a
        mid-think VU."""
        self._flush_fluct()
        oseed, ovu = self._fluct_row_identity(vu)
        stolen = StolenTask(
            func=func,
            ev_idx=ev_idx,
            t_submit=t_submit,
            origin_seed=oseed,
            origin_vu=ovu,
            fluct_row=list(self._fluct["rows"][vu]),
            program=self._programs[vu],
            prog_funcs=self._prog_funcs[vu],
            prog_sleeps=self._prog_sleeps[vu],
            next_pos=self._vu_pos[vu],
            src_vu=vu,
            attempts=attempts,
            fail_t=fail_t,
        )
        self._vu_pos[vu] = len(self._prog_funcs[vu])  # retire the VU here
        return stolen

    def salvage_queued(self) -> List[SalvagedVU]:
        """Export every still-live VU of a DEAD shard (no live workers) —
        the dead-shard drain hook (``core.stealing.drain_tick``).

        When the last worker dies, every VU is in one of two states, both
        parked on the event heap: its single outstanding request waits for a
        backoff retry (``_RESUBMIT``), or it is mid-think with a scheduled
        next submit (``_SUBMIT``).  Both are pure control-plane state — no
        sandbox memory, no partial work — so each VU's whole future can
        migrate exactly like a stolen pending task (same
        :class:`StolenTask` identity, bit-exact service draws).  The
        exported events are removed from the heap (exactly-once: the task
        re-runs on the receiver or nowhere), VUs are retired locally, and
        sweep/stale events stay behind.  Raises on a shard that still has
        live workers — salvage is the *dead*-shard path; live imbalance is
        work stealing's job.
        """
        if self.workers:
            raise ValueError(
                "salvage_queued requires a dead shard (live workers: "
                f"{sorted(self.workers)}); use steal_queued for live rebalance"
            )
        out: List[SalvagedVU] = []
        keep: List[Tuple[float, int, int, tuple]] = []
        for entry in self._heap:
            t, _, kind, payload = entry
            if kind == _RESUBMIT:
                task: _Task = payload[0]
                stolen = self._export_vu(
                    task.vu, task.func, task.ev_idx, task.t_submit,
                    attempts=task.attempts, fail_t=task.fail_t,
                )
                out.append(SalvagedVU(stolen=stolen, in_flight=True, resume_t=t))
            elif kind == _SUBMIT:
                vu = payload[0]
                pos = self._vu_pos[vu]
                funcs = self._prog_funcs[vu]
                if pos >= len(funcs):
                    continue  # exhausted program: drop the stale submit
                stolen = self._export_vu(vu, funcs[pos], pos, t)
                out.append(SalvagedVU(stolen=stolen, in_flight=False, resume_t=t))
            else:
                keep.append(entry)
        if len(keep) != len(self._heap):
            self._heap = keep
            heapq.heapify(self._heap)
        self.salvaged_out += len(out)
        if out:
            self._mark_dirty()
        return out

    def receive_task(self, stolen: StolenTask, t: Optional[float] = None) -> int:
        """Re-inject a stolen task (the work-stealing destination hook).

        Registers the migrated VU as a fresh local id — program resumed at
        ``next_pos``, fluctuation row bound to the *origin* identity
        ``(origin_seed, origin_vu)`` so every service draw replays bit-exactly
        (see :class:`StolenTask`) — and dispatches the stolen request at time
        ``t`` (default: now) with its original submission time, so recorded
        latency keeps the victim-side queueing delay.  Completion marks the
        record's ``migrated`` column.  Returns the new local VU id; callers
        that merge streams extend their local->global id table with it.
        """
        t = self.t if t is None else float(t)
        if t < self.t:
            raise ValueError(f"cannot receive in the past: t={t} < now={self.t}")
        vu = self._register_foreign(stolen)
        task = _Task(stolen.func, vu, stolen.ev_idx, stolen.t_submit)
        task.migrated = True
        task.attempts = stolen.attempts
        task.fail_t = stolen.fail_t
        self._push(t, _RESUBMIT, (task,))
        self.stolen_in += 1
        self._mark_dirty()
        return vu

    def _register_foreign(self, stolen: StolenTask) -> int:
        """Register a migrated VU as a fresh local id: program resumed at
        ``next_pos``, fluctuation row bound to the origin identity
        ``(origin_seed, origin_vu)`` so every service draw replays
        bit-exactly.  Shared by :meth:`receive_task` (work stealing) and
        :meth:`receive_salvaged` (dead-shard drain)."""
        vu = len(self._prog_funcs)
        self._programs.append(stolen.program)
        self._prog_funcs.append(stolen.prog_funcs)
        self._prog_sleeps.append(stolen.prog_sleeps)
        self._vu_pos.append(stolen.next_pos)
        self._detach_fluct()
        self._flush_fluct()  # fill native placeholders before the foreign row
        entry = self._fluct
        cols = entry["cols"]
        row = list(stolen.fluct_row[:cols])
        if len(row) < cols:  # origin band was narrower: fill from identity
            band = service_fluctuations(
                stolen.origin_seed, 1, cols - len(row), self.cfg.exec_sigma,
                ev_start=len(row), vu_start=stolen.origin_vu,
            )
            row.extend(band[0].tolist())
        # the foreign row must land at exactly index ``vu``: a band inherited
        # from the shared cache may be wider than this run's population (rows
        # left by earlier same-seed runs), in which case the now-private slot
        # is repointed rather than appended past the VU's index
        rows = entry["rows"]
        if len(rows) == vu:
            rows.append(row)
            self._fluct_identity.append((stolen.origin_seed, stolen.origin_vu))
        else:
            rows[vu] = row
            self._fluct_identity[vu] = (stolen.origin_seed, stolen.origin_vu)
            entry["pending"].discard(vu)
        return vu

    def receive_salvaged(self, sal: SalvagedVU, t: Optional[float] = None) -> int:
        """Re-home a VU salvaged off a dead shard (the drain's destination
        hook; mirror of :meth:`receive_task`).

        An in-flight VU's lost request re-dispatches immediately at ``t`` —
        salvage *is* its recovery, so it does not also serve out the dead
        shard's remaining backoff delay — keeping its original submit time
        (recorded latency charges the whole outage) and its retry history;
        its completion is flagged ``migrated``.  A mid-think VU resumes its
        program at ``max(resume_t, t)``: thinking continued while the shard
        was dark, only dispatch needs a live home.  Returns the new local VU
        id for the admission table.
        """
        t = self.t if t is None else float(t)
        if t < self.t:
            raise ValueError(f"cannot receive in the past: t={t} < now={self.t}")
        stolen = sal.stolen
        vu = self._register_foreign(stolen)
        if sal.in_flight:
            task = _Task(stolen.func, vu, stolen.ev_idx, stolen.t_submit)
            task.migrated = True
            task.attempts = stolen.attempts
            task.fail_t = stolen.fail_t
            self._push(t, _RESUBMIT, (task,))
        else:
            self._push(max(sal.resume_t, t), _SUBMIT, (vu,))
        self.salvaged_in += 1
        self._mark_dirty()
        return vu

    def outstanding(self) -> int:
        """Submitted-but-unresolved requests right now: running + pending on
        live workers, plus retry re-submissions waiting on the heap.  On a
        dead shard after :meth:`salvage_queued` this is 0 — the acceptance
        signal that the drain strands nothing (mid-think VUs have no
        *submitted* request, so they don't count here)."""
        n = 0
        for entry in self._heap:
            if entry[2] == _RESUBMIT:
                n += 1
        for w in self.workers.values():
            n += len(w.running) + len(w.pending)
        return n

    # ------------------------------------------------------------ handlers
    def _ev_submit(self, vu: int) -> None:
        pos = self._vu_pos[vu]
        funcs = self._prog_funcs[vu]
        if pos >= len(funcs) or self.t > self._deadline:
            return
        self._vu_pos[vu] = pos + 1
        self._dispatch(_Task(funcs[pos], vu, pos, self.t))

    def _retry_delay(self, attempts: int) -> float:
        """Backoff schedule: attempt ``i`` (1-based) waits
        ``min(retry_delay_s * retry_backoff**(i-1), retry_max_delay_s)``.
        Attempt 1 is exactly ``retry_delay_s`` — the seed engine's flat
        delay — which is what keeps single-retry runs byte-identical."""
        cfg = self.cfg
        if attempts <= 1:
            return cfg.retry_delay_s
        d = cfg.retry_delay_s * cfg.retry_backoff ** (attempts - 1)
        return d if d < cfg.retry_max_delay_s else cfg.retry_max_delay_s

    def _retry_or_lose(self, task: _Task) -> None:
        """A failure hit ``task``: resubmit with backoff, or — once the
        per-task ``retry_budget`` is exhausted — drop it as lost.  A lost
        task's closed-loop VU halts (it never completes, so it never thinks
        and never submits again); ``lost_tasks`` counts it and
        ``RunMetrics.lost_task_rate`` reports it."""
        task.attempts += 1
        if task.fail_t < 0.0:
            task.fail_t = self.t
        budget = self.cfg.retry_budget
        if budget is not None and task.attempts > budget:
            self.lost_tasks += 1
            return
        self.resubmits += 1
        self._push(self.t + self._retry_delay(task.attempts), _RESUBMIT, (task,))

    def _dispatch(self, task: _Task) -> None:
        fname = self._fnames[task.func]
        if not self.workers:
            # fully-dead cluster: nobody to schedule onto.  Backoff-retry
            # (the admission tier's drain salvages the task off this shard;
            # standalone, the retry_budget bounds the loop).
            self._retry_or_lose(task)
            return
        w = self.sched.schedule(fname)
        worker = self.workers.get(w)
        if worker is None or not worker.alive:
            # scheduler view raced with a failure; retry shortly
            self.sched.on_cancel(w, fname)
            self._retry_or_lose(task)
            return
        task.worker = w
        self._asg_t.append(self.t)
        self._asg_w.append(w)
        self._start_or_queue(worker, task)

    def _start_or_queue(self, worker: _Worker, task: _Task) -> None:
        worker.advance(self.t)
        func = task.func
        if func in worker.idle:
            inst = worker.pop_idle(func)
            self._warm_dec(func)  # warm reuse: the instance is busy again
            worker.busy_mem_mb += inst.mem_mb
            task.cold = False
            base_ms = self._fwarm[func]
        else:
            # cold path: make room for a new sandbox
            mem = self._fmem[func]
            while worker.busy_mem_mb + worker.idle_mem_mb + mem > worker.pool_mb:
                evicted = worker.evict_lru()
                if evicted is None:
                    break
                self._warm_dec(evicted.func)
                self.sched.on_evict(worker.wid, self._fnames[evicted.func])
            if worker.busy_mem_mb + worker.idle_mem_mb + mem > worker.pool_mb:
                worker.pending.append(task)  # waits for memory
                self._queued_n += 1
                return
            worker.busy_mem_mb += mem
            task.cold = True
            base_ms = self._fcold[func]
        entry = self._fluct
        row = entry["rows"][task.vu]
        if task.ev_idx >= entry["cols"]:
            self._extend_fluct(task.ev_idx)
            row = entry["rows"][task.vu]
        elif entry["pending"]:
            self._flush_fluct()  # lazily admitted rows fill in place
        task.work_s = task.remaining_s = base_ms * row[task.ev_idx] / 1e3
        if not worker.running:
            self._busy_n += 1  # idle -> busy transition
        worker.start(task)
        self._reschedule(worker)

    def _reschedule(self, worker: _Worker) -> None:
        nxt = worker.next_completion(self.t)
        if nxt is not None:
            if nxt == worker._sched_t:
                return  # the pending completion event is already correct
            worker.version += 1
            worker._sched_t = nxt
            heapq.heappush(
                self._heap, (nxt, next(self._seq), _COMPLETE, (worker.wid, worker.version))
            )
        elif worker._sched_t is not None:
            worker.version += 1  # invalidate the now-wrong pending event
            worker._sched_t = None

    def _ev_complete(self, wid: int, version: int) -> None:
        worker = self.workers.get(wid)
        if worker is None or version != worker.version or not worker.alive:
            return
        worker._sched_t = None  # this event is the live one; it just fired
        worker.advance(self.t)
        done = []
        keep = []
        for task in worker.running:
            (done if task.remaining_s <= 1e-12 else keep).append(task)
        if done:
            worker.running = keep
            if not keep:
                self._busy_n -= 1  # busy -> idle transition
            worker._min_ok = False
            for task in done:
                self._complete(worker, task)
        # pending tasks may now fit (an instance went idle and can be evicted)
        self._drain_pending(worker)
        self._reschedule(worker)

    def _complete(self, worker: _Worker, task: _Task) -> None:
        func = task.func
        mem = self._fmem[func]
        worker.busy_mem_mb -= mem
        t = self.t
        lst = worker.idle.get(func)
        if lst is None:
            worker.idle[func] = [_Instance(func, mem, t)]
        else:
            lst.append(_Instance(func, mem, t))  # t monotone: stays ascending
        worker.idle_mem_mb += mem
        self._warm[func] = self._warm.get(func, 0) + 1  # one more warm inst
        self.sched.on_finish(worker.wid, self._fnames[func])
        t_done = t + self._overhead_s
        if task.fail_t >= 0.0:
            # the request survived >=1 failure: recovery latency is first
            # failure -> completion (RunMetrics recovery percentiles)
            self.recovery_s.append(t_done - task.fail_t)
        self._rec_append(
            task.t_submit, t_done, func, worker.wid, task.cold, task.vu, task.migrated
        )
        # closed loop: VU thinks, then submits its next request
        sleeps = self._prog_sleeps[task.vu]
        ei = task.ev_idx
        sleep = sleeps[ei] if ei < len(sleeps) else sleeps[-1]
        heapq.heappush(self._heap, (t_done + sleep, next(self._seq), _SUBMIT, (task.vu,)))

    def _drain_pending(self, worker: _Worker) -> None:
        if not worker.pending:
            return
        waiting, worker.pending = worker.pending, []  # _start_or_queue may re-append
        self._queued_n -= len(waiting)
        for task in waiting:
            if (
                task.func in worker.idle
                or worker.mem_usage() + self._fmem[task.func] <= worker.pool_mb
                or worker.idle_mem_mb > 0
            ):
                self._start_or_queue(worker, task)
            else:
                worker.pending.append(task)
                self._queued_n += 1

    def _ev_sweep(self) -> None:
        cfg = self.cfg
        ka = cfg.keep_alive_s
        for worker in self.workers.values():
            if not worker.alive:
                continue
            worker.advance(self.t)
            if worker.idle:
                t = self.t
                for func in list(worker.idle):
                    lst = worker.idle[func]
                    # ascending last_used: expired instances form a prefix
                    cut = 0
                    end = len(lst)
                    while cut < end and t - lst[cut].last_used > ka:
                        inst = lst[cut]
                        worker.idle_mem_mb -= inst.mem_mb
                        self.sched.on_evict(worker.wid, self._fnames[func])
                        cut += 1
                    if cut:
                        self._warm_dec(func, cut)
                        if cut == end:
                            del worker.idle[func]
                        else:
                            worker.idle[func] = lst[cut:]
            self._drain_pending(worker)
        self._push(self.t + cfg.sweep_every_s, _SWEEP)

    # ------------------------------------------------- elasticity / faults
    def _ev_fail(self, wid: int) -> None:
        worker = self.workers.get(wid)
        if worker is None or not worker.alive:
            return
        self._ws_accrue()  # close the cost interval at the old pool size
        worker.advance(self.t)
        worker.alive = False
        self._queued_n -= len(worker.pending)
        if worker.running:
            self._busy_n -= 1
        self.sched.on_worker_removed(wid)
        # running + pending tasks are lost; control plane retries them with
        # capped exponential backoff until the per-task budget runs out
        for task in worker.running + worker.pending:
            fresh = _Task(task.func, task.vu, task.ev_idx, task.t_submit)
            fresh.migrated = task.migrated  # a retried stolen task stays stolen
            fresh.attempts = task.attempts
            fresh.fail_t = task.fail_t
            self._retry_or_lose(fresh)
        for func, lst in worker.idle.items():
            self._warm_dec(func, len(lst))  # the warm set dies with the worker
        worker.running, worker.pending, worker.idle = [], [], {}
        worker.busy_mem_mb = worker.idle_mem_mb = 0.0
        del self.workers[wid]

    def _ev_add_worker(self, wid: int) -> None:
        if wid in self.workers:
            return
        self._ws_accrue()  # close the cost interval at the old pool size
        w = _Worker(wid, self.cfg)
        w.last_t = self.t
        self.workers[wid] = w
        self.sched.on_worker_added(wid)
