"""Sharded multi-cluster simulation driver (the scale-out step).

A copy of the JAX package's ``core/shard.py`` (pure Python and numpy, no
JAX): the port keeps its own so that it imports nothing from ``repro``.

Partitions a large cluster and its virtual-user population into ``K``
independent shards — each a self-contained ``Simulator`` with its own seed
stream, worker pool, function population, and scheduler instance (serverless
scheduling as job scheduling across independent pools, per NOAH; core-granular
multi-cluster scheduling at datacenter scale, per Kaffes et al.) — runs them
on one of three backends, and merges the per-shard record streams into one
columnar store (``core.records``).

Contracts (pinned by tests/test_shard.py, tests/test_invariants.py, and the
frozen-seed-engine checks in tests/test_equivalence.py):

* **Per-shard exactness** — a shard's ``RequestRecord`` stream is
  byte-identical to a monolithic run of that shard's slice through the plain
  engine (and therefore to the frozen seed engine), on every backend.
* **Seeding contract** — shard ``k`` of a driver seeded with ``seed`` runs
  with ``shard_seed(seed, k) = (seed + 0x9E3779B1 * k) mod 2**32``: a
  golden-ratio uint32 stride keeps shard streams disjoint while staying in
  the single-word-entropy range the vectorized service RNG covers.
* **Partition contract** — workers and VUs split largest-remainder evenly
  (sizes differ by at most one); shard ``k`` owns the contiguous global id
  ranges starting at its prefix-sum offsets.
* **Merge semantics** — shard-local worker/VU ids are remapped by the shard
  offsets into disjoint global ranges, then streams are stable-merged by
  completion time (ties broken by shard index), matching the completion
  order a monolithic engine emits.  Aggregate metrics come out of one
  vectorized pass over the merged columns.
* **Stream semantics** — ``run_stream`` emits the same merge incrementally
  as completed ``StreamChunk`` windows (heap-merge frontier: a record is
  emitted once no shard can still produce an earlier completion);
  concatenated chunks are byte-identical to the batch merge on every
  backend and for any window width (tests/test_stream.py).

Backends:

* ``process`` — fork-based process pool, one shard per core; shard columns
  travel back through parent-named ``multiprocessing.shared_memory``
  segments (one memcpy per section, a few hundred bytes of pickled
  metadata per shard) with deterministic close/unlink teardown in the
  driver — set ``REPRO_SHARD_TRANSPORT=pickle`` to fall back to shipping
  the column buffers over the pool's pickle channel.
* ``interleaved`` — cooperative round-robin of ``Simulator.run_iter``
  generators in a single process (deterministic, no IPC; the fallback where
  fork is unavailable).
* ``serial`` — one shard after another (the K=1 degenerate case).

``aggregate_events_per_s`` is the scale-out capacity metric: the sum of
per-shard event rates, each shard measured on its own wall clock — what K
independent clusters report in aggregate.  The makespan-based rate
(``n_events / wall_s``) is additionally bounded by the local core count.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import time
import warnings
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bisect import bisect_right

from .metrics import RunMetrics, summarize
from .records import (
    RecordColumns,
    read_columns_shm,
    unlink_columns_shm,
    write_columns_shm,
)
from .scheduler import make_scheduler
from .simulator import SimConfig, Simulator
from .trace import VUProgram

__all__ = [
    "SEED_STRIDE",
    "MergedRun",
    "ShardResult",
    "ShardSpec",
    "ShardedSimulator",
    "StreamChunk",
    "build_simulator",
    "merge_shard_results",
    "run_shard",
    "shard_seed",
    "split_even",
]

SEED_STRIDE = 0x9E3779B1  # golden-ratio uint32 stride (per-shard seed contract)


def shard_seed(seed: int, index: int) -> int:
    """Per-shard base seed (documented contract; see module docstring)."""
    return (int(seed) + SEED_STRIDE * int(index)) % (2**32)


def split_even(total: int, parts: int) -> List[int]:
    """Largest-remainder partition: sizes differ by at most 1, sum == total."""
    base, rem = divmod(int(total), int(parts))
    return [base + (1 if i < rem else 0) for i in range(parts)]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Everything needed to replay one shard deterministically (picklable).

    ``programs`` is None for the default self-generated workload (the shard
    derives its VU programs from its own seed); when set, it carries this
    shard's contiguous slice of an explicit global VU population — the
    trace-driven path benchmarks use to build cross-shard skew the static
    partition cannot balance."""

    index: int
    n_shards: int
    scheduler: str
    seed: int
    n_vus: int
    duration_s: float
    cfg: SimConfig  # n_workers already set to this shard's share
    worker_offset: int  # global id base for this shard's workers
    vu_offset: int  # global id base for this shard's VUs
    failures: Tuple[Tuple[float, int], ...] = ()  # (t, local worker id)
    additions: Tuple[Tuple[float, int], ...] = ()  # (t, local worker id)
    programs: Optional[Tuple[VUProgram, ...]] = None  # explicit VU slice
    #: shared-memory segment this shard ships its columns through (set by the
    #: process-pool driver only; None everywhere else, keeping spec equality
    #: and pickles from older captures intact)
    shm_name: Optional[str] = None


@dataclasses.dataclass
class ShardResult:
    """One shard's output: columnar stream with *shard-local* ids (the exact
    byte-identical replay of that slice) plus its throughput accounting.

    ``resubmits``/``lost_tasks`` surface the engine's failure-retry
    counters (docs/ARCHITECTURE.md §10): retry pushes after a worker died
    mid-request, and requests dropped once ``SimConfig.retry_budget`` ran
    out.  Both stay 0 on a failure-free replay."""

    spec: ShardSpec
    records: RecordColumns
    assign_t: np.ndarray
    assign_w: np.ndarray
    n_events: int
    wall_s: float
    resubmits: int = 0
    lost_tasks: int = 0


def build_simulator(spec: ShardSpec) -> Simulator:
    """Construct the shard's scheduler + simulator exactly as specced."""
    sched = make_scheduler(spec.scheduler, spec.cfg.n_workers, seed=spec.seed)
    sim = Simulator(sched, cfg=spec.cfg, seed=spec.seed)
    for t, w in spec.failures:
        sim.inject_failure(t, w)
    for t, w in spec.additions:
        sim.inject_worker(t, w)
    return sim


def _result_from(spec: ShardSpec, sim: Simulator, wall_s: float) -> ShardResult:
    at, aw = sim.assignment_columns
    return ShardResult(
        spec=spec,
        records=sim.record_columns,
        assign_t=at,
        assign_w=aw,
        n_events=sim.n_events,
        wall_s=wall_s,
        resubmits=sim.resubmits,
        lost_tasks=sim.lost_tasks,
    )


def run_shard(spec: ShardSpec) -> ShardResult:
    """Run one shard to completion (the in-process / pickle-transport entry).

    Drains ``run_iter`` directly so no per-record Python objects are ever
    materialized — results stay columnar end to end.
    """
    sim = build_simulator(spec)
    programs = list(spec.programs) if spec.programs is not None else None
    t0 = time.perf_counter()
    for _ in sim.run_iter(n_vus=spec.n_vus, duration_s=spec.duration_s, programs=programs):
        pass
    return _result_from(spec, sim, time.perf_counter() - t0)


#: set to ``pickle`` to ship shard results through the pool's pickle channel
#: instead of shared-memory segments (debugging / exotic platforms)
TRANSPORT_ENV = "REPRO_SHARD_TRANSPORT"

#: every segment the pool driver names starts with this (leak checks key on
#: it).  It differs from the JAX package's ``"repro-shm-"`` so that a leak
#: check of one package never counts the other's live segments.
SHM_PREFIX = "repro_torch-shm-"


@dataclasses.dataclass
class _ShardShipment:
    """What a shard child sends back over the pool's pickle channel when the
    columns travel through shared memory: segment metadata plus the scalar
    counters — a few hundred bytes regardless of run size."""

    index: int
    shm_name: Optional[str]  # None when the shard produced zero rows
    n_rec: int
    n_asg: int
    n_events: int
    wall_s: float
    resubmits: int
    lost_tasks: int


def _run_shard_shipped(spec: ShardSpec) -> _ShardShipment:
    """Pool entry for the shared-memory transport: run the shard, write its
    columns into the parent-named segment, return only the metadata.

    The timed window covers the event loop exactly as ``run_shard``'s does;
    the segment write happens after the clock stops, so per-shard
    ``wall_s`` (and ``aggregate_events_per_s``) measure the same thing on
    both transports."""
    sim = build_simulator(spec)
    programs = list(spec.programs) if spec.programs is not None else None
    t0 = time.perf_counter()
    for _ in sim.run_iter(n_vus=spec.n_vus, duration_s=spec.duration_s, programs=programs):
        pass
    wall = time.perf_counter() - t0
    cols = sim.record_columns
    at, aw = sim.assignment_columns
    name = write_columns_shm(spec.shm_name, cols, at, aw)
    return _ShardShipment(
        index=spec.index,
        shm_name=name,
        n_rec=len(cols),
        n_asg=len(at),
        n_events=sim.n_events,
        wall_s=wall,
        resubmits=sim.resubmits,
        lost_tasks=sim.lost_tasks,
    )


@dataclasses.dataclass
class MergedRun:
    """K shard results merged into one global columnar stream."""

    shards: List[ShardResult]
    records: RecordColumns  # global ids, stable-merged by completion time
    assign_t: np.ndarray  # global assignment trace, stable-merged by time
    assign_w: np.ndarray
    workers: List[int]  # global ids of the statically partitioned workers
    n_events: int
    wall_s: float  # end-to-end makespan including backend overhead

    @property
    def events_per_s(self) -> float:
        """Makespan throughput: bounded by local cores running the backends."""
        return self.n_events / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def aggregate_events_per_s(self) -> float:
        """Scale-out capacity: sum of per-shard rates on their own clocks."""
        return float(sum(r.n_events / r.wall_s for r in self.shards if r.wall_s > 0))

    def summarize(self, duration_s: float) -> RunMetrics:
        return summarize(
            self.records,
            (self.assign_t, self.assign_w),
            self.workers,
            duration_s,
            resubmits=sum(r.resubmits for r in self.shards),
            lost_tasks=sum(r.lost_tasks for r in self.shards),
        )


def merge_assignments(
    ats: Sequence[np.ndarray], aws: Sequence[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Stable-merge per-shard assignment traces by time (shard-order concat +
    stable sort — the merge contract's tie-break, shared by the batch merge,
    the streaming merge, and the admission tier).  ``aws`` entries must
    already carry global worker ids."""
    if not ats:
        return np.zeros(0), np.zeros(0, np.int64)
    at = np.concatenate([np.asarray(a, np.float64) for a in ats])
    aw = np.concatenate([np.asarray(w, np.int64) for w in aws])
    order = np.argsort(at, kind="stable")
    return at[order], aw[order]


def merge_shard_results(results: Sequence[ShardResult], wall_s: float) -> MergedRun:
    """Remap shard-local ids to global ranges and stable-merge by time."""
    results = sorted(results, key=lambda r: r.spec.index)
    parts = [
        r.records.remap(worker_offset=r.spec.worker_offset, vu_offset=r.spec.vu_offset)
        for r in results
    ]
    records = merge_window(parts)
    at, aw = merge_assignments(
        [r.assign_t for r in results],
        [r.assign_w + r.spec.worker_offset for r in results],
    )
    workers = [
        r.spec.worker_offset + i for r in results for i in range(r.spec.cfg.n_workers)
    ]
    return MergedRun(
        shards=list(results),
        records=records,
        assign_t=at,
        assign_w=aw,
        workers=workers,
        n_events=sum(r.n_events for r in results),
        wall_s=wall_s,
    )


# ------------------------------------------------------------ streaming merge
@dataclasses.dataclass
class StreamChunk:
    """One completed window of a streaming K-shard merge.

    ``records`` holds the window's globally-id-remapped records in exactly
    the batch-merge order (stable by completion time, ties broken by shard
    index); concatenating every chunk of a stream reproduces
    ``MergedRun.records`` byte-for-byte.  Windows are
    ``t_lo < t_done <= t_hi`` (the first window also includes the stream
    start), with record times bucketed by ``t_done`` and assignments by
    assignment time.
    """

    index: int  # window number, 0-based
    t_lo: float
    t_hi: float
    records: RecordColumns  # global ids, merged by (t_done, shard)
    assign_t: np.ndarray
    assign_w: np.ndarray
    shard_counts: np.ndarray  # records per shard in this window (live load view)


class _StreamCursor:
    """Incremental reader over one shard's (possibly still growing) stream.

    Works over python lists (a live simulator's accumulator, via bisect) and
    numpy arrays (a completed shard's columns, same bisection protocol)
    alike; both are ascending in ``t_done`` / assignment time because the
    engine appends in event order."""

    __slots__ = ("td", "cols", "at", "aw", "ri", "ai")

    def __init__(self, td, cols, at, aw):
        self.td = td  # t_done sequence, ascending
        self.cols = cols  # 7-tuple of parallel column sequences
        self.at = at  # assignment times, ascending
        self.aw = aw
        self.ri = 0
        self.ai = 0

    def take_records(self, t_hi: float) -> RecordColumns:
        j = bisect_right(self.td, t_hi, self.ri)
        out = RecordColumns(*(c[self.ri : j] for c in self.cols))
        self.ri = j
        return out

    def take_assignments(self, t_hi: float) -> Tuple[np.ndarray, np.ndarray]:
        j = bisect_right(self.at, t_hi, self.ai)
        at = np.asarray(self.at[self.ai : j], np.float64)
        aw = np.asarray(self.aw[self.ai : j], np.int64)
        self.ai = j
        return at, aw

    @property
    def drained(self) -> bool:
        return self.ri >= len(self.td) and self.ai >= len(self.at)


def _cursor_for_result(res: ShardResult) -> _StreamCursor:
    c = res.records
    return _StreamCursor(
        c.t_done, (c.t_submit, c.t_done, c.func, c.worker, c.cold, c.vu, c.migrated),
        res.assign_t, res.assign_w,
    )


def _cursor_for_sim(sim: Simulator) -> _StreamCursor:
    acc = sim._rec
    return _StreamCursor(
        acc.t_done,
        (acc.t_submit, acc.t_done, acc.func, acc.worker, acc.cold, acc.vu, acc.migrated),
        sim._asg_t, sim._asg_w,
    )


def merge_window(parts: Sequence[RecordColumns]) -> RecordColumns:
    """Stable-merge already-remapped per-shard window segments by completion
    time — the same ``concat`` + stable argsort the batch merge applies, so
    a window of the stream equals the corresponding slice of the batch-merged
    stream."""
    cat = RecordColumns.concat(parts)
    if len(cat):
        cat = cat.take(np.argsort(cat.t_done, kind="stable"))
    return cat


def _stream_windows(
    specs: Sequence[ShardSpec],
    cursors: Sequence[_StreamCursor],
    duration_s: float,
    window_s: float,
    advance=None,
) -> "Iterator[StreamChunk]":
    """Yield merged windows until the run is over and every cursor drains.

    ``advance(t_hi)`` (live mode) steps each shard's event loop to the
    window boundary before the take, so a record can only be read once no
    shard can still produce an earlier completion — the heap-merge safety
    frontier."""
    if window_s <= 0:
        raise ValueError("window_s must be > 0")
    i = 0
    while True:
        t_lo = i * window_s
        t_hi = (i + 1) * window_s
        if advance is not None:
            advance(t_hi)
        parts, counts, ats, aws = [], [], [], []
        for spec, cur in zip(specs, cursors):
            p = cur.take_records(t_hi).remap(
                worker_offset=spec.worker_offset, vu_offset=spec.vu_offset
            )
            parts.append(p)
            counts.append(len(p))
            at, aw = cur.take_assignments(t_hi)
            ats.append(at)
            aws.append(aw + spec.worker_offset)
        records = merge_window(parts)
        at, aw = merge_assignments(ats, aws)
        yield StreamChunk(
            index=i,
            t_lo=t_lo,
            t_hi=t_hi,
            records=records,
            assign_t=at,
            assign_w=aw,
            shard_counts=np.asarray(counts, np.int64),
        )
        i += 1
        if t_hi >= duration_s and all(c.drained for c in cursors):
            return


def _publish_chunks(chunks, bus, n_shards: int):
    """Publish each chunk's window summary before yielding it (the
    ``run_stream(bus=...)`` path).  Payloads derive from the chunk alone —
    the same values on every backend — and follow the §14 publish order:
    shard topics in ascending shard index, then the cluster topic."""
    from .eventplane import CLUSTER_TOPIC, SHARD_TOPIC

    for ch in chunks:
        for k in range(n_shards):
            bus.publish(
                (SHARD_TOPIC, k), ch.index, ch.t_lo, ch.t_hi,
                {"n_done": int(ch.shard_counts[k])},
            )
        bus.publish(
            (CLUSTER_TOPIC,), ch.index, ch.t_lo, ch.t_hi,
            {"n_done": len(ch.records), "n_assign": int(len(ch.assign_t))},
        )
        yield ch


def _run_process_pool(
    specs: Sequence[ShardSpec], max_workers: Optional[int] = None
) -> List[ShardResult]:
    # fork is the only start method that doesn't re-pay the torch import in
    # every child; shard children are pure numpy/heapq and never touch torch
    # or a device, so a parent that has initialised CUDA may still fork them
    # — suppress just the fork warning at the fork site.  REPRO_SHARD_START_METHOD overrides
    # (spawn/forkserver) for environments where fork is not viable.
    start = os.environ.get("REPRO_SHARD_START_METHOD") or (
        "fork" if "fork" in mp.get_all_start_methods() else "spawn"
    )
    ctx = mp.get_context(start)
    max_workers = max_workers or min(len(specs), os.cpu_count() or 1)
    use_shm = os.environ.get(TRANSPORT_ENV, "shm").strip().lower() != "pickle"
    with warnings.catch_warnings():
        if start == "fork":
            warnings.filterwarnings(
                "ignore", message=r"os\.fork\(\) was called", category=RuntimeWarning
            )
        with ProcessPoolExecutor(max_workers=max_workers, mp_context=ctx) as pool:
            if not use_shm:
                return list(pool.map(run_shard, specs))
            # parent names every segment up front: whatever happens in the
            # children (including a crash mid-write), the finally below can
            # find and unlink each one — deterministic teardown, no orphans
            token = f"{SHM_PREFIX}{os.getpid()}-{os.urandom(4).hex()}"
            named = [
                dataclasses.replace(s, shm_name=f"{token}-{s.index}") for s in specs
            ]
            try:
                shipments = list(pool.map(_run_shard_shipped, named))
                results = []
                for spec, ship in zip(specs, shipments):
                    if ship.shm_name is None:  # zero-row shard: no segment
                        cols = RecordColumns.empty()
                        at = np.zeros(0, np.float64)
                        aw = np.zeros(0, np.int64)
                    else:
                        cols, at, aw = read_columns_shm(
                            ship.shm_name, ship.n_rec, ship.n_asg
                        )
                    results.append(
                        ShardResult(
                            spec=spec,  # the caller's spec: shm_name stays None
                            records=cols,
                            assign_t=at,
                            assign_w=aw,
                            n_events=ship.n_events,
                            wall_s=ship.wall_s,
                            resubmits=ship.resubmits,
                            lost_tasks=ship.lost_tasks,
                        )
                    )
                return results
            finally:
                for s in named:
                    unlink_columns_shm(s.shm_name)


def _run_interleaved(
    specs: Sequence[ShardSpec], yield_every: int = 2048
) -> List[ShardResult]:
    """Round-robin the shard event loops cooperatively in this process."""
    sims = [build_simulator(spec) for spec in specs]
    walls = [0.0] * len(specs)
    ready = deque(
        (i, sim.run_iter(n_vus=spec.n_vus, duration_s=spec.duration_s,
                         programs=list(spec.programs) if spec.programs is not None else None,
                         yield_every=yield_every))
        for i, (spec, sim) in enumerate(zip(specs, sims))
    )
    while ready:
        i, gen = ready.popleft()
        t0 = time.perf_counter()
        try:
            next(gen)
        except StopIteration:
            gen = None
        walls[i] += time.perf_counter() - t0
        if gen is not None:
            ready.append((i, gen))
    return [
        _result_from(spec, sim, walls[i])
        for i, (spec, sim) in enumerate(zip(specs, sims))
    ]


class ShardedSimulator:
    """K independent ``Simulator`` shards behind one ``run()`` call.

    Args:
        n_shards: shard (independent cluster) count, >= 1.
        n_workers: total workers, split largest-remainder evenly; shard
            ``k`` owns the contiguous global id range starting at its
            prefix-sum offset (partition contract).
        scheduler: per-shard scheduler name (each shard gets its own
            instance via ``make_scheduler``).
        cfg: per-shard :class:`SimConfig` template; ``n_workers`` is
            rewritten per shard, every other knob is shared.
        seed: driver seed; shard ``k`` runs with ``shard_seed(seed, k)``
            (golden-ratio stride, see module docstring — the seeding
            contract).
        backend: ``"process"`` / ``"interleaved"`` / ``"serial"`` /
            ``"auto"``; all backends produce identical per-shard streams.

    Elasticity and fault injection stay per-shard (each shard is an
    independent cluster): ``inject_failure`` and ``inject_worker`` both take
    a *global* worker id and map it onto the owning shard via the static
    partition.  Because global ids live inside a
    shard's static span by construction, elastic joins are re-joins of
    failed workers — ids beyond the partition would remap into the *next*
    shard's global range after the merge, so they are rejected.
    """

    def __init__(
        self,
        n_shards: int,
        n_workers: int,
        scheduler: str = "hiku",
        cfg: Optional[SimConfig] = None,
        seed: int = 0,
        backend: str = "auto",
    ):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if n_workers < n_shards:
            raise ValueError("need at least one worker per shard")
        if backend not in ("auto", "serial", "interleaved", "process"):
            raise ValueError(f"unknown backend {backend!r}")
        self.n_shards = int(n_shards)
        self.n_workers = int(n_workers)
        self.scheduler = scheduler
        self.cfg = cfg or SimConfig()
        self.seed = int(seed)
        self.backend = backend
        self._failures: List[Tuple[int, float, int]] = []  # (shard, t, local id)
        self._additions: List[Tuple[int, float, int]] = []
        self.worker_split = split_even(self.n_workers, self.n_shards)
        self.worker_offsets = [0]
        for n in self.worker_split:
            self.worker_offsets.append(self.worker_offsets[-1] + n)

    # ------------------------------------------------------------ topology
    def shard_of_worker(self, worker: int) -> Tuple[int, int]:
        """Global worker id -> (shard index, shard-local worker id)."""
        for k in range(self.n_shards):
            lo, hi = self.worker_offsets[k], self.worker_offsets[k + 1]
            if lo <= worker < hi:
                return k, worker - lo
        raise ValueError(f"worker {worker} outside the static partition")

    def inject_failure(self, t: float, worker: int) -> None:
        """Schedule a worker failure at time ``t`` by *global* worker id."""
        k, local = self.shard_of_worker(worker)
        self._failures.append((k, t, local))

    def inject_worker(self, t: float, worker: int) -> None:
        """Schedule an (elastic re-)join at time ``t`` by *global* worker id.

        Unified with :meth:`inject_failure`: the global id resolves to
        ``(owning shard, local id)`` through the static partition, so
        ``inject_failure(t1, w)`` + ``inject_worker(t2, w)`` round-trips the
        same physical worker.  Ids outside the partition are rejected
        because the merge remap only covers the static spans.
        """
        k, local = self.shard_of_worker(worker)
        self._additions.append((k, t, local))

    # ---------------------------------------------------------------- plan
    def plan(
        self,
        n_vus: int,
        duration_s: float,
        programs: Optional[Sequence[VUProgram]] = None,
    ) -> List[ShardSpec]:
        """The deterministic per-shard specs a run() with these args uses.

        With ``programs`` (an explicit global VU population, len ==
        ``n_vus``) each shard receives its *contiguous* slice — global VU
        ``vu_offset + i`` is shard-local VU ``i`` — which is exactly the
        static partitioning the pull-based admission tier
        (``core.admission``) is benchmarked against."""
        if programs is not None and len(programs) != n_vus:
            raise ValueError(f"len(programs)={len(programs)} != n_vus={n_vus}")
        vu_split = split_even(n_vus, self.n_shards)
        vu_off = 0
        specs = []
        for k in range(self.n_shards):
            specs.append(
                ShardSpec(
                    index=k,
                    n_shards=self.n_shards,
                    scheduler=self.scheduler,
                    seed=shard_seed(self.seed, k),
                    n_vus=vu_split[k],
                    duration_s=float(duration_s),
                    cfg=dataclasses.replace(self.cfg, n_workers=self.worker_split[k]),
                    worker_offset=self.worker_offsets[k],
                    vu_offset=vu_off,
                    failures=tuple((t, w) for s, t, w in self._failures if s == k),
                    additions=tuple((t, w) for s, t, w in self._additions if s == k),
                    programs=(
                        tuple(programs[vu_off : vu_off + vu_split[k]])
                        if programs is not None
                        else None
                    ),
                )
            )
            vu_off += vu_split[k]
        return specs

    def _resolve_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        if self.n_shards == 1:
            return "serial"
        if "fork" in mp.get_all_start_methods() and (os.cpu_count() or 1) > 1:
            return "process"
        return "interleaved"

    # ----------------------------------------------------------------- run
    def run(
        self,
        n_vus: int = 20,
        duration_s: float = 100.0,
        programs: Optional[Sequence[VUProgram]] = None,
    ) -> MergedRun:
        """Run all K shards to completion and batch-merge their streams.

        Args:
            n_vus: global closed-loop VU count, split largest-remainder
                evenly across shards.
            duration_s: simulated experiment length per shard, seconds.
            programs: optional explicit global VU population (see
                :meth:`plan`); default: each shard self-generates from its
                own seed.

        Bound by the merge contract: the returned stream is stable-merged
        by completion time (ties broken by shard index) over byte-exact
        per-shard replays.
        """
        specs = self.plan(n_vus, duration_s, programs)
        backend = self._resolve_backend()
        t0 = time.perf_counter()
        if backend == "process":
            results = _run_process_pool(specs)
        elif backend == "interleaved":
            results = _run_interleaved(specs)
        else:
            results = [run_shard(s) for s in specs]
        return merge_shard_results(results, time.perf_counter() - t0)

    # -------------------------------------------------------------- stream
    def run_stream(
        self,
        n_vus: int = 20,
        duration_s: float = 100.0,
        window_s: float = 1.0,
        programs: Optional[Sequence[VUProgram]] = None,
        bus=None,
    ) -> Iterator[StreamChunk]:
        """Streaming form of :meth:`run`: heap-merge the shard streams into
        completed ``window_s``-wide :class:`StreamChunk` windows.

        Concatenating every chunk's records reproduces the batch
        ``run().records`` byte-for-byte on every backend (pinned by
        tests/test_stream.py).  On the ``interleaved`` backend the shard
        event loops are co-run in simulated-time lockstep and each window is
        emitted as soon as it completes, so windowed metrics
        (``metrics.summarize_window``) observe an *in-flight* sharded run;
        ``serial``/``process`` complete the shards first and then stream the
        identical merge (useful for post-hoc windowing, without the
        in-flight property).

        ``bus`` optionally attaches an :class:`~repro_torch.core.eventplane
        .EventPlane`: before each chunk is yielded, one ``("shard", k)``
        summary per shard (ascending ``k`` — the merge tie-break) and one
        ``("cluster",)`` summary are published for that window.  Payloads
        are pure functions of the chunk, so the published stream is
        byte-identical across backends (tests/test_stream.py) and the bus
        is sealed here, before the loops arm (§14).
        """
        specs = self.plan(n_vus, duration_s, programs)
        backend = self._resolve_backend()
        if bus is not None:
            bus.seal()
        if backend == "interleaved":
            sims = [build_simulator(spec) for spec in specs]
            for spec, sim in zip(specs, sims):
                sim.begin(
                    n_vus=spec.n_vus,
                    duration_s=spec.duration_s,
                    programs=list(spec.programs) if spec.programs is not None else None,
                )
            cursors = [_cursor_for_sim(sim) for sim in sims]

            def advance(t_hi: float) -> None:
                for sim in sims:
                    sim.step_until(t_hi)

            chunks = _stream_windows(specs, cursors, duration_s, window_s, advance)
        else:
            if backend == "process":
                results = _run_process_pool(specs)
            else:
                results = [run_shard(s) for s in specs]
            results = sorted(results, key=lambda r: r.spec.index)
            cursors = [_cursor_for_result(r) for r in results]
            chunks = _stream_windows(specs, cursors, duration_s, window_s)
        if bus is None:
            yield from chunks
        else:
            yield from _publish_chunks(chunks, bus, len(specs))
