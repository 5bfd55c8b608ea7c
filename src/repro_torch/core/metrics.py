"""Metrics of Section V: latency, cold-start rate, load imbalance (CV), throughput.

A copy of the JAX package's ``core/metrics.py`` (pure numpy).

All metrics operate natively on the columnar record store
(``core.records``): a single vectorized pass over ``RecordColumns`` /
assignment arrays.  The legacy
row-API inputs (list of ``RequestRecord``, list of ``(t, worker)`` tuples)
are accepted through thin adapters that convert to columns first — the
numeric results are float-for-float identical either way, because the
vectorized expressions are the elementwise IEEE operations the old Python
loops performed (tests/test_records.py pins the parity at tolerance 0).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .records import RecordColumns, RequestRecord

RecordsLike = Union[RecordColumns, Sequence[RequestRecord]]
#: assignments as the legacy ``[(t, worker), ...]`` or ``(t[], worker[])`` arrays
AssignmentsLike = Union[Sequence[Tuple[float, int]], Tuple[np.ndarray, np.ndarray]]


@dataclasses.dataclass
class RunMetrics:
    """The §V scalar metrics of one run (or one stream window).

    Latencies in milliseconds; ``cold_rate`` is the cold-start fraction in
    [0, 1]; ``throughput_rps`` is requests per second over the summarized
    duration; ``load_cv`` is the mean per-second coefficient of variation
    of assignments across workers (Figure 14); ``migrated_rate`` is the
    fraction of requests completed on a shard other than their binding one
    (cross-shard work stealing; 0.0 whenever stealing is off);
    ``deadline_miss_rate`` is the fraction of deadline-carrying VUs whose
    *first completion* landed after ``arrival + deadline`` — time to first
    response, the flash-crowd SLO: it charges admission-queue wait as well
    as in-cluster latency, and a VU that never completed at all counts as
    missed (0.0 when the workload carries no deadline metadata — see
    ``summarize(deadline_ms=...)``).

    Failure telemetry (ARCHITECTURE.md §10; all 0.0 on fault-free runs):
    ``resubmit_rate`` is failure-retry pushes per completed request (can
    exceed 1 under heavy churn — one request may retry several times);
    ``lost_task_rate`` is the fraction of *resolved* requests that were
    dropped after exhausting the retry budget, ``lost / (completed +
    lost)``; ``recovery_p50_ms``/``recovery_p99_ms`` are percentiles of
    first-failure-to-completion latency over requests that survived at
    least one failure (0.0 when none did).

    Dataclass equality is exact float equality — the windowed-metrics
    parity tests rely on that."""

    n_requests: int
    mean_latency_ms: float
    p50_ms: float
    p90_ms: float
    p95_ms: float
    p99_ms: float
    cold_rate: float
    throughput_rps: float
    load_cv: float  # avg coefficient of variation of assignments/worker/second
    migrated_rate: float = 0.0
    deadline_miss_rate: float = 0.0
    resubmit_rate: float = 0.0
    lost_task_rate: float = 0.0
    recovery_p50_ms: float = 0.0
    recovery_p99_ms: float = 0.0

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _assignment_arrays(assignments: AssignmentsLike) -> Tuple[np.ndarray, np.ndarray]:
    """Adapter: legacy ``[(t, worker), ...]`` rows or a 2-tuple of ``(t,
    worker)`` columns (ndarrays or plain lists) -> float64/int64 arrays.

    A 2-tuple whose elements are arrays/lists is the columnar form; row
    streams are tuples-inside-a-sequence, so the shapes don't collide.
    """
    if (
        isinstance(assignments, tuple)
        and len(assignments) == 2
        and all(isinstance(c, (np.ndarray, list)) for c in assignments)
    ):
        t = np.asarray(assignments[0], np.float64)
        w = np.asarray(assignments[1], np.int64)
        if t.shape != w.shape:
            raise ValueError(f"assignment column lengths differ: {t.shape} vs {w.shape}")
        return t, w
    if not len(assignments):
        return np.zeros(0), np.zeros(0, np.int64)
    t, w = zip(*assignments)
    return np.asarray(t, np.float64), np.asarray(w, np.int64)


def latency_cdf(records: RecordsLike, n_points: int = 200) -> Tuple[np.ndarray, np.ndarray]:
    """Empirical latency CDF ``(latency_ms, fraction <= latency)`` over a
    record stream (Figures 10-12), downsampled to at most ``n_points``
    evenly spaced quantiles."""
    cols = RecordColumns.from_records(records)
    lat = np.sort(cols.latency_ms)
    y = np.arange(1, len(lat) + 1) / len(lat)
    if len(lat) > n_points:
        idx = np.linspace(0, len(lat) - 1, n_points).astype(int)
        return lat[idx], y[idx]
    return lat, y


def load_cv_per_second(
    assignments: AssignmentsLike, workers: Sequence[int], t_end: float
) -> np.ndarray:
    """Per-1s-bin CV across workers of assignment counts (Figure 14).

    The paper defines load imbalance as the coefficient of variation of the
    number of requests assigned per worker per second.  Vectorized: one
    ``bincount`` over ``bin * n_workers + worker_index`` — the integer count
    matrix is identical to the old per-assignment Python loop, so the CV
    series is bit-identical.
    """
    at, aw = _assignment_arrays(assignments)
    if at.size == 0 or not len(workers):
        return np.zeros(0)
    n_bins = int(np.ceil(t_end)) + 1
    n_w = len(workers)
    # dense worker-id -> column lookup (ids are small nonnegative ints)
    max_id = int(max(int(aw.max(initial=0)), max(workers)))
    lut = np.full(max_id + 1, -1, np.int64)
    for i, w in enumerate(workers):
        if 0 <= w <= max_id:
            lut[w] = i
    widx = lut[aw]
    known = widx >= 0
    bins = np.minimum(at.astype(np.int64), n_bins - 1)
    flat = bins[known] * n_w + widx[known]
    counts = np.bincount(flat, minlength=n_bins * n_w).reshape(n_bins, n_w)
    counts = counts.astype(np.float64)
    active = counts.sum(axis=1) > 0
    counts = counts[active]
    mean = counts.mean(axis=1)
    std = counts.std(axis=1)
    return np.where(mean > 0, std / np.maximum(mean, 1e-12), 0.0)


def summarize(
    records: RecordsLike,
    assignments: AssignmentsLike,
    workers: Sequence[int],
    duration_s: float,
    deadline_ms: Optional[np.ndarray] = None,
    arrival_s: Optional[np.ndarray] = None,
    resubmits: int = 0,
    lost_tasks: int = 0,
    recovery_s: Optional[Sequence[float]] = None,
) -> RunMetrics:
    """Aggregate §V metrics over a full record stream, in one vectorized pass.

    Args:
        records: completed-request stream (columnar or legacy row list).
        assignments: ``(t, worker)`` dispatch trace, columnar or row form;
            times in seconds.
        workers: global worker ids participating in the run (the CV
            denominator — include idle workers).
        duration_s: experiment length, seconds (throughput denominator).
        deadline_ms: optional per-VU relative latency deadline (ms), one
            entry per VU of the *population* (``inf`` = no deadline on
            that VU).  When given, ``deadline_miss_rate`` is the fraction
            of deadline-carrying VUs whose first completion exceeded
            ``arrival + deadline`` — time to first response, charging any
            admission-queue wait; a VU with no completions at all counts
            as missed.  Omitted: 0.0.
        arrival_s: per-VU arrival times (seconds), parallel to
            ``deadline_ms``; default: everyone at t=0 (the plain-engine
            convention where VU streams start with the run).
        resubmits: failure-retry pushes performed during the run
            (``Simulator.resubmits``, summed across shards) — feeds
            ``resubmit_rate``.
        lost_tasks: requests dropped after exhausting the retry budget
            (``Simulator.lost_tasks`` + never-re-homed salvage) — feeds
            ``lost_task_rate``.
        recovery_s: first-failure-to-completion latencies, seconds
            (``Simulator.recovery_s``) — feeds the recovery percentiles.

    Adapter-equivalence contract: row and columnar inputs produce
    float-for-float identical results (tests/test_records.py, tolerance 0).
    """
    cols = RecordColumns.from_records(records)
    n = len(cols)
    lat = cols.latency_ms if n else np.zeros(1)
    cold = cols.cold if n else np.zeros(1)
    migrated = cols.migrated if n else np.zeros(1)
    cv = load_cv_per_second(assignments, workers, duration_s)
    miss_rate = 0.0
    if deadline_ms is not None:
        dl = np.asarray(deadline_ms, np.float64)
        n_pop = dl.shape[0]
        arr_ms = (
            np.zeros(n_pop)
            if arrival_s is None
            else np.asarray(arrival_s, np.float64) * 1e3
        )
        first_done = np.full(n_pop, np.inf)
        if n:
            np.minimum.at(first_done, cols.vu, cols.t_done * 1e3)
        has_dl = np.isfinite(dl)
        if has_dl.any():
            miss = first_done[has_dl] - arr_ms[has_dl] > dl[has_dl]
            miss_rate = float(miss.mean())
    rec = (
        np.asarray(recovery_s, np.float64) * 1e3
        if recovery_s is not None and len(recovery_s)
        else np.zeros(0)
    )
    return RunMetrics(
        n_requests=n,
        mean_latency_ms=float(lat.mean()),
        p50_ms=float(np.percentile(lat, 50)),
        p90_ms=float(np.percentile(lat, 90)),
        p95_ms=float(np.percentile(lat, 95)),
        p99_ms=float(np.percentile(lat, 99)),
        cold_rate=float(cold.mean()),
        throughput_rps=n / max(duration_s, 1e-9),
        load_cv=float(cv.mean()) if cv.size else 0.0,
        migrated_rate=float(migrated.mean()),
        deadline_miss_rate=miss_rate,
        resubmit_rate=resubmits / max(n, 1),
        lost_task_rate=lost_tasks / (n + lost_tasks) if (n + lost_tasks) else 0.0,
        recovery_p50_ms=float(np.percentile(rec, 50)) if rec.size else 0.0,
        recovery_p99_ms=float(np.percentile(rec, 99)) if rec.size else 0.0,
    )


# ------------------------------------------------------------------ windowed
def summarize_window(
    records: RecordsLike,
    assignments: AssignmentsLike,
    workers: Sequence[int],
    t_lo: float,
    t_hi: float,
) -> RunMetrics:
    """Metrics for ONE completed stream window (``t_lo < t_done <= t_hi``).

    Takes exactly a ``StreamChunk``'s payload (the JAX package's
    ``core/shard.py``) — the window's records and its assignment slice —
    and evaluates the same
    vectorized expressions :func:`summarize` applies to a full run, with
    assignment times rebased to the window start so the per-second load-CV
    bins are window-relative.  Both the streaming consumer and the batch
    :func:`summarize_windows` go through this one function, which is what
    makes their floats identical (tests/test_stream.py pins the parity).
    """
    cols = RecordColumns.from_records(records)
    at, aw = _assignment_arrays(assignments)
    return summarize(cols, (at - t_lo, aw), workers, t_hi - t_lo)


def summarize_windows(
    records: RecordsLike,
    assignments: AssignmentsLike,
    workers: Sequence[int],
    window_s: float,
    duration_s: float,
    t_start: float = 0.0,
) -> List[Tuple[float, RunMetrics]]:
    """Windowed :func:`summarize` over a completion-ordered stream.

    Buckets records by ``t_done`` and assignments by assignment time into
    consecutive ``(t_lo, t_hi]`` windows of width ``window_s`` starting at
    ``t_start`` (the first window also includes events at exactly
    ``t_start``), continuing past ``duration_s`` until every record and
    assignment is covered (completions can trail the deadline by the
    scheduler overhead).  Returns ``[(t_hi, RunMetrics), ...]`` — the same
    windows, in the same order, with the same float values a streaming
    consumer gets from ``run_stream`` + :func:`summarize_window`.

    Requires the stream to be sorted by ``t_done`` (engine and merged-run
    order; see ``RecordColumns.window``).
    """
    if window_s <= 0:
        raise ValueError("window_s must be > 0")
    cols = RecordColumns.from_records(records)
    at, aw = _assignment_arrays(assignments)
    out: List[Tuple[float, RunMetrics]] = []
    i = 0
    n_rec = len(cols)
    n_asg = at.shape[0]
    ri = ai = 0
    while True:
        t_lo = t_start + i * window_s
        t_hi = t_start + (i + 1) * window_s
        wcols = cols.window(t_lo if i else -np.inf, t_hi)
        rj = ri + len(wcols)
        aj = int(np.searchsorted(at, t_hi, side="right"))
        out.append(
            (t_hi, summarize_window(wcols, (at[ai:aj], aw[ai:aj]), workers, t_lo, t_hi))
        )
        ri, ai = rj, aj
        i += 1
        if t_hi >= t_start + duration_s and ri >= n_rec and ai >= n_asg:
            return out
