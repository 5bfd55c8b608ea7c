"""Azure-like serverless workload generation (Section III-B, Figures 4-6).

A copy of the JAX package's ``core/trace.py`` (pure numpy); the service
fluctuations come from the port's own ``core.fastrng``.

The paper drives its evaluation with invocation probabilities sampled from the
Azure Functions dataset mapped onto 40 functions (8 FunctionBench apps x 5
copies), closed-loop k6 virtual users with U(0.1, 1)s think time, and
service-time heterogeneity.  This module generates statistically matching
workloads from a seed:

* **Skewed popularity** — Zipf exponent fitted so that for a large function
  population the top 10% of functions receive ~92.3% and the top 1% ~51.3% of
  invocations (the dataset stats quoted in Section III-B).  The 40 experiment
  functions take their weights from random ranks of that population, exactly
  like the paper's random subsampling of the dataset.
* **Heterogeneous performance** — per-app warm/cold base latencies from
  Table I with per-invocation lognormal fluctuation (Figure 5).
* **Bursty invocations** — closed-loop VUs produce arrival bursts naturally;
  an open-loop Markov-modulated generator is provided for the Figure-6
  characterization benchmark.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import fastrng

# Table I of the paper: FunctionBench on OpenLambda / m5.xlarge, ms.
TABLE_I: Dict[str, Tuple[float, float]] = {
    # app: (cold_ms, warm_ms)
    "chameleon": (536.0, 392.0),
    "dd": (706.0, 549.0),
    "float_operation": (263.0, 94.0),
    "gzip_compression": (510.0, 303.0),
    "json_dumps_loads": (269.0, 105.0),
    "linpack": (282.0, 58.0),
    "matmul": (284.0, 125.0),
    "pyaes": (329.0, 149.0),
}

# Plausible resident-set footprints for the FunctionBench sandboxes (MB).
# These act as the worker memory-pool pressure knob; see simulator defaults.
APP_MEM_MB: Dict[str, float] = {
    "chameleon": 340.0,
    "dd": 420.0,
    "float_operation": 160.0,
    "gzip_compression": 380.0,
    "json_dumps_loads": 210.0,
    "linpack": 260.0,
    "matmul": 310.0,
    "pyaes": 200.0,
}


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    """One deployable function: Table-I base latencies (ms), sandbox
    footprint (MB) and its Azure-skewed invocation probability."""

    name: str
    app: str
    cold_ms: float
    warm_ms: float
    mem_mb: float
    weight: float  # invocation probability


def fit_zipf_exponent(n: int = 1000, top10_share: float = 0.923) -> float:
    """Bisection fit of a single Zipf exponent to the top-10% share."""
    ranks = np.arange(1, n + 1, dtype=np.float64)

    def share(s: float) -> float:
        w = ranks ** (-s)
        w /= w.sum()
        return float(w[: n // 10].sum())

    lo, hi = 0.4, 3.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if share(mid) < top10_share:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _population_weights(n: int, top1: float = 0.513, top10: float = 0.923) -> np.ndarray:
    """Hierarchically calibrated popularity: matches BOTH Azure skew stats
    exactly by construction (top 1% -> 51.3%, top 10% -> 92.3% of calls),
    with Zipf-shaped mass inside each tier (Section III-B, Figure 4)."""
    w = np.empty(n)
    k1, k10 = max(1, n // 100), max(2, n // 10)
    tiers = [(0, k1, top1), (k1, k10, top10 - top1), (k10, n, 1.0 - top10)]
    for lo, hi, mass in tiers:
        # uniform within tier keeps the rank ordering monotone across tier
        # boundaries, so the top-k statistics hold exactly after sorting
        w[lo:hi] = mass / (hi - lo)
    return w


_POP_CACHE: Dict[int, np.ndarray] = {}


def azure_like_weights(n_funcs: int, seed: int, population: int = 1000) -> np.ndarray:
    """Sample ``n_funcs`` normalized weights from the calibrated population.

    Mirrors the paper's procedure: "randomly selected 40 functions from this
    dataset, calculated and normalized invocation probabilities".
    """
    if population not in _POP_CACHE:
        _POP_CACHE[population] = _population_weights(population)
    pop = _POP_CACHE[population]
    if n_funcs == population:
        return pop.copy()
    rng = np.random.default_rng(seed)
    idx = rng.choice(population, size=n_funcs, replace=False)
    w = pop[idx]
    return w / w.sum()


def make_functions(n_copies: int = 5, seed: int = 0) -> List[FunctionSpec]:
    """8 FunctionBench apps x ``n_copies`` uniquely named functions."""
    apps = sorted(TABLE_I)
    names = [f"{app}-{c}" for app in apps for c in range(n_copies)]
    weights = azure_like_weights(len(names), seed)
    funcs = []
    for i, name in enumerate(names):
        app = name.rsplit("-", 1)[0]
        cold, warm = TABLE_I[app]
        funcs.append(
            FunctionSpec(
                name=name,
                app=app,
                cold_ms=cold,
                warm_ms=warm,
                mem_mb=APP_MEM_MB[app],
                weight=float(weights[i]),
            )
        )
    return funcs


@dataclasses.dataclass
class VUProgram:
    """Pre-generated closed-loop program for one virtual user.

    Choices and think times are drawn ahead of time from the seed so that
    *every scheduler replays the identical request sequence* — the paper's
    fairness device ("we seeded the random number generator ... so that the
    order of function invocations as well as sleep durations ... were
    identical for each scheduling algorithm").
    """

    func_idx: np.ndarray  # (n_events,)
    sleep_s: np.ndarray  # (n_events,)


_PROG_CACHE: Dict[tuple, List["VUProgram"]] = {}
_PROG_FAST_OK = True  # cleared on any spot-check mismatch: per-VU path forever


def _vu_programs_ref(
    n_funcs: int,
    weights: np.ndarray,
    n_vus: int,
    n_events: int,
    seed: int,
    think_lo: float,
    think_hi: float,
    vu_start: int = 0,
) -> List["VUProgram"]:
    """The seed engine's per-VU draw loop, verbatim: one fresh
    ``default_rng((seed, vu))`` per VU.  Reference for the vectorized fast
    path (spot checks, pin tests, and the fallback when the fast path cannot
    prove itself)."""
    programs = []
    for vu in range(vu_start, vu_start + n_vus):
        rng = np.random.default_rng((seed, vu))
        idx = rng.choice(n_funcs, size=n_events, p=weights)
        sleep = rng.uniform(think_lo, think_hi, size=n_events)
        programs.append(VUProgram(idx, sleep))
    return programs


def _vu_programs_vec(
    n_funcs: int,
    weights: np.ndarray,
    n_vus: int,
    n_events: int,
    seed: int,
    think_lo: float,
    think_hi: float,
) -> List["VUProgram"]:
    """Vectorized, bit-exact rebuild of the per-VU draw loop.

    ``Generator.choice(n, size, p)`` is cdf-inversion over ``size`` raw
    uniform doubles and ``Generator.uniform`` is ``lo + (hi-lo) * u`` over
    the next ``size`` — both exactly reproducible from the first
    ``2*n_events`` doubles of each VU's stream, which ``fastrng
    .uniform_block`` computes for all VUs at once.  Each fresh workload key
    spot-checks one row against the real per-VU Generator and degrades to
    the reference loop process-wide on any mismatch (e.g. a numpy upgrade
    changing ``choice``'s consumption pattern)."""
    global _PROG_FAST_OK
    u = fastrng.uniform_block(seed, n_vus, 2 * n_events)
    cdf = weights.cumsum()
    cdf /= cdf[-1]
    idx = cdf.searchsorted(u[:, :n_events], side="right").astype(np.intp, copy=False)
    sleep = think_lo + (think_hi - think_lo) * u[:, n_events:]
    check = _vu_programs_ref(n_funcs, weights, 1, n_events, seed, think_lo, think_hi)[0]
    if not (np.array_equal(idx[0], check.func_idx) and np.array_equal(sleep[0], check.sleep_s)):
        _PROG_FAST_OK = False
        warnings.warn(
            "vectorized VU-program fast path disagrees with default_rng on "
            "this numpy; falling back to the per-VU loop (bit-exact, slower)",
            RuntimeWarning,
            stacklevel=3,
        )
        return _vu_programs_ref(n_funcs, weights, n_vus, n_events, seed, think_lo, think_hi)
    return [VUProgram(idx[v], sleep[v]) for v in range(n_vus)]


def default_n_events(duration_s: float) -> int:
    """Engine-default events per VU program for a ``duration_s``-second run.

    A generous upper bound (4 requests/s plus slack) so closed-loop VUs
    never exhaust their program before the deadline.  Every driver that
    builds a default workload (``Simulator.begin``, ``AdmissionSimulator``,
    benchmarks, examples) uses this one formula, which is pinned by the
    frozen seed engine's replay contract — changing it changes every
    default-workload stream."""
    return int(duration_s * 4) + 16


def make_vu_programs(
    funcs: Sequence[FunctionSpec],
    n_vus: int,
    n_events: int,
    seed: int,
    think_lo: float = 0.1,
    think_hi: float = 1.0,
) -> List[VUProgram]:
    """Seeded closed-loop programs for ``n_vus`` virtual users.

    VU ``vu`` draws ``n_events`` weighted function choices and
    ``U(think_lo, think_hi)`` think times (seconds) from
    ``default_rng((seed, vu))`` — deterministic per (weights, shape, seed),
    so every scheduler replays the identical request sequence (the paper's
    fairness device).  Returned lists are memoized and shared read-only."""
    # Programs are a pure function of (weights, shape, seed): memoize so the
    # benchmark matrix generates each seeded workload once, not once per
    # scheduler.  Returned lists are shared read-only.
    key = (tuple(f.weight for f in funcs), n_vus, n_events, seed, think_lo, think_hi)
    cached = _PROG_CACHE.get(key)
    if cached is not None:
        return cached
    weights = np.array([f.weight for f in funcs])
    weights = weights / weights.sum()
    seed_i = int(seed)
    if _PROG_FAST_OK and n_vus >= 4 and n_events > 0 and 0 <= seed_i < 2**32:
        programs = _vu_programs_vec(
            len(funcs), weights, n_vus, n_events, seed_i, think_lo, think_hi
        )
    else:
        programs = _vu_programs_ref(
            len(funcs), weights, n_vus, n_events, seed, think_lo, think_hi
        )
    if len(_PROG_CACHE) >= 16:
        _PROG_CACHE.clear()
    _PROG_CACHE[key] = programs
    return programs


def service_time_ms(spec: FunctionSpec, cold: bool, rng: np.random.Generator, sigma: float = 0.25) -> float:
    """Lognormal fluctuation around Table-I base latency (Figure 5)."""
    base = spec.cold_ms if cold else spec.warm_ms
    return float(base * rng.lognormal(mean=-0.5 * sigma**2, sigma=sigma))


def service_fluctuations(
    seed: int, n_vus: int, n_events: int, sigma: float, ev_start: int = 0, vu_start: int = 0
) -> np.ndarray:
    """Pre-generated per-request service-time fluctuation band.

    Entry ``[i, j]`` is bit-identical to what the seed simulator drew
    per-request: ``default_rng((seed, vu_start + i, ev_start + j))
    .lognormal(-σ²/2, σ)`` — the request-identity seeding that lets every
    scheduler replay the same stochastic demand.  Computed vectorized (see
    ``fastrng``) so programs can carry their fluctuations instead of paying
    a Generator construction per request in the simulator hot loop;
    ``vu_start`` lets dynamically admitted VUs fill in their single row.
    """
    from .fastrng import lognormal_matrix

    return lognormal_matrix(
        seed, n_vus, n_events, -0.5 * sigma**2, sigma, ev_start=ev_start, vu_start=vu_start
    )


# ------------------------------------------------------------------ Figure 6
def bursty_interarrivals(
    n: int,
    seed: int,
    base_rate: float = 50.0,
    burst_rate: float = 900.0,
    mean_burst_s: float = 40.0,
    mean_calm_s: float = 300.0,
) -> np.ndarray:
    """Time-modulated Poisson interarrivals (sec): minute-scale bursts so the
    per-minute arrival rate swings by ~13.5x (Figure 6).  Used by the
    open-loop trace characterization benchmark and burst-resilience tests."""
    rng = np.random.default_rng(seed)
    out = np.empty(n)
    bursting = False
    t = 0.0
    t_switch = rng.exponential(mean_calm_s)
    for i in range(n):
        if t >= t_switch:
            bursting = not bursting
            t_switch = t + rng.exponential(mean_burst_s if bursting else mean_calm_s)
        rate = burst_rate if bursting else base_rate
        out[i] = rng.exponential(1.0 / rate)
        t += out[i]
    return out
