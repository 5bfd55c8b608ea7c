"""Bursty workload scenario suite: the traffic shapes policies compete on.

A copy of the JAX package's ``core/workloads.py`` (pure numpy).

The paper motivates pull-based scheduling by its behavior under "commonly
occurring bursty workloads", but the repo's built-in populations only
exercised synthetic hot-block skew (``admission.make_skewed_programs`` /
``make_sleeper_programs``).  This module generates the realistic arrival
mixes the policy literature compares on (Kaffes et al., Nguyen et al. —
see PAPERS.md), as self-contained :class:`Scenario` bundles the admission
tier consumes directly:

* ``flash_crowd`` — a background population, then a spike of VUs arriving
  nearly at once, half on tight latency SLOs: the EDF showcase.
* ``diurnal`` — arrival times drawn from a sine-modulated intensity
  (day/night load), via deterministic inverse-transform sampling.
* ``on_off`` — Markov-modulated (ON/OFF bursty) arrivals layered on
  ``trace.bursty_interarrivals``, the Figure-6 generator.
* ``heavy_tail`` — a heavy-tailed service mix: a minority of VUs hammer the
  heaviest functions with Pareto-tailed think times.

Determinism contract (same device as ``trace.py``): every scenario is a
pure function of its arguments — no scenario reads global RNG state — so
it replays bit-exactly for every policy, and the engine's ``(seed, vu,
ev)`` fluctuation identity (``core.fastrng``) applies unchanged on top.
Program and deadline draws additionally use per-VU identity streams
(``np.random.default_rng((seed, vu[, tag]))``: VU ``i``'s draws are
independent of how many other VUs exist); the one exception is ``on_off``
*arrivals*, which come from a single seeded MMPP chain
(``trace.bursty_interarrivals``) — sequential by construction, so
``arrivals[i]`` depends on the draws before it (still bit-exact replay,
just not per-VU regenerable).

``make_scenario(name, ...)`` resolves from the ``SCENARIOS`` registry;
``benchmarks/bench_policies.py`` runs the policies x scenarios matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .trace import FunctionSpec, VUProgram, bursty_interarrivals, default_n_events

__all__ = [
    "SCENARIOS",
    "Scenario",
    "available_scenarios",
    "diurnal",
    "flash_crowd",
    "heavy_tail",
    "make_scenario",
    "on_off",
]

# rng tags: keep per-VU draw streams for programs/arrivals/deadlines disjoint
_ARRIVAL_TAG = 0x0A11
_CLASS_TAG = 0xC1A5


@dataclasses.dataclass
class Scenario:
    """One replayable traffic shape: programs + arrivals + deadline metadata.

    ``arrivals`` are admission-eligibility times (seconds); ``deadlines``
    are per-VU *relative* latency SLOs (seconds; ``None`` when the scenario
    carries no deadline semantics).  Feed it to the admission tier with
    ``adm.run(scn.n_vus, duration_s, **scn.run_kwargs())``.

    ``faults`` optionally attaches a ``FaultPlan`` (the JAX package's
    ``core/chaos.py``: an injected failure/recovery schedule) so a chaos
    scenario travels as one replayable bundle; ``run_kwargs`` forwards it
    only when set, keeping plain scenarios byte-identical to their
    pre-chaos form.

    ``axes`` names the metric columns this scenario is scored on in the
    policy leaderboard (``benchmarks/bench_policies`` cell keys: p99_ms,
    mean_ms, deadline_miss_rate, cold_rate); lower is better on every axis.
    """

    name: str
    programs: List[VUProgram]
    arrivals: np.ndarray
    deadlines: Optional[np.ndarray] = None
    faults: Optional[object] = None  # chaos.FaultPlan; object to avoid a cycle
    axes: Tuple[str, ...] = (
        "p99_ms", "mean_ms", "deadline_miss_rate", "cold_rate"
    )

    @property
    def n_vus(self) -> int:
        return len(self.programs)

    def run_kwargs(self) -> dict:
        """Keyword arguments for ``AdmissionSimulator.run``."""
        kw = dict(
            programs=self.programs, arrivals=self.arrivals, deadlines=self.deadlines
        )
        if self.faults is not None:
            kw["faults"] = self.faults
        return kw


def _weights(funcs: Sequence[FunctionSpec]) -> np.ndarray:
    w = np.asarray([f.weight for f in funcs])
    return w / w.sum()


def _heavy_funcs(funcs: Sequence[FunctionSpec], quantile: float = 0.75) -> np.ndarray:
    warm = np.asarray([f.warm_ms for f in funcs])
    return np.flatnonzero(warm >= np.quantile(warm, quantile))


def _light_funcs(funcs: Sequence[FunctionSpec], quantile: float = 0.5) -> np.ndarray:
    warm = np.asarray([f.warm_ms for f in funcs])
    return np.flatnonzero(warm <= np.quantile(warm, quantile))


def flash_crowd(
    funcs: Sequence[FunctionSpec],
    n_vus: int,
    duration_s: float,
    seed: int,
    spike_frac: float = 0.6,
    spike_at_frac: float = 0.25,
    tight_deadline_s: float = 2.0,
    loose_deadline_s: float = float("inf"),
) -> Scenario:
    """A flash crowd: background load, then a near-simultaneous VU spike.

    The first ``spike_frac`` of VUs arrive together inside a one-second
    window at ``spike_at_frac * duration_s``; alternating spike VUs are
    *interactive* (light functions, short think, ``tight_deadline_s``
    first-response SLO) and *batch* (heavy functions, ``loose_deadline_s``
    — default none: batch work has no latency SLO and is excluded from the
    miss-rate denominator).  The rest are background: Azure-weighted calls,
    moderate think, no SLO, arriving over the pre-spike window.  Because
    the spike dwarfs the watermark capacity, the admission queue backs up —
    which queued VU binds first is exactly what deadline-aware admission
    decides better than FIFO pull (the interactive VUs' first response
    otherwise waits behind batch admissions).
    """
    weights = _weights(funcs)
    heavy = _heavy_funcs(funcs)
    light = _light_funcs(funcs)
    n_events = default_n_events(duration_s)
    n_spike = int(round(spike_frac * n_vus))
    spike_t = spike_at_frac * duration_s
    programs: List[VUProgram] = []
    arrivals = np.empty(n_vus)
    deadlines = np.full(n_vus, loose_deadline_s)
    for vu in range(n_vus):
        rng = np.random.default_rng((seed, vu))
        arr_rng = np.random.default_rng((seed, vu, _ARRIVAL_TAG))
        if vu < n_spike:
            arrivals[vu] = spike_t + arr_rng.uniform(0.0, 1.0)
            if vu % 2 == 0:  # interactive half: tight SLO, light calls
                idx = light[rng.integers(0, len(light), size=n_events)]
                sleep = rng.uniform(0.1, 0.4, size=n_events)
                deadlines[vu] = tight_deadline_s
            else:  # batch half: heavy calls, slack SLO
                idx = heavy[rng.integers(0, len(heavy), size=n_events)]
                sleep = rng.uniform(0.2, 0.8, size=n_events)
        else:
            arrivals[vu] = arr_rng.uniform(0.0, max(spike_t - 1.0, 0.5))
            idx = rng.choice(len(funcs), size=n_events, p=weights)
            sleep = rng.uniform(0.5, 2.0, size=n_events)
        programs.append(VUProgram(np.asarray(idx), sleep))
    return Scenario("flash_crowd", programs, arrivals, deadlines)


def diurnal(
    funcs: Sequence[FunctionSpec],
    n_vus: int,
    duration_s: float,
    seed: int,
    cycles: float = 2.0,
    amplitude: float = 0.85,
    deadline_s: float = 4.0,
) -> Scenario:
    """Diurnal sine load: arrivals from a sinusoid-modulated intensity.

    Intensity ``λ(t) ∝ 1 + amplitude * sin(...)`` over ``cycles`` full
    periods in the arrival horizon (the first 75% of the run, so the tail
    can drain), starting at the trough.  Each VU's arrival is the inverse
    CDF of the cumulative intensity at its own uniform quantile — a pure
    function of ``(seed, vu)``, so the waveform replays bit-exactly.
    """
    horizon = 0.75 * duration_s
    grid = np.linspace(0.0, horizon, 4096)
    phase = 2.0 * np.pi * cycles * grid / horizon
    lam = 1.0 + amplitude * np.sin(phase - 0.5 * np.pi)  # start at the trough
    cum = np.cumsum(lam)
    cum = (cum - cum[0]) / (cum[-1] - cum[0])
    weights = _weights(funcs)
    n_events = default_n_events(duration_s)
    programs: List[VUProgram] = []
    arrivals = np.empty(n_vus)
    for vu in range(n_vus):
        rng = np.random.default_rng((seed, vu))
        u = np.random.default_rng((seed, vu, _ARRIVAL_TAG)).uniform()
        arrivals[vu] = float(np.interp(u, cum, grid))
        idx = rng.choice(len(funcs), size=n_events, p=weights)
        sleep = rng.uniform(0.2, 1.0, size=n_events)
        programs.append(VUProgram(idx, sleep))
    return Scenario("diurnal", programs, arrivals, np.full(n_vus, deadline_s))


def on_off(
    funcs: Sequence[FunctionSpec],
    n_vus: int,
    duration_s: float,
    seed: int,
    burst_factor: float = 12.0,
    deadline_s: float = 3.0,
) -> Scenario:
    """ON/OFF bursty (Markov-modulated Poisson) arrivals.

    Interarrival times come from ``trace.bursty_interarrivals`` — the
    Figure-6 two-state MMPP — with rates scaled to the run: calm traffic
    trickles, ON periods arrive ``burst_factor`` times faster.  Arrivals
    are clipped to the first 80% of the run so the tail drains (and no VU
    lands in the end-of-run admission blind window).  Note the arrival
    chain is one sequential ``default_rng(seed)`` stream (a Markov chain
    cannot be drawn per-VU); programs keep per-``(seed, vu)`` identity.
    """
    horizon = 0.8 * duration_s
    base_rate = max(n_vus / horizon, 1e-6)
    inter = bursty_interarrivals(
        n_vus,
        seed,
        base_rate=base_rate,
        burst_rate=burst_factor * base_rate,
        mean_burst_s=horizon / 8.0,
        mean_calm_s=horizon / 3.0,
    )
    arrivals = np.minimum(np.cumsum(inter), horizon)
    weights = _weights(funcs)
    n_events = default_n_events(duration_s)
    programs: List[VUProgram] = []
    for vu in range(n_vus):
        rng = np.random.default_rng((seed, vu))
        idx = rng.choice(len(funcs), size=n_events, p=weights)
        sleep = rng.uniform(0.1, 0.8, size=n_events)
        programs.append(VUProgram(idx, sleep))
    return Scenario("on_off", programs, arrivals, np.full(n_vus, deadline_s))


def heavy_tail(
    funcs: Sequence[FunctionSpec],
    n_vus: int,
    duration_s: float,
    seed: int,
    heavy_frac: float = 0.3,
    pareto_shape: float = 1.5,
    tight_deadline_s: float = 2.0,
    loose_deadline_s: float = 30.0,
) -> Scenario:
    """Heavy-tailed service mix: a hammering minority among light traffic.

    ``heavy_frac`` of VUs call only the heaviest function quartile with
    Pareto(``pareto_shape``)-tailed think times — long lulls punctuated by
    hammering runs — on slack SLOs; the light majority runs
    Azure-weighted calls on tight SLOs.  Arrivals trickle in over the
    first 30% of the run.  The elephant/mice mix is where cost-aware
    admission (warm-capacity scaling) separates from plain pull.
    """
    weights = _weights(funcs)
    heavy = _heavy_funcs(funcs)
    n_events = default_n_events(duration_s)
    n_heavy = int(round(heavy_frac * n_vus))
    programs: List[VUProgram] = []
    arrivals = np.empty(n_vus)
    deadlines = np.empty(n_vus)
    for vu in range(n_vus):
        rng = np.random.default_rng((seed, vu))
        arrivals[vu] = np.random.default_rng((seed, vu, _ARRIVAL_TAG)).uniform(
            0.0, 0.3 * duration_s
        )
        if vu < n_heavy:  # elephants: heavy calls, Pareto-tailed think
            idx = heavy[rng.integers(0, len(heavy), size=n_events)]
            sleep = np.minimum(0.05 * rng.pareto(pareto_shape, size=n_events), 10.0)
            deadlines[vu] = loose_deadline_s
        else:  # mice: light Azure mix, tight SLO
            idx = rng.choice(len(funcs), size=n_events, p=weights)
            sleep = rng.uniform(0.2, 1.0, size=n_events)
            deadlines[vu] = tight_deadline_s
        programs.append(VUProgram(np.asarray(idx), sleep))
    return Scenario("heavy_tail", programs, arrivals, deadlines)


#: scenario registry: name -> builder(funcs, n_vus, duration_s, seed, **kw)
SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "flash_crowd": flash_crowd,
    "diurnal": diurnal,
    "on_off": on_off,
    "heavy_tail": heavy_tail,
}


def available_scenarios() -> List[str]:
    """Sorted names of every registered workload scenario."""
    return sorted(SCENARIOS)


def make_scenario(
    name: str,
    funcs: Sequence[FunctionSpec],
    n_vus: int,
    duration_s: float,
    seed: int = 0,
    **kwargs,
) -> Scenario:
    """Build a registered scenario by name (unknown names list the registry)."""
    try:
        build = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; available: {available_scenarios()}"
        ) from None
    return build(funcs, n_vus, duration_s, seed, **kwargs)
