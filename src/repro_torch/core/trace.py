"""Azure-skewed function popularity: a copy of ``_population_weights`` and
``azure_like_weights`` from the JAX package's ``core/trace.py`` (pure
numpy), for the serving launcher."""

from __future__ import annotations

from typing import Dict

import numpy as np


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
