"""The Azure Functions invocation population the paper samples its functions
from: a copy of the port's ``core/trace.py::_population_weights`` and
``azure_like_weights`` (pure numpy).

The paper "randomly selected 40 functions from this dataset, calculated and
normalized invocation probabilities"; the population matches both skew
statistics it quotes (top 1% of functions -> 51.3% of calls, top 10% ->
92.3%).  A traffic mix draws its functions' weights from it once and keeps
them in its file (``traffic/<mix>.json``, with the draw's arguments), so
``--seed`` does not change a mix's popularity.
"""

from __future__ import annotations

import numpy as np


def population_weights(n: int, top1: float = 0.513, top10: float = 0.923) -> np.ndarray:
    """Tiered popularity of ``n`` functions: the top 1% share ``top1`` of
    the calls, the next 9% ``top10 - top1``, the rest the remainder,
    uniform within a tier."""
    w = np.empty(n)
    k1, k10 = max(1, n // 100), max(2, n // 10)
    for lo, hi, mass in [(0, k1, top1), (k1, k10, top10 - top1), (k10, n, 1.0 - top10)]:
        w[lo:hi] = mass / (hi - lo)
    return w


def azure_like_weights(n_funcs: int, seed: int, population: int = 1000) -> np.ndarray:
    """``n_funcs`` normalised weights drawn without replacement from the
    calibrated population of ``population`` functions."""
    pop = population_weights(population)
    if n_funcs == population:
        return pop.copy()
    idx = np.random.default_rng(seed).choice(population, size=n_funcs, replace=False)
    w = pop[idx]
    return w / w.sum()
