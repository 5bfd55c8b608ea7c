"""Online learned state for admission policies: duration estimation + bandits.

A copy of the JAX package's ``core/estimators.py`` (pure Python and numpy, no
JAX): the port keeps its own so that it imports nothing from ``repro``.

Data-driven admission — per-function execution-time estimates
(Przybylski et al.) and adaptive thresholds (Nguyen et al.) — must come
*without losing byte-exact replay*.  This module is the state side of that
contract; ``core.policies`` hosts the policies that consume it (``sjf``,
``bandit``, ``bandit+steal``).

Two building blocks, both with an explicit serializable snapshot:

* :class:`DurationEstimator` — per-function online mean/variance of observed
  request durations, Welford's algorithm (numerically stable single-pass
  moments), plus a global fallback stream for never-seen functions and a
  static prior before any observation at all.
* :class:`BanditTuner` — a tiny multi-armed bandit (UCB1 or seeded
  epsilon-greedy) over a fixed arm set, fed one windowed reward at a time.
  Epsilon-greedy draws come from counter-based streams
  (``np.random.default_rng((seed, step))``), so the tuner carries **no RNG
  object in its state**: the next draw is a pure function of ``(seed,
  step)``, which is what keeps snapshots tiny and replay trivial.

Snapshot contract (normative; docs/POLICIES.md "Learned state"):
``snapshot()`` returns a dict of pure JSON types (str keys, int/float/list
values) that fully determines future behavior given the same constructor
arguments; ``restore(snapshot())`` is a no-op; and a snapshot survives
``json.loads(json.dumps(snap))`` **bit-exactly** — Python floats round-trip
through JSON's repr-based serialization unchanged, and the estimators store
nothing but Python ints and floats.  ``tests/test_estimators.py`` pins all
of this property-style; ``tests/test_replay.py`` pins the run-level
consequence (record-then-replay byte-identity).

Update-order contract: Welford's update is **not** commutative in floating
point, so only the counts (``n``) are exactly permutation-invariant; means
and variances are order-invariant up to numerical noise.  Policies therefore
fold observations in a single canonical order (the completion-stream order
of ``PolicyContext.new_completions``) — determinism comes from the canonical
order, not from commutativity.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BanditTuner", "DurationEstimator"]


def _validated_duration(duration_ms: float) -> float:
    """Reject junk at the update boundary: durations must be finite and > 0.

    A NaN would poison every downstream mean (and every heap the predictions
    key); a zero or negative duration is a caller bug (the completion feed
    measures ``t_done - t_submit`` of a completed request, which is strictly
    positive in the engine).  Raising here keeps estimator state valid by
    construction — the failed update leaves state untouched.
    """
    d = float(duration_ms)
    if not math.isfinite(d) or d <= 0.0:
        raise ValueError(
            f"duration_ms must be finite and > 0, got {duration_ms!r}"
        )
    return d


class _Welford:
    """One Welford moment stream: (n, mean, M2)."""

    __slots__ = ("n", "mean", "m2")

    def __init__(self, n: int = 0, mean: float = 0.0, m2: float = 0.0):
        self.n = int(n)
        self.mean = float(mean)
        self.m2 = float(m2)

    def push(self, x: float) -> None:
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)

    @property
    def variance(self) -> float:
        if self.n < 2:
            return 0.0
        # M2 is non-negative analytically; clamp the (rare) tiny negative
        # float residue so variance() is >= 0 by contract
        return max(self.m2, 0.0) / (self.n - 1)

    def state(self) -> List[float]:
        return [self.n, self.mean, self.m2]


class DurationEstimator:
    """Online per-function duration mean/variance (Welford), with fallback.

    ``update(func, duration_ms)`` folds one observed request duration into
    the function's moment stream *and* a global stream; ``predict_ms(func)``
    returns the function's mean when it has been observed, else the global
    mean, else ``prior_ms`` (cold start of the estimator itself).

    Updates must come only from the ``AdmissionPolicy.observe`` hook (the
    policy-author obligation in docs/POLICIES.md): that is the one place in
    the admission loop where the completion feed is drained exactly once in
    a canonical order, which is what makes estimator state — and therefore
    every decision keyed on it — bit-exactly replayable.
    """

    def __init__(self, prior_ms: float = 200.0):
        p = float(prior_ms)
        if not math.isfinite(p) or p <= 0.0:
            raise ValueError(f"prior_ms must be finite and > 0, got {prior_ms!r}")
        self.prior_ms = p
        self._funcs: Dict[int, _Welford] = {}
        self._global = _Welford()

    # ------------------------------------------------------------- updates
    def update(self, func: int, duration_ms: float) -> None:
        """Fold one observed duration; invalid inputs raise, state untouched."""
        f = int(func)
        if f < 0:
            raise ValueError(f"func index must be >= 0, got {func!r}")
        d = _validated_duration(duration_ms)
        w = self._funcs.get(f)
        if w is None:
            w = self._funcs[f] = _Welford()
        w.push(d)
        self._global.push(d)

    # --------------------------------------------------------------- reads
    @property
    def total_updates(self) -> int:
        """Observations folded so far (across all functions)."""
        return self._global.n

    def n(self, func: int) -> int:
        w = self._funcs.get(int(func))
        return 0 if w is None else w.n

    def mean_ms(self, func: int) -> float:
        """Observed mean duration of ``func`` (NaN when never observed)."""
        w = self._funcs.get(int(func))
        return float("nan") if w is None else w.mean

    def variance_ms2(self, func: int) -> float:
        """Sample variance of ``func``'s durations (0.0 when n < 2; >= 0)."""
        w = self._funcs.get(int(func))
        return 0.0 if w is None else w.variance

    def std_ms(self, func: int) -> float:
        return math.sqrt(self.variance_ms2(func))

    def predict_ms(self, func: int) -> float:
        """Predicted duration: per-func mean -> global mean -> prior."""
        w = self._funcs.get(int(func))
        if w is not None and w.n > 0:
            return w.mean
        if self._global.n > 0:
            return self._global.mean
        return self.prior_ms

    # ----------------------------------------------------------- snapshots
    def snapshot(self) -> dict:
        """Serializable full state: pure JSON types, JSON-round-trip exact."""
        return {
            "version": 1,
            "prior_ms": self.prior_ms,
            "global": self._global.state(),
            "funcs": {str(f): w.state() for f, w in sorted(self._funcs.items())},
        }

    def restore(self, snap: Mapping) -> None:
        """Replace state with ``snap`` (as produced by :meth:`snapshot`,
        possibly after a JSON round trip — string func keys are expected)."""
        if snap.get("version") != 1:
            raise ValueError(f"unsupported estimator snapshot: {snap.get('version')!r}")
        self.prior_ms = float(snap["prior_ms"])
        self._global = _Welford(*snap["global"])
        self._funcs = {int(f): _Welford(*s) for f, s in snap["funcs"].items()}

    @classmethod
    def from_snapshot(cls, snap: Mapping) -> "DurationEstimator":
        est = cls()
        est.restore(snap)
        return est


class BanditTuner:
    """Fixed-arm bandit over windowed rewards (UCB1 or seeded eps-greedy).

    ``arms`` is any fixed sequence of payloads (the values a policy reads
    through :attr:`current` — e.g. watermark multipliers); the tuner only
    tracks per-arm reward statistics and the current arm index.  Rewards are
    "higher is better".  ``feed(reward)`` credits the *current* arm, then
    selects the next arm:

    * untried arms first, in index order (every arm gets one pull);
    * ``mode="ucb"`` — UCB1: ``argmax mean + ucb_c * sqrt(ln(steps) / n)``,
      ties to the lowest index.  Fully deterministic.
    * ``mode="egreedy"`` — with probability ``epsilon`` explore a uniform
      arm, else exploit the best mean.  Both draws come from counter-based
      streams keyed on ``(seed, steps)``, so selection is a pure function
      of the snapshot state: no RNG object to serialize.
    """

    _MODES = ("ucb", "egreedy")
    _EXPLORE_TAG = 0xBA2D  # keeps the explore-index stream disjoint

    def __init__(
        self,
        arms: Sequence,
        mode: str = "ucb",
        epsilon: float = 0.1,
        ucb_c: float = 0.5,
        seed: int = 0,
    ):
        self.arms = tuple(arms)
        if not self.arms:
            raise ValueError("BanditTuner needs at least one arm")
        if mode not in self._MODES:
            raise ValueError(f"mode must be one of {self._MODES}, got {mode!r}")
        if not 0.0 <= float(epsilon) <= 1.0:
            raise ValueError(f"epsilon must be in [0, 1], got {epsilon!r}")
        if float(ucb_c) < 0.0:
            raise ValueError(f"ucb_c must be >= 0, got {ucb_c!r}")
        self.mode = mode
        self.epsilon = float(epsilon)
        self.ucb_c = float(ucb_c)
        self.seed = int(seed)
        self._n = [0] * len(self.arms)
        self._mean = [0.0] * len(self.arms)
        self._steps = 0  # rewards fed so far
        self._arm = 0  # current arm index

    # --------------------------------------------------------------- reads
    @property
    def arm_index(self) -> int:
        return self._arm

    @property
    def current(self):
        """The current arm's payload."""
        return self.arms[self._arm]

    def pulls(self, i: int) -> int:
        return self._n[i]

    def mean_reward(self, i: int) -> float:
        return self._mean[i]

    # ------------------------------------------------------------- updates
    def feed(self, reward: float) -> None:
        """Credit ``reward`` to the current arm, then pick the next arm."""
        r = float(reward)
        if not math.isfinite(r):
            raise ValueError(f"reward must be finite, got {reward!r}")
        i = self._arm
        self._n[i] += 1
        self._mean[i] += (r - self._mean[i]) / self._n[i]
        self._steps += 1
        self._arm = self._select()

    def _best(self) -> int:
        best, best_mean = 0, -math.inf
        for i, m in enumerate(self._mean):
            if m > best_mean:
                best, best_mean = i, m
        return best

    def _select(self) -> int:
        for i, n in enumerate(self._n):
            if n == 0:
                return i
        if self.mode == "ucb":
            log_t = math.log(self._steps)
            best, best_score = 0, -math.inf
            for i in range(len(self.arms)):
                score = self._mean[i] + self.ucb_c * math.sqrt(log_t / self._n[i])
                if score > best_score:
                    best, best_score = i, score
            return best
        # egreedy: counter-based streams -> pure function of (seed, steps)
        u = float(np.random.default_rng((self.seed, self._steps)).random())
        if u < self.epsilon:
            return int(
                np.random.default_rng(
                    (self.seed, self._steps, self._EXPLORE_TAG)
                ).integers(len(self.arms))
            )
        return self._best()

    # ----------------------------------------------------------- snapshots
    def snapshot(self) -> dict:
        """Serializable full state (arm stats + cursor; arms are config)."""
        return {
            "version": 1,
            "n_arms": len(self.arms),
            "arm": self._arm,
            "steps": self._steps,
            "n": list(self._n),
            "mean": list(self._mean),
        }

    def restore(self, snap: Mapping) -> None:
        if snap.get("version") != 1:
            raise ValueError(f"unsupported bandit snapshot: {snap.get('version')!r}")
        if int(snap["n_arms"]) != len(self.arms):
            raise ValueError(
                f"snapshot has {snap['n_arms']} arms, tuner has {len(self.arms)} "
                "— record and replay must share the arm set"
            )
        self._arm = int(snap["arm"])
        self._steps = int(snap["steps"])
        self._n = [int(x) for x in snap["n"]]
        self._mean = [float(x) for x in snap["mean"]]
