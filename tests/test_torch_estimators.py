"""The port's learned-state building blocks (``repro_torch.core.estimators``).

* the cases of ``tests/test_estimators.py`` on the port's module;
* parity: the same seeded observation and reward sequences (numpy) through
  the JAX package's ``DurationEstimator``/``BanditTuner`` and the port's give
  the same predictions bit for bit and snapshots equal as JSON strings, and a
  snapshot taken on one package restores on the other.
"""

import json
import math

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core.estimators import BanditTuner, DurationEstimator
from repro.core import estimators as ref_estimators

def _observations(seed=0, n=200, n_funcs=5):
    rng = np.random.default_rng(seed)
    funcs = rng.integers(0, n_funcs, size=n)
    durs = rng.lognormal(mean=3.0, sigma=1.0, size=n) + 0.1  # ms, > 0
    return list(zip(funcs.tolist(), durs.tolist()))


# --------------------------------------------------------------- estimator
def test_estimator_prior_then_global_then_per_func_fallback():
    est = DurationEstimator(prior_ms=123.0)
    # estimator cold start: the static prior, for any function
    assert est.predict_ms(0) == 123.0 and est.predict_ms(7) == 123.0
    assert est.total_updates == 0 and est.n(0) == 0
    assert math.isnan(est.mean_ms(0))
    est.update(0, 50.0)
    # seen function: its own mean; unseen function: the global mean
    assert est.predict_ms(0) == 50.0
    assert est.predict_ms(7) == 50.0
    est.update(0, 150.0)
    est.update(3, 1000.0)
    assert est.predict_ms(0) == pytest.approx(100.0)
    assert est.n(0) == 2 and est.n(3) == 1 and est.total_updates == 3
    assert est.predict_ms(7) == pytest.approx((50.0 + 150.0 + 1000.0) / 3)


def test_estimator_mean_variance_match_numpy():
    est = DurationEstimator()
    durs = [12.5, 90.0, 33.3, 45.0, 250.0, 18.75]
    for d in durs:
        est.update(4, d)
    assert est.mean_ms(4) == pytest.approx(np.mean(durs), rel=1e-12)
    assert est.variance_ms2(4) == pytest.approx(np.var(durs, ddof=1), rel=1e-12)
    assert est.std_ms(4) == pytest.approx(np.std(durs, ddof=1), rel=1e-12)


def test_estimator_variance_nonnegative_and_zero_below_two_samples():
    est = DurationEstimator()
    assert est.variance_ms2(0) == 0.0
    est.update(0, 77.0)
    assert est.variance_ms2(0) == 0.0  # n < 2: no sample variance yet
    # many identical observations: catastrophic-cancellation territory for
    # the naive sum-of-squares formula; Welford + clamp must stay >= 0
    for _ in range(500):
        est.update(1, 1e6 + 1e-4)
    assert est.variance_ms2(1) >= 0.0


def test_estimator_rejects_junk_at_the_update_boundary_state_untouched():
    est = DurationEstimator()
    est.update(2, 40.0)
    before = est.snapshot()
    for bad in (float("nan"), float("inf"), float("-inf"), 0.0, -5.0):
        with pytest.raises(ValueError, match="finite and > 0"):
            est.update(2, bad)
    with pytest.raises(ValueError, match="func index"):
        est.update(-1, 10.0)
    assert est.snapshot() == before  # every rejected update left no trace
    with pytest.raises(ValueError, match="prior_ms"):
        DurationEstimator(prior_ms=0.0)
    with pytest.raises(ValueError, match="prior_ms"):
        DurationEstimator(prior_ms=float("nan"))


def test_estimator_counts_are_exactly_permutation_invariant():
    """The documented update-order contract: counts are exact under
    permutation; means/variances agree to numerical noise (Welford is not
    float-commutative — determinism comes from canonical fold order)."""
    obs = _observations(seed=3)
    rng = np.random.default_rng(7)
    a, b = DurationEstimator(), DurationEstimator()
    for f, d in obs:
        a.update(f, d)
    for i in rng.permutation(len(obs)).tolist():
        b.update(*obs[i])
    funcs = sorted({f for f, _ in obs})
    assert a.total_updates == b.total_updates
    for f in funcs:
        assert a.n(f) == b.n(f)  # exact
        assert a.mean_ms(f) == pytest.approx(b.mean_ms(f), rel=1e-9)
        assert a.variance_ms2(f) == pytest.approx(b.variance_ms2(f), rel=1e-6)


def test_estimator_snapshot_restore_continue_is_bit_exact():
    """snapshot -> restore -> keep updating == never snapshotting at all,
    float-for-float — the property the run-level replay tier rests on."""
    obs = _observations(seed=11, n=120)
    cont = DurationEstimator(prior_ms=42.0)
    for f, d in obs[:60]:
        cont.update(f, d)
    resumed = DurationEstimator.from_snapshot(cont.snapshot())
    for f, d in obs[60:]:
        cont.update(f, d)
        resumed.update(f, d)
    assert resumed.snapshot() == cont.snapshot()  # exact, not approx
    for f in sorted({f for f, _ in obs}):
        assert resumed.mean_ms(f) == cont.mean_ms(f)
        assert resumed.variance_ms2(f) == cont.variance_ms2(f)


def test_estimator_snapshot_survives_json_round_trip_bit_exactly():
    est = DurationEstimator()
    for f, d in _observations(seed=5, n=80):
        est.update(f, d)
    snap = est.snapshot()
    wire = json.loads(json.dumps(snap))
    assert wire == snap  # Python floats round-trip JSON bit-exactly
    back = DurationEstimator.from_snapshot(wire)
    assert back.snapshot() == snap
    assert back.predict_ms(0) == est.predict_ms(0)
    with pytest.raises(ValueError, match="snapshot"):
        DurationEstimator.from_snapshot({"version": 99})


# ------------------------------------------------------------ bandit tuner
def test_bandit_validates_construction():
    with pytest.raises(ValueError, match="at least one arm"):
        BanditTuner(())
    with pytest.raises(ValueError, match="mode"):
        BanditTuner((1.0,), mode="thompson")
    with pytest.raises(ValueError, match="epsilon"):
        BanditTuner((1.0,), mode="egreedy", epsilon=1.5)
    with pytest.raises(ValueError, match="ucb_c"):
        BanditTuner((1.0,), ucb_c=-0.1)
    with pytest.raises(ValueError, match="finite"):
        BanditTuner((1.0, 2.0)).feed(float("nan"))


def test_bandit_tries_every_arm_once_then_ucb_exploits_the_best():
    tuner = BanditTuner((0.5, 1.0, 2.0), mode="ucb", ucb_c=0.5)
    assert tuner.arm_index == 0 and tuner.current == 0.5
    rewards = {0: -3.0, 1: -1.0, 2: -2.0}  # arm 1 is clearly best
    order = []
    for _ in range(3):  # warm-up: untried arms in index order
        order.append(tuner.arm_index)
        tuner.feed(rewards[tuner.arm_index])
    assert order == [0, 1, 2]
    for _ in range(40):
        tuner.feed(rewards[tuner.arm_index])
    # UCB settles on the best arm: it gets the lion's share of pulls
    assert tuner.pulls(1) > tuner.pulls(0) and tuner.pulls(1) > tuner.pulls(2)
    assert tuner.mean_reward(1) == pytest.approx(-1.0)


def test_bandit_selection_is_deterministic_for_both_modes():
    for mode in ("ucb", "egreedy"):
        runs = []
        for _ in range(2):
            t = BanditTuner((1, 2, 3, 4), mode=mode, epsilon=0.3, seed=9)
            trace = []
            for i in range(50):
                trace.append(t.arm_index)
                t.feed(-float((t.arm_index - 2) ** 2) - 0.01 * i)
            runs.append(trace)
        assert runs[0] == runs[1], mode


def test_bandit_egreedy_explores_but_mostly_exploits():
    t = BanditTuner((0, 1, 2, 3), mode="egreedy", epsilon=0.25, seed=1)
    rewards = [1.0, 5.0, 2.0, 0.0]
    pulls = []
    for _ in range(400):
        pulls.append(t.arm_index)
        t.feed(rewards[t.arm_index])
    counts = [pulls.count(i) for i in range(4)]
    assert counts[1] > 200  # exploit share goes to the best arm
    assert all(c >= 5 for c in counts)  # epsilon keeps every arm sampled


def test_bandit_snapshot_restore_continue_matches_and_json_round_trips():
    rewards = lambda i: [-2.0, -0.5, -1.0][i]  # noqa: E731
    cont = BanditTuner((0.6, 1.0, 1.6), mode="egreedy", epsilon=0.2, seed=4)
    for _ in range(17):
        cont.feed(rewards(cont.arm_index))
    snap = json.loads(json.dumps(cont.snapshot()))
    assert snap == cont.snapshot()
    resumed = BanditTuner((0.6, 1.0, 1.6), mode="egreedy", epsilon=0.2, seed=4)
    resumed.restore(snap)
    assert resumed.arm_index == cont.arm_index
    for _ in range(30):  # futures coincide: selection is pure state function
        assert resumed.arm_index == cont.arm_index
        cont.feed(rewards(cont.arm_index))
        resumed.feed(rewards(resumed.arm_index))
    assert resumed.snapshot() == cont.snapshot()


def test_bandit_snapshot_rejects_mismatched_arm_set():
    t = BanditTuner((1.0, 2.0))
    t.feed(0.5)
    snap = t.snapshot()
    other = BanditTuner((1.0, 2.0, 3.0))
    with pytest.raises(ValueError, match="arm"):
        other.restore(snap)
    with pytest.raises(ValueError, match="snapshot"):
        t.restore({"version": 2})


# ----------------------------------------------- parity with the JAX package
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimator_snapshot_json_equals_the_reference(seed):
    obs = _observations(seed=seed, n=300, n_funcs=7)
    port, ref = DurationEstimator(prior_ms=80.0), ref_estimators.DurationEstimator(prior_ms=80.0)
    for i, (f, d) in enumerate(obs):
        port.update(f, d)
        ref.update(f, d)
        if i % 37 == 0:
            assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    assert json.dumps(port.snapshot(), sort_keys=True) == json.dumps(ref.snapshot(), sort_keys=True)
    for f in range(9):  # seen and unseen functions
        assert port.predict_ms(f).hex() == ref.predict_ms(f).hex()
        assert port.std_ms(f).hex() == ref.std_ms(f).hex()


def test_estimator_snapshot_restores_across_packages():
    obs = _observations(seed=5, n=120)
    ref = ref_estimators.DurationEstimator()
    for f, d in obs[:60]:
        ref.update(f, d)
    port = DurationEstimator.from_snapshot(json.loads(json.dumps(ref.snapshot())))
    for f, d in obs[60:]:
        port.update(f, d)
        ref.update(f, d)
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())


@pytest.mark.parametrize("mode", ["ucb", "egreedy"])
@pytest.mark.parametrize("seed", [0, 3])
def test_bandit_arms_and_snapshots_equal_the_reference(mode, seed):
    arms = (0.5, 0.8, 1.0, 1.25, 1.6)
    port = BanditTuner(arms, mode=mode, epsilon=0.15, seed=seed)
    ref = ref_estimators.BanditTuner(arms, mode=mode, epsilon=0.15, seed=seed)
    rng = np.random.default_rng(seed)
    means = rng.normal(size=len(arms))
    for _ in range(200):
        assert port.arm_index == ref.arm_index
        r = float(rng.normal(means[port.arm_index], 0.5))
        port.feed(r)
        ref.feed(r)
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    resumed = BanditTuner(arms, mode=mode, epsilon=0.15, seed=seed)
    resumed.restore(json.loads(json.dumps(ref.snapshot())))
    assert resumed.arm_index == ref.arm_index
