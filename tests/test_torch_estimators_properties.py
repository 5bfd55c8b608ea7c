"""Hypothesis property tests for the port's ``core.estimators``: the cases of
``tests/test_estimators_properties.py`` on the port's module, and for
arbitrary observation and reward streams the port's snapshots equal the JAX
package's as JSON strings.
"""

import json
import math

import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

pytest.importorskip("hypothesis")  # optional dep: skip only the property tests
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core.estimators import BanditTuner, DurationEstimator  # noqa: E402
from repro.core import estimators as ref_estimators

# realistic request durations in ms: positive, finite, non-degenerate scale
_durations = st.floats(
    min_value=1e-3, max_value=1e6, allow_nan=False, allow_infinity=False, width=64
)
_obs = st.lists(st.tuples(st.integers(0, 15), _durations), max_size=120)
_rewards = st.lists(
    st.floats(min_value=-1e6, max_value=1e6, allow_nan=False, allow_infinity=False),
    max_size=80,
)


def _fold(obs, est=None):
    est = est or DurationEstimator()
    for f, d in obs:
        est.update(f, d)
    return est


@settings(max_examples=60, deadline=None)
@given(obs=_obs, data=st.data())
def test_counts_exactly_permutation_invariant(obs, data):
    perm = data.draw(st.permutations(obs))
    a, b = _fold(obs), _fold(perm)
    assert a.total_updates == b.total_updates
    for f in range(16):
        assert a.n(f) == b.n(f)
        if a.n(f):  # moments: order-invariant up to float noise only
            assert b.mean_ms(f) == pytest.approx(a.mean_ms(f), rel=1e-9)
            assert b.variance_ms2(f) == pytest.approx(
                a.variance_ms2(f), rel=1e-6, abs=1e-9
            )


@settings(max_examples=60, deadline=None)
@given(obs=_obs)
def test_variance_is_never_negative_and_mean_stays_in_hull(obs):
    est = _fold(obs)
    per_func = {}
    for f, d in obs:
        per_func.setdefault(f, []).append(d)
    for f, ds in per_func.items():
        assert est.variance_ms2(f) >= 0.0
        assert est.std_ms(f) >= 0.0
        assert min(ds) <= est.mean_ms(f) <= max(ds)  # Welford mean in hull
    assert est.variance_ms2(99) == 0.0  # unseen: defined, not negative


@settings(max_examples=60, deadline=None)
@given(obs=_obs, cut=st.integers(0, 120))
def test_snapshot_restore_continue_equals_uninterrupted(obs, cut):
    cut = min(cut, len(obs))
    cont = _fold(obs[:cut])
    resumed = DurationEstimator.from_snapshot(cont.snapshot())
    _fold(obs[cut:], cont)
    _fold(obs[cut:], resumed)
    assert resumed.snapshot() == cont.snapshot()  # exact float equality
    for f in range(16):
        assert resumed.predict_ms(f) == cont.predict_ms(f)


@settings(max_examples=60, deadline=None)
@given(obs=_obs)
def test_snapshot_json_round_trip_bit_exact(obs):
    snap = _fold(obs).snapshot()
    wire = json.loads(json.dumps(snap))
    assert wire == snap
    assert DurationEstimator.from_snapshot(wire).snapshot() == snap


@settings(max_examples=60, deadline=None)
@given(
    obs=_obs,
    bad=st.one_of(
        st.just(float("nan")),
        st.just(float("inf")),
        st.just(float("-inf")),
        st.floats(max_value=0.0, allow_nan=False, width=64),
    ),
    func=st.integers(0, 15),
)
def test_junk_rejected_at_boundary_state_untouched(obs, bad, func):
    est = _fold(obs)
    before = est.snapshot()
    with pytest.raises(ValueError):
        est.update(func, bad)
    with pytest.raises(ValueError):
        est.update(-1 - func, 50.0)
    assert est.snapshot() == before


@settings(max_examples=40, deadline=None)
@given(
    rewards=_rewards,
    n_arms=st.integers(1, 6),
    mode=st.sampled_from(["ucb", "egreedy"]),
    eps=st.floats(0.0, 1.0),
    seed=st.integers(0, 2**31 - 1),
    cut=st.integers(0, 80),
)
def test_bandit_snapshot_resume_and_determinism(rewards, n_arms, mode, eps, seed, cut):
    arms = tuple(range(n_arms))
    mk = lambda: BanditTuner(arms, mode=mode, epsilon=eps, seed=seed)  # noqa: E731
    cut = min(cut, len(rewards))
    cont = mk()
    for r in rewards[:cut]:
        cont.feed(r)
    resumed = mk()
    resumed.restore(json.loads(json.dumps(cont.snapshot())))
    for r in rewards[cut:]:
        assert resumed.arm_index == cont.arm_index  # selection is pure state
        cont.feed(r)
        resumed.feed(r)
    assert resumed.snapshot() == cont.snapshot()
    assert 0 <= cont.arm_index < n_arms
    assert sum(cont.pulls(i) for i in range(n_arms)) == len(rewards)
    for i in range(n_arms):
        assert math.isfinite(cont.mean_reward(i))


# ----------------------------------------------- parity with the JAX package
@settings(max_examples=40, deadline=None)
@given(obs=_obs)
def test_snapshot_json_equals_the_reference(obs):
    port = _fold(obs)
    ref = ref_estimators.DurationEstimator()
    for f, d in obs:
        ref.update(f, d)
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())


@settings(max_examples=30, deadline=None)
@given(rewards=_rewards, n_arms=st.integers(1, 5), mode=st.sampled_from(["ucb", "egreedy"]),
       seed=st.integers(0, 1000))
def test_bandit_snapshot_json_equals_the_reference(rewards, n_arms, mode, seed):
    arms = tuple(float(a) for a in range(1, n_arms + 1))
    port = BanditTuner(arms, mode=mode, epsilon=0.3, seed=seed)
    ref = ref_estimators.BanditTuner(arms, mode=mode, epsilon=0.3, seed=seed)
    for r in rewards:
        assert port.arm_index == ref.arm_index
        port.feed(r)
        ref.feed(r)
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
