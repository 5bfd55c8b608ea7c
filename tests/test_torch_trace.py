"""The port's ``core/trace.py`` against the JAX package's: every function of
the workload generator gives bit for bit the reference's output over a few
seeds and shapes."""

import dataclasses

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro.core import trace as ref
from repro_torch.core import trace

SEEDS = [0, 3, 42]


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _same_programs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _same(x.func_idx, y.func_idx)
        _same(x.sleep_s, y.sleep_s)


def test_tables_and_specs_equal_the_reference():
    assert trace.TABLE_I == ref.TABLE_I and trace.APP_MEM_MB == ref.APP_MEM_MB
    assert [f.name for f in dataclasses.fields(trace.FunctionSpec)] == [
        f.name for f in dataclasses.fields(ref.FunctionSpec)]


@pytest.mark.parametrize("n,share", [(1000, 0.923), (200, 0.8), (5000, 0.95)])
def test_fit_zipf_exponent(n, share):
    assert trace.fit_zipf_exponent(n, share) == ref.fit_zipf_exponent(n, share)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_funcs", [10, 40, 1000])
def test_azure_like_weights(seed, n_funcs):
    _same(trace.azure_like_weights(n_funcs, seed), ref.azure_like_weights(n_funcs, seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_copies", [1, 5])
def test_make_functions(seed, n_copies):
    got, want = trace.make_functions(n_copies, seed), ref.make_functions(n_copies, seed)
    assert [dataclasses.astuple(f) for f in got] == [dataclasses.astuple(f) for f in want]


@pytest.mark.parametrize("seed", SEEDS)
def test_vu_programs_ref_and_vec(seed):
    w = ref.make_functions(seed=seed)
    weights = np.array([f.weight for f in w])
    weights = weights / weights.sum()
    args = (len(w), weights, 9, 56, seed, 0.1, 1.0)
    _same_programs(trace._vu_programs_ref(*args), ref._vu_programs_ref(*args))
    _same_programs(trace._vu_programs_vec(*args), ref._vu_programs_vec(*args))
    _same_programs(trace._vu_programs_ref(*args, vu_start=4), ref._vu_programs_ref(*args, vu_start=4))


@pytest.mark.parametrize("dur", [0.0, 6.0, 40.0, 60.5])
def test_default_n_events(dur):
    assert trace.default_n_events(dur) == ref.default_n_events(dur)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_vus", [3, 50])  # 3 takes the per-VU loop, 50 the vectorized path
def test_make_vu_programs(seed, n_vus):
    funcs = trace.make_functions(seed=seed)
    got = trace.make_vu_programs(funcs, n_vus, 64, seed, 0.2, 0.9)
    want = ref.make_vu_programs(ref.make_functions(seed=seed), n_vus, 64, seed, 0.2, 0.9)
    _same_programs(got, want)


def test_service_time_ms():
    for f, g in zip(trace.make_functions(seed=1), ref.make_functions(seed=1)):
        for cold in (False, True):
            a = trace.service_time_ms(f, cold, np.random.default_rng((1, 2)), 0.3)
            b = ref.service_time_ms(g, cold, np.random.default_rng((1, 2)), 0.3)
            assert a == b


@pytest.mark.parametrize("seed,sigma,ev_start,vu_start", [
    (0, 0.25, 0, 0), (123, 0.25, 40, 0), (7, 0.4, 0, 11), (2**33, 0.25, 0, 0)])
def test_service_fluctuations_bands(seed, sigma, ev_start, vu_start):
    got = trace.service_fluctuations(seed, 5, 24, sigma, ev_start=ev_start, vu_start=vu_start)
    want = ref.service_fluctuations(seed, 5, 24, sigma, ev_start=ev_start, vu_start=vu_start)
    _same(got, want)


@pytest.mark.parametrize("seed", [1, 2, 99])
def test_bursty_interarrivals(seed):
    _same(trace.bursty_interarrivals(5_000, seed), ref.bursty_interarrivals(5_000, seed))
    kw = dict(base_rate=10.0, burst_rate=200.0, mean_burst_s=5.0, mean_calm_s=20.0)
    _same(trace.bursty_interarrivals(2_000, seed, **kw), ref.bursty_interarrivals(2_000, seed, **kw))
