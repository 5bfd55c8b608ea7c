"""The port's ``core/fastrng.py`` against the JAX package's: the cases of
``tests/test_fastrng.py`` on the port's module, each also held bit for bit
against the reference module's arrays on the same arguments, and the port's
learned tables byte for byte the reference's."""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro.core import fastrng as ref_fastrng
from repro.core import trace as ref_trace
from repro_torch.core import fastrng
from repro_torch.core import trace

MEAN, SIGMA = -0.5 * 0.25**2, 0.25


def _reference(seed, n_vus, n_events, mean, sigma):
    return np.array(
        [
            [
                np.random.default_rng((seed, v, e)).lognormal(mean=mean, sigma=sigma)
                for e in range(n_events)
            ]
            for v in range(n_vus)
        ]
    )


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_tables_are_the_reference_bytes():
    port = Path(fastrng.__file__).with_name("zig_tables.json")
    assert fastrng._TABLE_PATH == port
    assert port.read_bytes() == Path(ref_fastrng.__file__).with_name("zig_tables.json").read_bytes()
    for a, b in zip(fastrng._load_tables(), ref_fastrng._load_tables()):
        _same(a, b)


def test_write_tables_refuses_the_checked_in_file():
    with pytest.raises(ValueError, match="refusing"):
        fastrng.write_tables(fastrng._TABLE_PATH, n_draws=8)


def test_selftest_passes():
    assert fastrng.selftest() and ref_fastrng.selftest()
    assert fastrng.selftest_uniform() and ref_fastrng.selftest_uniform()


@pytest.mark.parametrize("seed", [0, 1, 42, 999_999, 2**31])
def test_bit_exact_vs_default_rng(seed):
    got = fastrng.lognormal_matrix(seed, 8, 64, MEAN, SIGMA)
    assert np.array_equal(got, _reference(seed, 8, 64, MEAN, SIGMA))
    _same(got, ref_fastrng.lognormal_matrix(seed, 8, 64, MEAN, SIGMA))


def test_bit_exact_other_sigma():
    got = fastrng.lognormal_matrix(7, 4, 32, -0.08, 0.4)
    assert np.array_equal(got, _reference(7, 4, 32, -0.08, 0.4))
    _same(got, ref_fastrng.lognormal_matrix(7, 4, 32, -0.08, 0.4))


def test_ev_start_band():
    mean = -0.03125
    full = fastrng.lognormal_matrix(3, 4, 48, mean, SIGMA)
    band = fastrng.lognormal_matrix(3, 4, 16, mean, SIGMA, ev_start=32)
    assert np.array_equal(full[:, 32:48], band)
    _same(band, ref_fastrng.lognormal_matrix(3, 4, 16, mean, SIGMA, ev_start=32))
    rows = fastrng.lognormal_matrix(3, 2, 16, mean, SIGMA, vu_start=5)
    _same(rows, ref_fastrng.lognormal_matrix(3, 2, 16, mean, SIGMA, vu_start=5))


def test_out_of_range_seed_falls_back():
    seed = 2**33 + 5
    got = fastrng.lognormal_matrix(seed, 2, 8, -0.03125, 0.25)
    assert np.array_equal(got, _reference(seed, 2, 8, -0.03125, 0.25))
    _same(got, ref_fastrng.lognormal_matrix(seed, 2, 8, -0.03125, 0.25))


def test_state_reset_fallback_matches_fresh_generator():
    vu = np.arange(50, dtype=np.uint32)
    ev = np.full(50, 3, np.uint32)
    state = fastrng._init_state(77, vu, ev)
    for a, b in zip(state, ref_fastrng._init_state(77, vu, ev)):
        _same(a, b)
    sh, sl, inch, incl = state
    for i in range(50):
        st = (int(sh[i]) << 64) | int(sl[i])
        inc = (int(inch[i]) << 64) | int(incl[i])
        got = fastrng._slow_from_state(st, inc, -0.03125, 0.25)
        want = float(np.random.default_rng((77, int(vu[i]), 3)).lognormal(-0.03125, 0.25))
        assert got == want == ref_fastrng._slow_from_state(st, inc, -0.03125, 0.25)


def test_selftest_failure_warns_once_and_stays_bit_exact(monkeypatch):
    monkeypatch.setattr(fastrng, "_SELFTEST_OK", False)
    monkeypatch.setattr(fastrng, "_FALLBACK_WARNED", False)
    mean = -0.03125
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got1 = fastrng.lognormal_matrix(11, 3, 16, mean, SIGMA)
        got2 = fastrng.lognormal_matrix(12, 4, 8, mean, SIGMA)
    fallback = [w for w in caught if "fastrng fast path disabled" in str(w.message)]
    assert len(fallback) == 1
    assert issubclass(fallback[0].category, RuntimeWarning)
    _same(got1, ref_fastrng.lognormal_matrix(11, 3, 16, mean, SIGMA))
    _same(got2, ref_fastrng.lognormal_matrix(12, 4, 8, mean, SIGMA))
    assert np.array_equal(got1, _reference(11, 3, 16, mean, SIGMA))


def test_fast_path_emits_no_fallback_warning():
    assert fastrng.selftest()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fastrng.lognormal_matrix(3, 2, 16, -0.03125, 0.25)
    assert not [w for w in caught if "fastrng" in str(w.message)]


def test_unlearned_tables_fallback_bit_exact(monkeypatch):
    wi, ki, usable = fastrng._load_tables()
    monkeypatch.setattr(fastrng, "_TABLES", (wi, ki, np.zeros_like(usable)))
    got = fastrng.lognormal_matrix(99, 5, 40, MEAN, SIGMA)
    assert np.array_equal(got, _reference(99, 5, 40, MEAN, SIGMA))
    _same(got, ref_fastrng.lognormal_matrix(99, 5, 40, MEAN, SIGMA))


@pytest.mark.parametrize("seed", [0, 7, 123_456])
def test_vu_programs_vec_bit_identical_to_ref(seed):
    weights = np.array([0.5, 0.3, 0.2])
    vec = trace._vu_programs_vec(3, weights, 12, 40, seed, 1.0, 3.0)
    ref = trace._vu_programs_ref(3, weights, 12, 40, seed, 1.0, 3.0)
    want = ref_trace._vu_programs_vec(3, weights, 12, 40, seed, 1.0, 3.0)
    assert len(vec) == len(ref) == len(want) == 12
    for a, b, c in zip(vec, ref, want):
        _same(a.func_idx, b.func_idx)
        _same(a.sleep_s, b.sleep_s)
        _same(a.func_idx, c.func_idx)
        _same(a.sleep_s, c.sleep_s)
    assert trace._PROG_FAST_OK


@pytest.mark.parametrize("seed,vu_start", [(0, 0), (5, 3), (2**31, 0)])
def test_uniform_block_matches_reference(seed, vu_start):
    _same(fastrng.uniform_block(seed, 6, 20, vu_start=vu_start),
          ref_fastrng.uniform_block(seed, 6, 20, vu_start=vu_start))


def test_bit_exact_large_sample():
    """~20k draws covering all ziggurat strips and the rejection paths."""
    got = fastrng.lognormal_matrix(1234, 20, 1000, MEAN, SIGMA)
    assert np.array_equal(got, _reference(1234, 20, 1000, MEAN, SIGMA))
    _same(got, ref_fastrng.lognormal_matrix(1234, 20, 1000, MEAN, SIGMA))
