"""The port's ``core/records.py`` and ``core/metrics.py`` against the JAX
package's: the cases of ``tests/test_records.py`` on the port's modules (its
simulator's run of the same configuration), the property cases of
``tests/test_records_properties.py``, and every metric held field by field
against the reference's on the same records."""

import dataclasses
import os

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import SimConfig as RefSimConfig
from repro.core import Simulator as RefSimulator
from repro.core import make_scheduler as ref_make_scheduler
from repro.core import metrics as ref_metrics
from repro.core import records as ref_records
from repro_torch.core import SimConfig, Simulator, make_scheduler
from repro_torch.core import records as port_records
from repro_torch.core.metrics import (
    latency_cdf,
    load_cv_per_second,
    summarize,
    summarize_window,
    summarize_windows,
)
from repro_torch.core.records import REC_DTYPE, RecordAccumulator, RecordColumns, RequestRecord

WORKERS = list(range(5))


def _both(mk, Sim, Cfg):
    sim = Sim(mk("hiku", 5, seed=17), cfg=Cfg(mem_pool_mb=1024.0), seed=17)
    return sim, sim.run(n_vus=25, duration_s=30.0)


@pytest.fixture(scope="module")
def sim_run():
    sim, recs = _both(make_scheduler, Simulator, SimConfig)
    assert len(recs) > 100
    return sim, recs


@pytest.fixture(scope="module")
def ref_run():
    return _both(ref_make_scheduler, RefSimulator, RefSimConfig)


def _ref_cols(cols):
    """The same columns as the reference's ``RecordColumns``."""
    return ref_records.RecordColumns(*(getattr(cols, f) for f in port_records._FIELDS))


def _fields(m):
    return dataclasses.astuple(m)


def test_port_run_is_the_reference_run(sim_run, ref_run):
    (sim, recs), (rsim, rrecs) = sim_run, ref_run
    assert [tuple(r) for r in recs] == [tuple(r) for r in rrecs]
    assert sim.record_columns.as_structured().tobytes() == rsim.record_columns.as_structured().tobytes()
    for a, b in zip(sim.assignment_columns, rsim.assignment_columns):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert REC_DTYPE == ref_records.REC_DTYPE


def test_round_trip_records_columns_records(sim_run):
    _, recs = sim_run
    back = RecordColumns.from_records(recs).to_records()
    assert back == recs
    assert all(isinstance(r, RequestRecord) for r in back)
    assert all(isinstance(r.cold, bool) for r in back)


def test_accumulator_is_the_simulator_store(sim_run):
    sim, recs = sim_run
    cols = sim.record_columns
    assert len(cols) == len(recs)
    assert cols.to_records() == recs
    assert sim.records is sim.records


def test_column_dtypes_and_structured_view(sim_run):
    sim, _ = sim_run
    cols = sim.record_columns
    assert cols.t_submit.dtype == np.float64 and cols.t_done.dtype == np.float64
    assert cols.func.dtype == np.int32 and cols.worker.dtype == np.int32
    assert cols.cold.dtype == np.bool_ and cols.vu.dtype == np.int32
    packed = cols.as_structured()
    assert packed.dtype == REC_DTYPE and len(packed) == len(cols)
    assert RecordColumns.from_structured(packed).equals(cols)
    assert packed.tobytes() == _ref_cols(cols).as_structured().tobytes()


def test_concat_take_remap_getitem(sim_run):
    _, recs = sim_run
    cols = RecordColumns.from_records(recs)
    a, b = cols[: len(cols) // 2], cols[len(cols) // 2:]
    assert RecordColumns.concat([a, b]).equals(cols)
    rev = cols.take(np.arange(len(cols))[::-1])
    assert rev[0] == recs[-1] and rev[-1] == recs[0]
    shifted = cols.remap(worker_offset=100, vu_offset=1000)
    assert np.array_equal(shifted.worker, cols.worker + 100)
    assert np.array_equal(shifted.vu, cols.vu + 1000)
    assert np.array_equal(shifted.t_submit, cols.t_submit)
    assert cols.remap() is cols
    assert cols[3] == recs[3]
    assert list(cols[:2]) == recs[:2]
    want = _ref_cols(cols).remap(worker_offset=100, vu_offset=1000)
    assert shifted.as_structured().tobytes() == want.as_structured().tobytes()
    vu_map = np.arange(25, dtype=np.int64)[::-1] * 3
    assert cols.remap_vus(vu_map).as_structured().tobytes() == \
        _ref_cols(cols).remap_vus(vu_map).as_structured().tobytes()


def test_from_structured_defaults_only_migrated(sim_run):
    sim, _ = sim_run
    cols = sim.record_columns
    legacy_dtype = np.dtype([d for d in REC_DTYPE.descr if d[0] != "migrated"])
    legacy = np.empty(len(cols), legacy_dtype)
    for name in legacy_dtype.names:
        legacy[name] = getattr(cols, name)
    back = RecordColumns.from_structured(legacy)
    assert back.equals(cols) and not back.migrated.any()
    truncated = np.empty(3, np.dtype([("t_submit", "<f8"), ("t_done", "<f8")]))
    with pytest.raises(ValueError, match="lacks fields"):
        RecordColumns.from_structured(truncated)


def test_empty_store():
    empty = RecordColumns.empty()
    assert len(empty) == 0 and empty.to_records() == []
    assert RecordColumns.from_records([]).equals(empty)
    assert RecordColumns.concat([]).equals(empty)
    acc = RecordAccumulator()
    assert len(acc) == 0 and acc.columns().equals(empty)


def test_mismatched_column_lengths_rejected():
    with pytest.raises(ValueError):
        RecordColumns([0.0, 1.0], [1.0], [0], [0], [False], [0])


def test_accumulator_append_and_clear():
    acc = RecordAccumulator()
    acc.append(0.5, 1.5, 3, 2, True, 7)
    acc.append(0.6, 1.1, 1, 0, False, 4)
    assert len(acc) == 2
    assert acc.to_records() == [
        RequestRecord(0.5, 1.5, 3, 2, True, 7),
        RequestRecord(0.6, 1.1, 1, 0, False, 4),
    ]
    assert acc.columns().to_records() == acc.to_records()
    acc.clear()
    assert len(acc) == 0


def test_latency_vector_matches_row_property(sim_run):
    _, recs = sim_run
    cols = RecordColumns.from_records(recs)
    assert np.array_equal(cols.latency_ms, np.array([r.latency_ms for r in recs]))
    assert cols.latency_ms.tobytes() == _ref_cols(cols).latency_ms.tobytes()


def test_summarize_list_vs_columnar_tolerance_zero(sim_run, ref_run):
    sim, recs = sim_run
    m_list = summarize(recs, sim.assignments, WORKERS, 30.0)
    m_cols = summarize(sim.record_columns, sim.assignment_columns, WORKERS, 30.0)
    assert m_list == m_cols
    rsim, _ = ref_run
    want = ref_metrics.summarize(rsim.record_columns, rsim.assignment_columns, WORKERS, 30.0)
    assert _fields(m_cols) == _fields(want)


def test_latency_cdf_list_vs_columnar(sim_run):
    sim, recs = sim_run
    x1, y1 = latency_cdf(recs)
    x2, y2 = latency_cdf(sim.record_columns)
    assert np.array_equal(x1, x2) and np.array_equal(y1, y2)
    x3, y3 = ref_metrics.latency_cdf(_ref_cols(sim.record_columns))
    assert x2.tobytes() == x3.tobytes() and y2.tobytes() == y3.tobytes()


def _load_cv_loop(assignments, workers, t_end):
    """The pre-columnar implementation, verbatim."""
    n_bins = int(np.ceil(t_end)) + 1
    wid_index = {w: i for i, w in enumerate(workers)}
    counts = np.zeros((n_bins, len(workers)))
    for t, w in assignments:
        if w in wid_index:
            counts[min(int(t), n_bins - 1), wid_index[w]] += 1
    counts = counts[counts.sum(axis=1) > 0]
    mean, std = counts.mean(axis=1), counts.std(axis=1)
    return np.where(mean > 0, std / np.maximum(mean, 1e-12), 0.0)


def test_load_cv_matches_python_loop_reference(sim_run):
    sim, _ = sim_run
    want = _load_cv_loop(sim.assignments, WORKERS, 30.0)
    assert np.array_equal(load_cv_per_second(sim.assignments, WORKERS, 30.0), want)
    assert np.array_equal(load_cv_per_second(sim.assignment_columns, WORKERS, 30.0), want)


def test_load_cv_ignores_unknown_workers(sim_run):
    sim, _ = sim_run
    sub = [0, 2, 4]
    got = load_cv_per_second(sim.assignments, sub, 30.0)
    assert np.array_equal(got, _load_cv_loop(sim.assignments, sub, 30.0))
    assert got.tobytes() == ref_metrics.load_cv_per_second(sim.assignment_columns, sub, 30.0).tobytes()


def test_load_cv_accepts_plain_list_columns(sim_run):
    sim, _ = sim_run
    at, aw = sim.assignment_columns
    want = load_cv_per_second((at, aw), WORKERS, 30.0)
    assert np.array_equal(load_cv_per_second((at.tolist(), aw.tolist()), WORKERS, 30.0), want)


def test_load_cv_rejects_mismatched_columns():
    with pytest.raises(ValueError):
        load_cv_per_second((np.zeros(3), np.zeros(2, np.int64)), [0, 1], 5.0)


def test_summarize_empty_records_keeps_seed_semantics():
    m = summarize([], [], [0, 1], 10.0)
    assert m.n_requests == 0
    assert m.mean_latency_ms == 0.0 and m.cold_rate == 0.0
    assert m.load_cv == 0.0 and m.throughput_rps == 0.0
    assert _fields(m) == _fields(ref_metrics.summarize([], [], [0, 1], 10.0))


@pytest.mark.parametrize("window_s", [1.5, 4.0, 0.7])
def test_summarize_windows_equals_the_reference(sim_run, window_s):
    sim, _ = sim_run
    cols, asg = sim.record_columns, sim.assignment_columns
    got = summarize_windows(cols, asg, WORKERS, window_s, 30.0)
    want = ref_metrics.summarize_windows(_ref_cols(cols), asg, WORKERS, window_s, 30.0)
    assert len(got) == len(want) > 1
    for (t1, m1), (t2, m2) in zip(got, want):
        assert t1 == t2 and _fields(m1) == _fields(m2)
    assert sum(m.n_requests for _, m in got) == len(cols)


def test_summarize_with_deadlines_and_failures_equals_the_reference(sim_run):
    sim, _ = sim_run
    cols, asg = sim.record_columns, sim.assignment_columns
    rng = np.random.default_rng(0)
    kw = dict(deadline_ms=rng.uniform(100.0, 2000.0, 25), arrival_s=np.sort(rng.uniform(0, 5, 25)),
              resubmits=3, lost_tasks=1, recovery_s=[0.05, 0.2, 0.11])
    got = summarize(cols, asg, WORKERS, 30.0, **kw)
    want = ref_metrics.summarize(_ref_cols(cols), asg, WORKERS, 30.0, **kw)
    assert _fields(got) == _fields(want)
    assert got.row() == want.row()


def test_shm_round_trip_matches_the_reference_layout(sim_run):
    """The shared-memory transport on its own (the sharded driver that ships
    through it is not ported yet): one segment written and read back."""
    sim, _ = sim_run
    cols = sim.record_columns
    at, aw = sim.assignment_columns
    n_rec, n_asg = len(cols), len(at)
    assert port_records.shm_layout(n_rec, n_asg) == ref_records.shm_layout(n_rec, n_asg)
    name = f"repro_torch_test_{os.getpid()}"
    try:
        assert port_records.write_columns_shm(name, cols, at, aw) == name
        back, bt, bw = ref_records.read_columns_shm(name, n_rec, n_asg)
    finally:
        port_records.unlink_columns_shm(name)
    assert back.as_structured().tobytes() == cols.as_structured().tobytes()
    assert bt.tobytes() == at.tobytes() and bw.tobytes() == np.asarray(aw, np.int64).tobytes()
    port_records.unlink_columns_shm(name)  # idempotent
    assert port_records.write_columns_shm(name, RecordColumns.empty(), [], []) is None


# ---------------------------------------------------- property cases
_times = st.floats(min_value=0.0, max_value=1e6, allow_nan=False, allow_infinity=False, width=64)
_records = st.lists(
    st.builds(RequestRecord, t_submit=_times, t_complete=_times, func=st.integers(0, 63),
              worker=st.integers(0, 99), cold=st.booleans(), vu=st.integers(0, 499)),
    max_size=200,
)
_assignments = st.lists(
    st.tuples(st.floats(min_value=0.0, max_value=99.0, allow_nan=False), st.integers(0, 9)),
    max_size=200,
)


def _asg_cols(assignments):
    return (np.array([t for t, _ in assignments], np.float64),
            np.array([w for _, w in assignments], np.int64))


@settings(max_examples=60, deadline=None)
@given(records=_records)
def test_round_trip_preserves_order_dtype_and_flags(records):
    cols = RecordColumns.from_records(records)
    assert len(cols) == len(records)
    assert cols.t_submit.dtype == np.float64 and cols.cold.dtype == np.bool_
    back = cols.to_records()
    assert back == records
    assert [r.cold for r in back] == [r.cold for r in records]
    assert RecordColumns.from_structured(cols.as_structured()).to_records() == records
    assert cols.as_structured().tobytes() == \
        ref_records.RecordColumns.from_records(records).as_structured().tobytes()


@settings(max_examples=60, deadline=None)
@given(records=_records, assignments=_assignments, duration=st.floats(1.0, 500.0))
def test_summarize_list_vs_columnar_tolerance_zero_property(records, assignments, duration):
    workers = list(range(10))
    m_list = summarize(records, assignments, workers, duration)
    m_cols = summarize(RecordColumns.from_records(records), _asg_cols(assignments), workers,
                       duration)
    assert m_list == m_cols
    want = ref_metrics.summarize(ref_records.RecordColumns.from_records(records),
                                 _asg_cols(assignments), workers, duration)
    assert _fields(m_cols) == _fields(want)


@settings(max_examples=40, deadline=None)
@given(records=_records.filter(len))
def test_latency_cdf_list_vs_columnar_property(records):
    x1, y1 = latency_cdf(records)
    x2, y2 = latency_cdf(RecordColumns.from_records(records))
    assert np.array_equal(x1, x2) and np.array_equal(y1, y2)
    x3, y3 = ref_metrics.latency_cdf(ref_records.RecordColumns.from_records(records))
    assert x2.tobytes() == x3.tobytes() and y2.tobytes() == y3.tobytes()


@settings(max_examples=40, deadline=None)
@given(assignments=_assignments, t_end=st.floats(1.0, 200.0))
def test_load_cv_list_vs_columnar_property(assignments, t_end):
    workers = list(range(10))
    got_list = load_cv_per_second(assignments, workers, t_end)
    got_cols = load_cv_per_second(_asg_cols(assignments), workers, t_end)
    assert np.array_equal(got_list, got_cols)
    want = ref_metrics.load_cv_per_second(_asg_cols(assignments), workers, t_end)
    assert got_cols.tobytes() == want.tobytes()


@settings(max_examples=40, deadline=None)
@given(records=_records, split=st.integers(0, 200))
def test_concat_of_split_is_identity(records, split):
    cols = RecordColumns.from_records(records)
    split = min(split, len(cols))
    assert RecordColumns.concat([cols[:split], cols[split:]]).equals(cols)


def test_summarize_window_rebases_assignment_times(sim_run):
    sim, _ = sim_run
    cols, (at, aw) = sim.record_columns, sim.assignment_columns
    w = cols.window(3.0, 9.0)
    sel = (at > 3.0) & (at <= 9.0)
    got = summarize_window(w, (at[sel], aw[sel]), WORKERS, 3.0, 9.0)
    want = ref_metrics.summarize_window(_ref_cols(w), (at[sel], aw[sel]), WORKERS, 3.0, 9.0)
    assert _fields(got) == _fields(want)
