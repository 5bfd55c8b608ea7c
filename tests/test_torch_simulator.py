"""The port's discrete-event simulator against the JAX package's and the frozen
seed engine in ``tests/legacy``.

* the cases of ``tests/test_simulator.py`` on the port's modules, with the
  record streams and metrics also held against the reference simulator's;
* byte identity on the non-sharded configurations of
  ``tests/test_equivalence.py``: the port's record stream and assignment trace
  equal the reference ``Simulator``'s and the legacy engine's;
* the stepped-clock and record-window cases of ``tests/test_stream.py`` that
  build no ``ShardedSimulator`` (the sharded driver is not ported yet);
* the ``workloads`` scenarios, bit for bit the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from legacy import SimConfig as LegacySimConfig
from legacy import Simulator as LegacySimulator
from legacy import make_scheduler as legacy_make_scheduler
from repro.core import SimConfig as RefSimConfig
from repro.core import Simulator as RefSimulator
from repro.core import make_scheduler as ref_make_scheduler
from repro.core import metrics as ref_metrics
from repro.core import records as ref_records
from repro.core import trace as ref_trace
from repro.core import workloads as ref_workloads
from repro_torch.core import (
    BurstDetector,
    RecordAccumulator,
    RecordColumns,
    SimConfig,
    Simulator,
    available_scenarios,
    default_n_events,
    make_functions,
    make_scenario,
    make_scheduler,
    make_vu_programs,
    summarize,
    summarize_windows,
)
from repro_torch.core import sched, simulator
from repro_torch.core.trace import azure_like_weights, bursty_interarrivals

PAPER_SCHEDULERS = ["hiku", "ch_bl", "least_connections", "random"]
PORT = (make_scheduler, Simulator, SimConfig)
REF = (ref_make_scheduler, RefSimulator, RefSimConfig)
LEGACY = (legacy_make_scheduler, LegacySimulator, LegacySimConfig)


def _rows(recs):
    return [(r.t_submit, r.t_complete, r.func, r.worker, r.cold, r.vu) for r in recs]


def _col_rows(cols):
    return list(zip(cols.t_submit.tolist(), cols.t_done.tolist(), cols.func.tolist(),
                    cols.worker.tolist(), cols.cold.tolist(), cols.vu.tolist()))


def _run(name, seed=7, vus=30, dur=40.0, cfg=None, stack=PORT):
    mk, Sim, Cfg = stack
    sim = Sim(mk(name, 5, seed=seed), cfg=cfg or Cfg(), seed=seed)
    return sim, sim.run(n_vus=vus, duration_s=dur)


def _metrics_equal(a, b):
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


# ------------------------------------------------- tests/test_simulator.py
def test_burst_detector_is_the_ports_own():
    assert simulator.BurstDetector is sched.BurstDetector is BurstDetector


def test_simulator_deterministic():
    _, r1 = _run("hiku", seed=3)
    _, r2 = _run("hiku", seed=3)
    assert len(r1) == len(r2)
    assert all(a.t_complete == b.t_complete and a.worker == b.worker for a, b in zip(r1, r2))
    _, want = _run("hiku", seed=3, stack=REF)
    assert _rows(r1) == _rows(want)


def test_identical_workload_across_schedulers():
    _, r1 = _run("hiku", seed=11)
    _, r2 = _run("random", seed=11)
    f1 = {r.vu: r.func for r in sorted(r1, key=lambda r: r.t_submit)[:30]}
    f2 = {r.vu: r.func for r in sorted(r2, key=lambda r: r.t_submit)[:30]}
    shared = set(f1) & set(f2)
    assert shared and all(f1[v] == f2[v] for v in shared)


def test_processor_sharing_slows_under_load():
    _, light = _run("hiku", vus=1, dur=30.0, cfg=SimConfig(n_workers=1, cores_per_worker=1.0))
    _, heavy = _run("hiku", vus=10, dur=30.0, cfg=SimConfig(n_workers=1, cores_per_worker=1.0))
    assert np.mean([r.latency_ms for r in heavy]) > 1.5 * np.mean([r.latency_ms for r in light])
    _, want = _run("hiku", vus=10, dur=30.0, cfg=RefSimConfig(n_workers=1, cores_per_worker=1.0),
                   stack=REF)
    assert _rows(heavy) == _rows(want)


def test_cold_start_penalty_visible():
    _, recs = _run("hiku", seed=5)
    by_func = {}
    for r in recs:
        by_func.setdefault(r.func, {"cold": [], "warm": []})[
            "cold" if r.cold else "warm"].append(r.latency_ms)
    ratios = [np.mean(v["cold"]) / np.mean(v["warm"])
              for v in by_func.values() if len(v["cold"]) >= 3 and len(v["warm"]) >= 3]
    assert ratios and np.mean(ratios) > 1.15


@pytest.fixture(scope="module")
def paper_protocol():
    """The §V protocol at the seed the orderings are checked at: 5 workers,
    40 functions, 50 closed-loop VUs, 60 simulated seconds, on both
    simulators."""
    out = {}
    for name in PAPER_SCHEDULERS:
        for tag, stack in (("port", PORT), ("ref", REF)):
            sim, recs = _run(name, seed=42, vus=50, dur=60.0, stack=stack)
            summ = summarize if tag == "port" else ref_metrics.summarize
            out[tag, name] = (_rows(recs), summ(recs, sim.assignments, list(range(5)), 60.0))
    return out


def test_paper_ordering_cold_starts_and_latency(paper_protocol):
    res = {name: paper_protocol["port", name][1] for name in PAPER_SCHEDULERS}
    assert res["hiku"].cold_rate < res["least_connections"].cold_rate
    assert res["hiku"].cold_rate < res["random"].cold_rate
    assert res["hiku"].mean_latency_ms < res["random"].mean_latency_ms
    assert res["hiku"].mean_latency_ms < res["ch_bl"].mean_latency_ms
    assert res["hiku"].n_requests > res["random"].n_requests


@pytest.mark.parametrize("name", PAPER_SCHEDULERS)
def test_paper_protocol_equals_the_reference(paper_protocol, name):
    rows, m = paper_protocol["port", name]
    want_rows, want = paper_protocol["ref", name]
    assert rows == want_rows
    _metrics_equal(m, want)


def test_run_iter_matches_run_and_counts_events_on_early_stop():
    _, want = _run("hiku", seed=3, vus=15, dur=20.0)
    sim = Simulator(make_scheduler("hiku", 5, seed=3), seed=3)
    for _ in sim.run_iter(n_vus=15, duration_s=20.0, yield_every=64):
        pass
    assert sim.records == want
    full_events = sim.n_events
    ref = RefSimulator(ref_make_scheduler("hiku", 5, seed=3), seed=3)
    ref.run(n_vus=15, duration_s=20.0)
    assert full_events == ref.n_events

    sim2 = Simulator(make_scheduler("hiku", 5, seed=3), seed=3)
    for n in sim2.run_iter(n_vus=15, duration_s=20.0, yield_every=64):
        if n >= 128:
            break
    assert 128 <= sim2.n_events < full_events


def test_worker_failure_and_elastic_join():
    sim = Simulator(make_scheduler("hiku", 5, seed=1), seed=1)
    sim.inject_failure(10.0, 2)
    sim.inject_worker(20.0, 7)
    recs = sim.run(n_vus=20, duration_s=40.0)
    assert recs
    workers_late = {r.worker for r in recs if r.t_submit > 25.0}
    assert 2 not in workers_late and 7 in workers_late
    assert len({r.vu for r in recs}) == 20


def test_trace_skew_matches_azure_stats():
    w = np.sort(azure_like_weights(1000, seed=0, population=1000))[::-1]
    assert 0.85 < w[:100].sum() < 0.97


def test_bursty_interarrivals_have_burst_ratio():
    per_min = 1.0 / bursty_interarrivals(20_000, seed=1)
    assert per_min.max() / np.median(per_min) > 5


def test_function_table_composition():
    funcs = make_functions(n_copies=5, seed=0)
    assert len(funcs) == 40
    assert abs(sum(f.weight for f in funcs) - 1.0) < 1e-9
    assert all(f.cold_ms > f.warm_ms for f in funcs)


def _digest_recount(sim):
    counts = {}
    for w in sim.workers.values():
        for func, lst in w.idle.items():
            if lst:
                counts[func] = counts.get(func, 0) + len(lst)
    return counts


def test_warm_digest_matches_brute_force_recount():
    funcs = make_functions(seed=0)
    sim = Simulator(make_scheduler("hiku", 3, seed=4), funcs=funcs,
                    cfg=SimConfig(n_workers=3, mem_pool_mb=600.0), seed=4)
    sim.inject_failure(6.0, 1)
    sim.inject_worker(9.0, 1)
    sim.begin(n_vus=12, duration_s=20.0, programs=make_vu_programs(funcs, 12, 64, 4))
    checked_nonempty = 0
    for i in range(1, 81):
        sim.step_until(i * 0.25)
        digest = sim.warm_digest()
        assert digest == _digest_recount(sim), f"diverged at t={sim.t}"
        assert all(c > 0 for c in digest.values())
        checked_nonempty += bool(digest)
    assert checked_nonempty > 0


def test_warm_digest_reads_are_inert():
    funcs = make_functions(seed=0)
    progs = make_vu_programs(funcs, 10, 48, 2)

    def drive(poll):
        sim = Simulator(make_scheduler("hiku", 4, seed=2), funcs=funcs,
                        cfg=SimConfig(n_workers=4), seed=2)
        sim.begin(n_vus=10, duration_s=15.0, programs=progs)
        for i in range(1, 61):
            sim.step_until(i * 0.25)
            if poll:
                sim.warm_digest()
                sim.warm_capacity()
        return sim.record_columns

    assert drive(poll=True).equals(drive(poll=False))


# ----------------------------------------------- tests/test_equivalence.py
def _equiv_run(stack, name, seed, n_workers, n_vus, dur, cfg_kw, failures, adds):
    mk, Sim, Cfg = stack
    sim = Sim(mk(name, n_workers, seed=seed), cfg=Cfg(n_workers=n_workers, **cfg_kw), seed=seed)
    for t, w in failures:
        sim.inject_failure(t, w)
    for t, w in adds:
        sim.inject_worker(t, w)
    recs = sim.run(n_vus=n_vus, duration_s=dur)
    return _rows(recs), list(sim.assignments)


def _assert_identical(name, seed=7, n_workers=5, n_vus=30, dur=40.0, cfg_kw=None,
                      failures=(), adds=()):
    args = (name, seed, n_workers, n_vus, dur, cfg_kw or {}, failures, adds)
    r_port, a_port = _equiv_run(PORT, *args)
    assert r_port, f"{name}: empty record stream"
    for label, stack in (("reference", REF), ("legacy", LEGACY)):
        r, a = _equiv_run(stack, *args)
        assert len(r) == len(r_port), f"{name}: {len(r)} {label} records vs {len(r_port)}"
        for i, (x, y) in enumerate(zip(r, r_port)):
            assert x == y, f"{name}: record {i} diverged from the {label} engine: {x} vs {y}"
        assert a == a_port, f"{name}: assignment trace diverged from the {label} engine"


@pytest.mark.parametrize("name", PAPER_SCHEDULERS)
def test_paper_schedulers_byte_identical(name):
    _assert_identical(name)


@pytest.mark.parametrize("name", PAPER_SCHEDULERS)
def test_byte_identical_under_memory_pressure(name):
    _assert_identical(name, seed=11, n_vus=40, dur=30.0, cfg_kw=dict(mem_pool_mb=1024.0))


@pytest.mark.parametrize("name", ["hiku", "least_connections"])
def test_byte_identical_through_failure_and_scaleup(name):
    _assert_identical(name, seed=1, n_vus=20, dur=40.0, failures=[(10.0, 2)], adds=[(20.0, 7)])


def test_byte_identical_service_times_are_request_identity_seeded():
    from repro_torch.core.trace import service_fluctuations

    sigma = 0.25
    got = service_fluctuations(123, 5, 40, sigma)
    assert got.tobytes() == ref_trace.service_fluctuations(123, 5, 40, sigma).tobytes()
    for vu in range(5):
        for ev in range(40):
            want = np.random.default_rng((123, vu, ev)).lognormal(mean=-0.5 * sigma**2, sigma=sigma)
            assert got[vu, ev] == want, (vu, ev)


@pytest.mark.slow
def test_byte_identical_at_scale():
    """100 workers / 500 VUs: the configuration class the engine targets."""
    _assert_identical("hiku", seed=0, n_workers=100, n_vus=500, dur=10.0)


def test_byte_identical_with_warm_digest_polling():
    name, seed, n_workers, n_vus, dur = "hiku", 11, 5, 40, 30.0
    lsim = LegacySimulator(legacy_make_scheduler(name, n_workers, seed=seed),
                           cfg=LegacySimConfig(n_workers=n_workers, mem_pool_mb=1024.0), seed=seed)
    want = _rows(lsim.run(n_vus=n_vus, duration_s=dur))
    sim = Simulator(make_scheduler(name, n_workers, seed=seed),
                    cfg=SimConfig(n_workers=n_workers, mem_pool_mb=1024.0), seed=seed)
    sim.begin(n_vus=n_vus, duration_s=dur)
    polled_nonempty = 0
    for i in range(1, int(dur * 2) + 1):
        sim.step_until(i * 0.5)
        polled_nonempty += bool(sim.warm_digest())
        sim.warm_capacity()
    sim.step_until(float("inf"))
    assert sim.done and polled_nonempty > 0
    assert _col_rows(sim.record_columns) == want
    assert list(sim.assignments) == list(lsim.assignments)


# ---------------------------------------------------- tests/test_stream.py
def test_step_until_reproduces_run_byte_for_byte():
    s1 = Simulator(make_scheduler("hiku", 5, seed=3), cfg=SimConfig(), seed=3)
    s1.run(n_vus=20, duration_s=20.0)
    s2 = Simulator(make_scheduler("hiku", 5, seed=3), cfg=SimConfig(), seed=3)
    s2.begin(n_vus=20, duration_s=20.0)
    t, i = 0.0, 0
    while not s2.done:
        t += 0.3 + (i % 7) * 0.5
        i += 1
        s2.step_until(t)
    assert s2.record_columns.equals(s1.record_columns)
    assert s1.n_events == s2.n_events
    a1, a2 = s1.assignment_columns, s2.assignment_columns
    assert np.array_equal(a1[0], a2[0]) and np.array_equal(a1[1], a2[1])


def _cols(cls):
    return cls(t_submit=[0.0, 0.5, 1.0, 1.5], t_done=[1.0, 1.0, 2.0, 3.0], func=[0, 1, 2, 3],
               worker=[0, 1, 0, 1], cold=[True, False, True, False], vu=[0, 1, 2, 3])


def test_record_columns_window_views():
    cols = _cols(RecordColumns)
    assert cols.window(-np.inf, 1.0).func.tolist() == [0, 1]
    assert cols.window(1.0, 2.0).func.tolist() == [2]
    assert cols.window(2.0, 10.0).func.tolist() == [3]
    assert len(cols.window(5.0, 9.0)) == 0
    ref = _cols(ref_records.RecordColumns)
    for lo, hi in ((-np.inf, 1.0), (1.0, 2.0), (2.0, 10.0), (5.0, 9.0), (0.5, 3.0)):
        assert cols.window(lo, hi).as_structured().tobytes() == \
            ref.window(lo, hi).as_structured().tobytes()


def test_accumulator_extend_is_exact():
    cols = RecordColumns(t_submit=[0.1, 0.2], t_done=[0.3, 0.4], func=[1, 2],
                         worker=[0, 1], cold=[True, False], vu=[5, 6])
    acc = RecordAccumulator()
    acc.extend(cols[:1])
    acc.extend(cols[1:])
    assert acc.columns().equals(cols)


def test_window_boundary_tie_lands_in_exactly_one_window():
    """A completion or an assignment at exactly ``t == t_hi`` belongs to that
    window and never reappears in the next (windows are ``(t_lo, t_hi]``),
    through ``RecordColumns.window`` and ``summarize_windows``, as the
    reference's."""
    cols = RecordColumns(t_submit=[1.0, 2.0], t_done=[1.5, 3.0], func=[0, 1], worker=[0, 1],
                         cold=[False, True], vu=[0, 1])
    asg = (np.array([1.5, 3.0]), np.array([0, 1], np.int64))
    assert cols.window(-np.inf, 1.5).t_done.tolist() == [1.5]
    assert cols.window(1.5, 3.0).t_done.tolist() == [3.0]
    got = summarize_windows(cols, asg, [0, 1], 1.5, 3.0)
    assert [t for t, _ in got] == [1.5, 3.0]
    assert [m.n_requests for _, m in got] == [1, 1]
    ref_cols = ref_records.RecordColumns(*(getattr(cols, f) for f in ref_records._FIELDS))
    want = ref_metrics.summarize_windows(ref_cols, asg, [0, 1], 1.5, 3.0)
    assert [(t, dataclasses.astuple(m)) for t, m in got] == \
        [(t, dataclasses.astuple(m)) for t, m in want]


# ----------------------------------------------------------- workloads
FUNCS = make_functions(seed=0)
REF_FUNCS = ref_trace.make_functions(seed=0)


def test_scenario_registry_and_unknown_name():
    assert available_scenarios() == ["diurnal", "flash_crowd", "heavy_tail", "on_off"]
    assert available_scenarios() == ref_workloads.available_scenarios()
    with pytest.raises(ValueError, match="available"):
        make_scenario("tsunami", FUNCS, 8, 10.0)


def _same_scenario(a, b):
    assert a.name == b.name and a.axes == b.axes and a.n_vus == b.n_vus
    assert a.arrivals.dtype == b.arrivals.dtype and a.arrivals.tobytes() == b.arrivals.tobytes()
    if b.deadlines is None:
        assert a.deadlines is None
    else:
        assert a.deadlines.tobytes() == b.deadlines.tobytes()
    for pa, pb in zip(a.programs, b.programs, strict=True):
        assert pa.func_idx.tobytes() == pb.func_idx.tobytes()
        assert pa.sleep_s.tobytes() == pb.sleep_s.tobytes()


@pytest.mark.parametrize("name", sorted(available_scenarios()))
def test_scenarios_equal_the_reference(name):
    for seed in (1, 5, 6):
        _same_scenario(make_scenario(name, FUNCS, 16, 12.0, seed=seed),
                       ref_workloads.make_scenario(name, REF_FUNCS, 16, 12.0, seed=seed))
    a = make_scenario(name, FUNCS, 16, 12.0, seed=5)
    c = make_scenario(name, FUNCS, 16, 12.0, seed=6)
    assert not np.array_equal(a.arrivals, c.arrivals)
    assert set(a.run_kwargs()) == {"programs", "arrivals", "deadlines"}


@pytest.mark.parametrize("name", sorted(available_scenarios()))
def test_scenarios_shape_and_admissibility(name):
    dur = 12.0
    scn = make_scenario(name, FUNCS, 16, dur, seed=1)
    assert scn.n_vus == 16 and scn.arrivals.shape == (16,)
    assert (scn.arrivals >= 0).all() and scn.arrivals.max() < 0.9 * dur
    n_ev = default_n_events(dur)
    for p in scn.programs:
        assert p.func_idx.shape == (n_ev,)
        assert (p.func_idx >= 0).all() and (p.func_idx < len(FUNCS)).all()
        assert (p.sleep_s >= 0).all()


@pytest.mark.parametrize("name", ["flash_crowd", "heavy_tail"])
def test_scenario_programs_drive_both_simulators_alike(name):
    """A scenario's programs through the port's simulator give the reference
    simulator's record stream on the same programs."""
    scn = make_scenario(name, FUNCS, 24, 10.0, seed=3)
    rscn = ref_workloads.make_scenario(name, REF_FUNCS, 24, 10.0, seed=3)
    out = []
    for (mk, Sim, Cfg), funcs, s in ((PORT, FUNCS, scn), (REF, REF_FUNCS, rscn)):
        sim = Sim(mk("hiku", 4, seed=3), funcs=funcs, cfg=Cfg(n_workers=4), seed=3)
        sim.begin(n_vus=s.n_vus, duration_s=10.0, programs=s.programs)
        sim.step_until(float("inf"))
        out.append((_col_rows(sim.record_columns), list(sim.assignments)))
    assert out[0][0] and out[0] == out[1]
