"""The cases of ``tests/test_scale.py`` on the port's simulator and Hiku at
100 workers / 500 VUs, with two failures and a join, and the port's record
stream and assignment trace byte for byte the reference simulator's."""

import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro.core import SimConfig as RefSimConfig
from repro.core import Simulator as RefSimulator
from repro.core import make_scheduler as ref_make_scheduler
from repro_torch.core import SimConfig, Simulator, make_scheduler


def _scale(mk, Sim, Cfg):
    sched = mk("hiku", 100, seed=0)
    sim = Sim(sched, cfg=Cfg(n_workers=100), seed=0)
    sim.inject_failure(4.0, 17)
    sim.inject_failure(4.0, 18)
    sim.inject_worker(7.0, 120)
    recs = sim.run(n_vus=500, duration_s=12.0)
    return sched, sim, recs


@pytest.fixture(scope="module")
def scale_run():
    return _scale(make_scheduler, Simulator, SimConfig)


def test_scale_record_stream_equals_the_reference(scale_run):
    _, sim, _ = scale_run
    rsched, rsim, _ = _scale(ref_make_scheduler, RefSimulator, RefSimConfig)
    got, want = sim.record_columns, rsim.record_columns
    assert got.as_structured().tobytes() == want.as_structured().tobytes()
    for a, b in zip(sim.assignment_columns, rsim.assignment_columns):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    sched = scale_run[0]
    assert sched.conns == rsched.conns and sched.idle_counts == rsched.idle_counts
    assert (sched.pull_hits, sched.fallback_assigns) == (rsched.pull_hits, rsched.fallback_assigns)


def test_scale_run_completes_requests(scale_run):
    sched, sim, recs = scale_run
    assert len(recs) > 5000
    assert {r.vu for r in recs} == set(range(500))
    assert sched.pull_hits > 0 and sched.fallback_assigns > 0


def test_scale_no_negative_connections(scale_run):
    sched, _, _ = scale_run
    assert all(c >= 0 for c in sched.conns.values())
    assert sched.total_conns == sum(sched.conns[w] for w in sched.workers)


def test_scale_queue_depth_consistent_after_worker_removal(scale_run):
    sched, sim, recs = scale_run
    for dead in (17, 18):
        assert dead not in sched.workers
        assert all(dead not in counts for counts in sched.idle_counts.values())
        assert dead not in sched._worker_funcs or not sched._worker_funcs[dead]
        assert not any(r.worker == dead for r in recs if r.t_submit > 4.5)
    assert any(r.worker == 120 for r in recs)
    for func, counts in sched.idle_counts.items():
        assert all(n > 0 for n in counts.values())
        assert sched.queue_depth(func) == sum(counts.values())
    assert sched.queue_depth() == sum(sum(c.values()) for c in sched.idle_counts.values())


def test_scale_worker_accounting(scale_run):
    _, sim, _ = scale_run
    for w in sim.workers.values():
        assert w.busy_mem_mb >= -1e-9 and w.idle_mem_mb >= -1e-9
        assert w.mem_usage() <= w.pool_mb + 1e-9
        for lst in w.idle.values():
            assert all(a.last_used <= b.last_used for a, b in zip(lst, lst[1:]))
        assert w.idle_mem_mb == pytest.approx(sum(i.mem_mb for lst in w.idle.values() for i in lst))


def test_scale_queue_entries_reference_live_workers(scale_run):
    sched, _, _ = scale_run
    live = set(sched.workers)
    for counts in sched.idle_counts.values():
        assert set(counts) <= live
