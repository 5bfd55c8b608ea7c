"""The port's chaos tier (``repro_torch.core.chaos``) and the salvage and retry
paths it exercises: the cases of ``tests/test_chaos.py`` on the port's
modules (the salvage acceptance cells use the quick protocol and fault plans
of the reference's chaos benchmark, copied here as constants), and parity
with the JAX package — each fault-plan generator compiles the reference's
events, and one plan of each generator, under every registered policy for the
shard kill and its baselines, through both packages' ``AdmissionSimulator``
gives equal records, salvages, migrations and failure telemetry.
"""

import dataclasses

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core import SimConfig, Simulator, make_scheduler
from repro_torch.core.admission import AdmissionConfig, AdmissionSimulator
from repro_torch.core.chaos import (
    FaultEvent,
    FaultPlan,
    flappy_workers,
    rolling_restart,
    shard_kill_wave,
    spot_preemption,
)
from repro_torch.core.policies import available_policies
from repro_torch.core.trace import make_functions, make_vu_programs, service_fluctuations
from repro_torch.core.workloads import make_scenario
import warnings

from test_torch_cluster_cases import REF, PORT, canon, same

pytestmark = pytest.mark.shard


# ------------------------------------------------------------ plan layer
def test_fault_event_validation():
    with pytest.raises(ValueError, match="unknown FaultEvent kind"):
        FaultEvent(t=1.0, kind="explode", worker=0)
    with pytest.raises(ValueError, match="t must be >= 0"):
        FaultEvent(t=-1.0, kind="fail", worker=0)
    with pytest.raises(ValueError, match="worker must be >= 0"):
        FaultEvent(t=1.0, kind="fail", worker=-2)
    with pytest.raises(ValueError, match="until >= t"):
        FaultEvent(t=5.0, kind="notice", worker=0)  # no until
    with pytest.raises(ValueError, match="until >= t"):
        FaultEvent(t=5.0, kind="notice", worker=0, until=4.0)


def test_fault_plan_sorts_composes_and_reports_horizon():
    a = FaultEvent(t=2.0, kind="add", worker=1)
    b = FaultEvent(t=2.0, kind="fail", worker=1)
    c = FaultEvent(t=1.0, kind="notice", worker=0, until=9.0)
    p1 = FaultPlan("x", [a, b, c])
    p2 = FaultPlan("x", [c, a, b])
    assert p1 == p2  # construction order is irrelevant
    # at equal t: notice < fail < add (revival after the kill it undoes)
    assert [e.kind for e in p1.events] == ["notice", "fail", "add"]
    assert len(p1) == 3
    assert p1.horizon == 9.0  # a notice's until counts toward the horizon
    both = p1 + FaultPlan("y", [FaultEvent(t=20.0, kind="fail", worker=3)])
    assert both.name == "x+y" and len(both) == 4 and both.horizon == 20.0


def test_generators_are_pure_functions_of_their_arguments():
    kw = dict(n_shards=4, n_workers=32, shards=[0, 2], t_kill=5.0,
              stagger_s=1.0, jitter_s=0.5, seed=3)
    assert shard_kill_wave(**kw) == shard_kill_wave(**kw)
    assert shard_kill_wave(**kw) != shard_kill_wave(**{**kw, "seed": 4})
    sp = dict(n_workers=16, n_waves=2, wave_size=3, t0=2.0, t1=8.0, seed=1)
    assert spot_preemption(**sp) == spot_preemption(**sp)
    fl = dict(workers=[0, 5], duration_s=30.0, mtbf_s=5.0, mttr_s=1.0, seed=2)
    assert flappy_workers(**fl) == flappy_workers(**fl)


def test_shard_kill_wave_covers_exactly_the_listed_shards():
    plan = shard_kill_wave(4, 32, shards=[1], t_kill=3.0)
    # even split of 32 over 4: shard 1 owns global workers 8..15
    assert sorted(e.worker for e in plan.events) == list(range(8, 16))
    assert all(e.kind == "fail" and e.t == 3.0 for e in plan.events)
    with pytest.raises(ValueError, match="out of range"):
        shard_kill_wave(4, 32, shards=[4], t_kill=3.0)


def test_spot_preemption_emits_notice_kill_replace_triplets():
    plan = spot_preemption(8, n_waves=1, wave_size=2, t0=4.0, t1=4.0,
                           notice_s=2.0, replace_after_s=3.0, seed=0)
    kinds = sorted((e.kind, e.t) for e in plan.events)
    assert [k for k, _ in kinds] == ["add", "add", "fail", "fail",
                                     "notice", "notice"]
    for e in plan.events:
        if e.kind == "notice":
            assert e.t == 2.0 and e.until == 4.0
        elif e.kind == "fail":
            assert e.t == 4.0
        else:
            assert e.t == 7.0


def test_rolling_restart_is_deterministic_batched():
    plan = rolling_restart(8, t0=1.0, downtime_s=2.0, stagger_s=3.0, batch=2)
    fails = {e.worker: e.t for e in plan.events if e.kind == "fail"}
    adds = {e.worker: e.t for e in plan.events if e.kind == "add"}
    assert fails[0] == fails[1] == 1.0 and fails[6] == fails[7] == 10.0
    assert all(adds[w] == fails[w] + 2.0 for w in range(8))


def test_flappy_workers_alternate_and_truncate():
    plan = flappy_workers([3], duration_s=60.0, mtbf_s=4.0, mttr_s=1.0, seed=0)
    assert len(plan) > 2
    kinds = [e.kind for e in plan.events]
    assert kinds == ["fail", "add"] * (len(kinds) // 2) + (
        ["fail"] if len(kinds) % 2 else []
    )
    assert plan.horizon < 60.0


# --------------------------------------------- config + inject validation
def test_retry_config_validation():
    with pytest.raises(ValueError, match="retry_delay_s"):
        SimConfig(retry_delay_s=0.0)
    with pytest.raises(ValueError, match="retry_backoff"):
        SimConfig(retry_backoff=0.5)
    with pytest.raises(ValueError, match="retry_max_delay_s"):
        SimConfig(retry_max_delay_s=0.01)  # below retry_delay_s
    with pytest.raises(ValueError, match="retry_budget"):
        SimConfig(retry_budget=0)


def _sim(n_workers=4, seed=0):
    return Simulator(
        make_scheduler("hiku", n_workers, seed=seed),
        cfg=SimConfig(n_workers=n_workers), seed=seed,
    )


def test_inject_hooks_reject_bad_ids_and_times():
    sim = _sim()
    with pytest.raises(ValueError, match="worker id must be >= 0"):
        sim.inject_failure(1.0, -1)
    with pytest.raises(ValueError, match="t must be >= 0"):
        sim.inject_failure(-0.5, 0)
    with pytest.raises(ValueError, match="worker id must be >= 0"):
        sim.inject_worker(1.0, -3)
    # failing a worker that never exists surfaces at begin(), loudly
    sim.inject_failure(1.0, 7)
    with pytest.raises(ValueError, match="neither in the initial range"):
        sim.begin(n_vus=0, duration_s=10.0, programs=[])
    # schedules beyond the run deadline are rejected, not silently dropped
    sim2 = _sim()
    sim2.inject_failure(50.0, 1)
    with pytest.raises(ValueError, match="deadline"):
        sim2.begin(n_vus=0, duration_s=10.0, programs=[])
    sim3 = _sim()
    sim3.inject_worker(50.0, 9)
    with pytest.raises(ValueError, match="deadline"):
        sim3.begin(n_vus=0, duration_s=10.0, programs=[])


def test_admission_tier_rejects_out_of_partition_ids():
    adm = AdmissionSimulator(2, 8, scheduler="hiku", seed=0)
    with pytest.raises(ValueError, match="out of range"):
        adm.inject_failure(1.0, 8)
    with pytest.raises(ValueError, match="out of range"):
        adm.inject_worker(1.0, -1)
    with pytest.raises(ValueError, match="out of range"):
        adm.inject_notice(1.0, 99, until=2.0)
    with pytest.raises(ValueError, match="precedes"):
        adm.inject_notice(3.0, 0, until=2.0)


def test_backoff_formula_capped_and_legacy_compatible():
    cfg = SimConfig(retry_delay_s=0.05, retry_backoff=2.0, retry_max_delay_s=0.3)
    sim = Simulator(make_scheduler("hiku", 2, seed=0), cfg=cfg, seed=0)
    # attempt 1 is exactly the flat legacy delay (byte-identity anchor)
    assert sim._retry_delay(1) == cfg.retry_delay_s
    assert sim._retry_delay(2) == 0.1
    assert sim._retry_delay(3) == 0.2
    assert sim._retry_delay(4) == 0.3  # capped
    assert sim._retry_delay(9) == 0.3


# ------------------------------------------------------- engine salvage
def _dead_pressured_sim(seed=5, n_vus=8):
    """A 2-worker sim whose workers both die mid-run, leaving queued work."""
    funcs = make_functions(seed=0)
    progs = make_vu_programs(funcs, n_vus, 64, seed)
    sim = Simulator(
        make_scheduler("hiku", 2, seed=seed), funcs=funcs,
        cfg=SimConfig(n_workers=2, mem_pool_mb=400.0), seed=seed,
    )
    sim.inject_failure(2.0, 0)
    sim.inject_failure(2.5, 1)
    sim.begin(n_vus=n_vus, duration_s=30.0, programs=progs)
    sim.step_until(4.0)
    assert not sim.workers and sim.pressure() == float("inf")
    return sim, funcs


def test_salvage_drains_dead_shard_to_zero_outstanding():
    sim, _ = _dead_pressured_sim()
    out = sim.salvage_queued()
    assert len(out) > 0 and any(sv.in_flight for sv in out)
    assert sim.salvaged_out == len(out)
    assert sim.outstanding() == 0  # nothing stranded after the drain
    assert sim.salvage_queued() == []  # exactly-once: a second drain is empty


def test_salvage_requires_a_dead_shard():
    funcs = make_functions(seed=0)
    sim = Simulator(make_scheduler("hiku", 2, seed=1), funcs=funcs,
                    cfg=SimConfig(n_workers=2), seed=1)
    sim.begin(n_vus=2, duration_s=10.0,
              programs=make_vu_programs(funcs, 2, 16, 1))
    with pytest.raises(ValueError, match="dead shard"):
        sim.salvage_queued()


def test_salvaged_identity_bit_exact_on_destination():
    """The §10 invariant: a salvaged VU's service draws replay the ORIGIN
    (seed, vu) identity bit-exactly on its new home — same contract as
    stealing, across the salvage path."""
    sim, funcs = _dead_pressured_sim()
    dst = Simulator(make_scheduler("hiku", 2, seed=99), funcs=funcs,
                    cfg=SimConfig(n_workers=2), seed=99)
    dst.begin(n_vus=0, duration_s=40.0, programs=[])
    dst.step_until(4.0)
    salvaged = sim.salvage_queued()
    locals_ = [dst.receive_salvaged(sv, t=4.0) for sv in salvaged]
    assert dst.salvaged_in == len(salvaged)
    while not dst.done:
        dst.step_until(dst.t + 5.0)
    sigma = SimConfig().exec_sigma
    for sv, local in zip(salvaged, locals_):
        row = dst._fluct["rows"][local]
        assert len(row) > 0
        want = service_fluctuations(
            sv.stolen.origin_seed, 1, len(row), sigma,
            vu_start=sv.stolen.origin_vu,
        )[0]
        assert np.array_equal(np.asarray(row), want)
    # every in-flight salvage completed exactly once, flagged migrated,
    # with recovery latency charged from its first failure
    n_inflight = sum(1 for sv in salvaged if sv.in_flight)
    assert int(dst.record_columns.migrated.sum()) == n_inflight
    assert len(dst.recovery_s) >= n_inflight
    assert all(r > 0 for r in dst.recovery_s)


def test_retry_budget_exhaustion_counts_lost_tasks():
    funcs = make_functions(seed=0)
    progs = make_vu_programs(funcs, 4, 32, 3)
    cfg = SimConfig(n_workers=2, retry_budget=2, retry_delay_s=0.05)
    sim = Simulator(make_scheduler("hiku", 2, seed=3), funcs=funcs, cfg=cfg, seed=3)
    sim.inject_failure(1.0, 0)
    sim.inject_failure(1.0, 1)
    sim.run(n_vus=4, duration_s=12.0, programs=progs)
    assert sim.lost_tasks > 0  # budget ran out with no capacity left
    assert sim.resubmits > 0
    assert sim.outstanding() == 0  # lost, not stranded: the queue drained


# ------------------------------------- admission tier: salvage acceptance
QUICK = dict(n_shards=2, n_workers=8, n_vus=32, duration_s=14.0,
             mem_pool_mb=1024.0)


@pytest.fixture(scope="module")
def shard_kill_cells():
    return {c: _chaos_cell(c) for c in ("pull", "pull@nosalvage", "pull@legacy")}


def test_salvage_strands_nothing_where_baselines_strand_or_lose(shard_kill_cells):
    """The §10 acceptance: under a correlated shard kill, pull+salvage
    strands zero queued tasks and loses fewer than the no-salvage baseline,
    at comparable surviving-traffic p99; the legacy engine (flat infinite
    retries, no salvage) strands > 0."""
    r_sal, m_sal = shard_kill_cells["pull"]
    r_nos, m_nos = shard_kill_cells["pull@nosalvage"]
    r_leg, _ = shard_kill_cells["pull@legacy"]
    assert r_sal.n_salvages > 0, "the kill must actually trigger salvage"
    assert r_sal.stranded == 0
    assert r_leg.stranded > 0  # pre-PR engine: dead-shard work spins forever
    # salvage converts would-be losses into recoveries
    assert r_nos.lost_tasks > 0 and m_nos.lost_task_rate > 0.0
    assert m_sal.lost_task_rate < m_nos.lost_task_rate
    # ... without blowing up the tail for surviving traffic
    assert m_sal.p99_ms < 1.5 * m_nos.p99_ms
    # failure telemetry is populated on the salvage run
    assert m_sal.resubmit_rate > 0.0
    assert m_sal.recovery_p99_ms >= m_sal.recovery_p50_ms > 0.0


def test_salvage_off_never_salvages(shard_kill_cells):
    r_nos, _ = shard_kill_cells["pull@nosalvage"]
    assert r_nos.n_salvages == 0 and not r_nos.salvages
    assert sum(s.salvaged_out for s in r_nos.shards) == 0


def test_chaos_run_is_deterministic():
    r1, _ = _chaos_cell("pull")
    r2, _ = _chaos_cell("pull")
    assert r1.records.equals(r2.records)
    assert np.array_equal(r1.assign_t, r2.assign_t)
    assert r1.salvages == r2.salvages
    assert r1.stranded == r2.stranded and r1.lost_tasks == r2.lost_tasks


@pytest.mark.parametrize("policy", available_policies())
def test_exactly_once_conservation_per_policy_under_faults(policy):
    """Every registered policy, with a correlated shard-kill plan active:
    salvage bookkeeping balances (drained == re-homed, nothing buffered),
    admission tables agree on every salvaged VU's global id, and no request
    completes twice."""
    run, _ = _chaos_cell(policy)
    assert run.n_salvages > 0  # the kill bites under every policy
    assert sum(s.salvaged_out for s in run.shards) == run.n_salvages
    assert sum(s.salvaged_in for s in run.shards) == run.n_salvages
    assert run.unsalvaged == 0 and run.stranded == 0
    for mv in run.salvages:
        src_tab = run.shards[mv.src].admitted
        dst_tab = run.shards[mv.dst].admitted
        assert src_tab[mv.src_vu] == dst_tab[mv.dst_vu]  # same global VU
        assert not run.shards[mv.src].alive  # only dead shards drain
    # exactly-once: one migrated completion per in-flight recovery (plus
    # steal migrations when the policy steals)
    n_inflight = sum(1 for mv in run.salvages if mv.in_flight)
    assert int(run.records.migrated.sum()) == n_inflight + run.n_migrations
    # no duplicated completion: a VU's submissions are unique in time
    order = np.lexsort((run.records.t_submit, run.records.vu))
    vu, ts = run.records.vu[order], run.records.t_submit[order]
    assert not ((np.diff(vu) == 0) & (np.diff(ts) == 0)).any()


# ----------------------------------------------------- revival regression
def test_dead_shard_revival_restores_admission_candidate():
    """Regression: ``inject_worker`` reviving a fully-dead shard brings it
    back as an admission candidate — late arrivals bind to it again and it
    finishes the run alive."""
    adm = AdmissionSimulator(
        2, 4, scheduler="hiku", seed=0,
        admission=AdmissionConfig(tick_s=0.25),
    )
    n_vus = 12
    funcs = adm.funcs
    progs = make_vu_programs(funcs, n_vus, 32, 0)
    arrivals = [0.0] * 6 + [8.0] * 6  # second half lands after the revival
    # shard 0 (workers 0,1) dies at t=3 and worker 0 rejoins at t=6
    plan = FaultPlan("kill+revive", [
        FaultEvent(t=3.0, kind="fail", worker=0),
        FaultEvent(t=3.0, kind="fail", worker=1),
        FaultEvent(t=6.0, kind="add", worker=0),
    ])
    run = adm.run(n_vus, 20.0, programs=progs, arrivals=arrivals, faults=plan)
    s0 = run.shards[0]
    assert s0.alive  # revived, not dead, at run end
    late = [t for t in s0.admit_t.tolist() if t >= 8.0]
    assert late, "revived shard never pulled a post-revival arrival"
    assert run.stranded == 0


def test_cluster_dark_buffers_then_revival_rehomes_exactly_once():
    """Whole-cluster outage: salvage exports buffer while no live shard
    exists, then re-home on the first revival — never lost, never doubled."""
    adm = AdmissionSimulator(
        2, 4, scheduler="hiku", seed=1,
        admission=AdmissionConfig(tick_s=0.25),
    )
    n_vus = 8
    progs = make_vu_programs(adm.funcs, n_vus, 32, 1)
    events = [FaultEvent(t=4.0, kind="fail", worker=w) for w in range(4)]
    events.append(FaultEvent(t=7.0, kind="add", worker=2))  # shard 1 revives
    run = adm.run(n_vus, 25.0, programs=progs,
                  faults=FaultPlan("blackout", events))
    assert run.n_salvages > 0
    assert run.unsalvaged == 0  # the buffer drained onto the revived shard
    assert all(mv.dst == 1 for mv in run.salvages)  # only live home
    assert sum(s.salvaged_out for s in run.shards) == run.n_salvages
    assert run.stranded == 0
    # the revived shard finished the recovered work
    assert int(run.records.migrated.sum()) == sum(
        1 for mv in run.salvages if mv.in_flight
    )


# -------------------------------------------- doomed-worker notice signal
def test_notices_surface_as_doomed_workers():
    from repro_torch.core.policies import PullPolicy, register_policy, unregister_policy

    seen = []

    class ProbePolicy(PullPolicy):
        name = "probe_doomed"

        def want_pull(self, state):
            seen.append((state.index, state.doomed_workers))
            return super().want_pull(state)

    register_policy(ProbePolicy)
    try:
        adm = AdmissionSimulator(
            2, 4, scheduler="hiku", seed=0,
            admission=AdmissionConfig(policy="probe_doomed", tick_s=0.25),
        )
        progs = make_vu_programs(adm.funcs, 8, 32, 0)
        plan = FaultPlan("spot", [
            FaultEvent(t=2.0, kind="notice", worker=0, until=5.0),
            FaultEvent(t=5.0, kind="fail", worker=0),
        ])
        adm.run(8, 12.0, programs=progs, faults=plan,
                arrivals=[0.0, 0.0, 0.0, 0.0, 2.5, 2.5, 2.5, 2.5])
        doomed0 = {d for k, d in seen if k == 0}
        assert 1 in doomed0  # shard 0 read its doomed worker in the window
        assert all(d == 0 for k, d in seen if k == 1)
    finally:
        unregister_policy("probe_doomed")


# --------------------------------------------- static-path byte identity
def test_salvage_flag_is_inert_without_faults():
    """AdmissionConfig.salvage must be a pure no-op on fault-free runs —
    the static pull path stays byte-identical with the drain armed."""
    from repro_torch.core.admission import make_skewed_programs

    progs = None
    runs = []
    for salvage in (True, False):
        adm = AdmissionSimulator(
            2, 8, scheduler="hiku", seed=0,
            admission=AdmissionConfig(salvage=salvage),
        )
        if progs is None:
            progs = make_skewed_programs(adm.funcs, 16, 64, 0)
        runs.append(adm.run(16, 10.0, programs=progs))
    a, b = runs
    assert a.records.equals(b.records)
    assert np.array_equal(a.assign_t, b.assign_t)
    assert np.array_equal(a.assign_w, b.assign_w)
    assert a.n_salvages == b.n_salvages == 0
    assert a.stranded == b.stranded and a.lost_tasks == b.lost_tasks == 0


def test_doomed_worker_excluded_from_warm_signals():
    """Pinned regression: a worker inside an open preemption-notice window
    contributes neither headroom (warm_capacity) nor warmth (warm_digest) —
    and contributes both again once the window closes without a kill."""
    funcs = make_functions(seed=0)
    sim = Simulator(make_scheduler("hiku", 1, seed=3), funcs=funcs,
                    cfg=SimConfig(n_workers=1), seed=3)
    sim.inject_notice(8.0, 0, 12.0)
    # long-running programs keep the event clock moving through the window
    sim.begin(n_vus=2, duration_s=30.0,
              programs=make_vu_programs(funcs, 2, 64, 3))
    sim.step_until(7.0)  # pre-window: the sole worker is plain headroom
    assert sim.t < 8.0
    assert sim.warm_capacity() > 0.0 and sim.warm_digest()
    sim.step_until(9.5)  # inside [8, 12): every live worker is doomed
    assert 8.0 <= sim.t < 12.0
    assert sim.warm_capacity() == 0.0
    assert sim.warm_digest() == {}
    sim.step_until(13.0)  # window expired (no kill): signal restored
    assert sim.t >= 12.0
    assert sim.warm_capacity() > 0.0
    restored = sim.warm_digest()
    recount = {}
    for w in sim.workers.values():
        for func, lst in w.idle.items():
            if lst:
                recount[func] = recount.get(func, 0) + len(lst)
    assert restored and restored == recount


def test_doomed_warm_capacity_reaches_admission_snapshots():
    """The admission tier forwards notices to the owning shard engine, so a
    policy's ShardState.warm_capacity drops for the doomed shard's window."""
    from repro_torch.core.policies import CostPolicy, register_policy, unregister_policy

    seen = []

    class WarmProbe(CostPolicy):
        name = "probe_warm"

        def want_pull(self, state):
            seen.append((state.index, state.t, state.warm_capacity))
            return super().want_pull(state)

    register_policy(WarmProbe)
    try:
        adm = AdmissionSimulator(
            2, 2, scheduler="hiku", seed=0,  # 1 worker per shard
            admission=AdmissionConfig(policy="probe_warm", tick_s=0.25),
        )
        progs = make_vu_programs(adm.funcs, 8, 16, 0)
        plan = FaultPlan("spot", [
            FaultEvent(t=2.0, kind="notice", worker=0, until=6.0),
        ])
        adm.run(8, 12.0, programs=progs, faults=plan,
                arrivals=[0.0, 0.0, 2.5, 2.5, 3.0, 3.5, 7.0, 7.5])
        shard0_in = [w for k, t, w in seen if k == 0 and 2.0 <= t < 6.0]
        assert shard0_in and all(w == 0.0 for w in shard0_in)
        # the same shard reads normal headroom outside the window ...
        assert any(w > 0.0 for k, t, w in seen if k == 0 and t >= 6.0)
        # ... and the un-noticed shard never reads a doomed zero
        assert all(w > 0.0 for k, _, w in seen if k == 1)
    finally:
        unregister_policy("probe_warm")


# -------------------------------------------------- dark-cluster drain order
def test_drain_ordering_oldest_outage_first_across_dark_ticks():
    """Pinned regression for drain_tick's buffer ordering: exports carried
    across multiple fully-dark ticks stay ahead of every newer outage's
    exports, and the first live shard receives them in exactly that order."""
    from repro_torch.core.stealing import drain_tick

    simA, _ = _dead_pressured_sim(seed=5)
    simB, _ = _dead_pressured_sim(seed=6)
    inv = [0.5, 0.5]
    # tick 1: only A is down, cluster fully dark — its exports buffer
    moves, left1 = drain_tick([simA], [0.5], t=5.0)
    assert moves == [] and len(left1) > 0
    assert all(src == 0 for src, _ in left1)
    # tick 2: still dark; B's outage is newer — appended AFTER the buffer
    moves, left2 = drain_tick([simA, simB], inv, t=6.0, pending=left1)
    assert moves == []
    assert left2[: len(left1)] == left1  # oldest outage stays first
    assert len(left2) > len(left1)
    assert all(src == 1 for src, _ in left2[len(left1):])
    # exactly-once: the dead shards have nothing left to export
    assert simA.salvage_queued() == [] and simB.salvage_queued() == []
    # tick 3: a live shard appears — placement follows buffer order exactly
    funcs = make_functions(seed=0)
    live = Simulator(make_scheduler("hiku", 4, seed=9), funcs=funcs,
                     cfg=SimConfig(n_workers=4), seed=9)
    live.begin(n_vus=1, duration_s=30.0,
               programs=make_vu_programs(funcs, 1, 8, 9))
    live.step_until(7.0)
    moves, left3 = drain_tick([simA, simB, live], inv + [0.25], t=7.0,
                              pending=left2)
    assert left3 == []
    assert [(mv.src, mv.src_vu, mv.func, mv.ev_idx) for mv in moves] == [
        (src, sv.stolen.src_vu, sv.stolen.func, sv.stolen.ev_idx)
        for src, sv in left2
    ]
    assert all(mv.dst == 2 for mv in moves)


# ------------------------------------ learned state under active faults
def test_learned_completion_feed_exactly_once_under_shard_kill():
    """A learned policy's completion feed, with a correlated shard-kill
    plan active and salvage re-homing VUs mid-run: every merged request
    record is observed by the policy exactly once — salvaged VUs (which
    complete later work on a *new* shard under a fresh local id) are never
    double-counted and never dropped by the per-shard cursors."""
    from collections import Counter

    from repro_torch.core.policies import SjfPolicy, register_policy, unregister_policy

    class ProbeSjf(SjfPolicy):
        name = "probe_sjf"
        seen = []  # every completion handed to fold, across windows

        def __init__(self, cfg, **kw):
            # update_every=1: every tick's drain folds immediately, so
            # `seen` is exactly what the feed delivered over the whole run
            super().__init__(cfg, update_every=1, **kw)

        def fold(self, completions):
            type(self).seen.extend(completions)
            super().fold(completions)

    register_policy(ProbeSjf)
    try:
        run, _ = _chaos_cell("probe_sjf")
        seen = ProbeSjf.seen
        assert run.n_salvages > 0  # the kill bit: VUs really moved shards
        assert len(seen) == len(run.records)
        got = Counter((c.gid, c.func) for c in seen)
        want = Counter(zip(run.records.vu.tolist(), run.records.func.tolist()))
        assert got == want  # same multiset: exactly once, nothing doubled
        assert all(
            c.duration_ms > 0 and np.isfinite(c.duration_ms) for c in seen
        )
        # the salvaged VUs' post-move completions were observed too
        moved = {run.shards[mv.dst].admitted[mv.dst_vu] for mv in run.salvages}
        assert moved & {c.gid for c in seen}
    finally:
        unregister_policy("probe_sjf")
        ProbeSjf.seen.clear()


#: the baseline engine/tier configurations beside the policies (policy pull)
BASELINES = ("pull@nosalvage", "pull@legacy")


def _plan(core, name, p, seed=0):
    """Fault scenario ``name`` for protocol ``p`` (the reference chaos
    benchmark's plans)."""
    n_shards, n_workers, dur = p["n_shards"], p["n_workers"], p["duration_s"]
    if name == "shard_kill":
        return core.shard_kill_wave(n_shards, n_workers, shards=[0], t_kill=0.35 * dur,
                                    jitter_s=0.2, seed=seed)
    if name == "spot":
        return core.spot_preemption(n_workers, n_waves=2, wave_size=max(1, n_workers // 8),
                                    t0=0.25 * dur, t1=0.6 * dur, notice_s=2.0,
                                    replace_after_s=4.0, seed=seed)
    if name == "rolling":
        return core.rolling_restart(n_workers, t0=0.3 * dur, downtime_s=2.0, stagger_s=1.0,
                                    batch=max(1, n_workers // 8))
    if name == "flappy":
        return core.flappy_workers(range(0, n_workers, 4), dur, mtbf_s=8.0, mttr_s=2.0,
                                   t0=1.0, seed=seed)
    raise ValueError(name)


def _cell_on(core, column, fault="shard_kill", seed=0, p=QUICK):
    """One (policy-or-baseline, fault) cell on ``core`` -> (run, metrics)."""
    funcs = core.make_functions(seed=seed)
    scn = core.make_scenario("on_off", funcs, p["n_vus"], p["duration_s"], seed=seed)
    scn = dataclasses.replace(scn, faults=_plan(core, fault, p, seed=seed))
    cfg_kw = dict(mem_pool_mb=p["mem_pool_mb"])
    adm_kw = dict(policy="pull" if column in BASELINES else column, steal_watermark=1.25)
    if column in BASELINES:
        adm_kw["salvage"] = False
    if column == "pull@legacy":
        cfg_kw.update(retry_budget=None, retry_backoff=1.0)
    adm = core.AdmissionSimulator(
        p["n_shards"], p["n_workers"], scheduler="hiku", cfg=core.SimConfig(**cfg_kw),
        seed=seed, admission=core.AdmissionConfig(**adm_kw),
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        r = adm.run(scn.n_vus, p["duration_s"], **scn.run_kwargs())
    return r, r.summarize(p["duration_s"])


def _chaos_cell(column, fault="shard_kill", seed=0):
    return _cell_on(PORT, column, fault, seed)


@pytest.mark.parametrize("policy", ["sjf", "bandit", "bandit+steal"])
def test_learned_policies_deterministic_under_shard_kill(policy):
    """Learned state folding + an active fault plan must still be a pure
    function of the run: two identical chaos runs agree byte-for-byte on
    records AND on the recorded per-window policy snapshots."""
    P = QUICK

    def one():
        funcs = make_functions(seed=0)
        scn = make_scenario("on_off", funcs, P["n_vus"], P["duration_s"], seed=0)
        scn = dataclasses.replace(scn, faults=_plan(PORT, "shard_kill", P, seed=0))
        adm = AdmissionSimulator(
            P["n_shards"], P["n_workers"], scheduler="hiku",
            cfg=SimConfig(mem_pool_mb=P["mem_pool_mb"]), seed=0,
            admission=AdmissionConfig(
                policy=policy, steal_watermark=1.25,
                policy_args={"record_state": True},
            ),
        )
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return adm.run(scn.n_vus, P["duration_s"], **scn.run_kwargs())

    r1 = one()
    r2 = one()
    assert r1.n_salvages > 0
    assert r1.records.equals(r2.records)
    assert r1.policy_state and r1.policy_state == r2.policy_state


# ----------------------------------------------- parity with the JAX package
@pytest.mark.parametrize("fault", ["shard_kill", "spot", "rolling", "flappy"])
def test_fault_plans_compile_to_the_reference_events(fault):
    for seed in (0, 3):
        plan = same(lambda core: _plan(core, fault, QUICK, seed=seed))
        assert len(plan.events) > 0


@pytest.mark.parametrize("fault", ["shard_kill", "spot", "rolling", "flappy"])
def test_each_generator_run_equals_the_reference(fault):
    run, metrics = same(lambda core: _cell_on(core, "pull", fault))
    assert len(run.records) > 0 and metrics.resubmit_rate >= 0.0
    if fault == "shard_kill":
        assert run.n_salvages > 0


@pytest.mark.parametrize("column", sorted(available_policies()) + list(BASELINES))
def test_shard_kill_cell_equals_the_reference(column):
    got = _cell_on(PORT, column)
    want = _cell_on(REF, column)
    assert canon(got) == canon(want)
