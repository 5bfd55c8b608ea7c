"""The port's global pull-based admission tier (``repro_torch.core.admission``):
the cases of ``tests/test_admission.py`` on the port's modules, and parity
with the JAX package — over skewed programs, arrival times, watermarks, tick
widths and batch sizes, each intra-shard scheduler, and a run with a fault
plan, an event bus, an autoscaler and stealing all on at once, the port's
``AdmissionSimulator`` gives the reference's record columns, assignments,
admission tables and telemetry, and the same metrics.
"""

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core import SimConfig, Simulator, default_n_events, make_scheduler
from repro_torch.core.admission import (
    AdmissionConfig,
    AdmissionSimulator,
    load_cv_across_shards,
    make_skewed_programs,
)
from repro_torch.core.shard import ShardedSimulator
import warnings

from test_torch_cluster_cases import same

pytestmark = pytest.mark.shard

K, W, VUS, DUR = 4, 16, 48, 15.0
SEED = 0


@pytest.fixture(scope="module")
def skewed():
    adm = AdmissionSimulator(K, W, scheduler="hiku", seed=SEED)
    programs = make_skewed_programs(adm.funcs, VUS, default_n_events(DUR), SEED)
    return adm, programs


def test_pull_beats_static_partition_on_shard_load_cv(skewed):
    """Acceptance: under a skewed arrival population the admission tier's
    cross-shard load CV is well below the static partition's."""
    adm, programs = skewed
    static = ShardedSimulator(K, W, scheduler="hiku", seed=SEED, backend="serial").run(
        VUS, DUR, programs=programs
    )
    pull = adm.run(VUS, DUR, programs=programs)
    cv_static = load_cv_across_shards([len(r.records) for r in static.shards])
    cv_pull = pull.shard_load_cv
    assert pull.admitted == VUS
    assert cv_pull < 0.5 * cv_static, (cv_pull, cv_static)


def test_admission_run_is_deterministic(skewed):
    adm, programs = skewed
    r1 = adm.run(VUS, DUR, programs=programs)
    r2 = AdmissionSimulator(K, W, scheduler="hiku", seed=SEED).run(
        VUS, DUR, programs=programs
    )
    assert r1.records.equals(r2.records)
    assert np.array_equal(r1.assign_t, r2.assign_t)
    assert np.array_equal(r1.assign_w, r2.assign_w)
    assert [s.admitted.tolist() for s in r1.shards] == [
        s.admitted.tolist() for s in r2.shards
    ]


def test_merge_ids_and_ordering(skewed):
    adm, programs = skewed
    run = adm.run(VUS, DUR, programs=programs)
    g = run.records
    assert len(g) == sum(len(s.records) for s in run.shards)
    # global ids in range; VU ids translated through the admission tables
    assert run.workers == list(range(W))
    assert g.worker.min() >= 0 and g.worker.max() < W
    assert set(g.vu.tolist()) <= set(range(VUS))
    # every admitted VU id is unique across shards (late binding, no dup)
    all_admitted = np.concatenate([s.admitted for s in run.shards])
    assert len(all_admitted) == len(set(all_admitted.tolist())) == VUS
    # merged stream is completion-ordered, assignments time-ordered
    assert (np.diff(g.t_done) >= 0).all()
    assert (np.diff(run.assign_t) >= 0).all()
    # per-shard records use local ids that map back into the global tables
    for s in run.shards:
        if len(s.records):
            assert s.records.vu.max() < len(s.admitted)
            assert s.records.worker.max() < s.n_workers


def test_summarize_matches_direct_metrics(skewed):
    from repro_torch.core import summarize

    adm, programs = skewed
    run = adm.run(VUS, DUR, programs=programs)
    m = run.summarize(DUR)
    assert m == summarize(run.records, (run.assign_t, run.assign_w), run.workers, DUR)
    assert m.n_requests == len(run.records)


def test_watermark_throttles_admission():
    """A tiny watermark keeps most of the queue waiting (backpressure);
    the default admits everyone eventually."""
    adm_tight = AdmissionSimulator(
        2, 4, scheduler="hiku", seed=1,
        admission=AdmissionConfig(watermark=0.26, batch_size=1),
    )
    programs = make_skewed_programs(adm_tight.funcs, 24, 64, 1, hot_frac=1.0)
    with pytest.warns(RuntimeWarning, match="never admitted"):
        r = adm_tight.run(24, 10.0, programs=programs)
    assert r.admitted < 24  # queue never fully drained
    assert r.unadmitted == 24 - r.admitted
    assert int(r.queue_depth.max(initial=0)) > 0


def test_arrival_times_gate_eligibility():
    adm = AdmissionSimulator(2, 8, scheduler="hiku", seed=2)
    programs = make_skewed_programs(adm.funcs, 12, 64, 2)
    arrivals = [0.0] * 6 + [5.0] * 3 + [100.0] * 3  # last 3 after the deadline
    with pytest.warns(RuntimeWarning, match="never admitted"):
        r = adm.run(12, 10.0, programs=programs, arrivals=arrivals)
    assert r.admitted == 9 and r.unadmitted == 3
    admit_times = {
        int(g): float(t)
        for s in r.shards
        for g, t in zip(s.admitted.tolist(), s.admit_t.tolist())
    }
    assert all(admit_times[g] >= 5.0 for g in range(6, 9))
    assert all(admit_times[g] < 5.0 for g in range(6))


def test_arrivals_in_final_partial_tick_window_stay_unadmitted():
    """Pin the tick-quantized deadline semantics: admission only happens at
    tick boundaries strictly below duration_s, so an arrival between the
    last boundary and the deadline is never admitted (documented in
    AdmissionSimulator.run)."""
    adm = AdmissionSimulator(2, 8, scheduler="hiku", seed=2)  # tick_s=0.25
    programs = make_skewed_programs(adm.funcs, 4, 64, 2)
    with pytest.warns(RuntimeWarning, match="never admitted"):
        r = adm.run(4, 10.0, programs=programs, arrivals=[0.0, 0.0, 9.8, 9.9])
    assert r.admitted == 2 and r.unadmitted == 2
    admitted_gids = sorted(g for s in r.shards for g in s.admitted.tolist())
    assert admitted_gids == [0, 1]


def test_round_robin_policy_binds_on_arrival():
    adm = AdmissionSimulator(
        3, 9, scheduler="hiku", seed=3, admission=AdmissionConfig(policy="round_robin")
    )
    programs = make_skewed_programs(adm.funcs, 12, 64, 3)
    r = adm.run(12, 8.0, programs=programs)
    assert r.admitted == 12
    assert int(r.queue_depth.max(initial=0)) == 0  # never queues
    # cyclic binding: shard k gets gids congruent to k mod 3 (all arrive at 0)
    for k, s in enumerate(r.shards):
        assert s.admitted.tolist() == [g for g in range(12) if g % 3 == k]


def test_round_robin_honors_batch_size():
    """batch_size caps round_robin bindings per shard per tick too, so a
    capped burst baseline is actually capped."""
    adm = AdmissionSimulator(
        2, 4, scheduler="hiku", seed=4,
        admission=AdmissionConfig(policy="round_robin", batch_size=1, tick_s=0.5),
    )
    programs = make_skewed_programs(adm.funcs, 8, 32, 4)
    r = adm.run(8, 10.0, programs=programs)
    assert r.admitted == 8
    # tick 0 binds at most batch_size per shard (2 total), leaving 6 queued
    assert int(r.queue_depth[0]) == 6
    # the queue drains by at most 2 per tick thereafter
    assert (np.diff(r.queue_depth[r.queue_depth > 0]) >= -2).all()
    for s in r.shards:
        assert (np.diff(np.unique(s.admit_t)) >= adm.admission.tick_s - 1e-12).all()


def test_constructor_and_run_validation():
    with pytest.raises(ValueError):
        AdmissionSimulator(0, 4)
    with pytest.raises(ValueError):
        AdmissionSimulator(5, 4)
    with pytest.raises(ValueError):
        AdmissionSimulator(2, 4, admission=AdmissionConfig(policy="gossip"))
    with pytest.raises(ValueError):
        AdmissionSimulator(2, 4, admission=AdmissionConfig(tick_s=0.0))
    with pytest.raises(ValueError):
        AdmissionSimulator(2, 4, admission=AdmissionConfig(batch_size=0))
    adm = AdmissionSimulator(2, 4, seed=0)
    progs = make_skewed_programs(adm.funcs, 4, 16, 0)
    with pytest.raises(ValueError):
        adm.run(8, 5.0, programs=progs)  # len(programs) != n_vus
    with pytest.raises(ValueError):
        adm.run(4, 5.0, programs=progs, arrivals=[0.0])  # bad arrivals shape


def test_admitted_vu_fluctuations_keep_identity_seeding():
    """An admitted VU's service draws use the (seed, local_vu, ev) identity —
    the paper's fairness device extends to dynamically admitted VUs."""
    from repro_torch.core import make_functions, make_vu_programs

    funcs = make_functions(seed=0)
    programs = make_vu_programs(funcs, 3, 40, 77)
    sigma = SimConfig().exec_sigma

    sim = Simulator(make_scheduler("hiku", 2, seed=77), cfg=SimConfig(), seed=77)
    sim.begin(n_vus=2, duration_s=12.0, programs=programs[:2])
    sim.step_until(3.0)
    local = sim.admit_vu(programs[2], t=3.0)
    assert local == 2
    while not sim.done:
        sim.step_until(sim.t + 4.0)
    row = sim._fluct["rows"][local]
    assert len(row) > 0
    for ev in (0, 1, len(row) - 1):
        want = np.random.default_rng((77, local, ev)).lognormal(
            mean=-0.5 * sigma**2, sigma=sigma
        )
        assert row[ev] == want
    # the admitted VU actually produced records
    assert (sim.record_columns.vu == local).any()


def test_admit_vu_rejects_past_times():
    sim = Simulator(make_scheduler("hiku", 2, seed=0), cfg=SimConfig(), seed=0)
    sim.begin(n_vus=0, duration_s=5.0, programs=[])
    sim.step_until(2.0)
    from repro_torch.core import make_functions, make_vu_programs

    prog = make_vu_programs(make_functions(seed=0), 1, 8, 0)[0]
    with pytest.raises(ValueError):
        sim.admit_vu(prog, t=1.0)


def test_pressure_signal_bounds():
    sim = Simulator(make_scheduler("hiku", 4, seed=0), cfg=SimConfig(), seed=0)
    sim.begin(n_vus=0, duration_s=5.0, programs=[])
    assert sim.pressure() == 0.0  # idle
    sim2 = Simulator(make_scheduler("hiku", 2, seed=0), cfg=SimConfig(n_workers=2), seed=0)
    sim2.run(n_vus=30, duration_s=3.0)
    # after the run everything drained again
    assert sim2.pressure() >= 0.0


# ----------------------------------------------- parity with the JAX package
def test_skewed_run_equals_the_reference():
    def build(core):
        adm = core.AdmissionSimulator(K, W, scheduler="hiku", seed=SEED)
        programs = core.admission.make_skewed_programs(
            adm.funcs, VUS, core.default_n_events(DUR), SEED)
        run = adm.run(VUS, DUR, programs=programs)
        return run, run.summarize(DUR), run.shard_load_cv

    run, _, cv = same(build)
    assert run.admitted == VUS and cv >= 0.0


@pytest.mark.parametrize("scheduler", ["hiku", "ch_bl", "least_connections", "random"])
@pytest.mark.parametrize("adm_kw", [
    dict(),
    dict(watermark=0.4, tick_s=0.5),
    dict(policy="round_robin", batch_size=3),
    dict(policy="pull", batch_size=1, tick_s=0.125),
], ids=["default", "watermark", "round_robin", "batched"])
def test_configured_runs_equal_the_reference(scheduler, adm_kw):
    def build(core):
        rng = np.random.default_rng(4)
        arrivals = np.sort(rng.uniform(0.0, 6.0, 20))
        adm = core.AdmissionSimulator(3, 9, scheduler=scheduler,
                                      cfg=core.SimConfig(mem_pool_mb=900.0), seed=2,
                                      admission=core.AdmissionConfig(**adm_kw))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            run = adm.run(20, 10.0, arrivals=arrivals)
        return run, run.summarize(10.0)

    run, metrics = same(build)
    assert len(run.records) > 0 and metrics.n_requests == len(run.records)


@pytest.mark.parametrize("policy", ["pull+steal", "affinity+steal", "bandit+steal"])
def test_run_with_faults_bus_autoscaler_and_stealing_equals_the_reference(policy):
    def build(core):
        funcs = core.make_functions(seed=0)
        scn = core.make_scenario("flash_crowd", funcs, 36, 12.0, seed=1)
        faults = (core.shard_kill_wave(3, 12, shards=[2], t_kill=4.0)
                  + core.rolling_restart(12, t0=1.0, downtime_s=1.0, stagger_s=0.5))
        bus = core.EventPlane()
        events = []
        bus.subscribe((core.eventplane.CLUSTER_TOPIC,), events.append)
        asc = core.Autoscaler(core.AutoscaleConfig(mode="reactive", target_pressure=0.6))
        adm = core.AdmissionSimulator(
            3, 12, scheduler="hiku", cfg=core.SimConfig(mem_pool_mb=1024.0), seed=1,
            admission=core.AdmissionConfig(policy=policy, steal_watermark=1.25,
                                           policy_args={"record_state": True}
                                           if policy == "bandit+steal" else None))
        kw = scn.run_kwargs()
        kw["faults"] = faults
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            run = adm.run(scn.n_vus, 12.0, bus=bus, autoscaler=asc, metrics_window_s=1.0, **kw)
        return run, run.summarize(12.0), events, bus.log, asc.actuator.actions, asc.targets_log

    run, _, events, _, actions, _ = same(build)
    assert len(run.records) > 0 and events and run.n_salvages > 0
