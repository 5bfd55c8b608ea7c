"""The port's autoscaler (``repro_torch.core.autoscale``): the cases of
``tests/test_autoscale.py`` on the port's modules, and parity with the JAX
package — on the same synthetic metric stream the port's ``Autoscaler``
makes the reference's decisions (actuator calls and target logs), and an
autoscaled admission run, with and without a fault plan, gives the
reference's records, action schedule, targets and worker-seconds.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core import (
    AutoscaleConfig,
    Autoscaler,
    EventPlane,
    SimConfig,
    Simulator,
    make_functions,
    make_scheduler,
    shard_kill_wave,
    spot_preemption,
)
from repro_torch.core.admission import AdmissionConfig, AdmissionSimulator
from repro_torch.core.autoscale import AutoscaleActuator
from repro_torch.core.eventplane import CLUSTER_TOPIC, SHARD_TOPIC
from repro_torch.core.workloads import make_scenario
from repro.core import autoscale as ref_autoscale
from repro.core import eventplane as ref_eventplane
from test_torch_cluster_cases import canon, same

pytestmark = pytest.mark.shard

FUNCS = make_functions(seed=0)


def _sim(n_workers=4, dur=10.0, seed=0):
    sim = Simulator(
        make_scheduler("hiku", n_workers, seed=seed), funcs=FUNCS,
        cfg=SimConfig(n_workers=n_workers), seed=seed,
    )
    sim.begin(n_vus=0, duration_s=dur, programs=[])
    return sim


# ------------------------------------------------------------ config guard
def test_config_validation():
    AutoscaleConfig()  # defaults are valid
    for bad in (
        dict(mode="magic"),
        dict(window_s=0.0),
        dict(target_pressure=0.0),
        dict(target_pressure=1.5),
        dict(min_workers=-1),
        dict(initial_frac=0.0),
        dict(notice_s=-0.1),
        dict(horizon_windows=0),
        dict(alpha=0.0),
        dict(max_step=0),
        dict(down_step=0),
        dict(down_after=0),
        dict(idle_windows=0),
    ):
        with pytest.raises(ValueError):
            AutoscaleConfig(**bad)


def test_initial_split_floor_and_cap():
    asc = Autoscaler(AutoscaleConfig(initial_frac=0.5, min_workers=2))
    assert asc.initial_split([8, 5, 1]) == [4, 3, 1]  # ceil, floored, capped
    asc = Autoscaler(AutoscaleConfig(initial_frac=0.1, min_workers=2))
    assert asc.initial_split([8, 5, 1]) == [2, 2, 1]


# -------------------------------------- engine hooks: validation + dirty mark
def test_schedule_hooks_validate_and_mark_dirty():
    """The §13 invariant the coordinator A/B rests on: every elasticity
    mutation marks the owning shard dirty *at schedule time* (the heap
    gained an event the frontier skip must see)."""
    sim = _sim()
    sink = set()
    sim.attach_dirty(sink, 3)
    sink.clear()
    sim.schedule_worker_add(1.0, 0)
    assert sink == {3}
    sink.clear()
    sim.schedule_worker_fail(2.0, 1)
    assert sink == {3}
    sink.clear()
    sim.schedule_notice(2.0, 2, until=3.0)
    assert sink == {3}
    # validation: past times, beyond-deadline times, bad ids, until < t
    with pytest.raises(ValueError):
        sim.schedule_worker_add(11.0, 0)  # past the deadline
    with pytest.raises(ValueError):
        sim.schedule_worker_fail(1.0, -1)
    sim.step_until(5.0)
    with pytest.raises(ValueError):
        sim.schedule_worker_add(4.0, 0)  # behind the clock
    with pytest.raises(ValueError):
        sim.schedule_notice(6.0, 0, until=5.5)


# ------------------------------------------------- worker-seconds integral
def test_worker_seconds_piecewise_integral():
    """cost = integral of live workers: 4 x 2s, 3 x 4s, 4 x 4s."""
    sim = Simulator(
        make_scheduler("hiku", 4, seed=0), funcs=FUNCS,
        cfg=SimConfig(n_workers=4), seed=0,
    )
    sim.inject_failure(2.0, 3)
    sim.inject_worker(6.0, 3)
    sim.begin(n_vus=0, duration_s=10.0, programs=[])
    sim.step_until(10.0)
    assert sim.worker_seconds_until(10.0) == 4 * 2 + 3 * 4 + 4 * 4
    # the read is non-mutating and monotone in t
    assert sim.worker_seconds_until(10.0) == 36.0
    assert sim.worker_seconds_until(8.0) == 28.0


def test_worker_seconds_static_run_is_pool_times_duration():
    adm = AdmissionSimulator(
        2, 8, scheduler="hiku", cfg=SimConfig(mem_pool_mb=1024.0), seed=0,
        admission=AdmissionConfig(),
    )
    run = adm.run(12, 6.0)
    assert run.worker_seconds == 8 * 6.0
    assert [s.worker_seconds for s in run.shards] == [4 * 6.0, 4 * 6.0]


# ------------------------------------------------------------ the actuator
def test_actuator_dooms_high_ids_revives_low_ids():
    sim = _sim(n_workers=4, dur=10.0)
    notices = []
    act = AutoscaleActuator([sim], [4], [0], notices, 10.0, notice_s=1.0)
    assert act.alive(0) == 4 and act.planned(0, 0.0) == 4
    assert act.scale_to(0.0, 0, 2) == -2  # dooms workers 3 then 2
    assert notices == [(0.0, 0, 1.0), (0.0, 0, 1.0)]
    assert [(a.kind, a.worker) for a in act.actions] == [
        ("notice", 3), ("fail", 3), ("notice", 2), ("fail", 2),
    ]
    assert act.planned(0, 0.0) == 2  # doomed capacity no longer counts
    assert act.scale_to(0.0, 0, 2) == 0  # converged: idempotent
    sim.step_until(1.5)  # the kills fire at t=1.0
    assert act.alive(0) == 2 and act.planned(0, 1.5) == 2
    assert act.scale_to(1.5, 0, 3) == 1  # revives the lowest dead id: 2
    adds = [a for a in act.actions if a.kind == "add"]
    assert [(a.worker, a.fire_t) for a in adds] == [(2, 1.5)]
    assert act.planned(0, 1.5) == 3  # pending add counts before it fires
    sim.step_until(1.6)
    assert act.alive(0) == 3


def test_actuator_drops_actions_past_the_deadline():
    """The termination guarantee: no engine event is ever scheduled at or
    past the deadline (it could never fire; the run must end)."""
    sim = _sim(n_workers=4, dur=10.0)
    act = AutoscaleActuator([sim], [4], [0], [], 10.0, notice_s=1.0)
    act.scale_to(0.0, 0, 2)
    sim.step_until(9.5)
    assert act.scale_to(9.5, 0, 1) == 0  # kill would land at 10.5 >= 10
    assert act.scale_to(10.0, 0, 4) == 0  # add at the deadline itself
    assert not [a for a in act.actions if a.fire_t >= 10.0]


def test_actuator_clamps_target_to_span():
    sim = _sim(n_workers=4, dur=10.0)
    act = AutoscaleActuator([sim], [4], [0], [], 10.0, notice_s=1.0)
    assert act.scale_to(0.0, 0, 99) == 0  # span-clamped: already at 4
    act.scale_to(0.0, 0, -5)  # clamped to 0: dooms everyone
    assert act.planned(0, 0.0) == 0


# ------------------------------------------- sizing decisions (stub-driven)
class _StubActuator:
    """Recording actuator: tracks the planned size per shard, no engine."""

    def __init__(self, split):
        self._planned = list(split)
        self.calls = []

    def planned(self, k, t):
        return self._planned[k]

    def scale_to(self, t, k, target):
        self.calls.append((t, k, target))
        self._planned[k] = target
        return 0


def _drive(asc, split, windows):
    """Publish synthetic metric windows; each entry is (loads, n_done,
    sum_ms, queue_depth)."""
    bus = EventPlane()
    stub = _StubActuator(split)
    asc.attach(bus, stub, split)
    for i, (loads, n_done, sum_ms, queue_depth) in enumerate(windows):
        t_hi = float(i + 1)
        for k, load in enumerate(loads):
            bus.publish(
                (SHARD_TOPIC, k), i, t_hi - 1.0, t_hi,
                {
                    "n_done": n_done, "sum_ms": sum_ms, "n_cold": 0,
                    "load": load, "alive": stub.planned(k, t_hi),
                    "outstanding": load, "pressure": 0.0,
                },
            )
        bus.publish(
            (CLUSTER_TOPIC,), i, t_hi - 1.0, t_hi,
            {"n_done": n_done * len(loads), "arrivals": 0,
             "queue_depth": queue_depth},
        )
    return stub


def test_reactive_downscale_is_hysteretic_upscale_is_not():
    """Excess capacity is retired only after ``down_after`` consecutive
    over-provisioned windows, then ``down_step`` per window; demand spikes
    recover up to ``max_step`` immediately."""
    asc = Autoscaler(AutoscaleConfig(
        mode="reactive", target_pressure=0.5, down_after=2, down_step=1,
        max_step=4,
    ))
    low = ([2], 4, 400.0, 0)  # react target: ceil(2/0.5) = 4 < planned 8
    high = ([4], 4, 400.0, 0)  # react target: 8
    stub = _drive(asc, [8], [low, low, low, high])
    assert [t for _, _, t in stub.calls] == [8, 7, 6, 8]
    assert asc.targets_log == [[8], [7], [6], [8]]


def test_janitor_zeroes_an_idle_shard_bypassing_the_ramp():
    """After ``idle_windows`` windows with no load, no outstanding work and
    an empty queue, the whole pool retires at once (scale-to-zero)."""
    asc = Autoscaler(AutoscaleConfig(
        mode="reactive", scale_to_zero=True, idle_windows=3, down_after=2,
        down_step=1, min_workers=1,
    ))
    idle = ([0], 0, 0.0, 0)
    stub = _drive(asc, [8], [idle, idle, idle])
    assert [t for _, _, t in stub.calls] == [8, 7, 0]


def test_janitor_disabled_keeps_the_min_workers_floor():
    asc = Autoscaler(AutoscaleConfig(
        mode="reactive", scale_to_zero=False, idle_windows=3, down_after=1,
        down_step=4, min_workers=1,
    ))
    idle = ([0], 0, 0.0, 0)
    stub = _drive(asc, [8], [idle] * 6)
    assert stub.calls[-1][2] == 1  # ramps down to the floor, never 0


def test_predictive_provisions_ahead_of_a_rising_rate():
    """With identical (low) current load, the predictive mode sizes for the
    forecast worst window — strictly above the reactive answer once the
    completion rate trends up."""
    windows = [
        ([1], n_done, n_done * 500.0, 0) for n_done in (0, 10, 20, 30)
    ]
    stub_r = _drive(
        Autoscaler(AutoscaleConfig(mode="reactive", max_step=8)), [8], windows
    )
    stub_p = _drive(
        Autoscaler(AutoscaleConfig(mode="predictive", max_step=8)), [8], windows
    )
    assert stub_p.calls[-1][2] > stub_r.calls[-1][2]


def test_queue_depth_counts_as_shard_demand():
    """A backed-up global admission queue raises every shard's target even
    when the shards themselves look idle."""
    asc = Autoscaler(AutoscaleConfig(mode="reactive", target_pressure=0.5))
    stub = _drive(asc, [4, 4], [([0, 0], 0, 0.0, 6)])
    # each shard owns half the queue: ceil(3/0.5) = 6, span-clamped to 4
    assert [t for _, _, t in stub.calls] == [4, 4]


def test_attach_twice_raises():
    asc = Autoscaler()
    asc.attach(EventPlane(), _StubActuator([4]), [4])
    with pytest.raises(RuntimeError, match="attached"):
        asc.attach(EventPlane(), _StubActuator([4]), [4])


# ------------------------------------------------------------- integration
def _autoscaled(scenario="flash_crowd", mode="predictive", faults=None,
                seed=0, K=3, W=12, vus=24, dur=10.0):
    scn = make_scenario(scenario, FUNCS, vus, dur, seed=seed)
    if faults is not None:
        scn = dataclasses.replace(scn, faults=faults)
    adm = AdmissionSimulator(
        K, W, scheduler="hiku", cfg=SimConfig(mem_pool_mb=1024.0), seed=seed,
        admission=AdmissionConfig(),
    )
    asc = Autoscaler(AutoscaleConfig(mode=mode, target_pressure=0.6))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        run = adm.run(vus, dur, autoscaler=asc, **scn.run_kwargs())
    return run, asc


def test_autoscaled_run_is_deterministic():
    """Decisions are a pure function of the published stream: identical
    runs, identical action schedules, identical targets."""
    a, asc_a = _autoscaled()
    b, asc_b = _autoscaled()
    assert a.records.equals(b.records)
    np.testing.assert_array_equal(a.assign_t, b.assign_t)
    assert asc_a.actuator.actions == asc_b.actuator.actions
    assert asc_a.targets_log == asc_b.targets_log
    assert a.worker_seconds == b.worker_seconds


def test_autoscaled_run_cheaper_than_static_nothing_lost():
    """The headline economics at smoke scale: elasticity buys worker-seconds
    back without losing or stranding a single task."""
    run, asc = _autoscaled()
    assert len(asc.actuator.actions) > 0
    assert run.worker_seconds < 12 * 10.0  # strictly under the static pool
    assert run.lost_tasks == 0 and run.stranded == 0
    assert len(run.records) > 0


def _no_duplicate_completions(run):
    order = np.lexsort((run.records.t_submit, run.records.vu))
    vu, ts = run.records.vu[order], run.records.t_submit[order]
    assert not ((np.diff(vu) == 0) & (np.diff(ts) == 0)).any()


def test_conservation_under_shard_kill_wave_with_autoscaler():
    """Chaos composition (§10 x §14): a correlated shard kill with the
    autoscaler live on the same hooks — salvage bookkeeping balances,
    nothing strands, nothing completes twice, and the run is replayable."""
    faults = shard_kill_wave(3, 12, shards=[1], t_kill=3.0)
    a, asc_a = _autoscaled(scenario="on_off", faults=faults)
    assert len(asc_a.actuator.actions) > 0  # both planes actually acted
    assert a.stranded == 0 and a.unsalvaged == 0
    assert sum(s.salvaged_out for s in a.shards) == a.n_salvages
    assert sum(s.salvaged_in for s in a.shards) == a.n_salvages
    _no_duplicate_completions(a)
    b, asc_b = _autoscaled(scenario="on_off", faults=faults)
    assert a.records.equals(b.records)
    assert asc_a.actuator.actions == asc_b.actuator.actions


def test_conservation_under_spot_preemption_with_autoscaler():
    """Spot preemptions (notice -> kill -> delayed replace) interleave with
    autoscaler adds/dooms on one event schedule; conservation holds."""
    faults = spot_preemption(
        12, n_waves=2, wave_size=2, t0=2.0, t1=6.0, notice_s=1.0,
        replace_after_s=2.0, seed=0,
    )
    a, asc_a = _autoscaled(faults=faults)
    assert len(asc_a.actuator.actions) > 0
    assert a.stranded == 0 and a.unsalvaged == 0
    _no_duplicate_completions(a)
    b, asc_b = _autoscaled(faults=faults)
    assert a.records.equals(b.records)
    assert asc_a.actuator.actions == asc_b.actuator.actions
    assert a.worker_seconds == b.worker_seconds


def test_autoscaler_creates_bus_when_none_given():
    run, asc = _autoscaled(dur=6.0, vus=12)
    assert asc.actuator is not None
    assert len(asc.targets_log) > 0  # decisions fired on the implicit bus
    assert run.n_events > 0


# ----------------------------------------------- parity with the JAX package
def _metric_stream(seed, n_shards, n_windows):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, 12, n_shards).tolist(), int(rng.integers(0, 40)),
         float(rng.uniform(0.0, 20_000.0)), int(rng.integers(0, 8)))
        for _ in range(n_windows)
    ]


def _drive_with(autoscale_mod, eventplane_mod, cfg_kw, split, windows):
    """``_drive`` on either package's ``Autoscaler`` and ``EventPlane``."""
    asc = autoscale_mod.Autoscaler(autoscale_mod.AutoscaleConfig(**cfg_kw))
    bus = eventplane_mod.EventPlane()
    stub = _StubActuator(split)
    asc.attach(bus, stub, split)
    for i, (loads, n_done, sum_ms, queue_depth) in enumerate(windows):
        t_hi = float(i + 1)
        for k, load in enumerate(loads):
            bus.publish(
                (eventplane_mod.SHARD_TOPIC, k), i, t_hi - 1.0, t_hi,
                {"n_done": n_done, "sum_ms": sum_ms, "n_cold": 0, "load": load,
                 "alive": stub.planned(k, t_hi), "outstanding": load, "pressure": 0.0},
            )
        bus.publish(
            (eventplane_mod.CLUSTER_TOPIC,), i, t_hi - 1.0, t_hi,
            {"n_done": n_done * len(loads), "arrivals": 0, "queue_depth": queue_depth},
        )
    return stub.calls, asc.targets_log


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg_kw", [
    dict(mode="reactive", target_pressure=0.5, down_after=2, down_step=1, max_step=4),
    dict(mode="predictive", max_step=8),
    dict(mode="reactive", scale_to_zero=True, idle_windows=3, down_after=2, min_workers=1),
], ids=["reactive", "predictive", "janitor"])
def test_decisions_equal_the_reference_on_one_metric_stream(seed, cfg_kw):
    import repro_torch.core.autoscale as port_autoscale
    import repro_torch.core.eventplane as port_eventplane

    windows = _metric_stream(seed, 3, 24)
    got = _drive_with(port_autoscale, port_eventplane, cfg_kw, [8, 6, 10], windows)
    want = _drive_with(ref_autoscale, ref_eventplane, cfg_kw, [8, 6, 10], windows)
    assert got == want and len(got[0]) > 0


@pytest.mark.parametrize("case", ["flash_crowd", "shard_kill", "spot"])
def test_autoscaled_run_equals_the_reference(case):
    def build(core):
        faults = None
        if case == "shard_kill":
            faults = core.shard_kill_wave(3, 12, shards=[1], t_kill=3.0)
        elif case == "spot":
            faults = core.spot_preemption(12, n_waves=2, wave_size=2, t0=2.0, t1=6.0,
                                          notice_s=1.0, replace_after_s=2.0, seed=0)
        funcs = core.make_functions(seed=0)
        scn = core.make_scenario("on_off" if case == "shard_kill" else "flash_crowd",
                                 funcs, 24, 10.0, seed=0)
        if faults is not None:
            scn = dataclasses.replace(scn, faults=faults)
        adm = core.AdmissionSimulator(
            3, 12, scheduler="hiku", cfg=core.SimConfig(mem_pool_mb=1024.0), seed=0,
            admission=core.AdmissionConfig(),
        )
        asc = core.Autoscaler(core.AutoscaleConfig(mode="predictive", target_pressure=0.6))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            run = adm.run(24, 10.0, autoscaler=asc, **scn.run_kwargs())
        return run, asc.actuator.actions, asc.targets_log, run.worker_seconds

    run, actions, targets, _ = same(build)
    assert len(actions) > 0 and len(targets) > 0 and len(run.records) > 0
    assert canon(actions) == canon(list(actions))
