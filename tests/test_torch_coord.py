"""The port's dirty-shard coordinator (``repro_torch.core.coord``): the cases of
``tests/test_coord.py`` on the port's modules, and parity with the JAX
package — over the same admission runs, the coordinator's refresh sets (the
dirty shards each refresh re-reads, the cached pressures and the dead set it
leaves) equal the reference's refresh by refresh, as do the runs themselves.
"""

import warnings

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core import SimConfig, Simulator, make_functions, make_scheduler
from repro_torch.core import admission as admission_mod
from repro_torch.core.admission import AdmissionConfig, AdmissionSimulator
from repro_torch.core.chaos import shard_kill_wave
from repro_torch.core.coord import ShardCoordinator
from repro_torch.core.policies import AdmissionPolicy
from repro_torch.core.stealing import drain_tick as _real_drain
from repro_torch.core.stealing import steal_tick as _real_steal
from repro_torch.core.trace import make_vu_programs
from repro_torch.core.workloads import make_scenario
from test_torch_cluster_cases import REF, PORT, canon

pytestmark = pytest.mark.shard

FUNCS = make_functions(seed=0)

#: the acceptance matrix: heap-default policies (fast path), a stealing
#: pair, the warm-locality override path, and both learned queue/watermark
#: policies
MATRIX = ["pull", "pull+steal", "affinity+steal", "sjf", "bandit+steal"]


# ------------------------------------------------- the forced-legacy baseline
class _AlwaysDirtyCoordinator(ShardCoordinator):
    """Coordinator with every O(dirty) shortcut disabled: each refresh
    re-reads every shard (the O(K) poll), and the steal round can never be
    skipped on the victim probe."""

    def refresh(self):
        self.dirty.update(range(len(self.sims)))
        return super().refresh()

    def pressure_max(self):
        return float("inf")


def _legacy_admit(self, t, ctx):
    # route the fast-path dispatch back into the rebuild branch
    coord, ctx.coord = ctx.coord, None
    try:
        self.admit_tick(t, ctx)
    finally:
        ctx.coord = coord


def _legacy_steal(sims, **kw):
    kw.pop("pressures", None)  # force live engine reads, as before
    return _real_steal(sims, **kw)


def _legacy_drain(sims, inv_workers, t, pending=None, **kw):
    return _real_drain(sims, inv_workers, t, pending=pending)


def _run(policy, scn, dur, faults=None, legacy=False, seed=0, K=4, W=16,
         autoscale=False, coords=None):
    adm = AdmissionSimulator(
        K, W, scheduler="hiku", cfg=SimConfig(mem_pool_mb=1024.0), seed=seed,
        admission=AdmissionConfig(policy=policy, steal_watermark=1.25),
    )
    kw = scn.run_kwargs()
    if autoscale:
        from repro_torch.core import AutoscaleConfig, Autoscaler

        kw["autoscaler"] = Autoscaler(
            AutoscaleConfig(mode="predictive", target_pressure=0.6)
        )
    with pytest.MonkeyPatch.context() as mp:
        coord_cls = _AlwaysDirtyCoordinator if legacy else ShardCoordinator
        if coords is not None:
            base = coord_cls

            class _Capture(base):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    coords.append(self)

            coord_cls = _Capture
        if coords is not None or legacy:
            mp.setattr(admission_mod, "ShardCoordinator", coord_cls)
        if legacy:
            mp.setattr(admission_mod, "steal_tick", _legacy_steal)
            mp.setattr(admission_mod, "drain_tick", _legacy_drain)
            mp.setattr(
                AdmissionPolicy, "_admit_tick_incremental", _legacy_admit
            )
            # disable the frontier skip: every shard steps every tick
            mp.setattr(
                Simulator, "next_event_time", lambda self: float("-inf")
            )
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return adm.run(scn.n_vus, dur, faults=faults, **kw)


def _assert_same_run(a, b):
    assert a.records.equals(b.records)
    np.testing.assert_array_equal(a.assign_t, b.assign_t)
    np.testing.assert_array_equal(a.assign_w, b.assign_w)
    assert a.admitted == b.admitted and a.unadmitted == b.unadmitted
    assert a.n_events == b.n_events
    assert a.migrations == b.migrations
    assert a.salvages == b.salvages
    for sa, sb in zip(a.shards, b.shards):
        np.testing.assert_array_equal(sa.admitted, sb.admitted)
        np.testing.assert_array_equal(sa.admit_t, sb.admit_t)
        assert sa.pulls == sb.pulls
        assert (sa.stolen_in, sa.stolen_out) == (sb.stolen_in, sb.stolen_out)
        assert (sa.salvaged_in, sa.salvaged_out) == (
            sb.salvaged_in,
            sb.salvaged_out,
        )


@pytest.mark.parametrize("policy", MATRIX)
def test_coordinator_byte_identical_to_rebuild_loop(policy):
    scn = make_scenario("flash_crowd", FUNCS, 48, 12.0, seed=3)
    a = _run(policy, scn, 12.0)
    b = _run(policy, scn, 12.0, legacy=True)
    _assert_same_run(a, b)


@pytest.mark.parametrize("policy", MATRIX)
def test_coordinator_byte_identical_under_shard_kill_wave(policy):
    scn = make_scenario("heavy_tail", FUNCS, 48, 12.0, seed=5)
    faults = shard_kill_wave(4, 16, shards=[1, 2], t_kill=3.0, stagger_s=1.0)
    a = _run(policy, scn, 12.0, faults=faults)
    b = _run(policy, scn, 12.0, faults=faults, legacy=True)
    _assert_same_run(a, b)
    assert a.n_salvages > 0  # the wave actually exercised the drain path


@pytest.mark.parametrize("policy", ["pull", "pull+steal"])
def test_coordinator_byte_identical_on_autoscaled_runs(policy):
    """§14 x §13: autoscaler mutations (adds, notices, kills) flow through
    the same dirty marks as faults, and the published ``pressure`` payload
    is read from the coordinator cache — so an autoscaled run under the
    cached coordinator is byte-identical to the all-dirty rebuild (same
    records, same worker-seconds bill) while doing strictly fewer
    refreshes.  A missing dirty mark on any elasticity hook would skew the
    cached pressures, change a sizing decision, and fail the comparison."""
    scn = make_scenario("flash_crowd", FUNCS, 48, 12.0, seed=3)
    ca, cb = [], []
    a = _run(policy, scn, 12.0, autoscale=True, coords=ca)
    b = _run(policy, scn, 12.0, legacy=True, autoscale=True, coords=cb)
    _assert_same_run(a, b)
    assert a.worker_seconds == b.worker_seconds < 16 * 12.0
    assert len(ca) == len(cb) == 1
    assert ca[0].refreshes < cb[0].refreshes  # the A/B refreshes pin


# -------------------------------------------- incremental pressure counters
def test_pressure_matches_reference_scan_oracle():
    """The O(1) counter-backed pressure equals the retained O(workers) scan
    (``_pressure_ref``) at every step of a queue-building run, including
    across worker failures."""
    progs = make_vu_programs(FUNCS, 12, 48, seed=9)
    sim = Simulator(
        make_scheduler("hiku", 3, seed=9), funcs=FUNCS,
        cfg=SimConfig(n_workers=3, mem_pool_mb=400.0), seed=9,
    )
    sim.inject_failure(6.0, 1)
    sim.begin(n_vus=12, duration_s=20.0, programs=progs)
    for i in range(1, 80):
        sim.step_until(i * 0.25)
        assert sim.pressure() == sim._pressure_ref()
    assert sim.pressure() == sim._pressure_ref()


def test_pressure_ref_is_inf_for_dead_shard_both_paths():
    sim = Simulator(
        make_scheduler("hiku", 1, seed=0), funcs=FUNCS,
        cfg=SimConfig(n_workers=1), seed=0,
    )
    sim.inject_failure(0.5, 0)
    sim.begin(n_vus=0, duration_s=5.0, programs=[])
    sim.step_until(1.0)
    assert sim.pressure() == sim._pressure_ref() == float("inf")


# --------------------------------------------------- dirty marks and refresh
def _idle_pair(dur=30.0):
    sims = []
    for k in range(2):
        sim = Simulator(
            make_scheduler("hiku", 2, seed=k), funcs=FUNCS,
            cfg=SimConfig(n_workers=2), seed=k,
        )
        sim.begin(n_vus=0, duration_s=dur, programs=[])
        sims.append(sim)
    return sims


def test_idle_shards_stay_clean_after_first_refresh():
    sims = _idle_pair()
    coord = ShardCoordinator(sims)  # constructor refreshes everyone once
    assert coord.refreshes == 2 and not coord.dirty
    # step strictly below the event frontier (an idle engine still holds
    # e.g. keep-alive sweep events): nothing pops, nothing marks
    t_first = min(sim.next_event_time() for sim in sims)
    hi = 3.0 if t_first == float("inf") else t_first
    for frac in (0.25, 0.5, 0.75):
        for sim in sims:
            sim.step_until(hi * frac)  # below the frontier: pure no-op
        assert coord.refresh() == 0  # nothing marked, nothing re-read
    assert coord.refreshes == 2


def test_admit_marks_dirty_and_refresh_recaches():
    sims = _idle_pair()
    coord = ShardCoordinator(sims)
    progs = make_vu_programs(FUNCS, 1, 8, seed=0)
    sims[1].admit_vu(progs[0], t=0.0)
    assert coord.dirty == {1}  # admission published, neighbor stayed clean
    sims[1].step_until(0.5)  # submit fires: live pressure moves
    assert coord.refresh() == 1
    assert coord.pressure[1] == sims[1].pressure()
    assert coord.pressure[0] == 0.0


def test_dead_shard_enters_dead_set_on_refresh():
    doomed = Simulator(
        make_scheduler("hiku", 2, seed=0), funcs=FUNCS,
        cfg=SimConfig(n_workers=2), seed=0,
    )
    doomed.inject_failure(0.5, 0)
    doomed.inject_failure(0.5, 1)
    doomed.begin(n_vus=0, duration_s=30.0, programs=[])
    sims = [doomed, _idle_pair()[1]]
    coord = ShardCoordinator(sims)
    sims[0].step_until(1.0)
    coord.refresh()
    assert coord.dead == {0}
    assert coord.pressure[0] == float("inf")
    assert coord.pressure_max() == float("inf")


# ------------------------------------------------------ persistent heap unit
def test_heap_peek_pop_push_and_supersession():
    sims = _idle_pair()
    coord = ShardCoordinator(sims)
    assert coord.peek() == (0.0, 0)  # (pressure, index) total order
    assert coord.pop() == (0.0, 0)
    assert coord.peek() == (0.0, 1)
    coord.push(0.5, 0)  # re-enter above shard 1
    assert coord.peek() == (0.0, 1)
    coord.pop()
    assert coord.peek() == (0.5, 0)
    # a refresh supersedes any live entry: the stale 0.5 key is discarded
    coord.dirty.add(0)
    coord.refresh()
    assert coord.peek() == (0.0, 0)


def test_compaction_preserves_the_valid_entry_multiset():
    sims = _idle_pair()
    coord = ShardCoordinator(sims)
    for _ in range(200):  # far past the compaction threshold
        coord.dirty.update((0, 1))
        coord.refresh()
    assert len(coord._heap) <= coord._compact_at + 2
    assert coord.pop() == (0.0, 0)
    assert coord.pop() == (0.0, 1)
    assert coord.peek() is None
    assert coord.pressure_max() == 0.0


# ----------------------------------------------- parity with the JAX package
def _refresh_log(core, policy, faults=None, autoscale=False):
    """One admission run of ``core`` with its coordinator's refreshes logged:
    per refresh the dirty set it re-read, then the pressures and dead set."""
    log = []
    base = core.coord.ShardCoordinator

    class _Logged(base):
        __slots__ = ()

        def refresh(self):
            dirty = sorted(self.dirty)
            n = super().refresh()
            log.append((dirty, n, list(self.pressure), sorted(self.dead), self.refreshes))
            return n

    funcs = core.make_functions(seed=0)
    scn = core.make_scenario("flash_crowd", funcs, 48, 12.0, seed=3)
    adm = core.AdmissionSimulator(
        4, 16, scheduler="hiku", cfg=core.SimConfig(mem_pool_mb=1024.0), seed=0,
        admission=core.AdmissionConfig(policy=policy, steal_watermark=1.25),
    )
    kw = scn.run_kwargs()
    if autoscale:
        kw["autoscaler"] = core.Autoscaler(
            core.AutoscaleConfig(mode="predictive", target_pressure=0.6))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(core.admission, "ShardCoordinator", _Logged)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            run = adm.run(scn.n_vus, 12.0, faults=faults, **kw)
    return run, log


@pytest.mark.parametrize("policy", MATRIX)
def test_refresh_sets_equal_the_reference(policy):
    run, log = _refresh_log(PORT, policy)
    want_run, want_log = _refresh_log(REF, policy)
    assert len(log) > 1 and any(entry[0] for entry in log[1:])
    assert canon(log) == canon(want_log)
    assert canon(run) == canon(want_run)


@pytest.mark.parametrize("policy", ["pull+steal", "bandit+steal"])
def test_refresh_sets_equal_the_reference_under_shard_kill_and_autoscaler(policy):
    def faults(core):
        return core.shard_kill_wave(4, 16, shards=[1, 2], t_kill=3.0, stagger_s=1.0)

    run, log = _refresh_log(PORT, policy, faults=faults(PORT), autoscale=True)
    want_run, want_log = _refresh_log(REF, policy, faults=faults(REF), autoscale=True)
    assert any(entry[3] for entry in log)  # the wave left dead shards in view
    assert canon(log) == canon(want_log)
    assert canon(run) == canon(want_run)
