"""The port's scripted per-shard replay (``repro_torch.core.replay``): the cases
of ``tests/test_replay.py`` on the port's modules (record-then-replay of the
learned policies' snapshots, scripted replay on all three backends against
the recorded shards and the frozen seed engine), and parity with the JAX
package — the scripts the port derives from a run and the replayed shards
equal the reference's, and a snapshot schedule recorded by the reference
replays on the port to the reference's run.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core import SimConfig, Simulator, make_functions, make_scheduler
from repro_torch.core.admission import AdmissionConfig, AdmissionSimulator
from repro_torch.core.chaos import shard_kill_wave
from repro_torch.core.replay import REPLAY_BACKENDS, replay_shards, scripts_from_run
from repro_torch.core.workloads import make_scenario
from test_torch_cluster_cases import REF, PORT, canon, same

pytestmark = pytest.mark.shard

FUNCS = make_functions(seed=0)
K, W, DUR = 2, 8, 12.0
LEARNED = ["sjf", "bandit", "bandit+steal"]


def _record(policy, *, policy_args=None, scenario="heavy_tail", n_vus=24,
            dur=DUR, faults=None, seed=0):
    """One recorded admission run; returns (adm, run, scenario)."""
    scn = make_scenario(scenario, FUNCS, n_vus, dur, seed=seed)
    if faults is not None:
        scn = dataclasses.replace(scn, faults=faults)
    adm = AdmissionSimulator(
        K, W, scheduler="hiku", cfg=SimConfig(mem_pool_mb=1024.0), seed=seed,
        admission=AdmissionConfig(
            policy=policy, steal_watermark=1.25, policy_args=policy_args,
        ),
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        run = adm.run(scn.n_vus, dur, **scn.run_kwargs())
    return adm, run, scn


# ------------------------------------------- in-run snapshot record/replay
@pytest.mark.parametrize("policy", LEARNED)
def test_record_then_replay_byte_identical(policy):
    """The headline contract: a learned run recorded with per-window state
    snapshots, replayed from those snapshots (through a JSON wire round
    trip), reproduces the record streams, assignment traces, admission
    tables AND the snapshots themselves byte-for-byte — proof the snapshot
    captures *all* decision-relevant learned state."""
    _, r, _ = _record(policy, policy_args={"record_state": True})
    assert r.policy_state, "run too short: no reward window ever closed"
    wire = json.loads(json.dumps(r.policy_state))
    assert wire == r.policy_state  # snapshots are JSON-wire bit-exact
    _, r2, _ = _record(
        policy, policy_args={"replay_from": wire, "record_state": True}
    )
    assert r2.records.equals(r.records)
    assert np.array_equal(r2.assign_t, r.assign_t)
    assert np.array_equal(r2.assign_w, r.assign_w)
    assert [s.admitted.tolist() for s in r2.shards] == [
        s.admitted.tolist() for s in r.shards
    ]
    assert [s.admit_t.tolist() for s in r2.shards] == [
        s.admit_t.tolist() for s in r.shards
    ]
    assert r2.policy_state == r.policy_state


def test_policy_state_absent_unless_recording():
    _, r, _ = _record("sjf")
    assert r.policy_state is None  # recording is strictly opt-in


def test_replay_runs_out_of_snapshots_fails_loudly():
    """A replay schedule shorter than the run's window count must raise,
    not silently fall back to live folding (which would silently fork the
    replayed timeline)."""
    _, r, _ = _record("sjf", policy_args={"record_state": True})
    assert len(r.policy_state) >= 2
    with pytest.raises(IndexError):
        _record("sjf", policy_args={"replay_from": r.policy_state[:1]})


# ------------------------------------------------- scripted shard replay
@pytest.fixture(scope="module")
def sjf_recording():
    adm, r, scn = _record("sjf")
    assert r.n_migrations == 0 and r.n_salvages == 0
    return adm, r, scn


@pytest.mark.parametrize("backend", REPLAY_BACKENDS)
def test_scripted_replay_matches_recorded_shards(backend, sjf_recording):
    """Each shard of a recorded learned run, re-executed from nothing but
    its admission schedule, reproduces its record stream and assignment
    trace byte-for-byte — on the serial, interleaved and process
    backends."""
    adm, r, scn = sjf_recording
    scripts = scripts_from_run(adm, r, scn.programs, DUR)
    assert len(scripts) == K
    results = replay_shards(scripts, backend=backend)
    assert [res.index for res in results] == list(range(K))
    for res, shard in zip(results, r.shards):
        assert len(res.records) > 0
        assert res.matches(shard), f"shard {res.index} diverged on {backend}"


def test_scripted_replay_carries_engine_local_faults():
    """Worker kills that do NOT kill a whole shard are engine-local: the
    fault schedule rides on the script and the replay still matches."""
    from repro_torch.core.chaos import FaultEvent, FaultPlan

    plan = FaultPlan("one_worker", [FaultEvent(t=4.0, kind="fail", worker=0)])
    adm, r, scn = _record("sjf", scenario="on_off", faults=plan)
    assert r.n_salvages == 0  # 3 of 4 workers survive: no drain
    assert all(s.alive for s in r.shards)
    scripts = scripts_from_run(adm, r, scn.programs, DUR)
    assert scripts[0].failures == ((4.0, 0),)  # routed, shard-local id
    for res, shard in zip(replay_shards(scripts), r.shards):
        assert res.matches(shard)


def test_scripts_refuse_cross_shard_identity_moves():
    """Salvaged (or stolen) VUs carry their service identity across
    engines; per-shard scripting cannot replay that and must refuse."""
    plan = shard_kill_wave(K, W, shards=[0], t_kill=3.0)
    adm, r, scn = _record("pull", scenario="on_off", n_vus=32, dur=14.0,
                          faults=plan)
    assert r.n_salvages > 0, "the kill must actually trigger salvage"
    with pytest.raises(ValueError, match="cannot be replayed"):
        scripts_from_run(adm, r, scn.programs, 14.0)


def test_unknown_replay_backend_lists_available():
    with pytest.raises(ValueError, match="serial"):
        replay_shards([], backend="quantum")


# --------------------------------------- static byte-identity regression
def test_static_run_byte_identical_to_seed_engine_with_estimators_idle():
    """The frozen-seed-baseline contract extended to this PR: importing the
    estimator layer and holding an (idle) estimator changes nothing about a
    static run — byte-identical records and assignments vs tests/legacy."""
    from legacy import SimConfig as LegacySimConfig
    from legacy import Simulator as LegacySimulator
    from legacy import make_scheduler as legacy_make_scheduler

    from repro_torch.core.estimators import DurationEstimator

    est = DurationEstimator()  # instantiated, never updated: pure bystander
    name, seed, n_workers, n_vus, dur = "hiku", 7, 5, 30, 40.0
    lsim = LegacySimulator(
        legacy_make_scheduler(name, n_workers, seed=seed),
        cfg=LegacySimConfig(n_workers=n_workers), seed=seed,
    )
    lrecs = lsim.run(n_vus=n_vus, duration_s=dur)
    sim = Simulator(
        make_scheduler(name, n_workers, seed=seed),
        cfg=SimConfig(n_workers=n_workers), seed=seed,
    )
    recs = sim.run(n_vus=n_vus, duration_s=dur)
    assert len(recs) == len(lrecs) > 0
    for x, y in zip(recs, lrecs):
        assert (x.t_submit, x.t_complete, x.func, x.worker, x.cold, x.vu) == (
            y.t_submit, y.t_complete, y.func, y.worker, y.cold, y.vu
        )
    assert list(sim.assignments) == list(lsim.assignments)
    assert est.total_updates == 0  # nothing ever fed it


# ----------------------------------------------- parity with the JAX package
def _recorded_on(core, policy, faults=False, policy_args=None):
    funcs = core.make_functions(seed=0)
    scn = core.make_scenario("heavy_tail", funcs, 24, DUR, seed=0)
    if faults:
        scn = dataclasses.replace(scn, faults=core.FaultPlan("engine", [
            core.FaultEvent(2.0, "fail", 1), core.FaultEvent(6.0, "add", 1)]))
    adm = core.AdmissionSimulator(
        K, W, scheduler="hiku", cfg=core.SimConfig(mem_pool_mb=1024.0), seed=0,
        admission=core.AdmissionConfig(policy=policy, steal_watermark=1.25,
                                       policy_args=policy_args),
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        run = adm.run(scn.n_vus, DUR, **scn.run_kwargs())
    return adm, run, scn


@pytest.mark.parametrize("backend", REPLAY_BACKENDS)
@pytest.mark.parametrize("faults", [False, True], ids=["static", "engine_faults"])
def test_scripts_and_replayed_shards_equal_the_reference(backend, faults):
    def build(core):
        adm, run, scn = _recorded_on(core, "sjf", faults=faults)
        scripts = core.scripts_from_run(adm, run, scn.programs, DUR)
        return scripts, core.replay_shards(scripts, backend=backend)

    scripts, results = same(build)
    assert len(scripts) == K and all(len(res.records) > 0 for res in results)


@pytest.mark.parametrize("policy", LEARNED)
def test_reference_snapshots_replay_on_the_port(policy):
    _, want, _ = _recorded_on(REF, policy, policy_args={"record_state": True})
    wire = json.loads(json.dumps(want.policy_state))
    _, got, _ = _recorded_on(PORT, policy,
                             policy_args={"replay_from": wire, "record_state": True})
    assert canon(got) == canon(want)
