"""Cross-scheduler conservation invariants on the port's simulator and its
multi-cluster tier: the cases of ``tests/test_invariants.py`` on the port's
modules — conservation for every scheduler and scenario, the sharded run a
permutation of the monolithic runs of its slices (process backend), and
conservation and exactly-once under the admission tier for every registered
policy — with each sharded and admission run also held equal to the JAX
package's.
"""

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core import (
    SimConfig,
    Simulator,
    available_policies,
    available_schedulers,
    make_scheduler,
)
from repro_torch.core.trace import make_vu_programs
from test_torch_cluster_cases import same

N_VUS = 16
DURATION_S = 15.0

SCENARIOS = {
    "steady": {},
    "bursty": {"programs": "bursty"},
    "failure": {"failures": [(6.0, 1)], "adds": [(10.0, 9)]},
    "memory_pressure": {"cfg_kw": {"mem_pool_mb": 700.0}},
}


class CheckedSimulator(Simulator):
    """Asserts the memory-pool cap after every sandbox allocation."""

    def _start_or_queue(self, worker, task):
        super()._start_or_queue(worker, task)
        assert worker.busy_mem_mb + worker.idle_mem_mb <= worker.pool_mb + 1e-9, (
            worker.wid,
            worker.busy_mem_mb,
            worker.idle_mem_mb,
        )


def _run_scenario(scheduler: str, scenario: dict):
    cfg_kw = scenario.get("cfg_kw", {})
    sched = make_scheduler(scheduler, 5, seed=13)
    sim = CheckedSimulator(sched, cfg=SimConfig(n_workers=5, **cfg_kw), seed=13)
    for t, w in scenario.get("failures", ()):
        sim.inject_failure(t, w)
    for t, w in scenario.get("adds", ()):
        sim.inject_worker(t, w)
    programs = None
    if scenario.get("programs") == "bursty":
        # near-zero think time: every VU hammers the cluster (arrival bursts)
        programs = make_vu_programs(
            sim.funcs, N_VUS, int(DURATION_S * 60) + 16, 13,
            think_lo=0.005, think_hi=0.05,
        )
    recs = sim.run(n_vus=N_VUS, duration_s=DURATION_S, programs=programs)
    return sim, recs


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("scheduler", available_schedulers())
def test_conservation_invariants(scheduler, scenario):
    sim, recs = _run_scenario(scheduler, SCENARIOS[scenario])
    assert recs, f"{scheduler}/{scenario}: no requests completed"

    per_vu_submits = {}
    for r in recs:
        assert r.t_complete >= r.t_submit, r
        per_vu_submits.setdefault(r.vu, []).append(r.t_submit)

    # closed loop: per-VU submit times strictly increase (no duplicated or
    # double-completed arrival, even across failure retries)
    for vu, subs in per_vu_submits.items():
        assert all(b > a for a, b in zip(subs, subs[1:])), (vu, subs)

    # one record per arrival: at most the single in-flight request per VU
    # (closed loop => <=1 outstanding) separates submits from completions
    for vu in range(N_VUS):
        submitted = sim._vu_pos[vu]
        completed = len(per_vu_submits.get(vu, []))
        assert submitted - completed in (0, 1), (vu, submitted, completed)

    # a completion implies a dispatch; retries may add extra assignments
    assert len(recs) <= len(sim.assignments)

    # memory cap also holds at the end of the run (and was asserted after
    # every allocation by CheckedSimulator)
    for w in sim.workers.values():
        assert w.busy_mem_mb + w.idle_mem_mb <= w.pool_mb + 1e-9


@pytest.mark.shard
@pytest.mark.parametrize("scheduler", ["hiku", "ch_bl", "least_connections", "random"])
def test_sharded_records_permutation_identical_to_monolithic(scheduler):
    """Merged K>1 output == multiset of monolithic per-slice runs."""
    from repro_torch.core.shard import ShardedSimulator, build_simulator

    driver = ShardedSimulator(2, 8, scheduler=scheduler, seed=9, backend="process")
    merged = driver.run(n_vus=12, duration_s=15.0)
    assert len(merged.records) > 0

    mono = []
    for spec in driver.plan(12, 15.0):
        sim = build_simulator(spec)
        for r in sim.run(n_vus=spec.n_vus, duration_s=spec.duration_s):
            mono.append(
                (r.t_submit, r.t_complete, r.func,
                 r.worker + spec.worker_offset, r.cold, r.vu + spec.vu_offset)
            )
    g = merged.records
    got = list(
        zip(g.t_submit.tolist(), g.t_done.tolist(), g.func.tolist(),
            g.worker.tolist(), g.cold.tolist(), g.vu.tolist())
    )
    assert sorted(got) == sorted(mono)


@pytest.mark.shard
@pytest.mark.parametrize("policy", available_policies())
def test_admission_conservation_per_policy(policy):
    """Conservation + exactly-once, for EVERY registered admission policy:
    each admitted VU binds once globally (a migrated VU appears in two
    admission tables but completes each request exactly once), per-VU
    submissions strictly increase through migrations, records respect
    ``t_done >= t_submit``, and the migrated record count equals the
    migration schedule length."""
    import warnings

    from repro_torch.core import SimConfig, make_functions
    from repro_torch.core.admission import AdmissionConfig, AdmissionSimulator
    from repro_torch.core.workloads import make_scenario

    funcs = make_functions(seed=0)
    scn = make_scenario("flash_crowd", funcs, 24, 12.0, seed=7)
    adm = AdmissionSimulator(
        2, 8, scheduler="hiku", cfg=SimConfig(mem_pool_mb=1024.0), seed=7,
        admission=AdmissionConfig(policy=policy, steal_watermark=1.25),
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        run = adm.run(scn.n_vus, 12.0, **scn.run_kwargs())
    g = run.records
    assert len(g) > 0, f"{policy}: no requests completed"
    assert (g.t_done >= g.t_submit).all()
    # population conservation: admitted + unadmitted == n_vus, ids unique
    all_gids = [gid for s in run.shards for gid in s.admitted.tolist()]
    unique = set(all_gids)
    assert run.admitted + run.unadmitted == scn.n_vus
    assert len(unique) == run.admitted
    # a VU appears in at most 1 + (times migrated) admission tables
    assert len(all_gids) == run.admitted + run.n_migrations
    # exactly-once: one migrated record per migration, none when off
    assert int(g.migrated.sum()) == run.n_migrations
    # per-VU global submissions strictly increase (no duplicated or lost
    # arrival, even across cross-shard migration)
    order = np.lexsort((g.t_submit, g.vu))
    vu, ts = g.vu[order], g.t_submit[order]
    same_vu = np.diff(vu) == 0
    assert (np.diff(ts)[same_vu] > 0).all()
    # merged stream is exactly the union of the per-shard streams
    assert len(g) == sum(len(s.records) for s in run.shards)


@pytest.mark.shard
def test_sharded_conservation_across_shards():
    """Conservation holds shard-by-shard under a failure inside one shard."""
    from repro_torch.core.shard import ShardedSimulator

    driver = ShardedSimulator(2, 10, scheduler="hiku", seed=21, backend="interleaved")
    driver.inject_failure(4.0, 7)
    merged = driver.run(n_vus=12, duration_s=15.0)
    total = sum(len(r.records) for r in merged.shards)
    assert len(merged.records) == total
    for res in merged.shards:
        cols = res.records
        assert (cols.t_done >= cols.t_submit).all()
        for vu in set(cols.vu.tolist()):
            subs = cols.t_submit[cols.vu == vu]
            assert (np.diff(subs) > 0).all()


# ----------------------------------------------- parity with the JAX package
@pytest.mark.parametrize("scheduler", ["hiku", "ch_bl", "least_connections", "random"])
def test_sharded_run_equals_the_reference(scheduler):
    merged = same(lambda core: core.ShardedSimulator(2, 8, scheduler=scheduler, seed=9,
                                                     backend="process").run(12, 15.0))
    assert len(merged.records) > 0


@pytest.mark.parametrize("policy", available_policies())
def test_admission_run_equals_the_reference(policy):
    import warnings

    def build(core):
        funcs = core.make_functions(seed=0)
        scn = core.make_scenario("flash_crowd", funcs, 24, 12.0, seed=7)
        adm = core.AdmissionSimulator(
            2, 8, scheduler="hiku", cfg=core.SimConfig(mem_pool_mb=1024.0), seed=7,
            admission=core.AdmissionConfig(policy=policy, steal_watermark=1.25),
        )
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return adm.run(scn.n_vus, 12.0, **scn.run_kwargs())

    run = same(build)
    assert len(run.records) > 0
