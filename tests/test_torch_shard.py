"""The port's sharded multi-cluster driver (``repro_torch.core.shard``).

* the cases of ``tests/test_shard.py`` on the port's modules (the teardown
  check counts the shared-memory segments this process named: the port's
  prefix is its own, and other test processes may hold live segments);
* the two ``ShardedSimulator`` cases of ``tests/test_equivalence.py``: every
  shard of a K-shard run replays byte for byte what the frozen seed engine in
  ``tests/legacy`` produces for that shard's slice, on both parallel backends;
* parity: on all three backends and both process transports, with failures,
  re-joins and each scheduler, the port's merged run (records, assignments,
  per-shard results, counters) and its metrics equal the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core import SimConfig, Simulator, make_scheduler
from repro_torch.core.shard import (
    SEED_STRIDE,
    ShardedSimulator,
    build_simulator,
    run_shard,
    shard_seed,
    split_even,
)
import os

from legacy import SimConfig as LegacySimConfig
from legacy import Simulator as LegacySimulator
from legacy import make_scheduler as legacy_make_scheduler
from repro.core import shard as ref_shard
from repro_torch.core.shard import SHM_PREFIX, split_even
from test_torch_cluster_cases import same

pytestmark = pytest.mark.shard


def test_split_even_contract():
    for total, parts in [(10, 3), (8, 8), (1600, 7), (5, 5), (9, 2)]:
        sizes = split_even(total, parts)
        assert sum(sizes) == total and len(sizes) == parts
        assert max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)  # remainder goes first


def test_shard_seed_contract():
    assert shard_seed(7, 0) == 7
    assert shard_seed(7, 3) == (7 + 3 * SEED_STRIDE) % 2**32
    seeds = {shard_seed(0, k) for k in range(64)}
    assert len(seeds) == 64  # distinct per shard
    assert all(0 <= s < 2**32 for s in seeds)  # stays in fast-RNG entropy range


def test_plan_partitions_and_offsets():
    driver = ShardedSimulator(3, 10, scheduler="hiku", seed=9)
    specs = driver.plan(n_vus=11, duration_s=7.0)
    assert [s.cfg.n_workers for s in specs] == [4, 3, 3]
    assert [s.worker_offset for s in specs] == [0, 4, 7]
    assert [s.n_vus for s in specs] == [4, 4, 3]
    assert [s.vu_offset for s in specs] == [0, 4, 8]
    assert [s.seed for s in specs] == [shard_seed(9, k) for k in range(3)]
    assert all(s.duration_s == 7.0 for s in specs)


@pytest.mark.parametrize("backend", ["interleaved", "process"])
def test_backends_identical_to_serial(backend):
    def run(b):
        return ShardedSimulator(3, 9, scheduler="hiku", seed=5, backend=b).run(
            n_vus=18, duration_s=15.0
        )

    base, other = run("serial"), run(backend)
    assert len(base.records) > 0
    for r1, r2 in zip(base.shards, other.shards):
        assert r1.records.equals(r2.records)
        assert np.array_equal(r1.assign_t, r2.assign_t)
        assert np.array_equal(r1.assign_w, r2.assign_w)
        assert r1.n_events == r2.n_events
    assert base.records.equals(other.records)
    assert np.array_equal(base.assign_t, other.assign_t)
    assert np.array_equal(base.assign_w, other.assign_w)


def test_process_transport_fallback_matches_shm(monkeypatch):
    """``REPRO_SHARD_TRANSPORT=pickle`` ships the same bytes the shared-
    memory segments do — the transport is invisible to every consumer."""

    def run():
        return ShardedSimulator(
            2, 6, scheduler="hiku", seed=7, backend="process"
        ).run(n_vus=10, duration_s=10.0)

    via_shm = run()
    monkeypatch.setenv("REPRO_SHARD_TRANSPORT", "pickle")
    via_pickle = run()
    assert len(via_shm.records) > 0
    assert via_shm.records.equals(via_pickle.records)
    assert np.array_equal(via_shm.assign_t, via_pickle.assign_t)
    assert np.array_equal(via_shm.assign_w, via_pickle.assign_w)
    assert via_shm.n_events == via_pickle.n_events
    for r1, r2 in zip(via_shm.shards, via_pickle.shards):
        assert r1.spec == r2.spec  # and the caller-visible spec carries
        assert r1.spec.shm_name is None  # no transport detail either way
        assert (r1.resubmits, r1.lost_tasks) == (r2.resubmits, r2.lost_tasks)


def test_process_backend_teardown_is_deterministic():
    """Two back-to-back process-backend runs in one interpreter leave no
    shared-memory segments behind — teardown is explicit close/unlink in
    the driver, not interpreter-exit garbage collection."""
    import os

    from repro_torch.core.shard import SHM_PREFIX

    def segments():
        # the segments this process's drivers named (their token carries our pid)
        if not os.path.isdir("/dev/shm"):
            return set()
        mine = f"{SHM_PREFIX}{os.getpid()}-"
        return {f for f in os.listdir("/dev/shm") if f.startswith(mine)}

    before = segments()
    for seed in (1, 2):
        merged = ShardedSimulator(
            2, 6, scheduler="hiku", seed=seed, backend="process"
        ).run(n_vus=8, duration_s=8.0)
        assert len(merged.records) > 0
        assert segments() - before == set()  # clean between runs, not just after


def test_shard_stream_equals_standalone_simulator():
    """A shard's stream is byte-identical to a monolithic run of its slice."""
    driver = ShardedSimulator(2, 8, scheduler="least_connections", seed=4,
                              backend="interleaved")
    merged = driver.run(n_vus=14, duration_s=12.0)
    for res in merged.shards:
        spec = res.spec
        sched = make_scheduler(spec.scheduler, spec.cfg.n_workers, seed=spec.seed)
        solo = Simulator(sched, cfg=spec.cfg, seed=spec.seed)
        solo.run(n_vus=spec.n_vus, duration_s=spec.duration_s)
        assert res.records.equals(solo.record_columns)
        at, aw = solo.assignment_columns
        assert np.array_equal(res.assign_t, at)
        assert np.array_equal(res.assign_w, aw)


def test_merge_remaps_to_disjoint_global_ids():
    driver = ShardedSimulator(3, 9, scheduler="hiku", seed=2, backend="serial")
    merged = driver.run(n_vus=18, duration_s=15.0)
    assert len(merged.records) == sum(len(r.records) for r in merged.shards)
    assert merged.workers == list(range(9))
    # each record's global worker/vu id falls inside its shard's range
    for res in merged.shards:
        lo, hi = res.spec.worker_offset, res.spec.worker_offset + res.spec.cfg.n_workers
        w = res.records.worker
        assert ((w >= 0) & (w < res.spec.cfg.n_workers)).all()  # local ids
        vlo = res.spec.vu_offset
        assert ((res.records.vu >= 0) & (res.records.vu < res.spec.n_vus)).all()
        del lo, hi, vlo
    g = merged.records
    assert g.worker.min() >= 0 and g.worker.max() < 9
    assert g.vu.min() >= 0 and g.vu.max() < 18
    # merged stream is completion-ordered like a monolithic engine's
    assert (np.diff(g.t_done) >= 0).all()
    assert (np.diff(merged.assign_t) >= 0).all()


def test_merged_vu_populations_disjoint():
    driver = ShardedSimulator(2, 6, scheduler="hiku", seed=1, backend="serial")
    merged = driver.run(n_vus=10, duration_s=12.0)
    vu_sets = [
        set((res.records.vu + res.spec.vu_offset).tolist()) for res in merged.shards
    ]
    assert vu_sets[0].isdisjoint(vu_sets[1])


def test_failure_injection_routes_to_owning_shard():
    driver = ShardedSimulator(2, 10, scheduler="hiku", seed=6, backend="serial")
    driver.inject_failure(5.0, 7)  # global worker 7 -> shard 1, local 2
    specs = driver.plan(n_vus=12, duration_s=20.0)
    assert specs[0].failures == () and specs[1].failures == ((5.0, 2),)
    merged = driver.run(n_vus=12, duration_s=20.0)
    late = merged.records[merged.records.t_submit > 10.0]
    assert len(late) and 7 not in set(late.worker.tolist())


def test_rejoin_after_failure_stays_in_shard_span():
    driver = ShardedSimulator(2, 10, scheduler="hiku", seed=6, backend="serial")
    driver.inject_failure(4.0, 7)
    driver.inject_worker(8.0, 7)  # re-join of failed global worker 7
    specs = driver.plan(n_vus=12, duration_s=25.0)
    assert specs[1].failures == ((4.0, 2),) and specs[1].additions == ((8.0, 2),)
    merged = driver.run(n_vus=12, duration_s=25.0)
    late = merged.records[merged.records.t_submit > 12.0]
    assert len(late) and 7 in set(late.worker.tolist())  # global id 7 is back
    # additions beyond the static partition would collide with another
    # shard's global id range after the merge remap: rejected up front
    with pytest.raises(ValueError):
        driver.inject_worker(8.0, 10)


def test_inject_worker_legacy_shard_form_removed():
    """The deprecated ``inject_worker(t, local_id, shard=k)`` form is gone:
    the unified global-id signature rejects a ``shard`` keyword outright,
    and the global form maps onto the same (shard, local) pair the legacy
    form used to produce."""
    driver = ShardedSimulator(2, 10, scheduler="hiku", seed=6, backend="serial")
    driver.inject_failure(4.0, 7)  # global 7 -> shard 1, local 2
    driver.inject_worker(8.0, 7)
    with pytest.raises(TypeError):
        driver.inject_worker(8.0, 2, shard=1)
    su = driver.plan(12, 25.0)
    assert su[1].failures == ((4.0, 2),) and su[1].additions == ((8.0, 2),)


def test_shard_of_worker_bounds():
    driver = ShardedSimulator(2, 10, scheduler="hiku", seed=0)
    assert driver.shard_of_worker(0) == (0, 0)
    assert driver.shard_of_worker(9) == (1, 4)
    with pytest.raises(ValueError):
        driver.shard_of_worker(10)


def test_run_shard_is_picklable_roundtrip():
    import pickle

    driver = ShardedSimulator(2, 6, scheduler="hiku", seed=8)
    spec = driver.plan(8, 10.0)[1]
    spec2 = pickle.loads(pickle.dumps(spec))
    assert spec2 == spec
    res = run_shard(spec)
    res2 = pickle.loads(pickle.dumps(res))
    assert res2.records.equals(res.records)
    assert res2.n_events == res.n_events


def test_merged_summarize_matches_direct_metrics():
    from repro_torch.core import summarize

    driver = ShardedSimulator(2, 6, scheduler="hiku", seed=3, backend="serial")
    merged = driver.run(n_vus=10, duration_s=15.0)
    m = merged.summarize(15.0)
    direct = summarize(
        merged.records, (merged.assign_t, merged.assign_w), merged.workers, 15.0
    )
    assert m == direct
    assert m.n_requests == len(merged.records)


def test_constructor_validation():
    with pytest.raises(ValueError):
        ShardedSimulator(0, 4)
    with pytest.raises(ValueError):
        ShardedSimulator(5, 4)
    with pytest.raises(ValueError):
        ShardedSimulator(2, 4, backend="threads")


def test_cfg_template_propagates_to_shards():
    cfg = SimConfig(mem_pool_mb=1234.0, keep_alive_s=7.0)
    driver = ShardedSimulator(2, 6, scheduler="hiku", cfg=cfg, seed=0)
    for spec in driver.plan(4, 5.0):
        assert spec.cfg.mem_pool_mb == 1234.0
        assert spec.cfg.keep_alive_s == 7.0
        assert spec.cfg.n_workers == 3
    assert cfg.n_workers == 5  # template untouched


def test_build_simulator_applies_spec(monkeypatch):
    driver = ShardedSimulator(2, 6, scheduler="random", seed=12)
    driver.inject_failure(2.0, 4)
    spec = driver.plan(6, 8.0)[1]
    sim = build_simulator(spec)
    assert sim.seed == spec.seed
    assert sim.cfg == spec.cfg
    assert sim.sched.name == "random"
    assert sim._failures == [(2.0, 1)]


# ------------------------------------------- tests/test_equivalence.py (K-shard)
@pytest.mark.parametrize("backend", ["interleaved", "process"])
def test_kshard_streams_byte_identical_to_seed_engine(backend):
    """Every shard of a K-shard run must replay byte-for-byte what the
    FROZEN seed engine produces for that shard's slice (same seed, worker
    count, VU count, duration), on both execution backends."""
    driver = ShardedSimulator(3, 9, scheduler="hiku", seed=5, backend=backend)
    merged = driver.run(n_vus=18, duration_s=25.0)
    assert len(merged.records) > 0
    # the frozen legacy config predates the retry/backoff knobs; project
    # onto its fields — on static runs they change nothing
    legacy_fields = {f.name for f in dataclasses.fields(LegacySimConfig)}
    for res in merged.shards:
        spec = res.spec
        lsched = legacy_make_scheduler(spec.scheduler, spec.cfg.n_workers, seed=spec.seed)
        cfg_kw = {
            k: v for k, v in dataclasses.asdict(spec.cfg).items() if k in legacy_fields
        }
        lsim = LegacySimulator(lsched, cfg=LegacySimConfig(**cfg_kw), seed=spec.seed)
        lrecs = lsim.run(n_vus=spec.n_vus, duration_s=spec.duration_s)
        cols = res.records
        assert len(lrecs) == len(cols) > 0, f"shard {spec.index}"
        got = list(
            zip(cols.t_submit.tolist(), cols.t_done.tolist(), cols.func.tolist(),
                cols.worker.tolist(), cols.cold.tolist(), cols.vu.tolist())
        )
        want = [(r.t_submit, r.t_complete, r.func, r.worker, r.cold, r.vu) for r in lrecs]
        assert got == want, f"shard {spec.index} diverged from the seed engine"
        got_asg = list(zip(res.assign_t.tolist(), res.assign_w.tolist()))
        assert got_asg == [(t, w) for t, w in lsim.assignments], f"shard {spec.index}"


# ----------------------------------------------- parity with the JAX package
def test_seeding_and_partition_equal_the_reference():
    for k in range(8):
        assert shard_seed(123, k) == ref_shard.shard_seed(123, k)
    for n, parts in [(1600, 8), (10, 3), (7, 7)]:
        assert split_even(n, parts) == ref_shard.split_even(n, parts)
    assert SHM_PREFIX != ref_shard.SHM_PREFIX  # the port's own segment names


@pytest.mark.parametrize("backend", ["serial", "interleaved", "process"])
@pytest.mark.parametrize("scheduler", ["hiku", "ch_bl", "least_connections", "random"])
def test_merged_run_equals_the_reference(scheduler, backend):
    def build(core):
        driver = core.ShardedSimulator(3, 10, scheduler=scheduler, seed=4, backend=backend,
                                       cfg=core.SimConfig(mem_pool_mb=900.0))
        driver.inject_failure(5.0, 8)
        driver.inject_worker(9.0, 8)
        merged = driver.run(n_vus=20, duration_s=14.0)
        return merged, merged.summarize(14.0)

    merged, _ = same(build)
    assert len(merged.records) > 0 and len(merged.shards) == 3


def test_pickle_transport_equals_the_reference(monkeypatch):
    monkeypatch.setenv("REPRO_SHARD_TRANSPORT", "pickle")
    merged = same(lambda core: core.ShardedSimulator(2, 6, scheduler="hiku", seed=7,
                                                     backend="process").run(10, 10.0))
    assert len(merged.records) > 0
    assert os.environ["REPRO_SHARD_TRANSPORT"] == "pickle"
