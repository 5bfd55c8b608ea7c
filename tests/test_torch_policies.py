"""The port's admission-policy registry and built-in policies
(``repro_torch.core.policies``).

* the cases of ``tests/test_policies.py`` on the port's modules (the flash-crowd
  acceptance runs the quick protocol of the reference's policy benchmark,
  copied here as constants; the leaderboard cases test the benchmark module
  and its checked-in artifact, not the policies, and are not ported);
* parity: for every registered policy, with and without batching, learned
  state recorded, an ``AdmissionSimulator`` run at a few workers gives record
  columns, assignments, admission telemetry and policy snapshots equal to the
  JAX package's; the two registries are separate.
"""

import dataclasses
import heapq
import time
import warnings
from collections import deque

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core import SimConfig, Simulator, make_functions, make_scheduler
from repro_torch.core.admission import AdmissionConfig, AdmissionRun, AdmissionSimulator
from repro_torch.core.policies import (
    AdmissionPolicy,
    ShardState,
    available_policies,
    get_policy_class,
    make_policy,
    register_policy,
    unregister_policy,
)
from repro_torch.core.shard import shard_seed
from repro_torch.core.stealing import steal_tick
from repro_torch.core.trace import default_n_events
from repro_torch.core.workloads import available_scenarios, make_scenario
import repro.core as ref_core
from repro_torch.core.policies import PullPolicy
from test_torch_cluster_cases import same

pytestmark = pytest.mark.shard

FUNCS = make_functions(seed=0)


def _quick_scenario(name="flash_crowd", n_vus=24, dur=10.0, seed=0):
    return make_scenario(name, FUNCS, n_vus, dur, seed=seed), dur


def _run(policy, scn, dur, K=2, W=8, seed=0, **adm_kw):
    adm = AdmissionSimulator(
        K, W, scheduler="hiku", cfg=SimConfig(mem_pool_mb=1024.0), seed=seed,
        admission=AdmissionConfig(policy=policy, steal_watermark=1.25, **adm_kw),
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return adm.run(scn.n_vus, dur, **scn.run_kwargs())


# ------------------------------------------------------------ the registry
def test_available_policies_contains_the_builtins():
    names = available_policies()
    for name in ("pull", "pull+steal", "round_robin", "deadline", "cost",
                 "predictive", "affinity", "affinity+steal",
                 "sjf", "bandit", "bandit+steal"):
        assert name in names
    # the learned flag partitions the registry (the leaderboard's axis)
    for name in ("sjf", "bandit", "bandit+steal"):
        assert get_policy_class(name).learned
    for name in ("pull", "deadline", "cost", "affinity"):
        assert not get_policy_class(name).learned


def test_unknown_policy_error_lists_available():
    with pytest.raises(ValueError, match=r"available.*pull"):
        AdmissionConfig(policy="gossip")
    with pytest.raises(ValueError, match="available"):
        get_policy_class("nope")
    with pytest.raises(ValueError):
        unregister_policy("never-registered")


def test_register_resolve_run_unregister_round_trip():
    """Satellite acceptance: register -> resolve -> run -> unregister."""

    class EveryOther(AdmissionPolicy):
        """Admit only on even shards — deliberately quirky but deterministic."""

        name = "every_other"

        def want_pull(self, state):
            return state.index % 2 == 0 and state.pressure < self.cfg.watermark

    register_policy(EveryOther)
    try:
        assert "every_other" in available_policies()
        assert get_policy_class("every_other") is EveryOther
        scn, dur = _quick_scenario(n_vus=12)
        r = _run("every_other", scn, dur)
        assert isinstance(r, AdmissionRun)
        # odd shards never pulled
        assert all(len(r.shards[k].admitted) == 0 for k in range(1, len(r.shards), 2))
        assert sum(len(s.admitted) for s in r.shards) == r.admitted > 0
    finally:
        assert unregister_policy("every_other") is EveryOther
    assert "every_other" not in available_policies()
    with pytest.raises(ValueError, match="available"):
        AdmissionConfig(policy="every_other")
    # double registration of a taken name is rejected
    register_policy(EveryOther)
    try:
        class Imposter(AdmissionPolicy):
            name = "every_other"

        with pytest.raises(ValueError, match="already registered"):
            register_policy(Imposter)
    finally:
        unregister_policy("every_other")


def test_policy_args_validated_at_config_time():
    with pytest.raises(TypeError, match="unknown policy_args"):
        AdmissionConfig(policy="pull", policy_args={"bogus": 1})
    with pytest.raises(ValueError, match="cost_weight"):
        AdmissionConfig(policy="cost", policy_args={"cost_weight": -1.0})
    with pytest.raises(ValueError, match="alpha"):
        AdmissionConfig(policy="predictive", policy_args={"alpha": 0.0})
    # well-formed knobs construct fine
    AdmissionConfig(policy="cost", policy_args={"cost_weight": 0.8})


def test_policy_args_error_names_key_and_lists_accepted_knobs():
    """Satellite bugfix pin: the config-time rejection must name the
    offending key(s) and list the resolved policy class's accepted knobs
    (walked across the MRO, so inherited knobs show up too)."""
    with pytest.raises(
        TypeError, match=r"'priors_ms'.*accepted knobs.*'prior_ms'"
    ):
        AdmissionConfig(policy="sjf", policy_args={"priors_ms": 100.0})
    # a policy with no knobs at all says so instead of listing nothing
    with pytest.raises(
        TypeError, match=r"'record_state'.*accepted knobs: \(none\)"
    ):
        AdmissionConfig(policy="pull", policy_args={"record_state": True})
    # several unknown keys: all named, sorted, next to the class name
    with pytest.raises(
        TypeError, match=r"BanditPolicy.*'eps', 'sead'.*'bandit_seed'"
    ):
        AdmissionConfig(policy="bandit", policy_args={"sead": 1, "eps": 0.2})
    # knob sets are the policy's own: bandit's knobs include the inherited
    # LearnedPolicy window controls
    from repro_torch.core.policies import BanditStealPolicy, SjfPolicy, policy_knobs

    assert policy_knobs(SjfPolicy) == [
        "prior_ms", "record_state", "replay_from", "update_every",
    ]
    assert "arms" in policy_knobs(BanditStealPolicy)
    assert "update_every" in policy_knobs(BanditStealPolicy)


def test_shard_state_is_frozen():
    s = ShardState(0, 0.0, 4, 0.25, 1.0, 0, 0.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.pressure = 1.0


# ----------------------------------- byte identity vs the pre-registry tier
def _legacy_run(adm: AdmissionSimulator, n_vus, duration_s, programs, arrivals=None):
    """Verbatim replica of the PRE-REGISTRY AdmissionSimulator.run loop
    (hard-wired pull/round_robin/pull+steal), driving the same engine
    hooks.  The registry dispatch must reproduce its streams byte-for-byte.
    """
    cfg = adm.admission
    programs = list(programs)
    arr = np.zeros(n_vus) if arrivals is None else np.asarray(arrivals, np.float64)
    order = np.argsort(arr, kind="stable")
    sims = []
    for k in range(adm.n_shards):
        sk = shard_seed(adm.seed, k)
        sched = make_scheduler(adm.scheduler, adm.worker_split[k], seed=sk)
        sim = Simulator(
            sched, funcs=adm.funcs,
            cfg=dataclasses.replace(adm.cfg, n_workers=adm.worker_split[k]), seed=sk,
        )
        sim.begin(n_vus=0, duration_s=duration_s, programs=[])
        sims.append(sim)
    admitted = [[] for _ in range(adm.n_shards)]
    admit_t = [[] for _ in range(adm.n_shards)]
    pulls = [0] * adm.n_shards
    migrations = []
    waiting = deque()
    qpos = 0
    rr_next = 0
    tick = 0
    t = 0.0
    while True:
        while qpos < n_vus and arr[order[qpos]] <= t:
            waiting.append(int(order[qpos]))
            qpos += 1
        if t < duration_s and waiting:
            if cfg.policy == "round_robin":
                quota = n_vus if cfg.batch_size is None else cfg.batch_size * adm.n_shards
                while waiting and quota > 0:
                    quota -= 1
                    gid = waiting.popleft()
                    k = rr_next % adm.n_shards
                    rr_next += 1
                    sims[k].admit_vu(programs[gid], t=t)
                    admitted[k].append(gid)
                    admit_t[k].append(t)
                    pulls[k] += 1
            else:
                tick_pulls = [0] * adm.n_shards
                heap = [(sims[k].pressure(), k) for k in range(adm.n_shards)]
                heapq.heapify(heap)
                while waiting and heap:
                    p, k = heap[0]
                    if p >= cfg.watermark:
                        break
                    gid = waiting.popleft()
                    sims[k].admit_vu(programs[gid], t=t)
                    admitted[k].append(gid)
                    admit_t[k].append(t)
                    pulls[k] += 1
                    tick_pulls[k] += 1
                    if cfg.batch_size is not None and tick_pulls[k] >= cfg.batch_size:
                        heapq.heappop(heap)
                    else:
                        heapq.heapreplace(heap, (p + adm.inv_workers[k], k))
        if cfg.policy == "pull+steal" and t < duration_s:
            moves = steal_tick(
                sims, steal_watermark=cfg.steal_watermark,
                pull_watermark=cfg.watermark, inv_workers=adm.inv_workers,
                t=t, max_moves=cfg.steal_batch,
            )
            for mv in moves:
                gid = admitted[mv.src][mv.src_vu]
                admitted[mv.dst].append(gid)
                admit_t[mv.dst].append(t)
            migrations.extend(moves)
        if t >= duration_s and all(s.done for s in sims):
            break
        tick += 1
        t = tick * cfg.tick_s
        for sim in sims:
            sim.step_until(t)
    return adm._merge(
        sims, admitted, admit_t, pulls, n_vus, 0.0, [], [], migrations
    )


@pytest.mark.parametrize("policy", ["pull", "round_robin", "pull+steal"])
@pytest.mark.parametrize("batch_size", [None, 2])
def test_ported_policies_byte_identical_to_pre_registry_loop(policy, batch_size):
    """Acceptance: the three original behaviors, dispatched through the
    registry, reproduce the pre-registry admission tier byte-for-byte —
    records, assignments, admission tables and migration schedules."""
    from repro_torch.core.admission import make_sleeper_programs

    K, W, VUS, DUR = 2, 8, 24, 12.0
    cfg = AdmissionConfig(policy=policy, steal_watermark=1.25, batch_size=batch_size)
    programs = make_sleeper_programs(FUNCS, VUS, default_n_events(DUR), 3)
    arrivals = [(vu % 3) * 2.0 for vu in range(VUS)]
    adm = AdmissionSimulator(
        K, W, scheduler="hiku", cfg=SimConfig(mem_pool_mb=1024.0), seed=3,
        admission=cfg,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        new = adm.run(VUS, DUR, programs=programs, arrivals=arrivals)
        adm2 = AdmissionSimulator(
            K, W, scheduler="hiku", cfg=SimConfig(mem_pool_mb=1024.0), seed=3,
            admission=cfg,
        )
        old = _legacy_run(adm2, VUS, DUR, programs, arrivals)
    assert new.records.equals(old.records)
    assert np.array_equal(new.assign_t, old.assign_t)
    assert np.array_equal(new.assign_w, old.assign_w)
    assert [s.admitted.tolist() for s in new.shards] == [
        s.admitted.tolist() for s in old.shards
    ]
    assert [s.pulls for s in new.shards] == [s.pulls for s in old.shards]
    assert new.migrations == old.migrations


def test_deadline_without_metadata_degrades_to_pull():
    """EDF with no deadline annotations is FIFO by arrival: identical
    streams to plain pull (the documented fallback)."""
    scn, dur = _quick_scenario("on_off", n_vus=16)
    scn = dataclasses.replace(scn, deadlines=None)
    r_pull = _run("pull", scn, dur)
    r_dl = _run("deadline", scn, dur)
    assert r_dl.records.equals(r_pull.records)
    assert np.array_equal(r_dl.assign_w, r_pull.assign_w)


# ------------------------------------------------------------- determinism
@pytest.mark.parametrize("policy", sorted(available_policies()))
def test_every_registered_policy_is_deterministic(policy):
    scn, dur = _quick_scenario("flash_crowd", n_vus=20)
    r1 = _run(policy, scn, dur)
    r2 = _run(policy, scn, dur)
    assert r1.records.equals(r2.records)
    assert np.array_equal(r1.assign_t, r2.assign_t)
    assert [s.admitted.tolist() for s in r1.shards] == [
        s.admitted.tolist() for s in r2.shards
    ]


# ------------------------------------------------------ the new behaviors
def test_deadline_policy_orders_queue_by_edf():
    """Tight-SLO VUs admitted under backlog bind before slack ones."""
    scn, dur = _quick_scenario("flash_crowd", n_vus=24)
    r = _run("deadline", scn, dur)
    tight = set(np.flatnonzero(np.isfinite(scn.deadlines)).tolist())
    admit_time = {}
    for s in r.shards:
        for g, t in zip(s.admitted.tolist(), s.admit_t.tolist()):
            admit_time.setdefault(g, t)
    spike_arrival = scn.arrivals[sorted(tight)[0]]
    tight_waits = [admit_time[g] - scn.arrivals[g] for g in tight if g in admit_time]
    # every tight VU admitted, promptly (spike VUs without SLO wait longer)
    assert len(tight_waits) == len(tight)
    spike_loose = [
        g for g in range(scn.n_vus)
        if g not in tight and scn.arrivals[g] >= spike_arrival and g in admit_time
    ]
    if spike_loose:  # backlogged slack VUs bind strictly later on average
        loose_waits = [admit_time[g] - scn.arrivals[g] for g in spike_loose]
        assert np.mean(tight_waits) <= np.mean(loose_waits)


def test_cost_policy_prefers_warm_shards():
    """A shard with zero warm capacity is gated harder than a warm one."""
    cfg = AdmissionConfig(policy="cost")
    pol = make_policy("cost", cfg)
    warm = ShardState(0, 0.5, 4, 0.25, 1.0, 0, 0.0)
    cold = ShardState(1, 0.5, 4, 0.25, 0.0, 0, 0.0)
    assert pol.want_pull(warm)
    assert not pol.want_pull(cold)  # 0.5 + 0.5 penalty >= 0.75 watermark
    keys = dict((k, key) for key, k in pol.rank_shards([warm, cold]))
    assert keys[0] < keys[1]


def test_affinity_policy_scores_warm_hit_against_digest():
    """The hit blend: profile overlap plus first-call warmth, and the
    pressure discount ranks a warmer-but-busier shard first."""
    from repro_torch.core.policies import AffinityPolicy

    prof = ((3, 0.5), (7, 0.25), (9, 0.25))
    assert AffinityPolicy.warm_hit(prof, {3: 2, 9: 1}) == pytest.approx(0.75)
    assert AffinityPolicy.warm_hit(prof, {}) == 0.0
    assert AffinityPolicy.warm_hit(prof, None) == 0.0
    assert AffinityPolicy.warm_hit((), {3: 1}) == 0.0


def test_affinity_policy_routes_to_warm_shard():
    """A VU whose functions are warm on the busier shard still binds there:
    warmth is a pressure discount (the KV-router analog)."""
    import warnings as _w

    from repro_torch.core import make_functions as _mf
    from repro_torch.core.trace import make_vu_programs

    adm = AdmissionSimulator(
        2, 8, scheduler="hiku", cfg=SimConfig(mem_pool_mb=1024.0), seed=0,
        admission=AdmissionConfig(policy="affinity", tick_s=0.25),
    )
    funcs = adm.funcs
    # wave 1 seeds shard warmth; wave 2 (identical programs) arrives once
    # the wave-1 VUs' functions are warm *somewhere* and should co-locate
    progs = make_vu_programs(funcs, 8, 16, 0)
    progs = progs[:4] + progs[:4]  # wave 2 repeats wave 1's programs
    arrivals = [0.0] * 4 + [3.0] * 4
    with _w.catch_warnings():
        _w.simplefilter("ignore", RuntimeWarning)
        run = adm.run(8, 12.0, programs=progs, arrivals=arrivals)
    assert run.admitted == 8
    home = {}
    for s in run.shards:
        for g in s.admitted.tolist():
            home.setdefault(g, s.index)
    # each wave-2 VU landed on its wave-1 twin's shard (warm for exactly
    # its function mix), despite that shard carrying the wave-1 load
    for g in range(4):
        assert home[g + 4] == home[g], (g, home)


def test_nan_rank_key_raises_clear_error():
    """Satellite bugfix: a NaN rank key (the classic undeclared
    warm_capacity read) fails loudly instead of silently freezing the
    heap."""

    class NanRank(AdmissionPolicy):
        name = "nan_rank"

        # deliberately MISSING uses_warm_capacity = True
        def rank_shards(self, states):
            return [(s.pressure + s.warm_capacity, s.index) for s in states]

    register_policy(NanRank)
    try:
        scn, dur = _quick_scenario(n_vus=4)
        with pytest.raises(ValueError, match="uses_warm_capacity"):
            _run("nan_rank", scn, dur)
    finally:
        unregister_policy("nan_rank")


def test_warm_digest_gated_by_flag_and_read_only():
    """ShardState.warm_digest is None unless the policy declares
    ``uses_warm_digest``; when populated it is a read-only mapping view."""
    seen = {}

    class DigestProbe(AdmissionPolicy):
        name = "digest_probe"
        uses_warm_digest = True

        def want_pull(self, state):
            seen[state.index] = state.warm_digest
            return super().want_pull(state)

    class PlainProbe(AdmissionPolicy):
        name = "plain_probe"
        plain_seen = []

        def want_pull(self, state):
            PlainProbe.plain_seen.append(state.warm_digest)
            return super().want_pull(state)

    register_policy(DigestProbe)
    register_policy(PlainProbe)
    try:
        scn, dur = _quick_scenario(n_vus=6)
        _run("digest_probe", scn, dur)
        assert seen, "probe never saw a shard state"
        for digest in seen.values():
            assert digest is not None
            with pytest.raises(TypeError):
                digest[0] = 99  # frozen-snapshot read surface
        _run("plain_probe", scn, dur)
        assert PlainProbe.plain_seen
        assert all(d is None for d in PlainProbe.plain_seen)
    finally:
        unregister_policy("digest_probe")
        unregister_policy("plain_probe")


def test_predictive_policy_raises_watermark_under_bursts():
    cfg = AdmissionConfig(policy="predictive")
    pol = make_policy("predictive", cfg)

    class _Ctx:
        total_workers = 8

    assert pol._watermark == cfg.watermark
    pol.observe(0.0, 16, _Ctx())  # a burst: 16 arrivals in one tick
    assert pol._watermark > cfg.watermark
    high = pol._watermark
    for i in range(1, 60):  # long calm: forecast decays back
        pol.observe(i * 0.25, 0, _Ctx())
    assert cfg.watermark <= pol._watermark < high
    assert pol._watermark == pytest.approx(cfg.watermark, abs=1e-3)


def test_warm_capacity_signal_bounds():
    sim = Simulator(make_scheduler("hiku", 2, seed=0), cfg=SimConfig(n_workers=2), seed=0)
    sim.begin(n_vus=0, duration_s=5.0, programs=[])
    assert sim.warm_capacity() == 1.0  # idle cluster: whole pool is headroom
    dead = Simulator(make_scheduler("hiku", 1, seed=0), cfg=SimConfig(n_workers=1), seed=0)
    dead.inject_failure(0.5, 0)
    dead.begin(n_vus=0, duration_s=5.0, programs=[])
    dead.step_until(1.0)
    assert dead.warm_capacity() == 0.0  # dead cluster: no headroom at all
    busy = Simulator(make_scheduler("hiku", 2, seed=0), cfg=SimConfig(n_workers=2), seed=0)
    busy.begin(n_vus=8, duration_s=5.0)
    busy.step_until(0.1)
    assert 0.0 <= busy.warm_capacity() < 1.0  # running tasks pin pool memory


# --------------------------------------------------------- workload suite
def test_scenario_registry_and_unknown_name():
    assert available_scenarios() == ["diurnal", "flash_crowd", "heavy_tail", "on_off"]
    with pytest.raises(ValueError, match="available"):
        make_scenario("tsunami", FUNCS, 8, 10.0)


@pytest.mark.parametrize("name", sorted(available_scenarios()))
def test_scenarios_replay_bit_exactly(name):
    """Scenario generation is a pure function of (seed, vu) — the identity
    seeding contract extended to the workload tier."""
    a = make_scenario(name, FUNCS, 16, 12.0, seed=5)
    b = make_scenario(name, FUNCS, 16, 12.0, seed=5)
    c = make_scenario(name, FUNCS, 16, 12.0, seed=6)
    assert np.array_equal(a.arrivals, b.arrivals)
    assert not np.array_equal(a.arrivals, c.arrivals)
    if a.deadlines is None:
        assert b.deadlines is None
    else:
        assert np.array_equal(a.deadlines, b.deadlines)
    for pa, pb in zip(a.programs, b.programs):
        assert np.array_equal(pa.func_idx, pb.func_idx)
        assert np.array_equal(pa.sleep_s, pb.sleep_s)


@pytest.mark.parametrize("name", sorted(available_scenarios()))
def test_scenarios_shape_and_admissibility(name):
    dur = 12.0
    scn = make_scenario(name, FUNCS, 16, dur, seed=1)
    assert scn.n_vus == 16 and scn.arrivals.shape == (16,)
    assert (scn.arrivals >= 0).all()
    # no VU lands in the end-of-run admission blind window by construction
    assert scn.arrivals.max() < 0.9 * dur
    n_ev = default_n_events(dur)
    for p in scn.programs:
        assert p.func_idx.shape == (n_ev,)
        assert (p.func_idx >= 0).all() and (p.func_idx < len(FUNCS)).all()
        assert (p.sleep_s >= 0).all()


def test_run_validates_deadlines_shape():
    adm = AdmissionSimulator(2, 4, seed=0)
    scn, dur = _quick_scenario(n_vus=8)
    with pytest.raises(ValueError, match="deadlines"):
        adm.run(8, dur, programs=scn.programs, arrivals=scn.arrivals,
                deadlines=[1.0])


def test_deadline_miss_rate_zero_without_metadata():
    scn, dur = _quick_scenario("flash_crowd", n_vus=12)
    r = _run("pull", scn, dur)
    assert r.summarize(dur).deadline_miss_rate >= 0.0
    bare = dataclasses.replace(scn, deadlines=None)
    r2 = _run("pull", bare, dur)
    m = r2.summarize(dur)
    assert m.deadline_miss_rate == 0.0


def test_pull_tick_shim_removed_registry_path_drives_external_queue():
    """The deprecated direct-drive ``_pull_tick`` shim is gone; the registry
    path — one ``admit_tick`` over a caller-built PolicyContext — is the
    direct-drive entry point and admits from a caller-seeded queue."""
    from repro_torch.core.policies import PolicyContext
    from repro_torch.core.trace import make_vu_programs

    adm = AdmissionSimulator(2, 4, scheduler="hiku", seed=0)
    assert not hasattr(adm, "_pull_tick")  # the PR-5 shim is removed
    progs = make_vu_programs(FUNCS, 4, 32, 0)
    sims = []
    for k in range(2):
        sim = Simulator(
            make_scheduler("hiku", 2, seed=k), funcs=FUNCS,
            cfg=SimConfig(n_workers=2), seed=k,
        )
        sim.begin(n_vus=0, duration_s=10.0, programs=[])
        sims.append(sim)
    policy = make_policy("pull", adm.admission)
    admitted, admit_t, pulls = [[], []], [[], []], [0, 0]
    ctx = PolicyContext(
        sims=sims, programs=progs, worker_split=adm.worker_split,
        inv_workers=adm.inv_workers, admitted=admitted, admit_t=admit_t,
        pulls=pulls, policy=policy,
    )
    for gid in range(4):
        ctx.enqueue(gid)
    policy.admit_tick(0.0, ctx)
    assert sum(pulls) == 4 and ctx.waiting_n == 0


# ------------------------------------------------------ learned policies
class _ProfileCtx:
    """Minimal PolicyContext stand-in for queue_key unit tests: programs +
    the func_profile contract (sorted by func, frequencies summing to 1)."""

    def __init__(self, programs):
        self.programs = programs

    def func_profile(self, gid):
        fi = self.programs[gid].func_idx.tolist()
        if not fi:
            return ()
        counts = {}
        for f in fi:
            counts[f] = counts.get(f, 0) + 1
        return tuple((f, c / len(fi)) for f, c in sorted(counts.items()))


class _Prog:
    def __init__(self, func_idx):
        self.func_idx = np.asarray(func_idx, np.int64)


def test_sjf_queue_key_orders_by_predicted_total_service():
    """Stubbed estimator state: the queue key is ``n_calls * sum(freq *
    predict_ms(f))``, so observed-short VUs jump observed-long ones and
    never-seen functions fall back to the global mean."""
    from repro_torch.core.policies import make_policy

    pol = make_policy("sjf", AdmissionConfig(policy="sjf"))
    for _ in range(4):
        pol.estimator.update(0, 10.0)     # func 0: quick
        pol.estimator.update(1, 1000.0)   # func 1: an elephant
    ctx = _ProfileCtx([
        _Prog([0, 0, 0, 0]),  # 4 quick calls        -> 40
        _Prog([1, 1]),        # 2 elephant calls     -> 2000
        _Prog([5, 5]),        # unseen func: global mean 505 each -> 1010
    ])
    keys = [pol.queue_key(g, ctx) for g in range(3)]
    assert keys[0] == pytest.approx(40.0)
    assert keys[1] == pytest.approx(2000.0)
    assert keys[2] == pytest.approx(1010.0)
    assert keys[0] < keys[2] < keys[1]
    # pre-observation the key is n_calls * prior: FIFO up to program length
    fresh = make_policy("sjf", AdmissionConfig(
        policy="sjf", policy_args={"prior_ms": 500.0}))
    assert fresh.queue_key(0, ctx) == pytest.approx(4 * 500.0)
    assert fresh.queue_key(1, ctx) == pytest.approx(2 * 500.0)


def test_bandit_folds_windowed_reward_and_scales_the_pull_gate():
    """One reward window moves the tuner off the warm-up arm; the pull
    gate is ``cfg.watermark * current_arm`` so the same pressure reads
    differently under different arms.  Empty windows feed nothing."""
    from repro_torch.core.policies import Completion, make_policy

    cfg = AdmissionConfig(policy="bandit")
    pol = make_policy("bandit", cfg)
    assert pol.tuner.current == (0.6, 1.0)  # warm-up starts on arm 0
    state = ShardState(0, 0.5, 4, 0.25, 1.0, 0, 0.0)
    assert not pol.want_pull(state)  # gate 0.75 * 0.6 = 0.45 < pressure
    comps = tuple(
        Completion(gid=0, func=0, duration_ms=d, cold=False, shard=0)
        for d in (10.0, 20.0, 30.0)
    )
    pol.fold(comps)
    assert pol.tuner.pulls(0) == 1 and pol.tuner.arm_index == 1
    assert pol.want_pull(state)  # gate 0.75 * 1.0 = 0.75 > pressure
    pol.fold(())  # an empty window is no evidence: arm and stats unchanged
    assert pol.tuner.pulls(1) == 0 and pol.tuner.arm_index == 1


def test_bandit_steal_retunes_the_watermark_pair_per_arm():
    """bandit+steal routes its current arm through steal_params; a
    hand-tuned policy reports the config pair unchanged; and any arm that
    would invert the band is rejected at construction."""
    from repro_torch.core.policies import make_policy

    cfg = AdmissionConfig(policy="bandit+steal", steal_watermark=1.25)
    pol = make_policy("bandit+steal", cfg)
    wm, sm = pol.tuner.current
    assert pol.steal_params() == (1.25 * sm, cfg.watermark * wm)
    for arm_pair in pol.tuner.arms:  # every arm keeps the band uninverted
        assert 1.25 * arm_pair[1] >= cfg.watermark * arm_pair[0]
    hand = make_policy("pull+steal", AdmissionConfig(
        policy="pull+steal", steal_watermark=1.25))
    assert hand.steal_params() == (1.25, hand.cfg.watermark)
    with pytest.raises(ValueError, match="steal victim and pull thief"):
        AdmissionConfig(
            policy="bandit+steal", steal_watermark=1.25,
            policy_args={"arms": [(2.0, 0.5)]},
        )


def test_learned_policy_validates_window_and_requires_observe_feed():
    with pytest.raises(ValueError, match="update_every"):
        AdmissionConfig(policy="sjf", policy_args={"update_every": 0})
    # the estimator only ever moves at window boundaries driven by observe
    scn, dur = _quick_scenario("heavy_tail", n_vus=16)
    r = _run("sjf", scn, dur, policy_args={"record_state": True})
    assert r.policy_state  # windows closed and were recorded
    totals = [
        s["estimator"]["global"][0] for s in r.policy_state
    ]
    assert totals == sorted(totals)  # monotone: folds only accumulate
    assert totals[-1] > 0  # the completion feed actually reached the fold


#: the quick protocol of the reference's policy benchmark (2 shards of 4
#: workers, 32 VUs, 14 s, 1,024 MB pools)
QUICK = dict(n_shards=2, n_workers=8, n_vus=32, duration_s=14.0, mem_pool_mb=1024.0)


def _cell(policy, scn, p, seed=0):
    adm = AdmissionSimulator(
        p["n_shards"], p["n_workers"], scheduler="hiku",
        cfg=SimConfig(mem_pool_mb=p["mem_pool_mb"]), seed=seed,
        admission=AdmissionConfig(policy=policy, steal_watermark=1.25),
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        r = adm.run(scn.n_vus, p["duration_s"], **scn.run_kwargs())
    return r, r.summarize(p["duration_s"])


def test_flash_crowd_acceptance_deadline_beats_pull():
    """Acceptance: on the flash-crowd scenario the deadline policy beats
    pull on deadline-miss rate with p99 within 10% (pinned at quick
    scale)."""
    scn = make_scenario(
        "flash_crowd", FUNCS, QUICK["n_vus"], QUICK["duration_s"], seed=0
    )
    _, m_pull = _cell("pull", scn, QUICK, seed=0)
    _, m_dl = _cell("deadline", scn, QUICK, seed=0)
    assert m_pull.deadline_miss_rate > 0, "scenario must actually miss under pull"
    assert m_dl.deadline_miss_rate < m_pull.deadline_miss_rate
    assert abs(m_dl.p99_ms - m_pull.p99_ms) <= 0.10 * m_pull.p99_ms


# ----------------------------------------------- parity with the JAX package
def test_registries_hold_the_same_builtins():
    assert available_policies() == ref_core.available_policies()
    for name in available_policies():
        assert get_policy_class(name).learned == ref_core.policies.get_policy_class(name).learned


def test_a_policy_registered_with_one_package_is_unknown_to_the_other():
    @register_policy
    class PortOnly(PullPolicy):
        name = "port_only_probe"

    try:
        assert "port_only_probe" in available_policies()
        assert "port_only_probe" not in ref_core.available_policies()
        with pytest.raises(ValueError):
            ref_core.AdmissionConfig(policy="port_only_probe")
    finally:
        unregister_policy("port_only_probe")
    assert "port_only_probe" not in available_policies()


def _policy_run(core, policy, scenario, batch_size, seed):
    funcs = core.make_functions(seed=0)
    scn = core.make_scenario(scenario, funcs, 24, 10.0, seed=seed)
    args = {"record_state": True} if core.policies.get_policy_class(policy).learned else None
    adm = core.AdmissionSimulator(
        2, 8, scheduler="hiku", cfg=core.SimConfig(mem_pool_mb=1024.0), seed=seed,
        admission=core.AdmissionConfig(policy=policy, steal_watermark=1.25,
                                       batch_size=batch_size, policy_args=args),
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        run = adm.run(scn.n_vus, 10.0, **scn.run_kwargs())
    return run, run.summarize(10.0)


@pytest.mark.parametrize("scenario", ["flash_crowd", "heavy_tail"])
@pytest.mark.parametrize("batch_size", [None, 2])
@pytest.mark.parametrize("policy", sorted(available_policies()))
def test_every_policy_run_equals_the_reference(policy, batch_size, scenario):
    run, metrics = same(lambda core: _policy_run(core, policy, scenario, batch_size, 0))
    assert len(run.records) > 0 and run.admitted > 0
    assert metrics.n_requests == len(run.records)
