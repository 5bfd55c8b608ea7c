"""The port's cross-shard work stealing (``repro_torch.core.stealing``) and the
engine hooks it drives: the cases of ``tests/test_stealing.py`` on the port's
modules (the hot-block runs use the quick protocol and workload of the
reference's stealing benchmark, copied here as constants), and parity with
the JAX package — ``steal_tick`` on the same pressured shards makes the
reference's moves, and the hot-block and wave runs give the reference's
records, migrations and per-shard steal counters.
"""

import warnings

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core import SimConfig, Simulator, make_scheduler
from repro_torch.core.admission import (
    AdmissionSimulator,
    load_cv_across_shards,
    make_sleeper_programs,
)
from repro_torch.core.stealing import steal_tick
from repro_torch.core.trace import make_functions, make_vu_programs, service_fluctuations
from test_torch_cluster_cases import REF, PORT, canon, same

pytestmark = pytest.mark.shard


def _pressured_sim(seed=5, n_workers=2, pool=400.0, n_vus=8, dur=20.0, upto=2.0):
    """A simulator stepped until memory pressure parks tasks on pending."""
    funcs = make_functions(seed=0)
    progs = make_vu_programs(funcs, n_vus, 64, seed)
    cfg = SimConfig(n_workers=n_workers, mem_pool_mb=pool)
    sim = Simulator(make_scheduler("hiku", n_workers, seed=seed), funcs=funcs, cfg=cfg, seed=seed)
    sim.begin(n_vus=n_vus, duration_s=dur, programs=progs)
    sim.step_until(upto)
    return sim, funcs, progs


def _idle_sim(funcs, seed=99, n_workers=2, dur=20.0, upto=2.0):
    sim = Simulator(
        make_scheduler("hiku", n_workers, seed=seed), funcs=funcs,
        cfg=SimConfig(n_workers=n_workers), seed=seed,
    )
    sim.begin(n_vus=0, duration_s=dur, programs=[])
    sim.step_until(upto)
    return sim


# ------------------------------------------------------------- engine hooks
def test_steal_queued_exports_pending_and_retires_vu():
    sim, _, progs = _pressured_sim()
    pend_before = sum(len(w.pending) for w in sim.workers.values())
    assert pend_before > 0, "scenario must park tasks on pending"
    conns_before = sim.sched.total_conns
    stolen = sim.steal_queued(pend_before + 5)  # ask for more than exists
    assert len(stolen) == pend_before == sim.stolen_out
    assert sum(len(w.pending) for w in sim.workers.values()) == 0
    # each export released its scheduler connection (on_cancel)
    assert sim.sched.total_conns == conns_before - len(stolen)
    for s in stolen:
        assert s.origin_seed == sim.seed  # first binding: native identity
        assert s.next_pos == s.ev_idx + 1  # closed loop: one in-flight request
        assert s.prog_funcs[s.ev_idx] == s.func
        # the VU is retired locally: its program cursor is exhausted
        assert sim._vu_pos[s.src_vu] == len(s.prog_funcs)
    assert sim.steal_queued(1) == []  # nothing left to steal


def test_stolen_identity_bit_exact_across_migration():
    """A migrated VU's service draws replay the ORIGIN identity bit-exactly,
    including rows grown on the destination after the transfer."""
    sim, funcs, _ = _pressured_sim()
    dst = _idle_sim(funcs)
    stolen = sim.steal_queued(1)
    assert stolen
    s = stolen[0]
    local = dst.receive_task(s, t=2.0)
    while not dst.done:
        dst.step_until(dst.t + 4.0)
    row = dst._fluct["rows"][local]
    assert len(row) > 0
    sigma = SimConfig().exec_sigma
    want = service_fluctuations(s.origin_seed, 1, len(row), sigma, vu_start=s.origin_vu)[0]
    assert np.array_equal(np.asarray(row), want)
    # the stolen request completed on the destination, flagged migrated
    cols = dst.record_columns
    assert int(cols.migrated.sum()) == 1 == dst.stolen_in
    mig = cols[np.flatnonzero(cols.migrated)[0]]
    assert mig.vu == local and mig.func == s.func and mig.t_submit == s.t_submit
    # ... and the VU kept producing non-migrated records afterwards
    assert ((cols.vu == local) & ~cols.migrated).sum() > 0


def test_receive_task_lands_at_vu_index_with_stale_wide_band():
    """Regression: a shared fluctuation band left wider by an earlier
    same-seed run (warm _FLUCT_CACHE) must not displace the foreign row —
    stealing runs are invariant to cache warmth."""
    funcs = make_functions(seed=0)
    progs = make_vu_programs(funcs, 6, 32, 777)
    warm = _idle_sim(funcs, seed=99)  # run 1 grows the (99, 0, sigma) band wide
    for p in progs:
        warm.admit_vu(p, t=warm.t)
    while not warm.done:
        warm.step_until(warm.t + 5.0)
    victim, _, _ = _pressured_sim()
    dst = _idle_sim(funcs, seed=99)  # run 2 shares the warm band
    for p in progs[:2]:
        dst.admit_vu(p, t=dst.t)
    dst.step_until(2.5)
    s = victim.steal_queued(1)[0]
    local = dst.receive_task(s, t=2.5)
    assert local == 2  # third VU, even though the warm band has 6 rows
    while not dst.done:
        dst.step_until(dst.t + 5.0)
    row = dst._fluct["rows"][local]
    assert len(row) > 0
    sigma = SimConfig().exec_sigma
    want = service_fluctuations(s.origin_seed, 1, len(row), sigma, vu_start=s.origin_vu)[0]
    assert np.array_equal(np.asarray(row), want)
    assert int(dst.record_columns.migrated.sum()) == 1


def test_receive_task_rejects_past_times():
    sim, funcs, _ = _pressured_sim()
    dst = _idle_sim(funcs)
    stolen = sim.steal_queued(1)[0]
    with pytest.raises(ValueError):
        dst.receive_task(stolen, t=dst.t - 1.0)


def test_admitted_vu_after_steal_keeps_native_identity():
    """Native admissions after a foreign row still seed by (seed, local_vu)."""
    from repro_torch.core.trace import VUProgram

    sim, funcs, _ = _pressured_sim()
    dst = _idle_sim(funcs)
    dst.receive_task(sim.steal_queued(1)[0], t=2.0)
    progs = make_vu_programs(funcs, 3, 16, 123)
    local = dst.admit_vu(progs[0], t=2.5)
    while not dst.done:
        dst.step_until(dst.t + 4.0)
    row = dst._fluct["rows"][local]
    assert len(row) > 0
    sigma = SimConfig().exec_sigma
    want = service_fluctuations(dst.seed, 1, len(row), sigma, vu_start=local)[0]
    assert np.array_equal(np.asarray(row), want)


# -------------------------------------------------------------- coordinator
def test_steal_tick_moves_from_victim_to_thief():
    sim, funcs, _ = _pressured_sim()
    dst = _idle_sim(funcs)
    assert sim.pressure() > 1.0 and dst.pressure() == 0.0
    moves = steal_tick([sim, dst], steal_watermark=1.0, pull_watermark=0.75,
                       inv_workers=[0.5, 0.5], t=2.0)
    assert moves and all(m.src == 0 and m.dst == 1 for m in moves)
    assert sim.stolen_out == len(moves) == dst.stolen_in
    # effective-pressure accounting: the thief never exceeds the watermark
    assert len(moves) <= 2  # 0.75 / 0.5 -> at most 2 receives this tick


def test_steal_tick_respects_max_moves_and_validates():
    sim, funcs, _ = _pressured_sim()
    dst = _idle_sim(funcs)
    with pytest.raises(ValueError):
        steal_tick([sim, dst], steal_watermark=0.5, pull_watermark=0.75,
                   inv_workers=[0.5, 0.5])
    moves = steal_tick([sim, dst], steal_watermark=1.0, pull_watermark=0.75,
                       inv_workers=[0.5, 0.5], t=2.0, max_moves=1)
    assert len(moves) == 1


def test_steal_tick_clamps_reinjection_to_receiver_clock():
    """Regression: a receiver whose clock ran past the tick time must still
    get the task (re-injected at its own clock), never lose it — the victim
    is already mutated by the time the receive happens."""
    sim, funcs, _ = _pressured_sim()
    dst = _idle_sim(funcs, upto=5.0)  # keep-alive sweeps advanced its clock
    assert dst.t > 2.0
    moves = steal_tick([sim, dst], 1.0, 0.75, [0.5, 0.5], t=2.0)
    assert moves and dst.stolen_in == len(moves) == sim.stolen_out
    assert all(m.t == dst.t for m in moves)


def test_balanced_shards_produce_no_moves():
    funcs = make_functions(seed=0)
    a, b = _idle_sim(funcs, seed=1), _idle_sim(funcs, seed=2)
    assert steal_tick([a, b], 1.5, 0.75, [0.5, 0.5]) == []


# ------------------------------------------------- dead shards and pressure
def test_pressure_is_inf_with_all_workers_failed():
    sim = Simulator(make_scheduler("hiku", 1, seed=0), cfg=SimConfig(n_workers=1), seed=0)
    sim.inject_failure(0.5, 0)
    sim.begin(n_vus=0, duration_s=5.0, programs=[])
    sim.step_until(1.0)
    assert sim.pressure() == float("inf")


def test_dead_shard_never_wins_pull_tick_or_steal_heap():
    """Satellite: a dead shard (pressure inf) must never pull an admission
    nor receive a stolen task."""
    from repro_torch.core.policies import PolicyContext, make_policy

    funcs = make_functions(seed=0)
    dead = Simulator(make_scheduler("hiku", 1, seed=0), funcs=funcs,
                     cfg=SimConfig(n_workers=1), seed=0)
    dead.inject_failure(0.5, 0)
    dead.begin(n_vus=0, duration_s=30.0, programs=[])
    dead.step_until(2.0)
    live = _idle_sim(funcs, seed=7, n_workers=2, dur=30.0)
    assert dead.pressure() == float("inf")

    adm = AdmissionSimulator(2, 3, scheduler="hiku", seed=0)
    progs = make_vu_programs(funcs, 4, 32, 0)
    policy = make_policy("pull", adm.admission)
    admitted, admit_t, pulls = [[], []], [[], []], [0, 0]
    ctx = PolicyContext(
        sims=[dead, live], programs=progs, worker_split=adm.worker_split,
        inv_workers=adm.inv_workers, admitted=admitted, admit_t=admit_t,
        pulls=pulls, policy=policy,
    )
    for gid in range(4):
        ctx.enqueue(gid)
    policy.admit_tick(2.0, ctx)
    assert pulls[0] == 0 and admitted[0] == []  # the dead shard pulled nothing
    assert pulls[1] > 0

    # and the steal heaps: dead can't thieve (inf pressure) and, with every
    # worker gone, has nothing stealable as a victim either
    victim, _, _ = _pressured_sim()
    assert steal_tick([victim, dead], 1.0, 0.75, [0.5, 1.0], t=2.0) == []
    assert dead.stolen_in == 0 and dead.stolen_out == 0


def test_load_cv_across_shards_all_zero_counts():
    assert load_cv_across_shards([0, 0, 0]) == 0.0
    assert load_cv_across_shards([]) == 0.0


# ----------------------------------------------- pull+steal end-to-end runs
def test_pull_steal_conservation(hot_block):
    """Acceptance: every stolen task completes exactly once — the migrated
    record count equals the migration count, each migration's global VU is
    consistent across both shards' admission tables, and no request is
    duplicated or lost relative to the per-shard streams."""
    p, res = hot_block
    run, _ = res["pull+steal"]
    assert run.n_migrations > 0, "scenario must actually migrate"
    # exactly-once: one migrated record per migration (the scenario drains)
    assert int(run.records.migrated.sum()) == run.n_migrations
    assert sum(s.stolen_out for s in run.shards) == run.n_migrations
    assert sum(s.stolen_in for s in run.shards) == run.n_migrations
    for mv in run.migrations:
        src_tab = run.shards[mv.src].admitted
        dst_tab = run.shards[mv.dst].admitted
        assert src_tab[mv.src_vu] == dst_tab[mv.dst_vu]  # same global VU
    # merged stream is exactly the union of the shard streams
    assert len(run.records) == sum(len(s.records) for s in run.shards)
    # no duplicated completion: a VU's submissions are unique in time
    order = np.lexsort((run.records.t_submit, run.records.vu))
    vu, ts = run.records.vu[order], run.records.t_submit[order]
    dup = (np.diff(vu) == 0) & (np.diff(ts) == 0)
    assert not dup.any()
    # every VU of the population was admitted exactly once globally
    all_gids = {g for s in run.shards for g in s.admitted.tolist()}
    assert all_gids == set(range(p["n_vus"]))


def test_pull_steal_deterministic():
    r1, _ = _hot_block_run("pull+steal")
    r2, _ = _hot_block_run("pull+steal")
    assert r1.records.equals(r2.records)
    assert np.array_equal(r1.assign_t, r2.assign_t)
    assert np.array_equal(r1.assign_w, r2.assign_w)
    assert r1.migrations == r2.migrations


def test_pull_steal_beats_pull_on_hot_block(hot_block):
    """Acceptance: lower p99 AND lower cross-shard load CV than pull-only
    admission on the skewed (delayed-onset) hot-block scenario."""
    _, res = hot_block
    (r_pull, m_pull), (r_steal, m_steal) = res["pull"], res["pull+steal"]
    assert r_pull.n_migrations == 0 and m_pull.migrated_rate == 0.0
    assert int(r_pull.records.migrated.sum()) == 0  # stealing off: flag never set
    assert m_steal.p99_ms < m_pull.p99_ms, (m_steal.p99_ms, m_pull.p99_ms)
    assert r_steal.shard_load_cv < r_pull.shard_load_cv


# --------------------------------------------------- shard/admission seams
def test_admit_vu_batched_grow_is_bit_exact_and_batched(monkeypatch):
    """Satellite: admit_vu defers the fluctuation fill and flushes a burst in
    one vectorized call — with rows bit-identical to the per-VU path."""
    import repro_torch.core.simulator as simmod

    funcs = make_functions(seed=0)
    progs = make_vu_programs(funcs, 10, 48, 321)
    sigma = SimConfig().exec_sigma

    def run(per_vu_flush):
        simmod._FLUCT_CACHE.clear()  # fresh band: don't share across the two paths
        sim = Simulator(make_scheduler("hiku", 2, seed=321), funcs=funcs,
                        cfg=SimConfig(n_workers=2), seed=321)
        sim.begin(n_vus=2, duration_s=16.0, programs=progs[:2])
        sim.step_until(3.0)
        for p in progs[2:]:
            sim.admit_vu(p, t=3.0)
            if per_vu_flush:
                sim._flush_fluct()  # the pre-batching one-call-per-VU path
        while not sim.done:
            sim.step_until(sim.t + 4.0)
        return sim

    calls = []
    real = simmod.service_fluctuations

    def counting(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(simmod, "service_fluctuations", counting)
    batched = run(per_vu_flush=False)
    n_batched = len(calls)
    calls.clear()
    per_vu = run(per_vu_flush=True)
    n_per_vu = len(calls)
    monkeypatch.undo()

    # bit-exact: identical rows and identical record streams
    assert batched._fluct["cols"] == per_vu._fluct["cols"]
    for r1, r2 in zip(batched._fluct["rows"], per_vu._fluct["rows"]):
        assert r1 == r2
    assert batched.record_columns.equals(per_vu.record_columns)
    # and actually batched: the 8-VU admission burst filled in ONE call
    assert n_batched < n_per_vu
    # every admitted VU's row matches the per-VU identity call exactly
    cols = batched._fluct["cols"]
    for v in range(2, 10):
        want = service_fluctuations(321, 1, cols, sigma, vu_start=v)[0]
        assert batched._fluct["rows"][v] == want.tolist()


def test_unadmitted_vus_raise_runtime_warning():
    """Satellite: end-of-run blind-window drops are visible at runtime."""
    adm = AdmissionSimulator(2, 8, scheduler="hiku", seed=2)
    progs = make_sleeper_programs(adm.funcs, 4, 64, 2)
    with pytest.warns(RuntimeWarning, match="never admitted"):
        r = adm.run(4, 10.0, programs=progs, arrivals=[0.0, 0.0, 9.9, 100.0])
    assert r.unadmitted == 2
    # ... and a fully admitted run stays silent
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        r2 = adm.run(4, 10.0, programs=progs)
    assert r2.unadmitted == 0


# ------------------------------------------------- warm-locality stealing
def test_steal_queued_prefer_picks_newest_warm_servable():
    """With ``prefer``, the export is the newest pending task the thief can
    serve warm — not the plain newest — and the rest of the queue keeps its
    relative order (the fallback newest goes back on top)."""
    sim, _, _ = _pressured_sim(n_vus=12)
    victim = max(sim.workers.values(), key=lambda w: len(w.pending))
    before = [(tk.func, tk.ev_idx) for tk in victim.pending]
    assert len(before) >= 2
    # a function present mid-queue but not at the newest slot
    target = next(
        (f for f, _ in reversed(before[:-1]) if f != before[-1][0]), None
    )
    assert target is not None, "scenario needs >=2 distinct pending functions"
    got = sim.steal_queued(1, prefer={target})
    assert len(got) == 1 and got[0].func == target
    stolen_key = next(k for k in reversed(before) if k[0] == target)
    after = [(tk.func, tk.ev_idx) for tk in victim.pending]
    assert after == [k for k in before if k != stolen_key]


def test_steal_queued_prefer_without_match_is_plain_newest():
    """A prefer set the victim cannot satisfy falls back byte-identically to
    the unparameterized export (same task, same remaining queue)."""
    plain, _, _ = _pressured_sim(n_vus=12)
    twin, _, _ = _pressured_sim(n_vus=12)
    a = plain.steal_queued(1)[0]
    b = twin.steal_queued(1, prefer=frozenset({10**6}))[0]
    assert (a.func, a.ev_idx, a.src_vu) == (b.func, b.ev_idx, b.src_vu)
    assert (
        [(tk.func, tk.ev_idx) for w in plain.workers.values() for tk in w.pending]
        == [(tk.func, tk.ev_idx) for w in twin.workers.values() for tk in w.pending]
    )


def _warm_thief(funcs, seed=11):
    """A lightly loaded 2-worker sim with real warm instances to prefer."""
    sim = Simulator(
        make_scheduler("hiku", 2, seed=seed), funcs=funcs,
        cfg=SimConfig(n_workers=2), seed=seed,
    )
    sim.begin(n_vus=1, duration_s=20.0,
              programs=make_vu_programs(funcs, 1, 32, seed))
    sim.step_until(2.0)
    return sim


def test_steal_tick_prefer_warm_exports_thief_servable_task():
    """End-to-end: ``prefer_warm=True`` passes the thief's warm-digest keys
    to the victim, so the move matches what ``steal_queued(prefer=digest)``
    would export — warm-locality all the way through the coordinator."""
    victim, funcs, _ = _pressured_sim(seed=5, n_vus=12)
    thief = _warm_thief(funcs)
    digest = frozenset(thief.warm_digest())
    assert digest, "thief must hold warm instances for the test to bite"
    twin, _, _ = _pressured_sim(seed=5, n_vus=12)
    expected = twin.steal_queued(1, prefer=digest)[0]
    moves = steal_tick(
        [victim, thief], steal_watermark=2.0, pull_watermark=1.0,
        inv_workers=[0.5, 0.5], max_moves=1, prefer_warm=True,
    )
    assert len(moves) == 1 and (moves[0].src, moves[0].dst) == (0, 1)
    assert (moves[0].src_vu, moves[0].func, moves[0].ev_idx) == (
        expected.src_vu, expected.func, expected.ev_idx,
    )


def test_steal_tick_prefer_warm_without_warmth_matches_plain_schedule():
    """A thief with an empty digest makes ``prefer_warm=True`` collapse to
    the plain schedule — the §11 off-path guarantee at the coordinator."""
    funcs = make_functions(seed=0)

    def schedule(prefer_warm):
        victim, _, _ = _pressured_sim(seed=5, n_vus=12)
        thief = _idle_sim(funcs)  # zero VUs: warm_digest() is empty
        assert thief.warm_digest() == {}
        return [
            (mv.src, mv.dst, mv.src_vu, mv.func, mv.ev_idx)
            for mv in steal_tick(
                [victim, thief], steal_watermark=2.0, pull_watermark=1.0,
                inv_workers=[0.5, 0.5], prefer_warm=prefer_warm,
            )
        ]

    warm = schedule(True)
    assert warm and warm == schedule(False)


# ----------------------------------------------- pull+steal end-to-end runs
#: the quick protocol of the reference's stealing benchmark
QUICK = dict(
    n_shards=2, n_workers=8, n_vus=32, duration_s=14.0, mem_pool_mb=1024.0,
    wave_pool_mb=900.0, hot_frac=0.375, quiet_s=(3.0, 5.0), steal_watermark=1.25,
)


def _workload(core, scenario, funcs, p, seed):
    """The delayed-onset hot block (cold VUs at t=0, a sleeper block over
    [1, 4) s), or three arrival waves of mixed sleeper/cold VUs."""
    n_vus = p["n_vus"]
    n_events = core.default_n_events(p["duration_s"])
    if scenario == "hot_block":
        programs = core.admission.make_sleeper_programs(
            funcs, n_vus, n_events, seed, hot_frac=p["hot_frac"], quiet_s=p["quiet_s"])
        n_hot = int(round(p["hot_frac"] * n_vus))
        rng = np.random.default_rng((seed, 0xA11CE))
        arrivals = np.zeros(n_vus)
        arrivals[:n_hot] = rng.uniform(1.0, 4.0, n_hot)
        return programs, arrivals
    programs = core.admission.make_sleeper_programs(
        funcs, n_vus, n_events, seed + 1, hot_frac=0.5, quiet_s=p["quiet_s"])
    gap = p["duration_s"] / 4
    return programs, np.asarray([(vu % 3) * gap for vu in range(n_vus)])


def _scenario_runs(core, scenario, p, seed=0):
    """Both policies on one scenario: {policy: (run, metrics)}."""
    pool = p["wave_pool_mb"] if scenario == "wave" else p["mem_pool_mb"]
    out = {}
    for policy in ("pull", "pull+steal"):
        adm = core.AdmissionSimulator(
            p["n_shards"], p["n_workers"], scheduler="hiku",
            cfg=core.SimConfig(mem_pool_mb=pool), seed=seed,
            admission=core.AdmissionConfig(policy=policy,
                                           steal_watermark=p["steal_watermark"]),
        )
        programs, arrivals = _workload(core, scenario, adm.funcs, p, seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r = adm.run(p["n_vus"], p["duration_s"], programs=programs, arrivals=arrivals)
        out[policy] = (r, r.summarize(p["duration_s"]))
    return out


def _hot_block_run(policy, seed=0):
    return _scenario_runs(PORT, "hot_block", QUICK, seed=seed)[policy]


@pytest.fixture(scope="module")
def hot_block():
    return QUICK, _scenario_runs(PORT, "hot_block", QUICK, seed=0)


# ----------------------------------------------- parity with the JAX package
@pytest.mark.parametrize("scenario", ["hot_block", "wave"])
def test_scenario_runs_equal_the_reference(scenario, hot_block):
    got = hot_block[1] if scenario == "hot_block" else _scenario_runs(PORT, scenario, QUICK)
    want = _scenario_runs(REF, scenario, QUICK)
    assert canon(got) == canon(want)
    assert all(len(run.records) > 0 for run, _ in got.values())
    if scenario == "hot_block":
        assert got["pull+steal"][0].n_migrations > 0


@pytest.mark.parametrize("prefer_warm", [False, True])
@pytest.mark.parametrize("upto", [2.0, 5.0])
def test_steal_tick_moves_equal_the_reference(upto, prefer_warm):
    def build(core):
        funcs = core.make_functions(seed=0)
        progs = core.make_vu_programs(funcs, 8, 64, 5)
        sim = core.Simulator(core.make_scheduler("hiku", 2, seed=5), funcs=funcs,
                             cfg=core.SimConfig(n_workers=2, mem_pool_mb=400.0), seed=5)
        sim.begin(n_vus=8, duration_s=20.0, programs=progs)
        sim.step_until(2.0)
        dst = core.Simulator(core.make_scheduler("hiku", 2, seed=99), funcs=funcs,
                             cfg=core.SimConfig(n_workers=2), seed=99)
        dst.begin(n_vus=0, duration_s=20.0, programs=[])
        dst.step_until(upto)
        moves = core.steal_tick([sim, dst], 1.0, 0.75, [0.5, 0.5], t=2.0,
                                prefer_warm=prefer_warm)
        sim.step_until(12.0)
        dst.step_until(12.0)
        return moves, sim.record_columns, dst.record_columns, sim.stolen_out, dst.stolen_in

    moves = same(build)[0]
    assert moves
