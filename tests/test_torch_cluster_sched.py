"""Algorithm 1 on each shard's own decision stream under the port's
multi-cluster drivers: the CPU half of the ``cluster`` phase of
``chip_smoke.py``.

Both drivers — ``ShardedSimulator`` on the serial backend and
``AdmissionSimulator`` under ``pull`` admission — run a small cluster with
every shard's scheduler the recording Hiku of ``chip_smoke.recording_schedulers``
(registered in the port's scheduler registry for the run, one instance per
shard, lowest-id ties), with memory pools small enough to force LRU
evictions.  Each shard's stream then goes through the port's plain scan
``sched_many``, the fused route ``sched_many_fused`` (its plain version on the
CPU) and the JAX package's ``jax_sched.sched_many(key=None)``: every ARRIVAL
must land on the worker that shard's Python scheduler chose, and the final
state must be its ``idle_counts`` and ``conns``.  Last, ``phase_cluster``
itself runs on the CPU at this size with the card's calls stubbed.
"""

import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

from repro.core import jax_sched
from repro_torch import core

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

F = 40
SMALL = dict(n_shards=2, n_workers=32, n_vus=120, duration_s=20.0, mem_pool_mb=900.0, seed=3)


def _record(driver):
    a = SMALL
    return chip_smoke.record_cluster_streams(
        np, core, driver, a["n_shards"], a["n_workers"], a["n_vus"], a["duration_s"],
        a["seed"], mem_pool_mb=a["mem_pool_mb"])


@pytest.fixture(scope="module", params=chip_smoke.CLUSTER_DRIVERS)
def recorded(request):
    streams, run, _ = _record(request.param)
    assert len(run.records) > 0
    return request.param, streams, run


def _check(events, chosen, sched, W, ws, warm, idle, conns):
    arrival = events[:, 0] == core.ARRIVAL
    bad = np.flatnonzero(arrival & (ws != chosen))
    assert not len(bad), f"first diverging event {bad[0]}: {events[bad[0]]}, " \
                         f"array {ws[bad[0]]}, Python {chosen[bad[0]]}"
    assert int(warm[arrival].sum()) == sched.pull_hits
    want_idle, want_conns = chip_smoke.python_state(np, sched, F, W)
    assert np.array_equal(idle, want_idle) and np.array_equal(conns, want_conns)


def test_each_shard_stream_has_every_kind_and_both_arrival_routes(recorded):
    _, streams, run = recorded
    assert len(streams) == SMALL["n_shards"]
    assert [W for *_, W in streams] == core.shard.split_even(SMALL["n_workers"],
                                                              SMALL["n_shards"])
    for events, chosen, sched, W in streams:
        kinds = events[:, 0]
        assert {int(k) for k in np.unique(kinds)} == {core.ARRIVAL, core.FINISH, core.EVICT}
        arrival = kinds == core.ARRIVAL
        assert (events[arrival, 2] == -1).all() and (chosen[arrival] >= 0).all()
        assert (chosen[arrival] < W).all() and (chosen[~arrival] == -1).all()
        assert sched.pull_hits > 0 and sched.fallback_assigns > 0
        assert int(arrival.sum()) == sched.pull_hits + sched.fallback_assigns
    # the recorded shards made the run: one FINISH per record
    finishes = sum(int((e[:, 0] == core.FINISH).sum()) for e, _, _, _ in streams)
    assert finishes == len(run.records)


def test_recording_leaves_the_registry_as_it_was(recorded):
    assert chip_smoke.RECORDING not in core.available_schedulers()


@pytest.mark.parametrize("driver", chip_smoke.CLUSTER_DRIVERS)
def test_recorded_run_is_the_hiku_run_with_lowest_id_ties(driver):
    """Recording is passive: the recorded run equals the same driver under a
    plain Hiku whose tie RNG is the lowest-id shim."""
    streams, run, _ = _record(driver)

    class Plain(core.HikuScheduler):
        def __init__(self, n_workers, seed=0):
            super().__init__(n_workers, seed=seed)
            self.rng = chip_smoke.LowestId()

    core.scheduler.register("hiku_lowest_id")(Plain)
    try:
        a = SMALL
        cfg = core.SimConfig(mem_pool_mb=a["mem_pool_mb"])
        if driver == "sharded":
            want = core.ShardedSimulator(a["n_shards"], a["n_workers"], scheduler="hiku_lowest_id",
                                         cfg=cfg, seed=a["seed"], backend="serial").run(
                a["n_vus"], a["duration_s"])
        else:
            want = core.AdmissionSimulator(a["n_shards"], a["n_workers"],
                                           scheduler="hiku_lowest_id", cfg=cfg, seed=a["seed"],
                                           admission=core.AdmissionConfig(policy="pull")).run(
                a["n_vus"], a["duration_s"])
    finally:
        core.scheduler._REGISTRY.pop("hiku_lowest_id", None)
    assert run.records.equals(want.records)
    assert np.array_equal(run.assign_w, want.assign_w)


def test_port_plain_scan_is_each_shards_python_scheduler(recorded):
    for events, chosen, sched, W in recorded[1]:
        s, (ws, warm) = core.sched_many(core.init_state(F, W, "cpu"), torch.from_numpy(events))
        assert core.check_invariants(s)
        _check(events, chosen, sched, W, ws.numpy(), warm.numpy(), s.idle.numpy(),
               s.conns.numpy())


@pytest.mark.parametrize("chunk", [chip_smoke.SCHED_CHUNK, 100])
def test_port_fused_route_is_each_shards_python_scheduler(recorded, chunk):
    for events, chosen, sched, W in recorded[1]:
        padded = chip_smoke.pad_events(np, events, chunk)
        s, (ws, warm) = core.sched_many_fused(core.init_state(F, W, "cpu"),
                                              torch.from_numpy(padded), chunk=chunk, device="cpu")
        n = len(events)
        assert (ws.numpy()[n:] == -1).all()
        _check(events, chosen, sched, W, ws.numpy()[:n], warm.numpy()[:n], s.idle.numpy(),
               s.conns.numpy())


def test_jax_array_form_is_each_shards_python_scheduler(recorded):
    for events, chosen, sched, W in recorded[1]:
        state, (ws, warm) = jax_sched.sched_many(jax_sched.init_state(F, W), jnp.asarray(events),
                                                 key=None)
        _check(events, chosen, sched, W, np.asarray(ws), np.asarray(warm),
               np.asarray(state.idle), np.asarray(state.conns))


def test_recorder_raises_on_a_stealing_run():
    """Stealing cancels a queued request on its victim: the array form has no
    such event, so the recorded admission tier refuses a stealing policy."""
    with chip_smoke.recording_schedulers(core):
        # the delayed-onset hot block of the stealing tests: cold VUs at t=0,
        # a sleeper block over [1, 4) s, so the shards end up unbalanced
        adm = core.AdmissionSimulator(2, 8, scheduler=chip_smoke.RECORDING,
                                      cfg=core.SimConfig(mem_pool_mb=1024.0), seed=0,
                                      admission=core.AdmissionConfig(policy="pull+steal",
                                                                     steal_watermark=1.25))
        programs = core.admission.make_sleeper_programs(
            adm.funcs, 32, core.default_n_events(14.0), 0, hot_frac=0.375, quiet_s=(3.0, 5.0))
        arrivals = np.zeros(32)
        arrivals[:12] = np.random.default_rng((0, 0xA11CE)).uniform(1.0, 4.0, 12)
        with pytest.raises(RuntimeError, match="array form"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            adm.run(32, 14.0, programs=programs, arrivals=arrivals)
    assert chip_smoke.RECORDING not in core.available_schedulers()


class _Event:
    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def test_phase_cluster_runs_on_the_cpu_at_a_small_anchor(monkeypatch):
    """``phase_cluster`` as the card runs it, here at ``SMALL`` on the CPU: the
    card's device, events and sync stubbed, the counted path a stand-in that
    checks the kernels it names and what it returns."""
    import repro_torch.core.sched as sched_mod

    monkeypatch.setattr(chip_smoke, "CLUSTER_ANCHOR", dict(SMALL))
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(sched_mod, "default_device", lambda d=None: torch.device(d or "cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: _Event())
    from repro_torch.kernels import ops

    seen = {}

    def counted(path, kernels, fn):
        seen[path] = kernels
        return fn()

    carried, bursts, row = chip_smoke.phase_cluster(torch, np, core, ops, counted,
                                                     probe=(1e-5, 1e-5))
    assert set(seen) == {"cluster"} and seen["cluster"]
    assert set(seen["cluster"]) == {k for k, b in bursts.items() if b}
    assert sum(bursts.values()) * chip_smoke.SCHED_CHUNK == row["padded"] == sum(carried.values())
    assert row["events"] == sum(d["events"] for d in row["drivers"].values())
    for d in row["drivers"].values():
        assert d["by_kind"]["EVICT"] > 0 and d["bound_ms"] > 0 and d["ms"] == 1.0  # the stubbed events
