"""Algorithm 1 on the simulator's own decision stream: the CPU half of the
``sim`` phase of ``chip_smoke.py``.

The port's simulator runs a small cluster under ``chip_smoke.recording_hiku``
(the port's ``HikuScheduler`` with the lowest-id tie order, ``choice`` and
``randrange`` both, logging every callback as an event), with a memory pool
small enough to force LRU evictions.  The logged stream then goes through the
port's plain scan ``sched_many``, the fused route ``sched_many_fused`` (its
plain version on the CPU) and the JAX package's ``jax_sched.sched_many(key=
None)``: every ARRIVAL must land on the worker the Python scheduler chose,
and the final state must be its ``idle_counts`` and ``conns``."""

import sys
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

F, W, VUS, DUR, POOL = 40, 8, 60, 20.0, 900.0


@pytest.fixture(scope="module")
def stream():
    events, chosen, sched, sim, recs, _ = chip_smoke.record_sim_stream(
        np, core, W, VUS, DUR, seed=3, mem_pool_mb=POOL)
    assert len(sim.funcs) == F and recs
    return events, chosen, sched


def test_stream_has_every_kind_and_both_arrival_routes(stream):
    events, chosen, sched = stream
    kinds = events[:, 0]
    assert {int(k) for k in np.unique(kinds)} == {core.ARRIVAL, core.FINISH, core.EVICT}
    arrival = kinds == core.ARRIVAL
    assert (events[arrival, 2] == -1).all() and (chosen[arrival] >= 0).all()
    assert (chosen[~arrival] == -1).all()
    assert sched.pull_hits > 0 and sched.fallback_assigns > 0
    assert int(arrival.sum()) == sched.pull_hits + sched.fallback_assigns


def _check(events, chosen, sched, ws, warm, idle, conns):
    arrival = events[:, 0] == core.ARRIVAL
    bad = np.flatnonzero(arrival & (ws != chosen))
    assert not len(bad), f"first diverging event {bad[0]}: {events[bad[0]]}, " \
                         f"array {ws[bad[0]]}, Python {chosen[bad[0]]}"
    assert int(warm[arrival].sum()) == sched.pull_hits
    want_idle, want_conns = chip_smoke.python_state(np, sched, F, W)
    assert np.array_equal(idle, want_idle) and np.array_equal(conns, want_conns)


def test_port_plain_scan_is_the_python_scheduler(stream):
    events, chosen, sched = stream
    s, (ws, warm) = core.sched_many(core.init_state(F, W, "cpu"), torch.from_numpy(events))
    assert core.check_invariants(s)
    _check(events, chosen, sched, ws.numpy(), warm.numpy(), s.idle.numpy(), s.conns.numpy())


@pytest.mark.parametrize("chunk", [1024, 100])
def test_port_fused_route_is_the_python_scheduler(stream, chunk):
    events, chosen, sched = stream
    padded = chip_smoke.pad_events(np, events, chunk)
    assert len(padded) % chunk == 0 and (padded[len(events):, 0] == 3).all()
    s, (ws, warm) = core.sched_many_fused(core.init_state(F, W, "cpu"),
                                          torch.from_numpy(padded), chunk=chunk, device="cpu")
    n = len(events)
    assert (ws.numpy()[n:] == -1).all()
    _check(events, chosen, sched, ws.numpy()[:n], warm.numpy()[:n], s.idle.numpy(),
           s.conns.numpy())


def test_jax_array_form_is_the_python_scheduler(stream):
    events, chosen, sched = stream
    state, (ws, warm) = jax_sched.sched_many(jax_sched.init_state(F, W), jnp.asarray(events),
                                             key=None)
    _check(events, chosen, sched, np.asarray(ws), np.asarray(warm), np.asarray(state.idle),
           np.asarray(state.conns))


def test_recorder_refuses_events_the_array_form_lacks():
    sched = chip_smoke.recording_hiku(core, 3)
    for call in (lambda: sched.on_cancel(0, "f"), lambda: sched.on_worker_added(5),
                 lambda: sched.on_worker_removed(1)):
        with pytest.raises(RuntimeError, match="array form"):
            call()


def test_lowest_id_shim_is_the_array_tie_order():
    """Ties: the Python fallback with the shim and the array form both take the
    lowest id among the least-loaded workers."""
    sched = chip_smoke.recording_hiku(core, 4)
    sched.index = {"f": 0}
    assert [sched.schedule("f") for _ in range(6)] == [0, 1, 2, 3, 0, 1]
    events = torch.tensor([[core.ARRIVAL, 0, -1]] * 6, dtype=torch.int32)
    _, (ws, _) = core.sched_many(core.init_state(1, 4, "cpu"), events)
    assert ws.tolist() == [0, 1, 2, 3, 0, 1]
