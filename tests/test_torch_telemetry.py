"""The serving path's own request records (``serving/telemetry.py``) on the
CPU, with the tiny mamba2 endpoints of tests/test_torch_serving.py: one
record a request with its spans nested in order, a bounded ring, the
engine's and the worker's numbers as differences of the record's stamps,
a failed request's record, and the stamps on ``torch.profiler``'s clock."""

import collections

import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

from repro_torch.serving import Instance, ServingEngine, WorkerHost, telemetry
from test_torch_serving import _tiny_endpoint

TOKENS = torch.ones((1, 8), dtype=torch.int32)


def _engine():
    eps = [_tiny_endpoint(f"f{i}", seed=i) for i in range(3)]
    return ServingEngine(eps, n_workers=2, scheduler="hiku", keep_alive_s=600.0, device="cpu")


def _inside(inner, outer):
    return outer[0] <= inner[0] <= inner[1] <= outer[1]


def test_one_record_per_submit_with_spans_nested_in_order(monkeypatch):
    eng = _engine()
    ring = collections.deque(maxlen=3)
    monkeypatch.setattr(telemetry, "RING", ring)
    results = [eng.submit(f, TOKENS, 3) for f in ("f0", "f0", "f1", "f0", "f2")]
    assert len(ring) == 3  # bounded: the last three requests'
    assert [rec.id for rec in ring] == [r.record.id for r in results[2:]]
    ids = [r.record.id for r in results]
    assert ids == sorted(set(ids))
    assert telemetry.RING is ring and telemetry.current() is None
    for res in results:
        rec = res.record
        assert (rec.func, rec.worker, rec.cold, rec.failed) == (res.func, res.worker, res.cold,
                                                                False)
        want = ["schedule", "execute"] + (["materialise", "capture"] if res.cold else []) + \
            ["generate"]
        assert [n for n, _, _ in rec.spans] == want
        starts = [s for _, s, _ in rec.spans]
        assert starts == sorted(starts) and all(s <= t for _, s, t in rec.spans)
        ex = rec.span("execute")
        assert rec.span("schedule")[1] <= ex[0]
        for name in want[2:]:
            assert _inside(rec.span(name), ex)
        if res.cold:
            assert rec.span("materialise")[1] <= rec.span("capture")[0]
            assert rec.span("capture")[1] <= rec.span("generate")[0]
        assert (rec.prefill_ms, rec.decode_ms, rec.replays) == (None, None, 0)  # CPU
    assert [r.cold for r in results] == [True, False, True, False, True]


def test_the_ring_holds_at_least_4096_records():
    assert telemetry.RING.maxlen >= 4096


def test_reported_numbers_are_differences_of_the_stamps():
    eng = _engine()
    for f in ("f0", "f0"):
        res = eng.submit(f, TOKENS, 3)
        rec = res.record
        s0, s1 = rec.span("schedule")
        e0, _ = rec.span("execute")
        g0, g1 = rec.span("generate")
        assert res.sched_overhead_ms == (s1 - s0) / 1e6
        init_ms = (g0 - e0) / 1e6 if res.cold else 0.0
        assert res.latency_ms == init_ms + (g1 - g0) / 1e6
    # the worker on its own opens the record itself
    host = WorkerHost(0, device="cpu")
    ep = _tiny_endpoint("h")
    n = len(telemetry.RING)
    for cold in (True, False):
        er = host.execute(ep, TOKENS, 2)
        rec = telemetry.RING[-1]
        assert len(telemetry.RING) == min(n + 1 + (not cold), telemetry.RING.maxlen)
        assert er.cold == rec.cold == cold and rec.worker == 0 and rec.func == "h"
        e0, e1 = rec.span("execute")
        g0, g1 = rec.span("generate")
        assert er.init_ms == ((g0 - e0) / 1e6 if cold else 0.0)
        assert er.exec_ms == (g1 - g0) / 1e6
        assert rec.spans[0][0] == "execute" and rec.span("schedule") is None


def test_a_request_that_raises_leaves_a_failed_record(monkeypatch):
    eng = _engine()
    eng.submit("f0", TOKENS, 2)

    def broken(self, tokens, gen_len=4):
        with telemetry.span("generate"):
            raise RuntimeError("out of memory")

    monkeypatch.setattr(Instance, "generate", broken)
    with pytest.raises(RuntimeError, match="out of memory"):
        eng.submit("f0", TOKENS, 2)
    rec = telemetry.RING[-1]
    assert rec.failed and rec.func == "f0" and not rec.cold and rec.worker >= 0
    assert [n for n, _, _ in rec.spans] == ["schedule", "execute", "generate"]
    assert all(t is not None and s <= t for _, s, t in rec.spans)
    assert telemetry.current() is None
    with pytest.raises(RuntimeError):  # the worker on its own
        WorkerHost(1, device="cpu").execute(_tiny_endpoint("g"), TOKENS, 2)
    rec = telemetry.RING[-1]
    assert rec.failed and rec.cold and rec.func == "g" and rec.span("materialise") is not None
    assert telemetry.current() is None
    monkeypatch.undo()
    assert not eng.submit("f1", TOKENS, 2).record.failed


def test_spans_are_on_the_profilers_clock():
    """A program ``execute`` span run inside a ``record_function`` probe lies
    inside the probe's Kineto interval, within 1 ms at each end (the second
    probe: the first one in a profiler's run also pays the profiler's own
    first-call set-up, about 1 ms in a CPU run)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    host = WorkerHost(0, device="cpu")
    ep = _tiny_endpoint("p")
    host.execute(ep, TOKENS, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function("telemetry_probe"):
                host.execute(ep, TOKENS, 2)
    e0, e1 = telemetry.RING[-1].span("execute")
    probes = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "telemetry_probe")
    assert len(probes) == 2
    p0, p1 = probes[1]
    tol = 1_000_000
    assert p0 - tol <= e0 <= p0 + tol and p1 - tol <= e1 <= p1 + tol
    assert p0 - tol <= e0 < e1 <= p1 + tol
