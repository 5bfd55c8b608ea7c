"""The metrics that read the program's own request records
(``repro_torch.serving.telemetry``): their arithmetic on synthetic rings
and runs, None wherever the ring does not match the window (or the program
keeps no ring), and one tiny run per cell on the CPU in which the window's
records are found behind the warm-up's."""

import collections
import sys
import types

import pytest

from conftest import ROOT  # noqa: F401  (puts the checkout and src on sys.path)
from hikubench import harness, program_spans, trace
from repro_torch.serving import telemetry

NEW = ["materialise_ms", "capture_ms", "capture_idle_share", "prefill_ms", "decode_step_ms"]
MS = 1_000_000  # ns


def read(name, run):
    return harness.load_metric(name).read(run)


def _run(requests, tr=None):
    cell = harness.Cell("c", {"model": {}}, types.SimpleNamespace(workers=4), {}, [], [])
    return harness.Run(cell, 10.0, 1.0, requests, tr)


def _pair(i, worker, cold, traced, t0, materialise=0, capture=0, generate=10,
          prefill=None, decode=None, replays=0):
    """A window request as the harness saw it and the program's record of
    it; spans in ms from ``t0`` (s), stamped in ns."""
    r = harness.Served(0, 100, 13, worker=worker, cold=cold, traced=traced)
    base = int(t0 * 1e9)
    spans, at = [("schedule", base, base + MS // 10)], base + MS // 10
    ex = len(spans)
    spans.append(("execute", at, None))
    for name, d in (("materialise", materialise), ("capture", capture), ("generate", generate)):
        if d or name == "generate":
            spans.append((name, at, at + d * MS))
            at += d * MS
    spans[ex] = ("execute", spans[ex][1], at)
    rec = telemetry.RequestRecord(i, "f00", worker, cold, False, spans, prefill, decode, replays)
    return r, rec


@pytest.fixture
def ring(monkeypatch):
    ring = collections.deque(maxlen=4096)
    monkeypatch.setattr(telemetry, "RING", ring)
    return ring


def _window():
    """Two untraced cold, three untraced warm, one traced cold, one traced
    warm request."""
    return [
        _pair(0, 0, True, False, 0.0, materialise=200, capture=80),
        _pair(1, 1, True, False, 1.0, materialise=220, capture=60),
        _pair(2, 0, False, False, 2.0, prefill=200.0, decode=108.0, replays=12),
        _pair(3, 1, False, False, 3.0, prefill=210.0, decode=120.0, replays=12),
        _pair(4, 2, False, False, 4.0, prefill=190.0, decode=96.0, replays=12),
        _pair(5, 3, True, True, 5.0, materialise=900, capture=400),
        _pair(6, 3, False, True, 7.0, prefill=999.0, decode=999.0, replays=12),
    ]


def test_the_means_over_untraced_requests(ring):
    pairs = _window()
    ring.extend(telemetry.RequestRecord(100 + i, "f01", 9, True) for i in range(3))  # warm-up
    ring.extend(rec for _, rec in pairs)
    run = _run([r for r, _ in pairs])
    assert read("materialise_ms", run) == pytest.approx(210.0)
    assert read("capture_ms", run) == pytest.approx(70.0)
    assert read("prefill_ms", run) == pytest.approx(200.0)
    assert read("decode_step_ms", run) == pytest.approx((9.0 + 10.0 + 8.0) / 3)
    # materialise + capture is the cold start up to the generate span
    for _, rec in pairs[:2]:
        e0, g0 = rec.span("execute")[0], rec.span("generate")[0]
        assert rec.span_ms("materialise") + rec.span_ms("capture") == pytest.approx(
            telemetry.ms(e0, g0))


def test_capture_idle_share_over_the_traced_cold_captures(ring):
    pairs = _window()
    ring.extend(rec for _, rec in pairs)
    run = _run([r for r, _ in pairs])
    cap = pairs[5][1].span("capture")
    s, t = cap[0] * 1e-9, cap[1] * 1e-9
    assert t - s == pytest.approx(0.4)
    # device busy for the first 0.1 s of the capture; an op in an untraced
    # request's capture and one in the traced warm request do not count
    gen0 = pairs[6][1].span("generate")[0] * 1e-9
    ops = [("k", s, s + 0.1), ("k", 0.25, 0.27), ("k", gen0, gen0 + 0.005)]
    tr = trace.Trace(ops, [], (s - 1.0, gen0 + 1.0))
    assert read("capture_idle_share", _run([r for r, _ in pairs], tr)) == pytest.approx(75.0)
    assert read("capture_idle_share", _run([r for r, _ in pairs], trace.Trace([], [], (0, 1)))) \
        is None
    assert read("capture_idle_share", run) is None  # no trace
    for r, _ in pairs:
        r.traced = False  # no traced cold request
    assert read("capture_idle_share", _run([r for r, _ in pairs], tr)) is None


def _set_worker(r, rec):
    r.worker = 3


def _set_cold(r, rec):
    rec.cold = not rec.cold


@pytest.mark.parametrize("spoil", [_set_worker, _set_cold], ids=["worker", "cold"])
def test_none_where_a_record_does_not_match(ring, spoil):
    pairs = _window()
    ring.extend(rec for _, rec in pairs)
    spoil(*pairs[2])
    run = _run([r for r, _ in pairs], trace.Trace([("k", 0.0, 1e10)], [], (0.0, 1e10)))
    assert all(read(name, run) is None for name in NEW)


def test_none_where_the_ring_is_short_or_the_program_keeps_none(ring, monkeypatch):
    pairs = _window()
    ring.extend(rec for _, rec in pairs[1:])
    run = _run([r for r, _ in pairs])
    assert program_spans.window_records(run) is None
    assert all(read(name, run) is None for name in NEW)
    ring.appendleft(pairs[0][1])
    assert program_spans.window_records(run) == [rec for _, rec in pairs]
    # a program without the module (the parent of the change that added it)
    import repro_torch.serving

    monkeypatch.delattr(repro_torch.serving, "telemetry")
    monkeypatch.setitem(sys.modules, "repro_torch.serving.telemetry", None)
    assert all(read(name, run) is None for name in NEW)


@pytest.fixture
def runs(monkeypatch):
    """The ``Run`` objects ``run_cell`` hands the metrics."""
    made = []

    class Kept(harness.Run):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    return made


@pytest.mark.parametrize("name", ["minicpm-2b.azure40", "minicpm-2b.warm4"])
def test_a_tiny_run_finds_the_windows_records(tiny_root, runs, name):
    cell = harness.load_cell(name, tiny_root)
    res = harness.run_cell(cell, 2**31 + 11, 1.0, True, "cpu", 0.0)
    assert res["correct"]
    run, = runs
    recs = program_spans.window_records(run)
    assert recs is not None and len(recs) == len(run.requests)
    assert [rec.func for rec in recs] == [f"f{r.func:02d}" for r in run.requests]
    ring = list(telemetry.RING)
    assert ring[-len(recs) - 1].id < recs[0].id  # the warm-up's last record comes before
    mine = {m["name"] for m in cell.per_layer} & set(NEW)
    if name.endswith("azure40"):
        assert mine == {"materialise_ms", "capture_ms", "capture_idle_share"}
        cold = [rec for r, rec in zip(run.requests, recs) if r.cold and not r.traced]
        assert cold
        assert res["metrics"]["materialise_ms"]["value"] == pytest.approx(
            sum(rec.span_ms("materialise") for rec in cold) / len(cold))
        assert res["metrics"]["capture_ms"]["value"] >= 0
        assert res["metrics"]["cold_init_ms"]["value"] >= (
            res["metrics"]["materialise_ms"]["value"] + res["metrics"]["capture_ms"]["value"])
        assert "capture_idle_share" not in res["metrics"]  # no device operations on the CPU
    else:
        assert mine == {"prefill_ms", "decode_step_ms"}
        assert not {"prefill_ms", "decode_step_ms"} & set(res["metrics"])  # no card
        warm = [rec for r, rec in zip(run.requests, recs) if not r.cold and not r.traced]
        assert warm
        for i, rec in enumerate(warm):  # the card's intervals, as the program writes them
            rec.prefill_ms, rec.decode_ms, rec.replays = 200.0 + i, 60.0, 5
        assert read("prefill_ms", run) == pytest.approx(200.0 + (len(warm) - 1) / 2)
        assert read("decode_step_ms", run) == pytest.approx(12.0)
