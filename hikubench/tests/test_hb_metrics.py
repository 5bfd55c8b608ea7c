"""The metrics' arithmetic on synthetic runs and timelines: latency over
every request of a window, the device's idle share over the union of the
requests' spans, and shares of a peak that declare it and stay at or under
100 % for a time at the bound."""

import json
import types

import pytest

from conftest import ROOT
from hikubench import counts, harness, trace

CONFIGS = {p.stem: json.loads(p.read_text())
           for p in (ROOT / "hikubench" / "configs").glob("*.json")}


def _run(requests, tr=None, config="minicpm-2b", seconds=10.0):
    cfg = CONFIGS[config]
    cell = harness.Cell("c", cfg, types.SimpleNamespace(workers=4), {}, [], [])
    return harness.Run(cell, seconds, 1.0, requests, tr)


def _served(n, service=0.1, gap=1.0, **kw):
    return [harness.Served(0, 431, 16, due_s=i * gap, start_s=i * gap,
                           end_s=i * gap + service, **kw) for i in range(n)]


def read(name, run):
    return harness.load_metric(name).read(run)


def test_latency_metrics_take_every_request():
    reqs = _served(20)
    base_p90, base_mean = read("request_p90_ms", _run(reqs)), read("request_mean_ms", _run(reqs))
    assert base_p90 == pytest.approx(100.0) and base_mean == pytest.approx(100.0)
    # a stall of 3 s in request 10 delays it and the three due while it ran
    reqs[10].end_s += 3.0
    for prev, r in zip(reqs[10:], reqs[11:]):
        r.start_s = max(r.due_s, prev.end_s)
        r.end_s = r.start_s + 0.1
    assert read("request_mean_ms", _run(reqs)) > base_mean + 200
    assert read("request_p90_ms", _run(reqs)) > base_p90 + 1000


def test_queue_wait_and_cold_metrics():
    reqs = _served(4, cold=False)
    reqs[1].start_s += 0.5
    reqs[2].cold, reqs[2].built, reqs[2].init_ms = True, 1, 300.0
    for r in reqs:
        r.exec_ms = 100.0
    run = _run(reqs)
    assert read("queue_wait_ms", run) == pytest.approx(125.0)
    assert read("cold_start_pct", run) == pytest.approx(25.0)
    assert read("cold_init_ms", run) == pytest.approx(300.0)
    assert read("warm_exec_ms", run) == pytest.approx(100.0)
    reqs[2].traced = True  # host-clock layer metrics leave traced requests out
    assert read("cold_init_ms", _run(reqs)) is None


def test_load_cv_is_zero_when_every_worker_gets_the_same():
    reqs = _served(8, gap=0.25)
    for i, r in enumerate(reqs):
        r.worker = i % 4
    assert read("load_cv", _run(reqs, seconds=2.0)) == pytest.approx(0.0)
    for r in reqs:
        r.worker = 0
    assert read("load_cv", _run(reqs, seconds=2.0)) == pytest.approx(3 ** 0.5)


def test_idle_share_over_the_union_of_spans():
    ops = [("k", 0.0, 1.0), ("k", 0.5, 1.5), ("k", 3.0, 3.5), ("k", 9.0, 9.5)]
    spans = [("request", 0.0, 2.0), ("request", 1.0, 2.0), ("request", 3.0, 4.0)]
    tr = trace.Trace(ops, spans, (0.0, 10.0))
    # requests cover [0, 2] and [3, 4]: 3 s, busy in them 1.5 + 0.5 s; the op at 9 s
    # falls in an arrival gap and does not count
    assert trace.idle_share(tr, trace.span_intervals(tr, "request")) == pytest.approx(1 / 3)
    assert trace.busy(tr) == pytest.approx(2.5)
    run = _run([], tr)
    assert read("device_idle_share", run) == pytest.approx(100 / 3)
    gaps = dict(trace.idle_gaps(tr))
    assert gaps["request"] == pytest.approx(1.0) and gaps["outside"] == pytest.approx(6.5)


def test_kernel_names_and_top_ops():
    tr = trace.Trace([("void flash_attention_kernel<float, 64>(float const*)", 0.0, 1.0),
                      ("Memcpy HtoD (Pageable -> Device)", 1.0, 1.5)], [], (0.0, 2.0))
    assert trace.top_ops(tr) == [["flash_attention_kernel", 1.0], ["Memcpy HtoD", 0.5]]
    assert trace.kernel_seconds(tr, "flash_attention_kernel", [(0.0, 0.5)]) == (1.0, 1)
    assert trace.kernel_seconds(tr, "flash_attention_kernel", [(0.5, 2.0)]) == (0.0, 0)


def test_counts_are_functions_of_shapes_alone():
    for cfg in CONFIGS.values():
        m = cfg["model"]
        a = counts.request_flops(m, 431, 16, 2048)
        assert a == counts.request_flops(dict(m), 431, 16, 2048) > 0
        assert counts.request_flops(m, 862, 16, 2048) > a
        work = counts.kernel_work(m, 431, 16, 2048)
        assert len(work["flash_attention"]) == counts.attention_calls(m)
        assert len(work["decode_attention"]) == 15 * counts.attention_calls(m)
        assert set(work) == {"flash_attention", "decode_attention"}
    assert counts.flash_counts(1, 4, 2, 2, 8, True, None, 4) == (4 * 2 * 16 * 4 * 2, 32 * 2 * 10)
    assert counts.decode_counts(16, 2, 2, 8, [3], None, 4, 4)[1] == 4 * 8 * 2 * 4


def test_shares_declare_their_peak():
    assert counts.PEAK_F32_OPS_PER_S == 495e12 and counts.PEAK_BYTES_PER_S == 3.35e12
    for name in ("flash_attention_roofline", "decode_attention_roofline", "exec_mfu"):
        src = (ROOT / "hikubench" / "metrics" / f"{name}.py").read_text()
        assert "495 TFLOP/s" in src


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention"])
def test_roofline_is_at_most_100_at_the_bound(kernel):
    """A trace whose kernel time equals the counted bound reads 100 %; any
    longer time reads less."""
    config = "minicpm-2b"
    m = CONFIGS[config]["model"]
    mod = harness.load_metric(f"{kernel}_roofline")
    r = harness.Served(0, 300, 16, traced=True)
    least = sum(counts.bound_s(b, o) for b, o in counts.kernel_work(m, 300, 16, 2048)[kernel])
    name = {"flash_attention": "void flash_attention_kernel<float, 64>()",
            "decode_attention": "void decode_kernel<float>()"}[kernel]
    for slack in (1.0, 1.7):
        tr = trace.Trace([(name, 1.0, 1.0 + least * slack)], [("generate", 0.0, 5.0)],
                         (0.0, 5.0))
        share = mod.read(_run([r], tr, config))
        assert share == pytest.approx(100.0 / slack)
    assert mod.read(_run([r], trace.Trace([], [("generate", 0.0, 5.0)], (0.0, 5.0)),
                         config)) is None


def test_exec_mfu_at_the_peak_is_100():
    m = CONFIGS["minicpm-2b"]["model"]
    r = harness.Served(0, 1500, 13)
    r.exec_ms = counts.request_flops(m, 1500, 13, 2048) / counts.PEAK_F32_OPS_PER_S * 1e3
    assert read("exec_mfu", _run([r], None, "minicpm-2b")) == pytest.approx(100.0)
