"""The port's streaming shard merge (``ShardedSimulator.run_stream`` and
``shard._stream_windows``): the sharded cases of ``tests/test_stream.py`` on
the port's modules (the stepped-clock and record-store cases build no shard
and live in ``tests/test_torch_simulator.py``), the window-boundary tie
through ``_stream_windows`` itself, and parity with the JAX package — the
chunks of every backend and window width, and their windowed metrics, equal
the reference's.
"""

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)

from repro_torch.core import (
    RecordAccumulator,
    summarize,
    summarize_window,
    summarize_windows,
)
from repro_torch.core.shard import ShardedSimulator
from test_torch_cluster_cases import same

pytestmark = pytest.mark.shard

K, W, VUS, DUR, WIN = 3, 9, 18, 15.0, 1.5


def _drain_stream(backend, window_s=WIN, **kw):
    driver = ShardedSimulator(K, W, scheduler="hiku", seed=5, backend=backend)
    acc = RecordAccumulator()
    ats, aws, chunks = [], [], []
    for ch in driver.run_stream(n_vus=VUS, duration_s=DUR, window_s=window_s, **kw):
        acc.extend(ch.records)
        ats.append(ch.assign_t)
        aws.append(ch.assign_w)
        chunks.append(ch)
    return acc.columns(), np.concatenate(ats), np.concatenate(aws), chunks


@pytest.mark.parametrize("backend", ["serial", "interleaved", "process"])
def test_stream_byte_identical_to_batch_merge(backend):
    """Concatenated stream chunks == batch-merged run, per backend."""
    batch = ShardedSimulator(K, W, scheduler="hiku", seed=5, backend=backend).run(
        n_vus=VUS, duration_s=DUR
    )
    got, at, aw, chunks = _drain_stream(backend)
    assert len(batch.records) > 0
    assert got.equals(batch.records)
    assert np.array_equal(at, batch.assign_t)
    assert np.array_equal(aw, batch.assign_w)
    # chunks tile the stream: windows are (t_lo, t_hi], boundaries contiguous
    for a, b in zip(chunks, chunks[1:]):
        assert a.t_hi == b.t_lo
    for ch in chunks:
        if len(ch.records):
            assert ch.records.t_done.min() > ch.t_lo or ch.index == 0
            assert ch.records.t_done.max() <= ch.t_hi
        assert int(ch.shard_counts.sum()) == len(ch.records)


def test_stream_windows_independent_of_window_size():
    """The merged stream is the same whatever the window width."""
    a = _drain_stream("serial", window_s=0.7)[0]
    b = _drain_stream("serial", window_s=4.0)[0]
    assert a.equals(b)


def test_windowed_metrics_match_batch_slices():
    """summarize_window over live stream chunks == summarize_windows over the
    completed merged run: same windows, same float values (tolerance 0)."""
    batch = ShardedSimulator(K, W, scheduler="hiku", seed=5, backend="serial").run(
        n_vus=VUS, duration_s=DUR
    )
    ref = summarize_windows(
        batch.records, (batch.assign_t, batch.assign_w), batch.workers, WIN, DUR
    )
    stream = ShardedSimulator(
        K, W, scheduler="hiku", seed=5, backend="interleaved"
    ).run_stream(n_vus=VUS, duration_s=DUR, window_s=WIN)
    got = [
        (
            ch.t_hi,
            summarize_window(
                ch.records, (ch.assign_t, ch.assign_w), batch.workers, ch.t_lo, ch.t_hi
            ),
        )
        for ch in stream
    ]
    assert len(ref) == len(got) > 1
    for (t1, m1), (t2, m2) in zip(ref, got):
        assert t1 == t2
        assert m1 == m2  # dataclass equality: float-for-float identical
    # windows tile the run: per-window counts sum to the full-run count
    full = summarize(batch.records, (batch.assign_t, batch.assign_w), batch.workers, DUR)
    assert sum(m.n_requests for _, m in got) == full.n_requests


def test_stream_on_explicit_programs():
    """Streaming honors an explicit global VU population (trace-driven path)."""
    from repro_torch.core import make_functions, make_vu_programs

    programs = make_vu_programs(make_functions(seed=0), VUS, 64, 99)
    batch = ShardedSimulator(K, W, scheduler="hiku", seed=5, backend="serial").run(
        n_vus=VUS, duration_s=DUR, programs=programs
    )
    got = _drain_stream("serial", programs=programs)[0]
    assert len(got) and got.equals(batch.records)


def test_window_boundary_tie_lands_in_exactly_one_window():
    """A completion (or assignment) at exactly ``t == t_hi`` belongs to that
    window and never reappears in the next: windows are ``(t_lo, t_hi]``
    half-open, so boundary ties are read once (the bisect_right cursor)."""
    from types import SimpleNamespace

    from repro_torch.core.shard import _stream_windows, _StreamCursor

    td = [1.5, 3.0]  # both exactly on a WIN=1.5 window edge
    cols = ([1.0, 2.0], td, [0, 1], [0, 1], [False, True], [0, 1], [False, False])
    cur = _StreamCursor(td, cols, [1.5, 3.0], [0, 1])
    spec = SimpleNamespace(worker_offset=0, vu_offset=0)
    chunks = list(_stream_windows([spec], [cur], duration_s=3.0, window_s=1.5))
    assert [ch.index for ch in chunks] == [0, 1]
    assert chunks[0].records.t_done.tolist() == [1.5]  # tie -> its own window
    assert chunks[1].records.t_done.tolist() == [3.0]
    assert chunks[0].assign_t.tolist() == [1.5]
    assert chunks[1].assign_t.tolist() == [3.0]
    assert sum(len(ch.records) for ch in chunks) == 2  # once each, no dupes


def test_stream_bus_summaries_match_batch_on_every_backend():
    """§14 parity: the bus-published per-window summaries are a pure
    function of the run — identical across backends, per-shard counts
    summing to the batch merge, cluster counts matching the chunks."""
    from repro_torch.core import EventPlane

    batch = ShardedSimulator(K, W, scheduler="hiku", seed=5, backend="serial").run(
        n_vus=VUS, duration_s=DUR
    )
    streams = {}
    for backend in ("serial", "interleaved", "process"):
        bus = EventPlane()
        events = []
        bus.subscribe(("shard", "*"), events.append)
        bus.subscribe(("cluster",), events.append)
        chunks = list(
            ShardedSimulator(K, W, scheduler="hiku", seed=5, backend=backend)
            .run_stream(n_vus=VUS, duration_s=DUR, window_s=WIN, bus=bus)
        )
        streams[backend] = [
            (ev.topic, ev.window, dict(ev.payload)) for ev in events
        ]
        # cluster events reconcile against the chunks they summarize
        cluster = [ev for ev in events if ev.topic == ("cluster",)]
        assert [ev.payload["n_done"] for ev in cluster] == [
            len(ch.records) for ch in chunks
        ]
        assert sum(ev.payload["n_done"] for ev in cluster) == len(batch.records)
        # per-shard counts sum to the batch merge, shard by shard
        per_shard = np.zeros(K, np.int64)
        for ev in events:
            if ev.topic[0] == "shard":
                per_shard[ev.topic[1]] += ev.payload["n_done"]
        assert int(per_shard.sum()) == len(batch.records)
    assert streams["serial"] == streams["interleaved"] == streams["process"]


# ----------------------------------------------- parity with the JAX package
def _chunks(core, backend, window_s, programs=False):
    kw = {}
    if programs:
        kw["programs"] = core.make_vu_programs(core.make_functions(seed=0), VUS, 64, 99)
    driver = core.ShardedSimulator(K, W, scheduler="hiku", seed=5, backend=backend)
    chunks = list(driver.run_stream(n_vus=VUS, duration_s=DUR, window_s=window_s, **kw))
    metrics = [
        core.summarize_window(ch.records, (ch.assign_t, ch.assign_w), list(range(W)),
                              ch.t_lo, ch.t_hi)
        for ch in chunks
    ]
    return chunks, metrics


@pytest.mark.parametrize("backend", ["serial", "interleaved", "process"])
@pytest.mark.parametrize("window_s", [0.7, WIN, 4.0])
def test_stream_chunks_equal_the_reference(backend, window_s):
    chunks, _ = same(lambda core: _chunks(core, backend, window_s))
    assert sum(len(ch.records) for ch in chunks) > 0


def test_stream_on_explicit_programs_equals_the_reference():
    chunks, _ = same(lambda core: _chunks(core, "serial", WIN, programs=True))
    assert len(chunks) > 1
