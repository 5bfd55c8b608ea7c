"""Hypothesis property tests for the port's event plane and burst-adaptive
dispatch: the cases of ``tests/test_autoscale_properties.py`` on the port's
modules.  The adaptive dispatch case runs the port's ``sched_many_adaptive``
on CPU tensors against its plain scan ``sched_many`` (the reference's case
runs the Pallas kernel in interpret mode, which does not trace under this
JAX); the event-plane case also holds the port's delivery log equal to the
JAX package's for the same seeded publish sequence.
"""

import numpy as np
import pytest
import torch_test_threads  # noqa: F401  (shares the cores among test workers)
import torch

pytest.importorskip("hypothesis")  # optional dep: skip only the property tests
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import (  # noqa: E402
    ARRIVAL,
    BurstDetector,
    EventPlane,
    init_state,
    sched_many,
    sched_many_adaptive,
)
from repro_torch.core.eventplane import CLUSTER_TOPIC, SHARD_TOPIC  # noqa: E402
from repro.core import eventplane as ref_eventplane
from repro_torch.core import EventPlane as PortEventPlane  # noqa: E402

pytestmark = pytest.mark.shard

N_FUNCS, N_WORKERS = 6, 9


def _mixed_events(rng, n, n_funcs=N_FUNCS, n_workers=N_WORKERS):
    """Random arrival/finish/evict stream (same shape as tests/
    test_scheduler.py): worker ids only matter for non-arrival kinds."""
    events = []
    for _ in range(n):
        k = int(rng.integers(0, 3))
        events.append(
            (k, int(rng.integers(0, n_funcs)),
             -1 if k == ARRIVAL else int(rng.integers(0, n_workers)))
        )
    return torch.tensor(events, dtype=torch.int32).reshape(-1, 3)


@settings(max_examples=50, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    n_samples=st.integers(1, 12),
    alpha=st.floats(0.05, 1.0),
    n_rows=st.integers(1, 4),
)
def test_burst_detector_chunk_monotone_in_density(seed, n_samples, alpha, n_rows):
    """Feed two streams where one pointwise dominates the other: the EWMA
    (linear, positive weights) dominates too, so with a threshold table
    whose chunks grow with density the chosen chunk never shrinks."""
    rng = np.random.default_rng(seed)
    # density-descending AND chunk-descending rows: monotone table
    dens = np.sort(rng.uniform(1.0, 1000.0, n_rows))[::-1]
    chunks = np.sort(rng.integers(2, 4096, n_rows))[::-1]
    table = tuple((float(d), int(c)) for d, c in zip(dens, chunks))
    lo = rng.uniform(0.0, 1500.0, n_samples)
    hi = lo + rng.uniform(0.0, 500.0, n_samples)  # pointwise >= lo
    det_lo = BurstDetector(alpha=alpha, thresholds=table, base_chunk=1)
    det_hi = BurstDetector(alpha=alpha, thresholds=table, base_chunk=1)
    for a, b in zip(lo, hi):
        c_lo, c_hi = det_lo.observe(float(a)), det_hi.observe(float(b))
        assert det_hi.ewma >= det_lo.ewma
        assert c_hi >= c_lo


@settings(max_examples=50, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    n_shards=st.integers(1, 5),
    n_events=st.integers(1, 80),
    patterns=st.lists(
        st.sampled_from(
            [
                (SHARD_TOPIC, "*"),
                (SHARD_TOPIC, 0),
                (SHARD_TOPIC, 2),
                (CLUSTER_TOPIC,),
                (CLUSTER_TOPIC, "*"),  # wrong arity: matches nothing
            ]
        ),
        min_size=0,
        max_size=6,
    ),
)
def test_delivery_log_pure_function_of_seed_and_subscriptions(
    seed, n_shards, n_events, patterns
):
    """Two buses with the same subscription list, fed the same seeded
    publish sequence, produce identical delivery logs and identical
    per-subscriber event streams — delivery order is never a function of
    anything but (seed, subscriptions)."""

    def build():
        bus = EventPlane()
        seen = [[] for _ in patterns]
        for sink, pattern in zip(seen, patterns):
            bus.subscribe(
                pattern,
                lambda ev, sink=sink: sink.append(
                    (ev.seq, ev.topic, ev.window, dict(ev.payload))
                ),
            )
        rng = np.random.default_rng(seed)
        for i in range(n_events):
            k = int(rng.integers(0, n_shards + 1))
            topic = (SHARD_TOPIC, k) if k < n_shards else (CLUSTER_TOPIC,)
            bus.publish(topic, i, float(i), float(i + 1),
                        {"n_done": int(rng.integers(0, 100))})
        return bus, seen

    bus_a, seen_a = build()
    bus_b, seen_b = build()
    assert bus_a.log == bus_b.log
    assert seen_a == seen_b
    assert (bus_a.published, bus_a.delivered) == (bus_b.published, bus_b.delivered)
    # the log is exactly the per-subscriber streams, interleaved in seq
    # order with registration order breaking ties
    rebuilt = [
        (seq, topic, window, sub_id)
        for sub_id, stream in enumerate(seen_a)
        for (seq, topic, window, _payload) in stream
    ]
    rebuilt.sort(key=lambda r: (r[0], r[3]))
    assert rebuilt == bus_a.log


@settings(max_examples=20, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    n=st.integers(1, 120),
    threshold=st.floats(1.0, 1000.0),
    chunk=st.integers(2, 64),
    alpha=st.floats(0.05, 1.0),
    segment=st.integers(1, 90),
)
def test_adaptive_dispatch_bitwise_equals_scan(
    seed, n, threshold, chunk, alpha, segment
):
    """Whatever chunk sizes the detector picks window by window — including
    mid-stream switches and ragged tails — the adaptive dispatch result is
    bitwise the scan's: the detector is a pure observer."""
    rng = np.random.default_rng(seed)
    ev = _mixed_events(rng, n)
    n_windows = -(-n // segment)  # ceil: one density sample per window
    densities = rng.uniform(0.0, 2.0 * threshold, n_windows).tolist()
    det = BurstDetector(
        alpha=alpha, thresholds=((threshold, chunk),), base_chunk=1
    )
    s1, (ws1, warm1) = sched_many(init_state(N_FUNCS, N_WORKERS, "cpu"), ev)
    s2, (ws2, warm2) = sched_many_adaptive(
        init_state(N_FUNCS, N_WORKERS, "cpu"), ev, det, densities=densities,
        segment=segment, device="cpu",
    )
    assert torch.equal(ws1, ws2) and torch.equal(warm1, warm2)
    assert torch.equal(s1.idle, s2.idle) and torch.equal(s1.conns, s2.conns)


# ----------------------------------------------- parity with the JAX package
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n_pub=st.integers(0, 60),
       subs=st.lists(st.sampled_from(["shard*", "shard0", "shard2", "cluster"]),
                     min_size=1, max_size=5))
def test_delivery_log_equals_the_reference(seed, n_pub, subs):
    def build(plane_cls, mod):
        bus = plane_cls()
        pats = {"shard*": (mod.SHARD_TOPIC, "*"), "shard0": (mod.SHARD_TOPIC, 0),
                "shard2": (mod.SHARD_TOPIC, 2), "cluster": (mod.CLUSTER_TOPIC,)}
        for s in subs:
            bus.subscribe(pats[s], lambda ev: None)
        rng = np.random.default_rng(seed)
        for i in range(n_pub):
            k = int(rng.integers(0, 4))
            topic = (mod.SHARD_TOPIC, k) if k < 3 else (mod.CLUSTER_TOPIC,)
            bus.publish(topic, i, float(i), float(i + 1), {"v": float(rng.random())})
        return bus

    from repro_torch.core import eventplane as port_eventplane

    a = build(PortEventPlane, port_eventplane)
    b = build(ref_eventplane.EventPlane, ref_eventplane)
    assert a.log == b.log
    assert (a.published, a.delivered) == (b.published, b.delivered)
