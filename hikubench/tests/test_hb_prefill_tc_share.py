"""``prefill_tc_share``: the share of the untraced warm requests' dense
products that the program's records count on the tensor-core kernel, and
None where the records carry no such counts (a program without them)."""

import collections
import types

import pytest

from conftest import ROOT  # noqa: F401  (puts the checkout and src on sys.path)
from hikubench import harness
from repro_torch.serving import telemetry


def _run(requests):
    cell = harness.Cell("c", {"model": {}}, types.SimpleNamespace(workers=4), {}, [], [])
    return harness.Run(cell, 10.0, 1.0, requests, None)


def _served(worker, cold, traced):
    return harness.Served(0, 1500, 13, worker=worker, cold=cold, traced=traced)


@pytest.fixture
def ring(monkeypatch):
    ring = collections.deque(maxlen=4096)
    monkeypatch.setattr(telemetry, "RING", ring)
    return ring


def read(run):
    return harness.load_metric("prefill_tc_share").read(run)


def test_share_over_the_untraced_warm_requests(ring):
    """Warm untraced requests count; a cold one (its capture's eager decode
    step on ``torch.matmul``) and a traced one do not."""
    window = [(_served(0, False, False), (281, 0)), (_served(1, False, False), (279, 2)),
              (_served(2, True, False), (281, 40 * 7)), (_served(3, False, True), (0, 281))]
    for i, (r, (tc, other)) in enumerate(window):
        ring.append(telemetry.RequestRecord(i, "f00", r.worker, r.cold, products_tc=tc,
                                            products_other=other))
    run = _run([r for r, _ in window])
    assert read(run) == pytest.approx(100.0 * (281 + 279) / (2 * 281))
    ring[0].products_tc = ring[1].products_tc = 0
    ring[0].products_other = ring[1].products_other = 0
    assert read(run) is None  # no product counted


def test_none_for_records_without_the_counts(ring):
    """The records of a program that keeps no product counts (the parent of
    the change that added them)."""
    window = [_served(0, False, False), _served(1, False, False)]
    ring.extend(types.SimpleNamespace(worker=r.worker, cold=r.cold, spans=[]) for r in window)
    assert read(_run(window)) is None
    ring.clear()
    assert read(_run(window)) is None  # and no records at all
