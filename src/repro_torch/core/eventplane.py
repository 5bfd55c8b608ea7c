"""Deterministic in-process pub/sub bus for live windowed metrics.

A copy of the JAX package's ``core/eventplane.py`` (pure Python and numpy, no
JAX): the port keeps its own so that it imports nothing from ``repro``.

The streaming drivers (``ShardedSimulator.run_stream`` and the admission
loop in ``AdmissionSimulator.run``) publish one summary event per shard per
completed metric window onto an :class:`EventPlane`; subscribers — the
autoscaler (``core.autoscale``), dashboards, tests — react synchronously
inside the publishing tick.  The design goal is **replayability**: a run
with subscribers attached must remain a pure function of (seed,
subscriptions), so the bus is deliberately synchronous, ordered, and
sealed:

* **Topics** are tuples: ``("shard", k)`` for shard ``k``'s window summary,
  ``("cluster",)`` for the merged cluster-level summary.  The window index
  and ``(t_lo, t_hi]`` bounds ride on the event itself.
* **Publish order within a window** follows the streaming merge tie-break
  (docs/ARCHITECTURE.md §6): shard topics in ascending shard index, then
  the cluster topic — the same total order the batch merge induces on
  records, so delivery order never depends on wall-clock scheduling.
* **Subscribers register before the run arms** (``seal()``, called by the
  drivers right before ``begin()``); late subscriptions raise instead of
  silently seeing a suffix of the stream.  Within one event, subscribers
  fire in registration order.
* **Payloads are immutable views** (``MappingProxyType``); a subscriber
  cannot mutate what a later subscriber sees.

Together these make the delivery log (``EventPlane.log``) a pure function
of (seed, subscriptions) — pinned by the property sweep in
tests/test_eventplane.py.  The contract is normative in
docs/ARCHITECTURE.md §14.
"""

from __future__ import annotations

import dataclasses
from types import MappingProxyType
from typing import Callable, List, Mapping, Tuple

__all__ = ["MetricEvent", "EventPlane", "SHARD_TOPIC", "CLUSTER_TOPIC"]

#: topic-kind heads (``("shard", k)`` / ``("cluster",)``)
SHARD_TOPIC = "shard"
CLUSTER_TOPIC = "cluster"

#: wildcard element for subscription patterns: matches any value at that slot
WILDCARD = "*"


@dataclasses.dataclass(frozen=True)
class MetricEvent:
    """One published window summary.

    ``seq`` is the global publish sequence number — the total order every
    subscriber observes.  ``payload`` is a read-only mapping of plain
    scalars (JSON types only, by convention), shared by every subscriber.
    """

    topic: Tuple
    window: int  # metric-window index, 0-based
    t_lo: float  # window bounds: records with t_lo < t_done <= t_hi
    t_hi: float
    payload: Mapping
    seq: int


def _matches(pattern: Tuple, topic: Tuple) -> bool:
    if len(pattern) != len(topic):
        return False
    return all(p == WILDCARD or p == t for p, t in zip(pattern, topic))


class EventPlane:
    """Synchronous, ordered, sealed pub/sub bus (see module docstring).

    ``log`` records every delivery as ``(seq, topic, window, sub_id)`` —
    cheap tuples, kept unconditionally so tests can pin that delivery
    order is a pure function of (seed, subscriptions).
    """

    def __init__(self):
        self._subs: List[Tuple[int, Tuple, Callable[[MetricEvent], None]]] = []
        self._sealed = False
        self._seq = 0
        self.published = 0  # events published
        self.delivered = 0  # (event, subscriber) deliveries
        self.log: List[Tuple[int, Tuple, int, int]] = []

    @property
    def sealed(self) -> bool:
        return self._sealed

    def subscribe(
        self, pattern: Tuple, fn: Callable[[MetricEvent], None]
    ) -> int:
        """Register ``fn`` for every topic matching ``pattern``.

        ``pattern`` is a topic tuple where any element may be the wildcard
        ``"*"`` — e.g. ``("shard", "*")`` matches every shard topic,
        ``("cluster",)`` exactly the cluster topic.  Must be called before
        the bus is sealed (the drivers seal right before ``begin()``);
        registration order is delivery order within an event.  Returns the
        subscription id used in the delivery ``log``.
        """
        if self._sealed:
            raise RuntimeError(
                "EventPlane is sealed: subscribers register before the run "
                "arms (begin()); a late subscriber would see only a suffix "
                "of the stream and break replayability"
            )
        if not isinstance(pattern, tuple) or not pattern:
            raise ValueError(f"pattern must be a non-empty tuple, got {pattern!r}")
        sub_id = len(self._subs)
        self._subs.append((sub_id, pattern, fn))
        return sub_id

    def seal(self) -> None:
        """Freeze the subscription set (idempotent).  Publishing also seals
        implicitly, so a forgotten ``seal()`` cannot reopen the window."""
        self._sealed = True

    def publish(
        self, topic: Tuple, window: int, t_lo: float, t_hi: float,
        payload: Mapping,
    ) -> MetricEvent:
        """Publish one window summary and deliver it synchronously.

        Callers are responsible for the §14 publish order (shard topics in
        ascending shard index, then the cluster topic, once per completed
        window); the bus preserves whatever order it is handed — it never
        reorders, buffers, or drops.
        """
        self._sealed = True
        ev = MetricEvent(
            topic=tuple(topic), window=int(window), t_lo=float(t_lo),
            t_hi=float(t_hi), payload=MappingProxyType(dict(payload)),
            seq=self._seq,
        )
        self._seq += 1
        self.published += 1
        for sub_id, pattern, fn in self._subs:
            if _matches(pattern, ev.topic):
                self.log.append((ev.seq, ev.topic, ev.window, sub_id))
                self.delivered += 1
                fn(ev)
        return ev
