"""Per-request records of the serving path, kept by the program itself.

``ServingEngine.submit`` opens one ``RequestRecord`` a request
(``WorkerHost.execute`` opens it when called on its own); the layers below
add their spans to it through this module while it is open, since the
serving path is serial: ``schedule`` (the scheduler's decision),
``execute`` (the worker), ``materialise`` (``Instance.__init__``),
``capture`` (``Instance.prepare``) and ``generate``.  On the card
``Instance.generate`` also records its prefill's and its decode replays'
device intervals, read from CUDA events after the synchronise it makes
anyway.  A record is closed when its ``with`` ends, also when the body
raised (then it is marked ``failed``), and appended to ``RING``, a bounded
deque that anyone in the process can read.

Stamps are Unix-epoch nanoseconds, the clock of ``torch.profiler``'s
Kineto events (``start_ns()``): a traced run's device operations and these
spans lie on one timeline.  They are taken from ``time.perf_counter_ns``
plus one offset, so the differences the engine and the worker report
(``sched_overhead_ms``, ``init_ms``, ``exec_ms``) keep a monotonic clock.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Deque, List, Optional, Tuple

from ..kernels import ops

#: Unix-epoch ns minus ``perf_counter_ns``, read once
_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def now_ns() -> int:
    """Unix-epoch nanoseconds on a monotonic clock."""
    return time.perf_counter_ns() + _EPOCH_OFFSET_NS


def ms(start_ns: int, end_ns: int) -> float:
    """Milliseconds from ``start_ns`` to ``end_ns``."""
    return (end_ns - start_ns) / 1e6


@dataclasses.dataclass
class RequestRecord:
    """One request through the serving path.  ``spans`` are (name,
    start_ns, end_ns) in the order they were opened; ``prefill_ms`` and
    ``decode_ms`` are device intervals (None off the card), ``replays``
    the decode graph replays they cover.  ``products_tc`` and
    ``products_other`` count the dense products that ``kernels.ops.dense``
    ran while the record was open (``ops.PRODUCTS``' growth, set when it
    closes), on the tensor-core kernel and on ``torch.matmul`` (a graph
    replay runs no Python and counts none)."""

    id: int
    func: str
    worker: int = -1
    cold: bool = False
    failed: bool = False
    spans: List[Tuple[str, int, Optional[int]]] = dataclasses.field(default_factory=list)
    prefill_ms: Optional[float] = None
    decode_ms: Optional[float] = None
    replays: int = 0
    products_tc: int = 0
    products_other: int = 0

    def span(self, name: str) -> Optional[Tuple[int, int]]:
        """(start_ns, end_ns) of the first span called ``name``, None where
        there is none."""
        for n, s, t in self.spans:
            if n == name:
                return s, t
        return None

    def span_ms(self, name: str) -> Optional[float]:
        """The length of that span in ms, None where there is none."""
        st = self.span(name)
        return None if st is None else ms(*st)


#: finished records, oldest first
RING: Deque[RequestRecord] = collections.deque(maxlen=4096)
_IDS = itertools.count()
_open: Optional[RequestRecord] = None


def current() -> Optional[RequestRecord]:
    """The record of the request being served, None between requests."""
    return _open


class request:
    """``with request(func) as rec``: opens a record unless one is open
    already (then ``rec`` is that one and this ``with`` leaves it open),
    and on leaving closes it, marks it ``failed`` if the body raised, sets
    its product counts and appends it to ``RING``."""

    __slots__ = ("func", "owner", "products")

    def __init__(self, func: str):
        self.func = func

    def __enter__(self) -> RequestRecord:
        global _open
        self.owner = _open is None
        if self.owner:
            _open = RequestRecord(next(_IDS), self.func)
            self.products = dict(ops.PRODUCTS)
        return _open

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _open
        if self.owner:
            rec, _open = _open, None
            rec.failed = exc_type is not None
            rec.products_tc = ops.PRODUCTS["tc"] - self.products["tc"]
            rec.products_other = ops.PRODUCTS["other"] - self.products["other"]
            RING.append(rec)
        return False


class span:
    """``with span(name)``: a span of the open record around the body
    (ended also when the body raises; ``start`` is its start stamp);
    nothing between requests."""

    __slots__ = ("name", "rec", "i", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self.rec = rec = _open
        if rec is not None:
            self.i, self.start = len(rec.spans), now_ns()
            rec.spans.append((self.name, self.start, None))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self.rec
        if rec is not None:
            rec.spans[self.i] = (self.name, self.start, now_ns())
        return False
